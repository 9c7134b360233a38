"""ATE evaluation (counterpart of examples/evaluate_ate.py; reference:
evaluation/evaluate_ate_scale.py with evaluation/associate.py): Horn
alignment, optionally with scale, and the RMSE over associated pairs of two
TUM-format trajectories.

    python -m dani_slam_tpu_torch.examples.evaluate_ate GROUNDTRUTH.txt \
        ESTIMATE.txt [--scale] [--max-dt 0.02] [--plot out.png]
"""
from __future__ import annotations

import argparse

import numpy as np

from dani_slam_tpu_torch.utils import eval as ev


def load_tum(path):
    rows = np.loadtxt(path)
    if rows.ndim == 1:
        rows = rows[None]
    return rows[:, 0], rows[:, 1:4]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("groundtruth")
    ap.add_argument("estimate")
    ap.add_argument("--scale", action="store_true",
                    help="align scale too (monocular)")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--plot", default=None)
    args = ap.parse_args(argv)

    t_gt, p_gt = load_tum(args.groundtruth)
    t_est, p_est = load_tum(args.estimate)
    ie, ig = ev.associate(t_est, t_gt, max_dt=args.max_dt)
    if len(ie) < 2:
        raise SystemExit("no associated pairs")
    rmse = ev.ate_rmse(p_est[ie], p_gt[ig], with_scale=args.scale)
    s, R, tr = ev.align_horn(p_est[ie], p_gt[ig], with_scale=args.scale)
    aligned = (s * (R @ p_est[ie].T)).T + tr
    err = np.linalg.norm(aligned - p_gt[ig], axis=1)
    print(f"compared_pose_pairs {len(ie)} pairs")
    print(f"absolute_translational_error.rmse {rmse:.6f} m")
    print(f"absolute_translational_error.mean {err.mean():.6f} m")
    print(f"absolute_translational_error.median {np.median(err):.6f} m")
    print(f"absolute_translational_error.std {err.std():.6f} m")
    print(f"absolute_translational_error.min {err.min():.6f} m")
    print(f"absolute_translational_error.max {err.max():.6f} m")
    if args.scale:
        print(f"scale {s:.6f}")
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(7, 7))
        ax.plot(p_gt[ig][:, 0], p_gt[ig][:, 1], "k-", label="ground truth")
        ax.plot(aligned[:, 0], aligned[:, 1], "b-", label="estimated")
        ax.legend()
        ax.set_aspect("equal")
        fig.savefig(args.plot, dpi=110)


if __name__ == "__main__":
    main()
