"""KITTI odometry stereo runner (counterpart of examples/stereo_kitti.py;
reference: Examples/Stereo/stereo_kitti.cc): image_0/image_1 pairs at
times.txt through System.track_stereo (KITTI ships rectified pairs),
CameraTrajectory.txt in KITTI format.

    python -m dani_slam_tpu_torch.examples.stereo_kitti SETTINGS.yaml \
        SEQUENCE [--out-prefix OUT] [--max-frames N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

from dani_slam_tpu_torch.examples._common import add_device_argument, \
    device_of


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence", help="KITTI sequence dir (image_0/ image_1/"
                                     " times.txt)")
    ap.add_argument("--out-prefix", default="")
    ap.add_argument("--max-frames", type=int, default=0)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from dani_slam_tpu_torch.core import config as cfg
    from dani_slam_tpu_torch.core import state as mstate
    from dani_slam_tpu_torch.slam.system import Sensor, System
    from dani_slam_tpu_torch.utils import io as io_utils
    from dani_slam_tpu_torch.utils.native import ImagePrefetcher

    dev = device_of(args)
    settings = cfg.Settings.from_yaml(args.settings)
    print(settings, file=sys.stderr)
    system = System(settings.camera(dev), Sensor.STEREO,
                    caps=mstate.MapCaps(N=settings.n_features),
                    n_features=settings.n_features, pipelined=True,
                    device=dev)
    frames = io_utils.load_kitti_stereo_list(args.sequence)
    if args.max_frames:
        frames = frames[:args.max_frames]
    with ImagePrefetcher([lp for _, lp, _ in frames]) as lefts, \
            ImagePrefetcher([rp for _, _, rp in frames]) as rights:
        for i, (ts, _, _) in enumerate(frames):
            state, _, _ = system.track_stereo(lefts.get(i), rights.get(i),
                                              ts, settings.baseline)
            if i % 50 == 0:
                print(f"[{i}/{len(frames)}] {state} "
                      f"kf={system.n_keyframes()}", flush=True)
    system.shutdown()
    io_utils.save_trajectory_kitti(args.out_prefix + "CameraTrajectory.txt",
                                   system.tracker.trajectory)
    print(f"done: {len(frames)} frames, {len(system.tracker.trajectory)} "
          f"poses on {dev}", flush=True)


if __name__ == "__main__":
    main()
