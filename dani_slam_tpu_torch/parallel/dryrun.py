"""Entry points of the port for a driver (counterpart of the JAX
repository's __graft_entry__.py, kept inside the package).

entry(): the flagship forward — SuperPoint on one 480x640 gray image, the
per-frame hot path of the SLAM front-end.

dryrun_multichip(n, backend): the sharded programs on n ranks (launch.py),
small shapes:
  * the SuperPoint training step, batch split over "data" and conv output
    channels over "model" (dp x tp; parallel/train.py), checked for a
    finite loss and the same parameters on every rank after the step;
  * sharded_ba_solve (landmarks split over the ranks, kernel 2 on each
    rank's shard on the card) and sharded_gba (the whole-map PCG solve in
    float32, its per-landmark sums kernel 3 on the card), checked against
    the same solve in one process (the GBA against the float64 solve:
    GBA_TOL).

    python -m dani_slam_tpu_torch.parallel.dryrun N --backend nccl|gloo \
        [--device cuda|cpu]

The backend is the caller's: nccl with one card per rank, gloo otherwise
(on a machine with one card every rank then computes on cuda:0).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, args): fn(model, x) -> (heat [1,480,640], desc [1,60,80,256])
    with the seed-0 Flax-initialized SuperPoint on `device`."""
    from dani_slam_tpu_torch.models import superpoint
    model = superpoint.init_params(0, device).eval()
    x = torch.zeros((1, 1, 480, 640), device=model.conv1a.weight.device)

    def fn(model, x):
        with torch.no_grad():
            return model(x)
    return fn, (model, x)


# ---------------------------------------------------------------------------
# Problems, built from a seed with numpy (every rank builds the same)
# ---------------------------------------------------------------------------

def make_ba_problem(P: int, N: int, L: int, seed: int = 0,
                    cam=(500.0, 500.0, 320.0, 240.0, 640, 480),
                    pose_err: float = 0.02, pt_err: float = 0.05,
                    invalid: float = 0.1) -> dict:
    """A local-BA-shaped problem as numpy arrays: L landmarks 4-8 m in
    front of P keyframes spread 0.3 m apart along x, each keyframe
    observing N distinct landmarks (keyframe-major, a fraction `invalid`
    of the observations masked), pixel noise 0.5, the initial poses and
    landmarks perturbed by pose_err / pt_err; keyframes 0 and 1 fixed
    (two anchors pin the scale gauge, as in local BA)."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, w, h = cam
    pts = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                    rng.uniform(4, 8, L)], -1).astype(np.float32)
    t_true = np.zeros((P, 3), np.float32)
    t_true[:, 0] = -0.3 * np.arange(P)
    olm = np.concatenate([rng.choice(L, N, replace=False) for _ in range(P)])
    okf = np.repeat(np.arange(P), N)
    pc = pts[olm] + t_true[okf]
    xy = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                   fy * pc[:, 1] / pc[:, 2] + cy], -1)
    xy += rng.normal(0, 0.5, xy.shape)
    fixed = np.zeros(P, bool)
    fixed[:2] = True
    t0 = t_true + rng.normal(0, pose_err, (P, 3)) * ~fixed[:, None]
    return dict(cam=cam, R0=np.broadcast_to(np.eye(3, dtype=np.float32),
                                            (P, 3, 3)).copy(),
                t0=t0.astype(np.float32), fixed=fixed,
                lm0=(pts + rng.normal(0, pt_err, pts.shape)).astype(
                    np.float32),
                lm_valid=np.ones(L, bool), obs_kf=okf.astype(np.int64),
                obs_lm=olm.astype(np.int64), obs_xy=xy.astype(np.float32),
                obs_valid=rng.random(P * N) >= invalid)


def ba_args(problem: dict, device):
    """ba_solve's positional arguments from make_ba_problem's arrays."""
    from dani_slam_tpu_torch.core import cameras
    fx, fy, cx, cy, w, h = problem["cam"]
    cam = cameras.Camera.pinhole(fx, fy, cx, cy, w, h, device=device)
    T = lambda k: torch.as_tensor(problem[k], device=device)  # noqa: E731
    return (T("R0"), T("t0"), T("fixed"), T("lm0"), T("lm_valid"), cam,
            T("obs_kf"), T("obs_lm"), T("obs_xy"), T("obs_valid"))


# the dry run's and the tests' GBA map: make_drifted_loop_state's 16
# keyframes (7303 landmarks) at capacities just above them
GBA_MAP = (16, 0.35, (16, 8192, 1024, 32))


def gba_map(device, K: int, drift: float, caps):
    """(MapState, camera) of utils/synthetic.make_drifted_loop_state's
    drifted loop map on `device`, the loop bench's camera."""
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.core import state as mstate
    from dani_slam_tpu_torch.utils import synthetic
    cam = cameras.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480,
                                 device=device)
    st, _, _, _ = synthetic.make_drifted_loop_state(
        cam, mstate.MapCaps(*caps), K=K, drift=drift)
    return st, cam


def single_gba(st, cam, iters: int, dtype=torch.float32, relabel=None):
    """The whole-map solve of loopclosing.global_bundle_adjustment in one
    process, in `dtype` (float64: the yardstick the float32 solves are
    held to). relabel (a seed) stores the landmarks in another order of
    the table (a random permutation, undone in the result): the same
    problem, each landmark's sums in the same order (kernels.segment_sum)
    where the JAX package's running-sum differences change."""
    from dani_slam_tpu_torch.ops import ba_large
    from dani_slam_tpu_torch.slam.loopclosing import _gba_problem
    inv = None
    if relabel is not None:
        L = st.lm_pos.shape[0]
        perm = torch.randperm(L, generator=torch.Generator().manual_seed(
            relabel)).to(st.lm_pos.device)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(L, device=perm.device)
        st = dataclasses.replace(
            st, lm_pos=st.lm_pos[perm], lm_mask=st.lm_mask[perm],
            obs_lm=torch.where(st.obs_lm >= 0, inv[st.obs_lm.clamp(min=0)],
                               st.obs_lm))
    pf, okf, olm, oxy, ov, info = _gba_problem(st)
    c = lambda t: t.to(dtype)                          # noqa: E731
    res = ba_large.ba_solve_pcg(c(st.kf_R), c(st.kf_t), pf, c(st.lm_pos),
                                st.lm_mask, cam, okf, olm, c(oxy), ov,
                                obs_info=c(info), iters=iters)
    return res if inv is None else res._replace(lm_pos=res.lm_pos[inv])


def gba_errors(res, ref, st):
    """(largest keyframe translation difference over the live keyframes,
    largest landmark difference over the live landmarks seen from two
    keyframes or more) of two GBA results. A landmark seen from one
    keyframe has no depth in the problem: damping and rounding place it,
    in a float64 solve too."""
    seen = (st.obs_lm >= 0) & st.kf_kp_mask
    n_obs = torch.bincount(st.obs_lm[seen].long(),
                           minlength=st.lm_pos.shape[0])
    dt = torch.abs(res.t.double() - ref.t.double())[st.kf_mask]
    dl = torch.abs(res.lm_pos.double() - ref.lm_pos.double())[
        st.lm_mask & (n_obs >= 2)]
    return float(dt.max()), float(dl.max())


# the float32 GBA (one process in any order of the landmark table, or
# sharded) against the one-process float64 solve after GBA_ITERS
# iterations: largest keyframe translation and landmark difference
# (gba_errors). Measured on GBA_MAP on the CPU with the plain versions:
# one process 2.6e-4 / 6.4e-4 m in every order of the table, 2 ranks
# 3.1e-4 / 7.7e-4, 4 ranks 5.6e-4 / 1.13e-3; on an H100 (PERF.md):
# one process at MapCaps() 2.3e-4 / 6.2e-4 in every order, 4 ranks
# 4.2e-4 / 1.01e-3 (at GBA_MAP 5.4e-4 / 9.7e-4). The bound is about
# twice the largest.
GBA_TOL = (1e-3, 2.5e-3)
GBA_ITERS = 10


# ---------------------------------------------------------------------------
# Rank functions (launch.launch runs them on every rank)
# ---------------------------------------------------------------------------

def sharded_ba_rank(device, problem: dict, iters: int):
    """sharded_ba_solve on this rank; its result, the kernel launches of
    the rank and its landmark range."""
    from dani_slam_tpu_torch.ops import kernels
    from dani_slam_tpu_torch.parallel import mesh as pmesh
    m = pmesh.make_mesh(device=device)
    args = ba_args(problem, device)
    kernels.reset_launch_counts()
    res = pmesh.sharded_ba_solve(m, *args, iters=iters)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    l0, l1, _ = pmesh.landmark_range(m, args[3].shape[0])
    return dict(res._asdict(), launches=kernels.launch_counts(),
                landmarks=(l0, l1))


def sharded_gba_rank(device, K: int, drift: float, caps, iters: int):
    """sharded_gba of gba_map's map on this rank."""
    from dani_slam_tpu_torch.parallel import mesh as pmesh
    st, cam = gba_map(device, K, drift, caps)
    res = pmesh.sharded_gba(pmesh.make_mesh(device=device), st, cam,
                            iters=iters)
    return dict(res._asdict(), kf_mask=st.kf_mask, lm_mask=st.lm_mask)


def sharded_train_rank(device, n: int, steps: int, init_state=None, x=None,
                       lr: float = 1e-4):
    """`steps` of the dp x tp training step on this rank (make_mesh_2d,
    shard_params, make_train_step, Adam(lr)) from `init_state` (a float32
    SuperPoint's state dict; else Flax's initialization from seed 1) on
    the global batch x (B,1,H,W): the losses, the full gradients of the
    first step, the full parameters after the last, whether every rank
    holds the same parameters, the split layers and the rank's mesh
    coordinates."""
    from dani_slam_tpu_torch.models import convert
    from dani_slam_tpu_torch.models.optim import Adam
    from dani_slam_tpu_torch.models.superpoint import SuperPoint
    from dani_slam_tpu_torch.parallel import train as ptrain
    mesh = ptrain.make_mesh_2d(n, device)
    full = SuperPoint(compute_dtype=torch.float32)
    if init_state is None:
        convert.flax_init(full, 1)
    else:
        full.load_state_dict(init_state)
    model = ptrain.shard_params(full.to(device), mesh)
    step = ptrain.make_train_step(model, Adam(model.parameters(), lr), mesh)
    x = x.to(device)
    losses, grads = [], None
    for _ in range(steps):
        losses.append(step(x))
        if grads is None:
            grads = model.gather(grad=True).state_dict()
    return dict(losses=torch.stack(losses), grads=grads,
                params=model.gather().state_dict(),
                same=ptrain.params_equal_across(mesh, model),
                split=sorted(model.split), coords=mesh.coords)


def _dryrun_rank(device, n: int):
    import torch.distributed as dist
    from dani_slam_tpu_torch.ops import ba as ba_ops
    from dani_slam_tpu_torch.ops import kernels
    from dani_slam_tpu_torch.ops.ba import BAResult
    from dani_slam_tpu_torch.parallel import train as ptrain
    if device.type == "cuda":
        if dist.get_rank() == 0:          # one nvcc per source, not n
            kernels.build_kernels()
        dist.barrier()
        kernels.build_kernels()
    model, losses = ptrain.train_superpoint_sharded(n, steps=1,
                                                    device=device)
    problem = make_ba_problem(4, 48, 64, pose_err=0.05)
    ba = sharded_ba_rank(device, problem, 2)
    ref = ba_ops.ba_solve(*ba_args(problem, device), iters=2)
    gba = sharded_gba_rank(device, *GBA_MAP, GBA_ITERS)
    st, cam = gba_map(device, *GBA_MAP)
    gba_err = gba_errors(
        BAResult(gba["R"], gba["t"], gba["lm_pos"], None, gba["cost"]),
        single_gba(st, cam, GBA_ITERS, torch.float64), st)
    return dict(
        backend=dist.get_backend(), coords=model.mesh.coords,
        loss=float(losses[-1]),
        same_params=ptrain.params_equal_across(model.mesh, model),
        ba_cost=float(ba["cost"]), ba_launches=ba["launches"],
        ba_landmarks=ba["landmarks"],
        ba_dt=float(torch.max(torch.abs(ba["t"] - ref.t))),
        ba_dlm=float(torch.max(torch.abs(ba["lm_pos"] - ref.lm_pos))),
        gba_cost=float(gba["cost"]), gba_err=gba_err)


def dryrun_multichip(n_devices: int, backend: str, device="cuda") -> list:
    """The sharded programs on n_devices ranks; raises unless each ran
    with a finite loss and cost, the same parameters on every rank, the
    sharded BA within 1e-3 (poses) / 1e-2 (landmarks) of the one-process
    solve and the sharded GBA (float32) within GBA_TOL of the one-process
    float64 solve. Returns the ranks' reports."""
    from dani_slam_tpu_torch.parallel.launch import launch
    from dani_slam_tpu_torch.utils.device import resolve_device
    resolve_device(device)
    reports = launch(_dryrun_rank, n_devices, n_devices, backend=backend,
                     device=device)
    for r in reports:
        ok = (math.isfinite(r["loss"]) and r["same_params"] and
              math.isfinite(r["ba_cost"]) and math.isfinite(r["gba_cost"])
              and r["ba_dt"] < 1e-3 and r["ba_dlm"] < 1e-2 and
              r["gba_err"][0] <= GBA_TOL[0] and
              r["gba_err"][1] <= GBA_TOL[1] and not r["foreign_modules"])
        if not ok:
            raise RuntimeError(f"dryrun_multichip: {r}")
    return reports


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="number of ranks")
    ap.add_argument("--backend", required=True, choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    heat, desc = fn(*fargs)
    print(f"entry ok: heat {tuple(heat.shape)}, desc {tuple(desc.shape)}",
          flush=True)
    reports = dryrun_multichip(args.n, args.backend, args.device)
    for rank, r in enumerate(reports):
        print(f"rank {rank} ({args.backend}, {args.device}): mesh "
              f"{r['coords']}, train loss {r['loss']:.6f}, same params "
              f"{r['same_params']}; BA landmarks {r['ba_landmarks']}, cost "
              f"{r['ba_cost']:.6g}, kernel launches {r['ba_launches']}, "
              f"|dt| {r['ba_dt']:.2e} |dlm| {r['ba_dlm']:.2e} against one "
              f"process; GBA (float32, {GBA_ITERS} iterations) cost "
              f"{r['gba_cost']:.6g}, |dt| {r['gba_err'][0]:.2e} |dlm| "
              f"{r['gba_err'][1]:.2e} against one process in float64",
              flush=True)
    print(f"dryrun_multichip ok: {args.n} ranks, backend "
          f"{reports[0]['backend']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
