#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dani_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize(); any failure exits non-zero:
  1. build every CUDA kernel from dani_slam_tpu_torch/csrc (nvcc, sm_90a) and
     print the build seconds;
  2. hold each kernel against its plain PyTorch version on the card at the
     main-path shapes (kernel 1 also at relocalization's: M 1024 x N 1024,
     all rows live, scalar radius 10 px and 3 px) and one ragged shape
     (window match: distances within
     atol 1e-4, indices up to near-ties, two launches bitwise equal; landmark
     blocks: rtol/atol 1e-5; the reduction plan: exactly equal), and time
     kernel, plain version and a one-call PyTorch yardstick (one call of the
     wrapper between CUDA events, median of 25 after warm-up), the device
     time of the kernel's own launches (torch.profiler) and an empty kernel
     launched the same way (the floor under any separately launched kernel);
  3. drive the port's main path, the configuration bench.py runs: the
     60-frame 640x480 detector-on RGB-D sequence through System(device=
     "cuda", matcher="auto", pipelined=True) with loop closing and
     relocalization on (the defaults) and the shipped vocabulary, at
     MapCaps() = K=256/L=32768/N=1024/D=256, 1024 features, LightGlue
     matcher, deferred decisions, one captured CUDA graph per tracked frame
     — once to warm up, then a timed pass with every kernel launch counter,
     the LightGlue forward counter and the host-sync counters set to 0 just
     before it and read just after (a graph replay adds the launches it
     holds); bench.py's checks (>= 51/60 frames tracked, >= 5 keyframes, >=
     1000 landmarks, detector fired) plus finite poses, the ATE against the
     ground truth, >= 50 graph replays, fewer blocking host syncs per frame
     than the non-pipelined path's 2.33, a BoW update per keyframe and loop
     detection dispatched (0 loops expected: the arc never returns); then a
     jump in the timestamps, which must stash the map in the Atlas and go
     on tracking on a new one, which each keyframe pull tries to merge back
     into the stored map (printed);
  4. bench.py's loop pass (loop_close_kf_latency): the drifted 16-keyframe
     loop map at MapCaps() through LoopCloser.on_keyframe, a warm-up pass,
     a timed pass and finish_gba; one loop, the loop-end error below 0.3 of
     the drifted one and a lower mean error; then a pass timed stage by
     stage and three stages under torch.profiler;
  5. relocalization: the main path over the whole sequence, six blacked-out
     frames (image and depth zero), after which the camera is back at the
     map's start (the first frame's view for 6 frames, then the sequence
     replayed): lost, at least one relocalization (kernel 1 launched inside
     it, counted), OK at the end, ATE < 0.25 m;
  6. the earlier path at a smaller depth: the non-pipelined, descriptor
     mutual-NN configuration without loop closing for 12 frames, its checks
     scaled;
  7. held against each other: a small input on the CPU (the kernels' plain
     versions) and on the card; LightGlue on the card against the CPU on
     one pair of 1024 keypoints (and its time per forward at both call
     shapes of the path); pipelined against non-pipelined trajectories (on
     pre-extracted features within 5 cm, the rule of tests/test_slam_e2e.py,
     and on 30 frames of the image sequence within 0.15 m); graph replay
     against the eager fused function over 8 frames (same bindings, poses
     within 1e-5);
  8. where the time goes: six steady-state frames of the main path under
     torch.profiler (device busy share, kernels per frame inside and outside
     the graph, top operators), and the device time and kernel count of a
     replayed frame and of the two candidates that selecting the fallbacks
     on the device always computes.

The line before the last is {"kernels": [...]} with each kernel's numbers;
the last line is {"ok": true, "device": {...}}. Without CUDA, or run outside
a checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import platform
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16
F32_FLOPS = 67e12                  # f32 outside the tensor cores


def _sync():
    import torch
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of fn() over `reps` CUDA-event-timed calls."""
    import torch
    for _ in range(warmup):
        fn()
    _sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, names, reps: int = 20) -> dict:
    """Device milliseconds per call of fn() spent in the kernels whose name
    contains each of `names` (each launched once a call): torch.profiler
    over `reps` calls after warm-up, the mean over the launches it recorded
    (a session now and then drops a record). Fails when a name was never
    launched, so a host-side number can never stand in for a device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        _sync()
    total = {n: 0.0 for n in names}
    count = {n: 0 for n in names}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        for n in names:
            if n in e.name:
                total[n] += e.device_time_total
                count[n] += 1
    missing = [n for n in names if count[n] < reps // 2 or total[n] <= 0]
    if missing:
        raise SystemExit(f"profiler recorded no device time for {missing} "
                         f"({count} launches recorded of {reps})")
    return {n: total[n] / 1e3 / count[n] for n in names}


def phase(name: str):
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def match_inputs(M, N, D, n_live, seed, dev, radius=None):
    """Unit descriptors with planted matches, pixel coords in 640x480, a
    valid prefix of n_live rows (the compacted local-map query set) and
    per-query radii 4 * 1.2^level — or, given `radius`, that scalar for every
    query (relocalization's 10 px and 3 px passes)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    q = rng.randn(M, D).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.randn(N, D).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    k = min(n_live, N) // 2
    t[:k] = q[:k] + 0.05 * rng.randn(k, D).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    qxy = rng.uniform(0, [640, 480], (M, 2)).astype(np.float32)
    txy = rng.uniform(0, [640, 480], (N, 2)).astype(np.float32)
    txy[:k] = qxy[:k] + rng.randn(k, 2).astype(np.float32) * 2
    qv = np.arange(M) < n_live
    tv = rng.rand(N) > 0.1
    r = (4.0 * 1.2 ** rng.randint(0, 4, M)).astype(np.float32)
    T = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    return T(q), T(qxy), T(qv), T(t), T(txy), T(tv), \
        T(r) if radius is None else float(radius)


def check_window_match(kernels, M, N, D, n_live, seed, timed, radius=None):
    import torch
    dev = torch.device("cuda")
    args = match_inputs(M, N, D, n_live, seed, dev, radius)
    out_k = kernels.window_match_topk2(*args)
    again = kernels.window_match_topk2(*args)
    ref_dist = kernels.window_match_dist_ref(*args)
    out_r = kernels.window_match_reduce_ref(ref_dist)
    _sync()
    res = kernels.window_match_agreement(out_k, out_r, ref_dist, atol=1e-4)
    same = all(torch.equal(a, b) for a, b in zip(out_k, again))
    ok = res["ok"] and same
    rtxt = "per-query radii" if radius is None else f"radius {radius} px"
    print(f"window_match_topk2 M={M} N={N} D={D} live={n_live} {rtxt}: "
          f"rows found {int((out_r[0] < 1e8).sum())}, cols found "
          f"{int((out_r[3] < 1e8).sum())}, max |err| "
          f"{res['max_abs_err']:.3g} (atol 1e-4), indices differing on "
          f"near-ties: {res['idx_differ']} rows, {res['col_idx_differ']} "
          f"columns, two launches bitwise equal: {same} "
          f"{'OK' if ok else 'MISMATCH ' + str(res['why'])}", flush=True)
    if not ok:
        raise SystemExit("window_match_topk2 disagrees with its plain version")
    del ref_dist
    if not timed:
        return res["max_abs_err"], None
    q, qxy, qv, t, txy, tv, r = args
    r2 = torch.as_tensor(r, device=dev) ** 2
    r2 = r2.expand(M) if r2.ndim == 0 else r2

    def library():
        # one bf16 matmul + the masked reductions, all in PyTorch
        dots = torch.matmul(q.to(torch.bfloat16),
                            t.to(torch.bfloat16).T).float()
        dist = torch.clamp(2.0 - 2.0 * dots, min=0.0)
        dx = qxy[:, None, 0] - txy[None, :, 0]
        dy = qxy[:, None, 1] - txy[None, :, 1]
        m = ((dx * dx + dy * dy) <= r2[:, None]) & tv[None, :] & qv[:, None]
        dist = torch.where(m, dist, torch.full_like(dist, 1e9))
        v2, i2 = torch.topk(dist, 2, dim=1, largest=False)
        return v2, i2, torch.min(dist, dim=0)

    ms = time_ms(lambda: kernels.window_match_topk2(*args))
    plain_ms = time_ms(lambda: kernels.window_match_topk2_ref(*args))
    lib_ms = time_ms(library)
    dev = device_ms(lambda: kernels.window_match_topk2(*args),
                    ("wm_prep_kernel", "wm_match_kernel"))
    print(f"window_match_topk2 device time per call: target rounding "
          f"{dev['wm_prep_kernel']:.4f} ms + match "
          f"{dev['wm_match_kernel']:.4f} ms", flush=True)
    # bytes the function must move on this run's data: descriptors of the
    # live query rows only (rounded up to 32 rows, a granularity at which
    # dead rows can be skipped and the one this bound has used since the
    # first version), every query's xy/valid/radius, all targets, and the
    # outputs (best/second/idx per row, best/row per column); the scratch
    # bf16 copy of the targets is the kernel's own business, not counted
    live_rows = min(M, -(-n_live // 32) * 32)
    r_bytes = 4 if radius is None else 0           # a scalar radius is free
    nbytes = live_rows * D * 4 + M * (2 * 4 + 1 + r_bytes) + \
        N * (D * 4 + 2 * 4 + 1) + M * 12 + N * 8
    flops = 2.0 * n_live * N * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return res["max_abs_err"], dict(
        ms=ms, device_ms=sum(dev.values()), plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        idx_differ=res["idx_differ"], col_idx_differ=res["col_idx_differ"])


def lba_inputs(P, N, L, seed, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    row_lm = rng.integers(0, L, size=(P, N)).astype(np.int32)
    row_lm[rng.random((P, N)) < 0.3] = -1
    vals = rng.standard_normal((P, N, 30)).astype(np.float32)
    return (torch.as_tensor(row_lm, device=dev),
            torch.as_tensor(vals, device=dev))


def check_lba(kernels, P, N, L, seed, timed):
    import torch
    dev = torch.device("cuda")
    row_lm, vals = lba_inputs(P, N, L, seed, dev)
    plan = kernels.lba_plan(row_lm, L)
    plan_r = kernels.lba_plan_ref(row_lm, L)
    out_k = kernels.lba_landmark_blocks(row_lm, vals, L, plan)
    again = kernels.lba_landmark_blocks(row_lm, vals, L, plan)
    out_r = kernels.lba_landmark_blocks_ref(row_lm, vals, L)
    _sync()
    plan_ok = all(torch.equal(a, b) for a, b in zip(plan, plan_r))
    same = all(torch.equal(a, b) for a, b in zip(out_k, again))
    err = max(torch.max(torch.abs(a - b)).item()
              for a, b in zip(out_k, out_r))
    ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
             for a, b in zip(out_k, out_r)) and same
    print(f"lba_plan P={P} N={N} L={L}: device plan equals the plain "
          f"version's sort exactly: {plan_ok}", flush=True)
    if not plan_ok:
        raise SystemExit("lba_plan disagrees with its plain version")
    print(f"lba_landmark_blocks P={P} N={N} L={L}: max |err| {err:.3g} "
          f"(rtol/atol 1e-5), two launches bitwise equal: {same} "
          f"{'OK' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise SystemExit("lba_landmark_blocks disagrees with its plain "
                         "version")
    if not timed:
        return err, None
    valid = row_lm >= 0
    ids = torch.where(valid, row_lm, torch.full_like(row_lm, L)).long()
    pid = torch.arange(P, device=dev)[:, None] * (L + 1) + ids

    def library():
        a = torch.zeros((L + 1, 12), device=dev).index_add_(
            0, ids.reshape(-1), vals[..., :12].reshape(-1, 12))
        b = torch.zeros((P * (L + 1), 18), device=dev).index_add_(
            0, pid.reshape(-1), vals[..., 12:].reshape(-1, 18))
        return a, b

    ms = time_ms(lambda: kernels.lba_landmark_blocks(row_lm, vals, L, plan))
    plain_ms = time_ms(lambda: kernels.lba_landmark_blocks_ref(row_lm, vals,
                                                               L))
    lib_ms = time_ms(library)
    plan_ms = time_ms(lambda: kernels.lba_plan(row_lm, L))
    plan_plain_ms = time_ms(lambda: kernels.lba_plan_ref(row_lm, L))
    dev = device_ms(lambda: kernels.lba_landmark_blocks(row_lm, vals, L,
                                                        plan),
                    ("lba_blocks_kernel",))
    dev.update(device_ms(lambda: kernels.lba_plan(row_lm, L),
                         ("lba_plan_kernel",)))
    print(f"lba_plan (once per BA solve, not in the kernel's time): "
          f"{plan_ms:.4f} ms a call, {dev['lba_plan_kernel']:.4f} ms on the "
          f"device; its plain version (argsort + searchsorted) "
          f"{plan_plain_ms:.4f} ms", flush=True)
    # bytes the function must move on this run's data: every id, the 30
    # channels of the valid observations only (no kernel needs the rest),
    # and the outputs H_ll/g_l [L,12] and H_pl [P,L,18]
    n_obs = int(valid.sum())
    nbytes = row_lm.numel() * 4 + n_obs * 30 * 4 + L * 12 * 4 + \
        P * L * 18 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_obs * 30 / F32_FLOPS * 1e3
    return err, dict(ms=ms, device_ms=dev["lba_blocks_kernel"],
                     plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     plan_ms=plan_ms, plan_device_ms=dev["lba_plan_kernel"],
                     plan_plain_ms=plan_plain_ms)


# ---------------------------------------------------------------------------
# Phase 3/4: the port's main path
# ---------------------------------------------------------------------------

def make_sequence(n_frames, width, height, f, angle_span):
    from dani_slam_tpu_torch.utils import synthetic
    R_gt, t_gt = synthetic.orbit_trajectory(n_frames, radius=10.0,
                                            angle_span=angle_span)
    imgs, deps, times = synthetic.make_rgbd_image_sequence(
        [f, f, width / 2, height / 2], width, height, R_gt, t_gt, seed=0)
    return R_gt, t_gt, imgs, deps, times


# bench.py's configuration: loop closing and relocalization on (the
# System's defaults, as bench.py leaves them)
NEW = dict(matcher="auto", pipelined=True)
# the first slice's
OLD = dict(matcher=None, pipelined=False, enable_loop_closing=False,
           enable_relocalization=False)


def make_system(device, caps, n_feat, width, height, f, mode,
                detector=True):
    """A fresh System in configuration `mode`, with bench.py's keypoint
    threshold."""
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.models import yolo
    from dani_slam_tpu_torch.slam.system import Sensor, System
    cam = cameras.Camera.pinhole(f, f, width / 2, height / 2, width, height,
                                 device=device)
    sys_ = System(cam, Sensor.RGBD, caps=caps, n_features=n_feat,
                  detector=yolo.load_default_detector(device) if detector
                  else None, device=device, **mode)
    sys_.sp_threshold = 0.012
    return sys_


def frames_on(device, seq):
    """(images, depths, times) of a sequence, the tensors on `device`."""
    import torch
    _, _, imgs, deps, times = seq
    return ([torch.as_tensor(x, device=device) for x in imgs],
            [torch.as_tensor(x.astype("int32"), device=device)
             for x in deps], times)


def run_system(device, caps, n_feat, seq, width, height, f, mode,
               n_frames=None, frame_graph=None):
    """One pass through a fresh System; returns (system, n_ok, seconds)."""
    sys_ = make_system(device, caps, n_feat, width, height, f, mode)
    if frame_graph is not None:
        sys_.tracker.frame_graph = frame_graph
    imgs, deps, times = frames_on(device, seq)
    if device == "cuda":
        _sync()
    t0 = time.perf_counter()
    n_ok = 0
    for i in range(n_frames or len(imgs)):
        state, _, _ = sys_.track_rgbd(imgs[i], deps[i], times[i])
        n_ok += state == "OK"
    sys_.shutdown()
    if device == "cuda":
        _sync()
    return sys_, n_ok, time.perf_counter() - t0


def trajectory_ate(sys_, seq):
    """(camera centres [F,3], ATE RMSE in m against the ground truth)."""
    import numpy as np
    from dani_slam_tpu_torch.utils import eval as ev
    traj = sys_.tracker.trajectory
    C_est = centers(traj)
    idx = np.round(np.asarray([tm for tm, _, _ in traj]) * 30).astype(int)
    C_gt = ev.centers_from_tcw(seq[0][idx], seq[1][idx])
    return C_est, ev.ate_rmse(C_est, C_gt)


def check_lightglue(width, height):
    """LightGlue on the card against the CPU on one pair of 1024 keypoints,
    and its time per forward at the two call shapes of the main path. The
    bf16 layers of the two devices round differently (as the two libraries
    do in tests/test_torch_lightglue.py): probabilities within 0.03, match
    sets differing on at most 2 % of the rows."""
    import numpy as np
    import torch
    from dani_slam_tpu_torch.models import lightglue as lg
    rng = np.random.RandomState(0)

    def pair(b, n):
        xy0 = rng.uniform(0, [width, height], (b, n, 2)).astype(np.float32)
        d0 = rng.randn(b, n, 256).astype(np.float32)
        d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
        perm = rng.permutation(n)
        xy1 = xy0[:, perm] + rng.randn(b, n, 2).astype(np.float32)
        d1 = d0[:, perm] + 0.05 * rng.randn(b, n, 256).astype(np.float32)
        d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
        m0 = np.broadcast_to(np.arange(n)[None] < int(0.9 * n), (b, n))
        m1 = np.broadcast_to(np.arange(n)[None] < int(0.8 * n), (b, n))
        return xy0, d0, m0.copy(), xy1, d1, m1.copy()

    a = pair(1, 1024)
    outs = {}
    for dev in ("cpu", "cuda"):
        ms = lg.load_default_matcher(width, height, device=dev)
        outs[dev] = [x.cpu().numpy() for x in lg.match_pairs(
            ms.model, *(torch.as_tensor(x, device=dev) for x in a), width,
            height)]
    (ic, bc, okc), (ig, bg, okg) = outs["cpu"], outs["cuda"]
    d_best = float(np.abs(bc - bg).max())
    differ = int(((okc != okg) | (okc & okg & (ic != ig))).sum())
    print(f"LightGlue card vs CPU, 1 x 1024 x 1024 keypoints: accepted "
          f"{int(okg.sum())} / {int(okc.sum())}, best probability differs "
          f"by at most {d_best:.4f} (limit 0.03), {differ} of 1024 rows "
          f"differ in match (limit 20)", flush=True)
    if not (d_best < 0.03 and differ <= 20 and okg.sum() > 100):
        raise SystemExit("LightGlue on the card disagrees with the CPU")
    ms = lg.load_default_matcher(width, height, device="cuda")
    times = {}
    for name, (b, n) in (("1x1024", (1, 1024)), ("5x512", (5, 512))):
        args = [torch.as_tensor(x, device="cuda") for x in pair(b, n)]
        times[name] = time_ms(lambda: lg.match_pairs(ms.model, *args, width,
                                                     height), reps=10)
    print(f"LightGlue forward (match_pairs, eager, CUDA events, median of "
          f"10): {times['1x1024']:.3f} ms at 1 x 1024^2 tokens, "
          f"{times['5x512']:.3f} ms at 5 x 512^2", flush=True)
    return times


def feature_frames(n_frames, n_max, device):
    """The pre-extracted-feature sequence of tests/test_slam_e2e.py's
    pipelined case: 25 frames of an orbit around a random landmark cloud."""
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.utils import synthetic
    cam = cameras.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480,
                                 device=device)
    world = synthetic.make_world(1500, desc_dim=64, seed=0)
    R_gt, t_gt = synthetic.orbit_trajectory(n_frames, radius=10.0,
                                            angle_span=0.5)
    return [synthetic.render_frame(world, cam, R_gt[i], t_gt[i], n_max=n_max,
                                   seed=i, with_depth=True,
                                   time=i / 30.0)[0]
            for i in range(n_frames)]


def check_pipelined_vs_plain_features():
    """Deferred decisions must give an equivalent trajectory: 25 feature
    frames through System.track_features, pipelined and not, on the card."""
    import numpy as np
    from dani_slam_tpu_torch.core import state as mstate
    feats = feature_frames(25, 512, "cuda")
    caps = mstate.MapCaps(K=64, L=8192, N=512, D=64)
    outs = {}
    for pipelined in (False, True):
        sys_ = make_system("cuda", caps, 512, 640, 480, 500.0,
                           dict(matcher="auto", pipelined=pipelined),
                           detector=False)
        for i, ft in enumerate(feats):
            sys_.track_features(ft, timestamp=i / 30.0)
        sys_.shutdown()
        outs[pipelined] = sys_.tracker.trajectory
    n = min(len(outs[True]), len(outs[False]))
    d = float(np.linalg.norm(centers(outs[True][:n]) -
                             centers(outs[False][:n]), axis=1).max())
    print(f"pipelined vs non-pipelined on 25 feature frames: "
          f"{len(outs[True])} / {len(outs[False])} poses, centres within "
          f"{d:.4f} m (limit 0.05)", flush=True)
    if len(outs[True]) < 23 or d >= 0.05:
        raise SystemExit("pipelined and non-pipelined trajectories differ")


def centers(traj):
    import numpy as np
    return np.stack([-R.T @ t for _, R, t in traj])


def _kernel_events(prof):
    return [e for e in prof.events()
            if e.device_type.name == "CUDA" and e.device_time_total > 0]


def profile_main_path(caps, seq, start, n_frames, width, height, f):
    """Frames start .. start+n_frames of the main path (after `start`
    frames run unprofiled) under torch.profiler: host wall time, summed
    device time of the kernels, kernels per frame — those launched one by
    one from the host (counted by their cudaLaunchKernel calls) and those
    inside graph replays (the rest) — and the operators with the most device
    time. The profiler's own cost inflates the host time; the device sums
    and kernel counts are exact."""
    from torch.profiler import ProfilerActivity, profile
    sys_ = make_system("cuda", caps, 1024, width, height, f, NEW)
    imgs, deps, times = frames_on("cuda", seq)
    for i in range(start):
        sys_.track_rgbd(imgs[i], deps[i], times[i])
    _sync()
    replays0, kf0 = sys_.tracker.graph_replays, sys_._kf_count
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(start, start + n_frames):
            sys_.track_rgbd(imgs[i], deps[i], times[i])
        _sync()
        dt = time.perf_counter() - t0
    kernels = _kernel_events(prof)
    dev_ms = sum(e.device_time_total for e in kernels) / 1e3
    host_launches = sum(1 for e in prof.events()
                        if e.device_type.name == "CPU" and
                        e.name.startswith("cudaLaunchKernel"))
    graph_launches = sum(1 for e in prof.events()
                         if e.device_type.name == "CPU" and
                         e.name.startswith("cudaGraphLaunch"))
    in_graph = len(kernels) - host_launches
    print(f"profiled frames {start}..{start + n_frames - 1} "
          f"({sys_.tracker.graph_replays - replays0} replays, "
          f"{sys_._kf_count - kf0} keyframe steps): host "
          f"{1e3 * dt / n_frames:.1f} ms/frame under the profiler, device "
          f"kernels {dev_ms / n_frames:.2f} ms/frame (busy share "
          f"{dev_ms / (1e3 * dt):.3f}), {len(kernels) / n_frames:.0f} "
          f"kernels/frame: {in_graph / n_frames:.0f} inside "
          f"{graph_launches} graph launches, {host_launches / n_frames:.0f} "
          f"launched from the host", flush=True)
    rows = sorted(prof.key_averages(),
                  key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:12]:
        print(f"  {e.self_device_time_total / 1e3 / n_frames:8.3f} ms/frame "
              f"device, {e.count / n_frames:7.1f} calls/frame  "
              f"{e.key[:90]}", flush=True)


def candidate_costs(width, height):
    """Device time and kernel count of the captured frame program and of its
    parts, each part captured as a graph of its own on the inputs the frame
    graph last ran on: the detector, the frontend, the three candidates of
    track_frame_step (the last two are what selecting the fallbacks on the
    device adds to every frame) and the local-map track. Time: CUDA events
    around one replay, median of 10; kernels: torch.profiler over 2
    replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dani_slam_tpu_torch.core import lie
    from dani_slam_tpu_torch.slam import frame as frame_mod
    from dani_slam_tpu_torch.slam import framegraph, tracking
    fg = next(g for g in framegraph._GRAPHS.values()
              if tuple(g.img.shape[:2]) == (height, width) and
              g.matcher is not None and g.st.caps.N == 1024)
    feat0, R0, t0, bind0 = (fg._out[i] for i in (0, 1, 2, 3))
    feat = type(feat0)(*(None if x is None else x.clone() for x in feat0))
    R_new, t_new, bind_new = R0.clone(), t0.clone(), bind0.clone()
    R_pred, t_pred = lie.se3_mul(fg.Rv, fg.tv, fg.R, fg.t)
    boxes, bmask, _ = fg.detector.dynamic_mask_inputs(fg.img)
    parts = {
        "detector (YOLO, NMS, boxes)":
            lambda: fg.detector.dynamic_mask_inputs(fg.img),
        "frontend (SuperPoint, select, sample)":
            lambda: frame_mod._frame_rgbd_program(
                fg.sp_model, fg.img, fg.depth, fg.cam, fg.time, 5000.0,
                0.012, boxes, bmask, n_max=1024),
        "candidate 1: motion model, radius 15":
            lambda: tracking.track_motion_model(
                fg.st, fg.cam, feat, fg.last_bind, R_pred, t_pred,
                radius=15.0, use_depth=True, rounds=2),
        "candidate 2: motion model, radius 30 (extra)":
            lambda: tracking.track_motion_model(
                fg.st, fg.cam, feat, fg.last_bind, R_pred, t_pred,
                radius=30.0, use_depth=True, rounds=2),
        "candidate 3: reference keyframe, LightGlue (extra)":
            lambda: tracking.track_reference_keyframe(
                fg.st, fg.cam, feat, fg.ref_kf, fg.R, fg.t, use_depth=True,
                matcher=fg.matcher),
        "local-map track":
            lambda: tracking.track_local_map(
                fg.st, fg.cam, feat, bind_new, R_new, t_new, use_depth=True),
    }
    graphs = {"whole frame program": fg.graph}
    for name, fn in parts.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            keep = fn()                              # noqa: F841
        graphs[name] = g
    out = {}
    for name, g in graphs.items():
        ms = time_ms(g.replay, reps=10, warmup=2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            g.replay()
            g.replay()
            _sync()
        ks = _kernel_events(prof)
        out[name] = (ms, len(ks) / 2,
                     sum(e.device_time_total for e in ks) / 2e3)
        print(f"  {ms:8.3f} ms a replay, {out[name][1]:7.0f} kernels, "
              f"{out[name][2]:8.3f} ms summed kernel time  {name}",
              flush=True)
    return out


def loop_pass(caps):
    """bench.py's loop_close_kf_latency workload on the card: the drifted
    16-keyframe loop map at `caps` through LoopCloser.on_keyframe (live
    vocabulary, min_kf_gap 6, fixed scale), a warm-up pass, a timed pass
    (CUDA-synchronised wall time per keyframe) and finish_gba; the gates of
    tests/test_loop_reloc.py (one loop, loop-end error below 0.3 of the
    drifted one, lower mean error)."""
    import numpy as np
    import torch
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.slam.loopclosing import LoopCloser
    from dani_slam_tpu_torch.utils import device as devmod
    from dani_slam_tpu_torch.utils.synthetic import make_drifted_loop_state
    cam = cameras.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480,
                                 device="cuda")
    t0 = time.perf_counter()
    st0, kf_ids, (R_gt, t_gt), _ = make_drifted_loop_state(cam, caps, K=16)
    _sync()
    print(f"drifted loop map: {len(kf_ids)} keyframes, "
          f"{int(st0.lm_mask.sum())} landmarks at caps {tuple(caps)}, built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    def errs(st):
        R, t = st.kf_R.cpu().numpy(), st.kf_t.cpu().numpy()
        return np.asarray([np.linalg.norm(
            -R[k].T @ t[k] - (-R_gt[i].T @ t_gt[i]))
            for i, k in enumerate(kf_ids)])

    def run():
        lc = LoopCloser(cam, caps, codebook="live", seed=0, min_kf_gap=6,
                        fix_scale=True)
        lc.train_codebook_after = 6
        st, ms = st0, []
        for count, k in enumerate(kf_ids, start=1):
            t1 = time.perf_counter()
            st = lc.on_keyframe(st, k, kf_count=count)
            _sync()
            ms.append(1e3 * (time.perf_counter() - t1))
        t1 = time.perf_counter()
        st = lc.finish_gba(st, kf_ids[-1])
        _sync()
        return lc, st, ms, 1e3 * (time.perf_counter() - t1)

    run()
    devmod.SYNCS.count = devmod.ASYNC.ready = devmod.ASYNC.waited = 0
    lc, st, ms, fin_ms = run()
    syncs, waited = devmod.SYNCS.count, devmod.ASYNC.waited
    before, after = errs(st0), errs(st)
    print(f"loop pass (timed, after a warm-up pass): n_loops {lc.n_loops}, "
          f"median {statistics.median(ms):.2f} ms/keyframe, max "
          f"{max(ms):.2f} ms (keyframe {int(np.argmax(ms)) + 1}), "
          f"finish_gba {fin_ms:.1f} ms, {lc.stats}, blocking syncs {syncs} "
          f"(of them asynchronous reads that had to wait: {waited}); "
          f"loop-end centre error {before[-1]:.4f} -> {after[-1]:.4f} m, "
          f"mean {before.mean():.4f} -> {after.mean():.4f} m", flush=True)
    print("  ms per keyframe: " + " ".join(f"{x:.1f}" for x in ms),
          flush=True)
    loop_stages(cam, st0, kf_ids, run)
    checks = {"n_loops == 1": lc.n_loops == 1,
              "loop end < 0.3 x drifted": after[-1] < 0.3 * before[-1],
              "mean error lower": after.mean() < before.mean(),
              "finite": bool(np.all(np.isfinite(after)))}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"loop-pass checks failed: {failed}")
    return dict(median_ms=statistics.median(ms), max_ms=max(ms),
                finish_ms=fin_ms, syncs=syncs)


def loop_stages(cam, st0, kf_ids, run):
    """Where the loop pass's time goes: one more pass with every stage of
    slam/loopclosing wrapped in torch.cuda.synchronize() and the host clock
    (ms summed per stage), then the device time and kernel count of one
    Sim3 verification, one pose-graph chunk and one GBA chunk under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dani_slam_tpu_torch.models import vocab
    from dani_slam_tpu_torch.ops import sim3
    from dani_slam_tpu_torch.slam import loopclosing as lcm
    stages = {lcm: ("verify_loop_candidate", "refine_loop_from_hypothesis",
                    "loop_pg_chunk", "loop_correction_apply",
                    "apply_loop_weld", "search_and_fuse", "gba_chunk",
                    "apply_gba"),
              vocab: ("train_codebook", "update_bow_row",
                      "detect_candidates"),
              sim3: ("sim3_ransac", "optimize_sim3")}
    spent, plain = {}, {}

    def timed(mod, name):
        fn = getattr(mod, name)
        plain[(mod, name)] = fn

        def wrapper(*a, **k):
            _sync()
            t1 = time.perf_counter()
            out = fn(*a, **k)
            _sync()
            ms = spent.setdefault(name, [0, 0.0])
            ms[0] += 1
            ms[1] += 1e3 * (time.perf_counter() - t1)
            return out
        setattr(mod, name, wrapper)

    for mod, names in stages.items():
        for name in names:
            timed(mod, name)
    try:
        run()
    finally:
        for (mod, name), fn in plain.items():
            setattr(mod, name, fn)
    print("  loop pass by stage (synchronised, ms in all / calls): " +
          ", ".join(f"{k} {v[1]:.1f}/{v[0]}" for k, v in
                    sorted(spent.items(), key=lambda kv: -kv[1][1])),
          flush=True)
    K = st0.caps.K
    dev = st0.kf_R.device
    eye = (torch.eye(3, device=dev), torch.zeros(3, device=dev),
           torch.ones((), device=dev))
    jobs = {
        "verify_loop_candidate": lambda: lcm.verify_loop_candidate(
            st0, cam, kf_ids[-1], kf_ids[0],
            torch.Generator(device=dev).manual_seed(0), fix_scale=True),
        "loop_pg_chunk (3 iterations)": lambda: lcm.loop_pg_chunk(
            st0, kf_ids[-1], kf_ids[0], eye,
            (st0.kf_R, st0.kf_t, torch.ones(K, device=dev)), iters=3,
            fix_scale=True),
        "gba_chunk (2 LM x 40 CG)": lambda: lcm.gba_chunk(
            st0, cam, (st0.kf_R, st0.kf_t, st0.lm_pos,
                       torch.full((), 1e-4, device=dev)), iters=2)}
    for name, fn in jobs.items():
        fn()
        _sync()
        t1 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            _sync()
        wall = 1e3 * (time.perf_counter() - t1)
        ks = _kernel_events(prof)
        print(f"  {name}: {sum(e.device_time_total for e in ks) / 1e3:.1f} "
              f"ms of kernels, {len(ks)} kernels, {wall:.1f} ms of host "
              f"time under the profiler", flush=True)


def reloc_pass(caps, seq, W, H, f):
    """Relocalization in the main path's configuration: the bench sequence
    (60 frames), then 6 blacked-out frames (image and depth zero), then the
    camera is back where the map began — the first frame's view held for 6
    frames, then the sequence replayed from its second frame (24 frames),
    timestamps running on at 30 fps. The tracker must
    lose track, relocalize at least once (the window-match kernel counted
    inside the relocalizations), end OK, and its trajectory must be within
    0.25 m ATE of the ground truth of the frames it shows. (Continuing the
    orbit after the blackout instead leaves the tracker lost: on this scene
    a lost frame's matches against a keyframe are 14-30 % inliers unless the
    views nearly coincide, too few for 256 six-point PnP hypotheses; the
    JAX package fails the same case, PERF.md PR 4.)"""
    import numpy as np
    import torch
    from dani_slam_tpu_torch.ops import kernels
    from dani_slam_tpu_torch.utils import eval as ev
    sys_ = make_system("cuda", caps, 1024, W, H, f, NEW)
    tr = sys_.tracker
    reloc = dict(calls=0, launches=0, ms=0.0)
    plain = tr.reloc_fn

    def counted(tracker, feat):
        a = kernels.window_match_topk2.launches
        _sync()
        t1 = time.perf_counter()
        out = plain(tracker, feat)
        _sync()
        reloc["ms"] += 1e3 * (time.perf_counter() - t1)
        reloc["calls"] += 1
        reloc["launches"] += kernels.window_match_topk2.launches - a
        return out

    tr.reloc_fn = counted
    imgs, deps, _ = frames_on("cuda", seq)
    b0, b1, hold, replay = len(imgs), len(imgs) + 6, 6, 24
    # (index of the frame shown, or None for a blank frame) per step
    shown = list(range(b0)) + [None] * (b1 - b0) + [0] * hold + \
        list(range(1, 1 + replay))
    blank_i, blank_d = torch.zeros_like(imgs[0]), torch.zeros_like(deps[0])
    kernels.reset_launch_counts()
    states, first = [], None
    for step, j in enumerate(shown):
        sys_.track_rgbd(blank_i if j is None else imgs[j],
                        blank_d if j is None else deps[j], step / 30.0)
        states.append(tr.state)
        if first is None and tr.relocalizations > 0:
            first = step
    sys_.shutdown()
    _sync()
    launches = kernels.launch_counts()
    traj = tr.trajectory
    steps = np.round(np.asarray([tm for tm, _, _ in traj]) * 30).astype(int)
    src = np.asarray([shown[k] for k in steps])
    C_est = centers(traj)
    C_gt = ev.centers_from_tcw(seq[0][src], seq[1][src])
    ate = ev.ate_rmse(C_est, C_gt)
    lost = any(s_ != "OK" for s_ in states[b0:])
    print(f"steps 0..{b0 - 1} the sequence, {b0}..{b1 - 1} blacked out, then "
          f"the first frame's view "
          f"for {hold} steps and frames 1..{replay}: tracker states "
          f"{''.join(s_[0] for s_ in states)} (O ok, R recently lost, L "
          f"lost), {tr.rollbacks} rollbacks, {reloc['calls']} "
          f"relocalization attempts ({reloc['ms']:.1f} ms in all), "
          f"{tr.relocalizations} succeeded, the first at step {first} "
          f"({None if first is None else first - b1} steps after the "
          f"blackout), window-match launches inside relocalization "
          f"{reloc['launches']} (all launches {launches}), {len(traj)} "
          f"tracked frames, ATE {ate:.4f} m, final state {tr.state}",
          flush=True)
    checks = {"lost after the blackout": lost or tr.rollbacks > 0,
              "relocalized": tr.relocalizations >= 1,
              "window match launched by relocalization":
              reloc["launches"] > 0,
              "OK at the last frame": tr.state == "OK",
              "ATE < 0.25 m": ate < 0.25,
              "poses finite": bool(np.all(np.isfinite(C_est)))}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"relocalization checks failed: {failed}")
    return reloc


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "dani_slam_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import numpy as np
    from dani_slam_tpu_torch.core import state as mstate
    from dani_slam_tpu_torch.ops import kernels
    from dani_slam_tpu_torch.utils import device as devmod

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    # the main path is host-bound (PERF.md section 5), so its FPS depends on
    # the host CPU as much as on the card: name it beside every reading
    # (a sandboxed kernel may report "model name: unknown", so the vendor,
    # family, model and clock of the first CPU are printed as well)
    host_cpu = platform.processor() or platform.machine()
    if os.path.exists("/proc/cpuinfo"):
        keys = ("vendor_id", "cpu family", "model", "model name", "cpu MHz")
        info = {}
        with open("/proc/cpuinfo") as fh:
            for ln in fh:
                if not ln.strip():
                    break
                k, _, v = ln.partition(":")
                if k.strip() in keys:
                    info[k.strip()] = v.strip()
        host_cpu = ", ".join(f"{k} {info[k]}" for k in keys if k in info)
    print(f"host: {host_cpu}, {os.cpu_count()} logical CPUs", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    phase("1. build kernels")
    build_s = kernels.build_kernels()
    print(f"built {sorted(kernels.SOURCES)} in {build_s:.1f} s", flush=True)
    for name in kernels.SOURCES:
        log = os.path.join(kernels.BUILD_DIR, f"{name}.log")
        if os.path.exists(log):
            with open(log) as fh:
                for line in fh:
                    if "registers" in line or "spill" in line:
                        print(f"  {name}: {line.strip()}")
    _sync()

    phase("2. kernels vs plain versions")
    err1, k1 = check_window_match(kernels, 4096, 1024, 256, 3000, 0, True)
    err1b, _ = check_window_match(kernels, 300, 700, 256, 300, 1, False)
    # relocalization's shape: one keyframe's 1024 landmarks against the
    # frame's 1024 keypoints, every row live, a scalar radius (10 px, 3 px)
    err1r, k1r = check_window_match(kernels, 1024, 1024, 256, 1024, 2, True,
                                    radius=10.0)
    err1r3, k1r3 = check_window_match(kernels, 1024, 1024, 256, 1024, 3,
                                      True, radius=3.0)
    err2, k2 = check_lba(kernels, 16, 1024, 2048, 0, True)
    err2b, _ = check_lba(kernels, 16, 1000, 1000, 1, False)
    _sync()
    floor_ms = time_ms(kernels.launch_floor)
    floor_dev = device_ms(kernels.launch_floor,
                          ("launch_floor_kernel",))["launch_floor_kernel"]
    print(f"launch floor (an empty kernel through the same kind of C call): "
          f"{floor_ms:.4f} ms a call, {floor_dev:.4f} ms on the device",
          flush=True)
    for name, k in (("window_match_topk2", k1),
                    ("window_match_topk2 (relocalization, 10 px)", k1r),
                    ("window_match_topk2 (relocalization, 3 px)", k1r3),
                    ("lba_landmark_blocks", k2)):
        k["launch_floor_ms"] = floor_ms
        print(f"{name}: kernel {k['ms']:.4f} ms a call, {k['device_ms']:.4f} "
              f"ms on the device, plain {k['plain_ms']:.4f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms "
              f"({k['bound_by']})", flush=True)

    phase("3. main path: 60-frame 640x480 detector-on RGB-D sequence, "
          "matcher='auto', pipelined=True, loop closing and relocalization "
          "on")
    from dani_slam_tpu_torch.models import lightglue
    caps = mstate.MapCaps()
    n_frames, W, H, f = 60, 640, 480, 500.0
    t0 = time.perf_counter()
    seq = make_sequence(n_frames, W, H, f, 0.35)
    print(f"rendered {n_frames} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _, n_ok_w, dt_w = run_system("cuda", caps, 1024, seq, W, H, f, NEW)
    print(f"warm-up pass (captures the frame graph): {n_ok_w}/{n_frames} "
          f"tracked in {dt_w:.2f} s", flush=True)
    kernels.reset_launch_counts()
    lightglue.FORWARDS.count = 0
    devmod.SYNCS.count = devmod.ASYNC.ready = devmod.ASYNC.waited = 0
    sys_, n_ok, dt = run_system("cuda", caps, 1024, seq, W, H, f, NEW)
    launches = kernels.launch_counts()
    lg_forwards = lightglue.FORWARDS.count
    syncs, ready, waited = (devmod.SYNCS.count, devmod.ASYNC.ready,
                            devmod.ASYNC.waited)
    tr = sys_.tracker
    lcs = dict(sys_.loop_closer.stats)
    n_kf, n_lm = sys_.n_keyframes(), sys_.n_landmarks()
    dyn = float(tr.dynamic_ratio)
    C_est, ate = trajectory_ate(sys_, seq)
    print(f"timed pass: tracked {n_ok}/{n_frames}, {n_kf} keyframes "
          f"({sys_._kf_count} keyframe steps), {n_lm} landmarks, last "
          f"dyn_ratio {dyn:.3f}, {n_frames / dt:.2f} FPS "
          f"({1e3 * dt / n_frames:.1f} ms/frame), {syncs / n_frames:.2f} "
          f"blocking host syncs/frame, {(ready + waited) / n_frames:.2f} "
          f"asynchronous reads/frame of which {waited} of {ready + waited} "
          f"had to wait, {tr.graph_replays} graph replays, "
          f"{tr.eager_frames} eager image frames, {tr.rollbacks} rollbacks, "
          f"ATE {ate:.4f} m, launches {launches}, LightGlue forwards "
          f"{lg_forwards}", flush=True)
    print(f"loop closer in the timed pass: {lcs['bow_updates']} BoW updates, "
          f"{lcs['detections']} detection dispatches, {lcs['verifications']} "
          f"Sim3 verifications, {lcs['refines']} hypothesis refines, "
          f"{sys_.loop_closer.n_loops} loops closed (0 expected: the "
          f"0.35 rad arc never returns to a mapped place), "
          f"{tr.relocalizations} relocalizations", flush=True)
    checks = {
        "tracked >= 51/60": n_ok >= 0.85 * n_frames,
        "keyframes >= 5": n_kf >= 5,
        "landmarks >= 1000": n_lm >= 1000,
        "detector fired": dyn > 0.0,
        "poses finite": bool(np.all(np.isfinite(C_est))) and
        C_est.shape == (len(tr.trajectory), 3),
        "ATE < 0.25 m": ate < 0.25,
        "graph replays >= 50": tr.graph_replays >= 50,
        "blocking syncs/frame < 2.33": syncs / n_frames < 2.33,
        "window_match_topk2 ran on every tracked frame":
        launches["window_match_topk2"] >= tr.graph_replays > 0,
        "lba_landmark_blocks launched": launches["lba_landmark_blocks"] > 0,
        "lba_plan launched": launches["lba_plan"] > 0,
        "LightGlue forwards > 0": lg_forwards > 0,
        "a BoW update per resolved keyframe": lcs["bow_updates"] >= n_kf,
        "loop detection dispatched": lcs["detections"] > 0,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"main-path checks failed: {failed}")

    # kernel 2's plan is built once per BA solve and serves that solve's
    # launches: the cost of a launch with its share of the plan
    per_solve = launches["lba_landmark_blocks"] / launches["lba_plan"]
    k2["launches_per_solve"] = per_solve
    k2["amortised_ms"] = (k2["plan_ms"] + per_solve * k2["ms"]) / per_solve
    print(f"lba_landmark_blocks: {launches['lba_plan']} plans for "
          f"{launches['lba_landmark_blocks']} launches ({per_solve:.2f} per "
          f"solve): (plan + n * kernel) / n = {k2['amortised_ms']:.4f} ms a "
          f"launch", flush=True)

    # a cut in the stream: the map goes into the Atlas, tracking restarts,
    # and every keyframe pull of the new map tries to merge it back
    imgs, deps, times = frames_on("cuda", seq)
    n_kf_old = n_kf
    states = [sys_.track_rgbd(imgs[i], deps[i], 100.0 + times[i])[0]
              for i in range(52, 60)]
    sys_.shutdown()
    _sync()
    stashed = [int(e["st"].kf_mask.sum()) for e in sys_.atlas.stored]
    print(f"timestamp jump of 100 s: {sys_.merges} merges of the new map "
          f"into the stored one ({'merged back' if sys_.merges else 'not merged'}"
          f"), atlas holds {sys_.atlas.n_maps()} maps of {stashed} keyframes; "
          f"active map: states {states}, {sys_.n_keyframes()} keyframes "
          f"({n_kf_old} before the jump), {sys_.n_landmarks()} landmarks, "
          f"final state {sys_.tracker.state}", flush=True)
    stash_ok = sys_.atlas.n_maps() == 1 or \
        (sys_.merges >= 1 and sys_.atlas.n_maps() == 0)
    if not stash_ok or states.count("OK") < 7 or sys_.n_landmarks() < 200:
        raise SystemExit("timestamp jump: no stashed or merged map, or the "
                         "new map does not track")

    phase("4. loop pass: bench.py's loop_close_kf_latency on the drifted "
          "16-keyframe loop map at MapCaps()")
    lp = loop_pass(caps)

    phase("5. relocalization: the main path, six blacked-out frames, then "
          "back at the map's start")
    rl = reloc_pass(caps, seq, W, H, f)

    phase("6. earlier path, 12 frames: matcher=None, pipelined=False")
    n_old = 12
    kernels_before = kernels.launch_counts()
    devmod.SYNCS.count = 0
    so, n_ok_o, dt_o = run_system("cuda", caps, 1024, seq, W, H, f, OLD,
                                  n_frames=n_old)
    old_launches = {k: v - kernels_before[k]
                    for k, v in kernels.launch_counts().items()}
    _, ate_o = trajectory_ate(so, seq)
    print(f"tracked {n_ok_o}/{n_old}, {so.n_keyframes()} keyframes, "
          f"{so.n_landmarks()} landmarks, {n_old / dt_o:.2f} FPS "
          f"({1e3 * dt_o / n_old:.1f} ms/frame, no warm-up pass), "
          f"{devmod.SYNCS.count / n_old:.2f} blocking host syncs/frame, "
          f"ATE {ate_o:.4f} m, launches {old_launches}", flush=True)
    if n_ok_o < n_old - 2 or so.n_keyframes() < 2 or \
            so.n_landmarks() < 500 or \
            ate_o >= 0.25 or min(old_launches.values()) <= 0 or \
            old_launches["window_match_topk2"] != n_old - 1:
        raise SystemExit("earlier-path checks failed")

    phase("7. held against each other")
    small = make_sequence(4, 320, 240, 300.0, 0.35 * 4 / 60)
    caps_s = mstate.MapCaps(K=32, L=4096, N=256, D=256)
    sc, n_c, _ = run_system("cpu", caps_s, 256, small, 320, 240, 300.0, OLD)
    sg, n_g, _ = run_system("cuda", caps_s, 256, small, 320, 240, 300.0, OLD)
    dC = np.abs(centers(sc.tracker.trajectory) -
                centers(sg.tracker.trajectory)).max()
    print(f"small input: cpu {n_c}/4 tracked, {sc.n_keyframes()} kf, "
          f"{sc.n_landmarks()} lm; card {n_g}/4, {sg.n_keyframes()} kf, "
          f"{sg.n_landmarks()} lm; max camera-centre difference {dC:.2e} m "
          f"(limit 5e-2)", flush=True)
    if n_c != 4 or n_g != 4 or dC > 5e-2:
        raise SystemExit("card and CPU disagree on the small input")
    check_lightglue(W, H)
    check_pipelined_vs_plain_features()
    n_img = 30
    sp, _, _ = run_system("cuda", caps, 1024, seq, W, H, f,
                          dict(matcher="auto", pipelined=False),
                          n_frames=n_img)
    C_plain, ate_plain = trajectory_ate(sp, seq)
    m = min(len(C_plain), len(C_est))
    d_img = float(np.linalg.norm(C_plain[:m] - C_est[:m], axis=1).max())
    print(f"pipelined vs non-pipelined on the first {n_img} image frames "
          f"(matcher='auto' both): {sp.n_keyframes()} keyframes "
          f"non-pipelined, centres within {d_img:.4f} m (limit 0.15: "
          f"keyframes land on other frames, and either run is "
          f"{ate_plain:.3f} / {ate:.3f} m from the truth)", flush=True)
    if m < 0.85 * n_img or d_img >= 0.15:
        raise SystemExit("pipelined and non-pipelined image runs differ")
    n_cmp = 8
    sa, _, dt_g = run_system("cuda", caps, 1024, seq, W, H, f, NEW,
                             n_frames=n_cmp, frame_graph=True)
    sb, _, dt_e = run_system("cuda", caps, 1024, seq, W, H, f, NEW,
                             n_frames=n_cmp, frame_graph=False)
    Ta, Tb = sa.tracker.trajectory, sb.tracker.trajectory
    d_pose = max(float(np.abs(a[1] - b[1]).max()) +
                 float(np.abs(a[2] - b[2]).max()) for a, b in zip(Ta, Tb))
    same_bind = bool(torch.equal(sa.tracker.last_bind, sb.tracker.last_bind))
    print(f"graph replay vs eager fused function, {n_cmp} frames: "
          f"{sa.tracker.graph_replays} replays against "
          f"{sb.tracker.eager_frames} eager frames, poses within "
          f"{d_pose:.2e} (limit 1e-5), last bindings equal: {same_bind}, "
          f"{1e3 * dt_g / n_cmp:.0f} against {1e3 * dt_e / n_cmp:.0f} "
          f"ms/frame", flush=True)
    if len(Ta) != len(Tb) or d_pose > 1e-5 or not same_bind or \
            sa.tracker.graph_replays != n_cmp - 2 or \
            sb.tracker.graph_replays != 0:
        raise SystemExit("graph replay and eager fused function differ")
    _sync()

    phase("8. where the time goes: torch.profiler over frames 20..25 of the "
          "main path; the frame program and its parts")
    profile_main_path(caps, seq, 20, 6, W, H, f)
    candidate_costs(W, H)

    kernels_out = [
        dict(name="window_match_topk2", route="cuda",
             source="dani_slam_tpu_torch/csrc/window_match.cu",
             replaces="dani_slam_tpu/ops/pallas_kernels.py:168",
             launches=launches["window_match_topk2"], max_abs_err=err1,
             shape="tracking: M 4096 x N 1024 x D 256, per-query radii",
             **k1),
        dict(name="window_match_topk2", route="cuda",
             source="dani_slam_tpu_torch/csrc/window_match.cu",
             replaces="dani_slam_tpu/ops/pallas_kernels.py:168",
             launches=rl["launches"], max_abs_err=max(err1r, err1r3),
             shape="relocalization: M 1024 x N 1024 x D 256, radius 10 px "
             "(3 px: ms %.4f, device_ms %.4f)" % (k1r3["ms"],
                                                  k1r3["device_ms"]),
             **k1r),
        dict(name="lba_landmark_blocks", route="cuda",
             source="dani_slam_tpu_torch/csrc/lba_blocks.cu",
             replaces="dani_slam_tpu/ops/pallas_kernels.py:265",
             launches=launches["lba_landmark_blocks"], max_abs_err=err2,
             **k2),
    ]
    print(f"loop pass: median {lp['median_ms']:.2f} ms/keyframe, max "
          f"{lp['max_ms']:.2f} ms; relocalization: {rl['calls']} attempts, "
          f"{rl['launches']} window-match launches", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
