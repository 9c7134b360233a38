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
     on the device always computes;
  9. the monocular entry point, examples/mono_tum.py's configuration
     (System(MONOCULAR, pipelined=True, n_levels=8, scale_factor=1.2),
     LightGlue, loop closing and relocalization on, MapCaps()) on the
     bench's 60 images: a warm-up pass (capturing the track step's graphs,
     recording kernel 2's arguments, and counting the synchronizing calls
     torch's sync debug mode flags), a pass over the first 12 frames with
     the track step eager (recording kernel 1's tracking calls, which the
     graphed passes run inside the graph; the held one has the most live
     query rows, at least MIN_HELD_LIVE), then a timed pass on a fresh
     System with every counter set to 0 just before it and read just
     after: init frame, tracked frames, keyframes,
     landmarks, Sim3-aligned ATE, FPS, syncs and asynchronous reads per
     frame, launches, the keyframes' octave histogram; checked against the
     JAX package's numbers on the CPU (JAX_TARGETS, margins in PERF.md);
     both kernels held against their plain versions and timed again on the
     path's own recorded arguments (kernel 1 at octave-scaled radii);
 10. the stereo entry point, examples/stereo_kitti.py's configuration
     (System(STEREO, pipelined=True)) on a rectified pair of the same world
     (0.12 m baseline), as phase 9 with metric ATE and at least one
     LightGlue stereo forward per frame;
 11. the new functions on the card against the CPU on small inputs:
     two_view_init with injected draws (and the synchronizing calls of one
     call), stereo_match_depth and its LightGlue variant, stereo_fisheye_
     depth, the rectifier's grids and remap of one pair, extract_multiscale;
 12. bench.py's official pass: the main path's configuration with the
     reference-scale nets (models/yolo_official's yolov5s as the detector,
     models/lightglue_official's LightGlue 256x9 as the matcher, the shipped
     official weights): a warm-up pass (capturing their frame graph and
     recording both kernels' arguments outside the capture), three timed
     passes on fresh Systems, counters set to 0 before each and read after;
     bench.py's checks (>= 51/60, >= 5 keyframes, >= 1000 landmarks,
     detector fired) on the last, >= 50 graph replays, both kernels and the
     official LightGlue counted, finite poses, the ATE; both kernels held
     against their plain versions and timed on the recorded calls; the
     official nets on the card against the CPU and their eager times
     (match_pairs at 1 x 1024^2 and 5 x 512^2, yolov5s at 384x512);
 13. the RGB-D runner as a user runs it: 30 frames of the bench sequence
     written as a TUM directory (PPM colour, 16-bit PGM depth, assoc.txt,
     settings.yaml), `python -m dani_slam_tpu_torch.examples.rgbd_tum ...
     --detector` in a subprocess on the default device (cuda): a trajectory
     row per pose, at the sequence's timestamps, the log naming cuda; then
     save_atlas / load_atlas on the card and a frame tracked against the
     loaded map;
 14. the IMU_RGBD sensor: the bench's 640x480 detector-on RGB-D images
     played at 10 Hz along its orbit, 400 Hz IMU windows made from the
     analytic orbit (numpy; 40 samples a frame), System(IMU_RGBD,
     detector=<compact YOLO>, matcher="auto", pipelined=True) with loop
     closing and relocalization on at MapCaps(): a warm-up pass over all
     60 frames as the timed pass runs them (capturing the graphs, recording
     kernel 2's arguments on a local BA before the IMU initialization,
     counting the synchronizing calls torch's sync debug mode flags in
     every frame), a pass over the first 20 frames with the track step
     eager (through the IMU initialization; recording kernel 1's tracking
     calls after it, held as in phase 9), then a timed pass over all 60
     frames on a fresh System (every feature-path track step a graph
     replay) with every counter set to 0 just before it and read just after:
     IMU init frame, tracked frames, keyframes, landmarks, rigid ATE (the
     initialization rotates the world to gravity), |bias_g|, |bias_a|, the
     stages reached (init, VIBA1, VIBA2), local and full inertial BA calls,
     launches, FPS, syncs; held to bench.py's counts and the JAX package's
     numbers (INERTIAL_TARGETS), both kernels held against their plain
     versions on the recorded calls;
 15. the IMU_STEREO sensor, examples/stereo_inertial_euroc.py's
     System(IMU_STEREO, pipelined=True) on phase 10's rectified pair at
     10 Hz with the same IMU windows, as phase 14.

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

ROOT = os.path.dirname(os.path.abspath(__file__))
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


def device_ms(fn, names, reps: int = 20, per_session: int = 5):
    """Device milliseconds per call of fn() spent in the kernels whose name
    contains each of `names` (each launched once a call): torch.profiler
    over short sessions of `per_session` calls after warm-up (late in a
    long run one long session kept only a third to a half of its records),
    the mean over the launches recorded, until each name has `reps` of
    them or `reps` * 10 calls were made. Returns (ms by name, launches
    recorded by name); fails when a name has fewer than `reps` // 2, so a
    host-side number can never stand in for a device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    _sync()
    total = {n: 0.0 for n in names}
    count = {n: 0 for n in names}
    # a session late in a long run may keep few of its records: up to ten
    # times the calls are made before giving up
    for _session in range(10 * reps // per_session):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(per_session):
                fn()
            _sync()
        for e in prof.events():
            if e.device_type.name != "CUDA":
                continue
            for n in names:
                if n in e.name:
                    total[n] += e.device_time_total
                    count[n] += 1
        if all(count[n] >= reps for n in names):
            break
    if all(count[n] >= reps // 2 and total[n] > 0 for n in names):
        return {n: total[n] / 1e3 / count[n] for n in names}, count
    raise SystemExit(f"profiler recorded too few device times: {count} "
                     f"launches of {10 * reps} calls")


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


def check_window_match(kernels, M=0, N=0, D=0, n_live=0, seed=0,
                       timed=False, radius=None, args=None, label=None):
    """Kernel 1 against its plain version (and timed) on match_inputs'
    planted problem, or on `args` captured from a pass of the port."""
    import torch
    dev = torch.device("cuda")
    if args is None:
        args = match_inputs(M, N, D, n_live, seed, dev, radius)
        live_rows = min(M, -(-n_live // 32) * 32)
    else:
        (M, D), N = args[0].shape, args[3].shape[0]
        n_live = int(args[2].sum())
        radius = None if isinstance(args[6], torch.Tensor) else args[6]
        # 32-row groups holding a live row: the granularity at which dead
        # rows can be skipped
        live_rows = 32 * int(torch.nn.functional.pad(
            args[2], (0, -M % 32)).reshape(-1, 32).any(1).sum())
    out_k = kernels.window_match_topk2(*args)
    again = kernels.window_match_topk2(*args)
    ref_dist = kernels.window_match_dist_ref(*args)
    out_r = kernels.window_match_reduce_ref(ref_dist)
    _sync()
    res = kernels.window_match_agreement(out_k, out_r, ref_dist, atol=1e-4)
    same = all(torch.equal(a, b) for a, b in zip(out_k, again))
    ok = res["ok"] and same
    rtxt = "per-query radii" if radius is None else f"radius {radius} px"
    if label:
        rtxt += f", {label}"
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
    dev, rec = device_ms(lambda: kernels.window_match_topk2(*args),
                         ("wm_prep_kernel", "wm_match_kernel"))
    print(f"window_match_topk2 device time per call: target rounding "
          f"{dev['wm_prep_kernel']:.4f} ms + match "
          f"{dev['wm_match_kernel']:.4f} ms (mean of {rec} launches the "
          f"profiler recorded)", flush=True)
    # bytes the function must move on this run's data: descriptors of the
    # live query rows only (in groups of 32 rows, a granularity at which
    # dead rows can be skipped and the one this bound has used since the
    # first version), every query's xy/valid/radius, all targets, and the
    # outputs (best/second/idx per row, best/row per column); the scratch
    # bf16 copy of the targets is the kernel's own business, not counted
    r_bytes = 4 if radius is None else 0           # a scalar radius is free
    nbytes = live_rows * D * 4 + M * (2 * 4 + 1 + r_bytes) + \
        N * (D * 4 + 2 * 4 + 1) + M * 12 + N * 8
    flops = 2.0 * n_live * N * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return res["max_abs_err"], dict(
        ms=ms, device_ms=sum(dev.values()),
        device_launches_recorded=min(rec.values()), plain_ms=plain_ms,
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


def check_lba(kernels, P=0, N=0, L=0, seed=0, timed=False, args=None):
    """Kernel 2 and its plan against their plain versions (and timed) on
    lba_inputs' random problem, or on (row_lm, vals, L) captured from a
    pass of the port."""
    import torch
    dev = torch.device("cuda")
    if args is None:
        row_lm, vals = lba_inputs(P, N, L, seed, dev)
    else:
        row_lm, vals, L = args[:3]
        P, N = row_lm.shape
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
    rel_err = None
    if args is None:
        rule = "rtol/atol 1e-5"
        ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
                 for a, b in zip(out_k, out_r))
    else:
        # a bundle adjustment's own sums cancel (signed Jacobian products
        # of 1e4-1e6): each output is held against the float64 sum, within
        # 1e-6 of the sum of its terms' magnitudes, f32 summation in any
        # order staying far inside (eps 6e-8 times a few dozen terms)
        rule = "within 1e-6 of the terms' absolute sum of the f64 sum"
        ref64 = kernels.lba_landmark_blocks_ref(row_lm, vals.double(), L)
        mag = kernels.lba_landmark_blocks_ref(row_lm, vals.double().abs(), L)
        errs = [float(torch.max(torch.abs(o.double() - r) /
                                (m + 1e-30)).item())
                for o, r, m in zip(out_k, ref64, mag)]
        errs_plain = [float(torch.max(torch.abs(o.double() - r) /
                                      (m + 1e-30)).item())
                      for o, r, m in zip(out_r, ref64, mag)]
        ok = max(errs) < 1e-6
        rel_err = max(errs)
        rule += (f": kernel {max(errs):.2e}, plain version "
                 f"{max(errs_plain):.2e}, largest term sum "
                 f"{max(float(m.max()) for m in mag):.3g}")
    ok = ok and same
    print(f"lba_plan P={P} N={N} L={L}: device plan equals the plain "
          f"version's sort exactly: {plan_ok}", flush=True)
    if not plan_ok:
        raise SystemExit("lba_plan disagrees with its plain version")
    print(f"lba_landmark_blocks P={P} N={N} L={L}: max |err| {err:.3g} "
          f"({rule}), two launches bitwise equal: {same} "
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
    dev, rec = device_ms(lambda: kernels.lba_landmark_blocks(
        row_lm, vals, L, plan), ("lba_blocks_kernel",))
    dev_p, rec_p = device_ms(lambda: kernels.lba_plan(row_lm, L),
                             ("lba_plan_kernel",))
    dev.update(dev_p)
    rec.update(rec_p)
    print(f"lba_plan (once per BA solve, not in the kernel's time): "
          f"{plan_ms:.4f} ms a call, {dev['lba_plan_kernel']:.4f} ms on the "
          f"device; its plain version (argsort + searchsorted) "
          f"{plan_plain_ms:.4f} ms; device times the mean of {rec} "
          f"launches the profiler recorded", flush=True)
    # bytes the function must move on this run's data: every id, the 30
    # channels of the valid observations only (no kernel needs the rest),
    # and the outputs H_ll/g_l [L,12] and H_pl [P,L,18]
    n_obs = int(valid.sum())
    nbytes = row_lm.numel() * 4 + n_obs * 30 * 4 + L * 12 * 4 + \
        P * L * 18 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_obs * 30 / F32_FLOPS * 1e3
    return err, dict(ms=ms, device_ms=dev["lba_blocks_kernel"],
                     device_launches_recorded=rec["lba_blocks_kernel"],
                     plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     plan_ms=plan_ms, plan_device_ms=dev["lba_plan_kernel"],
                     plan_plain_ms=plan_plain_ms,
                     **({} if rel_err is None else
                        {"err_of_term_sum": rel_err}))


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
    threshold; `detector` True for the shipped compact one, False for
    none, or a models.yolo.Detector."""
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.models import yolo
    from dani_slam_tpu_torch.slam.system import Sensor, System
    cam = cameras.Camera.pinhole(f, f, width / 2, height / 2, width, height,
                                 device=device)
    if detector is True:
        detector = yolo.load_default_detector(device)
    sys_ = System(cam, Sensor.RGBD, caps=caps, n_features=n_feat,
                  detector=detector or None, device=device, **mode)
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
               n_frames=None, frame_graph=None, detector=True,
               sync_debug=False):
    """One pass through a fresh System; returns (system, n_ok, seconds).
    sync_debug: torch's sync debug mode warns at every synchronizing call
    of the frames (not of the set-up)."""
    import torch
    sys_ = make_system(device, caps, n_feat, width, height, f, mode,
                       detector=detector)
    if frame_graph is not None:
        sys_.tracker.frame_graph = frame_graph
    imgs, deps, times = frames_on(device, seq)
    if device == "cuda":
        _sync()
    if sync_debug:
        torch.cuda.set_sync_debug_mode("warn")
    t0 = time.perf_counter()
    n_ok = 0
    try:
        for i in range(n_frames or len(imgs)):
            state, _, _ = sys_.track_rgbd(imgs[i], deps[i], times[i])
            n_ok += state == "OK"
        sys_.shutdown()
        if device == "cuda":
            _sync()
    finally:
        if sync_debug:
            torch.cuda.set_sync_debug_mode("default")
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


def check_lightglue(width, height, load=None, name="LightGlue",
                    prob_tol=0.03, row_tol=20):
    """A LightGlue (the shipped compact one unless `load(device)` gives
    another MatcherState) on the card against the CPU on one pair of 1024
    keypoints, and its time per forward at the two call shapes of the main
    path. The bf16 layers of the two devices round differently (as the two
    libraries do in tests/test_torch_lightglue.py): probabilities within
    prob_tol, match sets differing on at most row_tol of the 1024 rows."""
    import numpy as np
    import torch
    from dani_slam_tpu_torch.models import lightglue as lg
    if load is None:
        def load(dev):
            return lg.load_default_matcher(width, height, device=dev)
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
        ms = load(dev)
        outs[dev] = [x.cpu().numpy() for x in lg.match_pairs(
            ms.model, *(torch.as_tensor(x, device=dev) for x in a), width,
            height)]
    (ic, bc, okc), (ig, bg, okg) = outs["cpu"], outs["cuda"]
    d_best = float(np.abs(bc - bg).max())
    differ = int(((okc != okg) | (okc & okg & (ic != ig))).sum())
    print(f"{name} card vs CPU, 1 x 1024 x 1024 keypoints: accepted "
          f"{int(okg.sum())} / {int(okc.sum())}, best probability differs "
          f"by at most {d_best:.4f} (limit {prob_tol}), {differ} of 1024 "
          f"rows differ in match (limit {row_tol})", flush=True)
    if not (d_best < prob_tol and differ <= row_tol and okg.sum() > 100):
        raise SystemExit(f"{name} on the card disagrees with the CPU")
    ms = load("cuda")
    times = {}
    for shape, (b, n) in (("1x1024", (1, 1024)), ("5x512", (5, 512))):
        args = [torch.as_tensor(x, device="cuda") for x in pair(b, n)]
        times[shape] = time_ms(lambda: lg.match_pairs(ms.model, *args,
                                                      width, height),
                               reps=10)
    print(f"{name} forward (match_pairs, eager, CUDA events, median of "
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


# ---------------------------------------------------------------------------
# Phases 9-10: the monocular and stereo entry points
# ---------------------------------------------------------------------------

# The JAX package's run of the same configurations on the same sequences on
# the CPU (`python tests/test_torch_mono_stereo_system.py jax mono-full` and
# `... stereo-full`), the parity targets, with the margins of PERF.md
# section 6: init frame within 2 frames, tracked >= 51 and no more than 3
# below, keyframes within a factor of 2, landmarks within 40 %; ATE (mono
# Sim3-aligned, stereo rigid and metric) at most 0.10 m above the largest
# ATE of the JAX package on its own frames and on those frames with every
# keypoint moved by N(0, 1e-3) px (`... spread mono-full <seeds>`: seeds
# 0-5 and 9-17; stereo-full 0-5): on such rounding-sized changes the JAX package's
# monocular run ends anywhere from 0.050 to 0.488 m from the truth and the
# port's on the same frames from 0.156 to 0.489 m (15 seeds, no systematic
# difference), so one run is held to the range, not to one sample.
JAX_TARGETS = {"mono": dict(init=4, tracked=56, kf=12, lm=733, ate=0.1054,
                            ate_spread=(0.0498, 0.4879)),
               "stereo": dict(init=0, tracked=60, kf=19, lm=2216,
                              ate=0.1346, ate_spread=(0.0999, 0.1617))}
STEREO_BASELINE = 0.12
# the least number of live query rows of the tracking call of kernel 1 that
# a pass holds against its plain version (a tracked frame with the map in
# view: 430 / 508 in the mono / stereo recording passes on an H100, 631 /
# 1958 at the end of a full pass)
MIN_HELD_LIVE = 300


def sync_sites(caught):
    """Counter of (file, line) of the warnings torch's sync debug mode
    raised: each marks a call that made the host wait for the card."""
    import collections
    return collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def counted_sync_sites() -> dict:
    """The lines of the port whose host waits utils/device.SYNCS counts, as
    sync_sites names them: `pull`'s copy, an `AsyncRead` that has to wait,
    a constant staged on the card, and the SVDs of ops/linalg."""
    import inspect
    from dani_slam_tpu_torch.ops import linalg
    from dani_slam_tpu_torch.utils import device as devmod

    def line(fn, text):
        src, first = inspect.getsourcelines(fn)
        hits = [first + i for i, s in enumerate(src) if text in s]
        assert len(hits) == 1, (fn, text, hits)
        return f"{os.path.relpath(inspect.getsourcefile(fn), ROOT)}:{hits[0]}"
    return {"pull": line(devmod.pull, ".cpu()"),
            "async": line(devmod.AsyncRead.get, ".synchronize()"),
            "const": line(devmod._const.__wrapped__, "torch.tensor("),
            "svd": line(linalg.svd, "torch.linalg.svd("),
            "eigh": line(linalg.eigh, "torch.linalg.eigh("),
            "svdvals": line(linalg.svdvals, "torch.linalg.svdvals(")}


def uncounted_waits(sites, syncs, svds, waited) -> dict:
    """Checks the flagged host waits of a run against the counted ones:
    every flag inside the port at a counted line (`hidden` lists the
    others), and the flags at those lines exactly the counted waits, an SVD
    flagged twice, a symmetric eigendecomposition once (`flagged`,
    `expected`; an AsyncRead that waits may or may not be flagged)."""
    counted = counted_sync_sites()
    lines = set(counted.values())
    hidden = {k: v for k, v in sites.items()
              if k.startswith("dani_slam_tpu_torch/") and k not in lines}
    flagged = sum(sites[v] for k, v in counted.items() if k != "async")
    expected = syncs - waited + svds
    async_ok = sites[counted["async"]] <= waited
    return dict(hidden=hidden, flagged=flagged, expected=expected,
                ok=not hidden and flagged == expected and async_ok)


class ArgRecorder:
    """Keeps clones of the arguments of the last `history` calls of a
    kernel wrapper that `keep` accepts while installed on the kernels
    module, the attribute its callers look up (`args`: the last one;
    `best(score)`: the one scoring highest). Every call passes through
    unchanged; the launches made meanwhile are counted on the recorder (the
    wrapper's counter is not touched), so it is installed only around a
    warm-up pass."""

    def __init__(self, kernels, name, keep=lambda args: True, history=1):
        import collections
        self.kernels, self.name, self.keep = kernels, name, keep
        self.calls = collections.deque(maxlen=history)

    @property
    def args(self):
        return self.calls[-1] if self.calls else None

    def best(self, score):
        return max(self.calls, key=score) if self.calls else None

    def held(self, least):
        """The call with the most live query rows (kernel 1's argument 2),
        which must have at least `least`."""
        args = self.best(lambda a: int(a[2].sum()))
        live = 0 if args is None else int(args[2].sum())
        if live < least:
            raise SystemExit(f"{self.name}: the recorded calls have at most "
                             f"{live} live query rows, fewer than {least}")
        return args

    def __enter__(self):
        import functools
        import torch
        self.orig = orig = getattr(self.kernels, self.name)

        @functools.wraps(orig)
        def record(*a):
            # a call inside a graph capture holds the graph's buffers, not
            # a frame's values
            if not torch.cuda.is_current_stream_capturing() and self.keep(a):
                self.calls.append(tuple(x.clone() if isinstance(
                    x, torch.Tensor) else x for x in a))
            return orig(*a)
        setattr(self.kernels, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.kernels, self.name, self.orig)


def sensor_sequence(kind, n_frames, width, height, f):
    """(R_gt, t_gt, left images, right images or None, times): the bench's
    orbit; mono its images, stereo a rectified pair of the same world
    without the moving board."""
    from dani_slam_tpu_torch.utils import synthetic
    R_gt, t_gt = synthetic.orbit_trajectory(n_frames, radius=10.0,
                                            angle_span=0.35)
    params = [f, f, width / 2, height / 2]
    if kind == "mono":
        imgs, _, times = synthetic.make_rgbd_image_sequence(
            params, width, height, R_gt, t_gt, seed=0)
        return R_gt, t_gt, imgs, None, times
    left, right, times = synthetic.make_stereo_image_sequence(
        params, width, height, R_gt, t_gt, baseline=STEREO_BASELINE, seed=0)
    return R_gt, t_gt, left, right, times


def run_sensor(kind, caps, seq, width, height, f, sync_debug=False,
               n_frames=None, frame_graph=True):
    """One pass of examples/mono_tum.py's System(MONOCULAR, pipelined=True,
    n_levels=8, scale_factor=1.2) or examples/stereo_kitti.py's
    System(STEREO, pipelined=True) on a fresh System (loop closing and
    relocalization on, LightGlue, 1024 features) over the first n_frames
    frames (all when None). sync_debug: torch's sync debug mode warns at
    every synchronizing call of the frames (not of the set-up);
    frame_graph=False runs the track step eagerly (its kernel calls then
    pass through the wrappers, where they can be recorded). Returns
    (system, per-frame states, seconds)."""
    import torch
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.slam.system import Sensor, System
    cam = cameras.Camera.pinhole(f, f, width / 2, height / 2, width, height,
                                 device="cuda")
    extra = dict(n_levels=8, scale_factor=1.2) if kind == "mono" else {}
    sys_ = System(cam, Sensor.MONOCULAR if kind == "mono" else Sensor.STEREO,
                  caps=caps, n_features=1024, pipelined=True, device="cuda",
                  **extra)
    sys_.tracker.frame_graph = frame_graph
    _, _, left, right, times = seq
    left = [torch.as_tensor(x, device="cuda") for x in left[:n_frames]]
    right = None if right is None else [torch.as_tensor(x, device="cuda")
                                        for x in right[:n_frames]]
    _sync()
    if sync_debug:
        torch.cuda.set_sync_debug_mode("warn")
    t0 = time.perf_counter()
    try:
        states = []
        for i in range(len(left)):
            if right is None:
                out = sys_.track_monocular(left[i], times[i])
            else:
                out = sys_.track_stereo(left[i], right[i], times[i],
                                        STEREO_BASELINE)
            states.append(out[0])
        sys_.shutdown()
        _sync()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sys_, states, time.perf_counter() - t0


def sensor_pass(kind, caps, kernels, n_record=12):
    """A warm-up pass (which captures the track step's graphs, records
    kernel 2's arguments and counts the synchronizing calls torch's sync
    debug mode flags), a pass over the first n_record frames with the track
    step eager (which records kernel 1's tracking calls: in the graphed
    passes they run inside the graph) and a timed pass, on fresh Systems,
    counters set to 0 just before the timed pass and read just after;
    checks against the JAX package's numbers."""
    import warnings
    import numpy as np
    import torch
    from dani_slam_tpu_torch.models import lightglue
    from dani_slam_tpu_torch.utils import device as devmod
    from dani_slam_tpu_torch.utils import eval as ev
    W, H, f, n = 640, 480, 500.0, 60
    seq = sensor_sequence(kind, n, W, H, f)
    devmod.SYNCS.count = devmod.SYNCS.svd = devmod.ASYNC.waited = 0
    # kernel 2's last call
    with ArgRecorder(kernels, "lba_landmark_blocks") as lb, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, states_w, dt_w = run_sensor(kind, caps, seq, W, H, f,
                                       sync_debug=True)
    sites = sync_sites(caught)
    waits = uncounted_waits(sites, devmod.SYNCS.count, devmod.SYNCS.svd,
                            devmod.ASYNC.waited)
    print(f"warm-up pass: {states_w.count('OK')}/{n} tracked in {dt_w:.2f} s; "
          f"synchronizing calls of its frames flagged by torch's sync debug "
          f"mode: {sum(sites.values())}, blocking reads counted (pull, "
          f"AsyncRead waits, staged constants, SVDs): {devmod.SYNCS.count} "
          f"({devmod.SYNCS.svd} SVDs, {devmod.ASYNC.waited} AsyncRead "
          f"waits); flags at the counted lines {waits['flagged']}, expected "
          f"{waits['expected']} (an SVD flagged twice); by call site: "
          f"{sites.most_common(12)}", flush=True)
    # kernel 1's tracking calls (per-query radii; a relocalization passes a
    # scalar); the held one is that with the most live query rows
    with ArgRecorder(kernels, "window_match_topk2", history=n_record,
                     keep=lambda a: isinstance(a[6], torch.Tensor)) as wm:
        _, states_r, dt_r = run_sensor(kind, caps, seq, W, H, f,
                                       n_frames=n_record, frame_graph=False)
    wm_args = wm.held(MIN_HELD_LIVE)
    print(f"recording pass (track step eager): {states_r.count('OK')}/"
          f"{n_record} tracked in {dt_r:.2f} s, {len(wm.calls)} tracking "
          f"calls of window_match_topk2 recorded, the held one with "
          f"{int(wm_args[2].sum())} live query rows", flush=True)
    kernels.reset_launch_counts()
    lightglue.FORWARDS.count = 0
    devmod.SYNCS.count = devmod.ASYNC.ready = devmod.ASYNC.waited = 0
    sys_, states, dt = run_sensor(kind, caps, seq, W, H, f)
    launches = kernels.launch_counts()
    lg_forwards = lightglue.FORWARDS.count
    syncs, ready, waited = (devmod.SYNCS.count, devmod.ASYNC.ready,
                            devmod.ASYNC.waited)
    tr = sys_.tracker
    st = sys_.map_state
    n_kf, n_lm = sys_.n_keyframes(), sys_.n_landmarks()
    traj = tr.trajectory
    C = centers(traj)
    idx = np.round(np.asarray([tm for tm, _, _ in traj]) * 30).astype(int)
    ate = ev.ate_rmse(C, ev.centers_from_tcw(seq[0][idx], seq[1][idx]),
                      with_scale=kind == "mono")
    kp = (st.kf_kp_mask & st.kf_mask[:, None]).cpu().numpy()
    octaves = np.bincount(st.kf_octave.cpu().numpy()[kp].astype(np.int64),
                          minlength=8)
    init = states.index("OK") if "OK" in states else None
    n_ok = states.count("OK")
    lcs = dict(sys_.loop_closer.stats)
    print(f"timed pass: init at frame {init}, tracked {n_ok}/{n}, {n_kf} "
          f"keyframes ({sys_._kf_count} keyframe steps), {n_lm} landmarks, "
          f"ATE {ate:.4f} m ({'Sim3-aligned' if kind == 'mono' else 'metric'}"
          f"), {n / dt:.2f} FPS ({1e3 * dt / n:.1f} ms/frame), "
          f"{syncs / n:.2f} blocking host syncs/frame, "
          f"{(ready + waited) / n:.2f} asynchronous reads/frame of which "
          f"{waited} of {ready + waited} had to wait, {tr.rollbacks} "
          f"rollbacks, launches {launches}, LightGlue forwards {lg_forwards}, "
          f"{lcs['bow_updates']} BoW updates, {lcs['detections']} detection "
          f"dispatches, {sys_.loop_closer.n_loops} loops", flush=True)
    print(f"octave histogram of the keyframes' keypoints (levels 0..7): "
          f"{octaves.tolist()}", flush=True)
    print("states " + "".join(s[0] for s in states), flush=True)
    tgt = JAX_TARGETS[kind]
    checks = {
        "init frame within 2 of the JAX run's": init is not None and
        abs(init - tgt["init"]) <= 2,
        "tracked >= 51 and >= JAX - 3": n_ok >= max(51, tgt["tracked"] - 3),
        "keyframes within a factor 2 of the JAX run's":
        tgt["kf"] / 2 <= n_kf <= 2 * tgt["kf"],
        "landmarks within 40 % of the JAX run's":
        abs(n_lm - tgt["lm"]) <= 0.4 * tgt["lm"],
        f"ATE <= {tgt['ate_spread'][1] + 0.10:.4f} m (JAX {tgt['ate']:.4f} "
        f"m, {tgt['ate_spread'][0]:.4f}-{tgt['ate_spread'][1]:.4f} m on "
        f"frames moved by 1e-3 px)": ate <= tgt["ate_spread"][1] + 0.10,
        "poses finite": bool(np.all(np.isfinite(C))),
        "window_match_topk2 launched": launches["window_match_topk2"] > 0,
        "lba_landmark_blocks launched": launches["lba_landmark_blocks"] > 0,
        "lba_plan launched": launches["lba_plan"] > 0,
        f"every host wait of the port counted {waits}": waits["ok"],
    }
    if kind == "mono":
        checks["non-zero octaves in the keyframes"] = octaves[1:].sum() > 0
        checks["no depth in the map's keyframes"] = not bool(
            torch.isfinite(st.kf_depth[st.kf_kp_mask & st.kf_mask[:, None]])
            .any())
    else:
        checks["a LightGlue stereo forward per frame"] = lg_forwards >= n
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"{kind} pass checks failed: {failed}")
    return dict(launches=launches, wm_args=wm_args,
                lba_args=lb.args[:3] if lb.args else None, fps=n / dt,
                ate=ate)


# ---------------------------------------------------------------------------
# Phases 14-15: the inertial sensors (IMU_RGBD, IMU_STEREO)
# ---------------------------------------------------------------------------

# The JAX package's runs of the same configurations on the same images and
# IMU windows on the CPU (`python tests/test_torch_inertial_system.py jax
# rgbd-full` and `... stereo-full`) and on its frames with every keypoint
# moved by N(0, 1e-3) px (`... spread rgbd-full 1 2 3`): a full-size
# inertial run is chaotic in the JAX package (RGB-D: 6-10 keyframes,
# 1283-1824 landmarks, ATE 0.119-0.305 m over seeds 0-3; deferred decisions
# that find a frame lost roll the map back), so the port is held to that
# range: init frame within 2 of the JAX runs' (the same in all of them),
# tracked >= 51 and at most 3 below, keyframes within a factor of 2 of the
# range, landmarks within 40 % of it, rigid ATE at most 0.10 m above its
# largest.
INERTIAL_TARGETS = {"rgbd": dict(init=13, tracked=60, kf=(6, 10),
                                 lm=(1283, 1824), ate=0.3054,
                                 ate_spread=(0.1189, 0.3054)),
                    "stereo": dict(init=17, tracked=60, kf=(7, 22),
                                   lm=(1117, 2226), ate=0.2177,
                                   ate_spread=(0.2177, 0.2545))}
IMU_FPS, IMU_RATE, GRAVITY = 10.0, 400.0, (0.0, 0.0, -9.81)


def orbit_imu_windows(n_frames, span, radius=10.0):
    """Host IMU samples between consecutive frames of
    synthetic.orbit_trajectory(n_frames, radius, span) played at IMU_FPS
    (the camera at angle omega t, omega = span * IMU_FPS / (n_frames - 1)),
    at IMU_RATE: the gyroscope from the finite rotation between samples,
    the accelerometer the specific force R_wb^T (a - g), body == camera
    (the rule of tests/test_mono_inertial.py). [None, (gyro, acc, dts),
    ...], 40 samples a window."""
    import numpy as np
    omega = span * IMU_FPS / (n_frames - 1)

    def pose(t):
        ang = omega * t
        C = np.array([radius * np.sin(ang), 0.0, -radius * np.cos(ang)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        return np.stack([x, np.cross(z, x), z], 1), \
            -omega ** 2 * np.array([C[0], 0.0, C[2]])

    def rotvec(R):
        ang = np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]])
        return w * (0.5 if ang < 1e-8 else ang / (2.0 * np.sin(ang)))

    out = [None]
    for i in range(1, n_frames):
        t0, t1 = (i - 1) / IMU_FPS, i / IMU_FPS
        n = int(round((t1 - t0) * IMU_RATE))
        ts = np.linspace(t0, t1, n + 1)
        gyro, acc = [], []
        for k in range(n):
            R0, a0 = pose(ts[k])
            R1, _ = pose(ts[k + 1])
            gyro.append(rotvec(R0.T @ R1) / (ts[k + 1] - ts[k]))
            acc.append(R0.T @ (a0 - np.asarray(GRAVITY)))
        out.append((np.asarray(gyro, np.float32),
                    np.asarray(acc, np.float32),
                    np.diff(ts).astype(np.float32)))
    return out


def inertial_sequence(kind, n_frames, width, height, f):
    """(R_gt, t_gt, left images, depths or right images, times) at
    IMU_FPS along the bench's orbit: the bench's RGB-D images, or phase
    10's rectified pair."""
    from dani_slam_tpu_torch.utils import synthetic
    R_gt, t_gt = synthetic.orbit_trajectory(n_frames, radius=10.0,
                                            angle_span=0.35)
    params = [f, f, width / 2, height / 2]
    if kind == "rgbd":
        imgs, deps, times = synthetic.make_rgbd_image_sequence(
            params, width, height, R_gt, t_gt, seed=0, fps=IMU_FPS)
        return R_gt, t_gt, imgs, [d.astype("int32") for d in deps], times
    left, right, times = synthetic.make_stereo_image_sequence(
        params, width, height, R_gt, t_gt, baseline=STEREO_BASELINE, seed=0,
        fps=IMU_FPS)
    return R_gt, t_gt, left, right, times


def run_inertial(kind, caps, seq, host_windows, width, height, f,
                 sync_debug=False, progress=None, n_frames=None,
                 frame_graph=True):
    """One pass of System(IMU_RGBD, detector=<compact YOLO>, matcher=
    "auto", pipelined=True) or examples/stereo_inertial_euroc.py's
    System(IMU_STEREO, pipelined=True) on a fresh System (loop closing and
    relocalization on, 1024 features, the default IMU calibration), every
    frame with the IMU window since the previous one (made and copied to
    the card before the pass), over the first n_frames frames (all when
    None). progress(system) runs after each frame; frame_graph=False runs
    the track step eagerly (its kernel calls then pass through the
    wrappers, where they can be recorded). Returns (system, states, IMU
    init frame, seconds)."""
    import torch
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.models import yolo
    from dani_slam_tpu_torch.slam.inertial import make_window
    from dani_slam_tpu_torch.slam.system import Sensor, System
    cam = cameras.Camera.pinhole(f, f, width / 2, height / 2, width, height,
                                 device="cuda")
    if kind == "rgbd":
        sys_ = System(cam, Sensor.IMU_RGBD, caps=caps, n_features=1024,
                      detector=yolo.load_default_detector("cuda"),
                      matcher="auto", pipelined=True, device="cuda")
    else:
        sys_ = System(cam, Sensor.IMU_STEREO, caps=caps, n_features=1024,
                      pipelined=True, device="cuda")
    sys_.tracker.frame_graph = frame_graph
    _, _, a, b, times = seq
    n = n_frames or len(a)
    a = [torch.as_tensor(x, device="cuda") for x in a[:n]]
    b = [torch.as_tensor(x, device="cuda") for x in b[:n]]
    wins = [None if w is None else make_window(*w, device="cuda")
            for w in host_windows[:n]]
    _sync()
    if sync_debug:
        torch.cuda.set_sync_debug_mode("warn")
    t0 = time.perf_counter()
    states, init = [], None
    try:
        for i in range(len(a)):
            if kind == "rgbd":
                out = sys_.track_rgbd(a[i], b[i], times[i],
                                      imu_window=wins[i])
            else:
                out = sys_.track_stereo(a[i], b[i], times[i],
                                        STEREO_BASELINE, imu_window=wins[i])
            states.append(out[0])
            if init is None and sys_.tracker.inertial.initialized:
                init = i
            if progress is not None:
                progress(sys_)
        sys_.shutdown()
        _sync()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sys_, states, init, time.perf_counter() - t0


def inertial_pass(kind, caps, kernels, n_record=20):
    """Phase 14 / 15: a warm-up pass over the whole sequence in the timed
    configuration (it captures the graphs, records kernel 2's arguments on
    a local BA before the IMU initialization, and counts the synchronizing
    calls torch's sync debug mode flags in all its frames), a pass over the
    first n_record frames with the track step eager (through the IMU
    initialization: it records kernel 1's tracking calls after it, which
    in the graphed passes run inside the graph) and a timed pass over the
    whole sequence, on fresh Systems, counters set to 0 just before the
    timed pass and read just after; checks against bench.py's counts and
    the JAX package's numbers."""
    import warnings
    import numpy as np
    import torch
    from dani_slam_tpu_torch.utils import device as devmod
    from dani_slam_tpu_torch.utils import eval as ev
    W, H, f, n = 640, 480, 500.0, 60
    seq = inertial_sequence(kind, n, W, H, f)
    host_windows = orbit_imu_windows(n, 0.35)
    flags = dict(imu=False)

    def note(sys_):
        flags["imu"] = bool(sys_.tracker.inertial.initialized)

    devmod.SYNCS.count = devmod.SYNCS.svd = devmod.SYNCS.eigh = 0
    devmod.ASYNC.waited = 0
    with ArgRecorder(kernels, "lba_landmark_blocks",
                     keep=lambda a: not flags["imu"]) as lb, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, states_w, init_w, dt_w = run_inertial(
            kind, caps, seq, host_windows, W, H, f, sync_debug=True,
            progress=note)
    sites = sync_sites(caught)
    waits = uncounted_waits(sites, devmod.SYNCS.count, devmod.SYNCS.svd,
                            devmod.ASYNC.waited)
    print(f"warm-up pass: {states_w.count('OK')}/{n} tracked, IMU init at "
          f"frame {init_w}, {dt_w:.2f} s; synchronizing calls of its frames "
          f"flagged by torch's sync debug mode: {sum(sites.values())}, "
          f"blocking reads counted: {devmod.SYNCS.count} "
          f"({devmod.SYNCS.svd} SVDs, {devmod.SYNCS.eigh} eigh, "
          f"{devmod.ASYNC.waited} AsyncRead waits); flags at the counted "
          f"lines {waits['flagged']}, expected {waits['expected']}; by call "
          f"site: {sites.most_common(12)}", flush=True)
    # kernel 1's tracking calls after the initialization (per-query radii;
    # a relocalization passes a scalar); the held one is that with the
    # most live query rows
    flags["imu"] = False
    with ArgRecorder(kernels, "window_match_topk2",
                     keep=lambda a: isinstance(a[6], torch.Tensor) and
                     flags["imu"], history=n_record) as wm:
        _, states_r, init_r, dt_r = run_inertial(
            kind, caps, seq, host_windows, W, H, f, progress=note,
            n_frames=n_record, frame_graph=False)
    wm_args = wm.held(MIN_HELD_LIVE)
    print(f"recording pass (track step eager): {states_r.count('OK')}/"
          f"{n_record} tracked, IMU init at frame {init_r}, {dt_r:.2f} s, "
          f"{len(wm.calls)} tracking calls of window_match_topk2 after it "
          f"recorded, the held one with {int(wm_args[2].sum())} live query "
          f"rows", flush=True)
    kernels.reset_launch_counts()
    devmod.SYNCS.count = devmod.ASYNC.ready = devmod.ASYNC.waited = 0
    sys_, states, init, dt = run_inertial(kind, caps, seq, host_windows, W,
                                          H, f)
    launches = kernels.launch_counts()
    syncs, ready, waited = (devmod.SYNCS.count, devmod.ASYNC.ready,
                            devmod.ASYNC.waited)
    tr = sys_.tracker
    st = sys_.map_state
    n_kf, n_lm = sys_.n_keyframes(), sys_.n_landmarks()
    traj = tr.trajectory
    C = centers(traj)
    idx = np.round(np.asarray([tm for tm, _, _ in traj]) *
                   IMU_FPS).astype(int)
    ate = ev.ate_rmse(C, ev.centers_from_tcw(seq[0][idx], seq[1][idx]),
                      with_scale=False)
    bg = float(torch.linalg.norm(tr.inertial.bias_g))
    ba = float(torch.linalg.norm(tr.inertial.bias_a))
    stage_flags = [bool(x) for x in (st.imu_initialized, st.imu_ba1,
                                     st.imu_ba2)]
    n_ok = states.count("OK")
    dyn = float(tr.dynamic_ratio) if tr.dynamic_ratio is not None else 0.0
    print(f"timed pass: IMU init at frame {init}, tracked {n_ok}/{n}, {n_kf} "
          f"keyframes ({sys_._kf_count} keyframe steps), {n_lm} landmarks, "
          f"ATE {ate:.4f} m (rigid), |bias_g| {bg:.5f} rad/s, |bias_a| "
          f"{ba:.5f} m/s^2, stages (init, VIBA1, VIBA2) {stage_flags}, "
          f"{sys_.local_inertial_bas} local inertial BAs, "
          f"{sys_.full_inertial_bas} full inertial BAs, {n / dt:.2f} FPS "
          f"({1e3 * dt / n:.1f} ms/frame), {syncs / n:.2f} blocking host "
          f"syncs/frame, {(ready + waited) / n:.2f} asynchronous "
          f"reads/frame of which {waited} of {ready + waited} had to wait, "
          f"{tr.rollbacks} rollbacks ({len(traj)} frames kept in the "
          f"trajectory), launches {launches}, last dyn_ratio {dyn:.3f}",
          flush=True)
    print("states " + "".join(s[0] for s in states), flush=True)
    tgt = INERTIAL_TARGETS[kind]
    checks = {
        "IMU initialized": init is not None and stage_flags[0],
        "init frame within 2 of the JAX run's": init is not None and
        abs(init - tgt["init"]) <= 2,
        "tracked >= 51 and >= JAX - 3": n_ok >= max(51, tgt["tracked"] - 3),
        f"keyframes >= 5 and within a factor 2 of the JAX runs' "
        f"{tgt['kf']}":
        n_kf >= 5 and tgt["kf"][0] / 2 <= n_kf <= 2 * tgt["kf"][1],
        f"landmarks >= 1000 and within 40 % of the JAX runs' {tgt['lm']}":
        n_lm >= 1000 and 0.6 * tgt["lm"][0] <= n_lm <= 1.4 * tgt["lm"][1],
        f"ATE <= {tgt['ate_spread'][1] + 0.10:.4f} m (JAX {tgt['ate']:.4f} "
        f"m, {tgt['ate_spread'][0]:.4f}-{tgt['ate_spread'][1]:.4f} m on "
        f"frames moved by 1e-3 px)": ate <= tgt["ate_spread"][1] + 0.10,
        "poses finite": bool(np.all(np.isfinite(C))),
        "a local inertial BA": sys_.local_inertial_bas >= 1,
        "window_match_topk2 launched": launches["window_match_topk2"] > 0,
        "lba_landmark_blocks launched": launches["lba_landmark_blocks"] > 0,
        "lba_plan launched": launches["lba_plan"] > 0,
        f"every host wait of the port counted {waits}": waits["ok"],
    }
    if kind == "rgbd":
        checks["detector fired"] = dyn > 0.0
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"IMU {kind} pass checks failed: {failed}")
    return dict(launches=launches, wm_args=wm_args,
                lba_args=lb.args[:3] if lb.args else None, fps=n / dt,
                ate=ate, init=init, n_kf=n_kf, n_lm=n_lm)


# ---------------------------------------------------------------------------
# Phase 11: the new functions on the card against the CPU
# ---------------------------------------------------------------------------

def check_sensor_functions_card_vs_cpu():
    """two_view_init with injected draws, stereo_match_depth and its
    LightGlue variant, stereo_fisheye_depth, the rectifier's remap of one
    pair and extract_multiscale: the card against the CPU on the same
    inputs."""
    import warnings
    import numpy as np
    import torch
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.models import superpoint
    from dani_slam_tpu_torch.ops import frontend, image, rectify, twoview
    from dani_slam_tpu_torch.slam import frame
    from dani_slam_tpu_torch.utils import agreement
    from dani_slam_tpu_torch.utils import device as devmod
    from dani_slam_tpu_torch.utils import synthetic

    def both(fn):
        return {d: fn(d) for d in ("cpu", "cuda")}

    # two_view_init and stereo depth: the rules of utils/agreement, which
    # the card-only tests hold too
    r = agreement.two_view_init("cuda")
    r1, r2, _, _, idx = synthetic.two_view_rays()
    args_dev = (tuple(torch.as_tensor(i, device="cuda") for i in idx),
                torch.as_tensor(r1, device="cuda"),
                torch.as_tensor(r2, device="cuda"),
                torch.ones(len(r1), dtype=torch.bool, device="cuda"))
    _sync()
    syncs0 = devmod.SYNCS.count
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            twoview.two_view_init(*args_dev, 520.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = sync_sites(caught)
    print(f"two_view_init card vs CPU (300 matches, 60 corrupted, injected "
          f"draws; R within 1e-4, t within 1e-3): {r}; synchronizing calls "
          f"in one call on the card: {sum(sites.values())} flagged, "
          f"{devmod.SYNCS.count - syncs0} counted, by site "
          f"{sites.most_common(8)}", flush=True)
    if not r["ok"]:
        raise SystemExit("two_view_init: card and CPU disagree")
    r = agreement.stereo_depth("cuda", STEREO_BASELINE)
    print(f"stereo_match_depth card vs CPU (same set, relative 1e-5; "
          f"LightGlue variant: rows and values >= 0.97): {r}", flush=True)
    if not r["ok"]:
        raise SystemExit("stereo depth: card and CPU disagree")

    # fisheye stereo: the KB8 pair of tests/test_stereo.py
    kb_l = (280.0, 280.0, 320.0, 240.0, -0.01, 0.02, -0.005, 0.001, 640, 480)
    kb_r = (282.0, 282.0, 318.0, 242.0, -0.012, 0.021, -0.004, 0.0012, 640,
            480)
    ang = 0.02
    R_rl = np.float32([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]])
    t_rl = np.float32([-0.11, 0.0, 0.0])
    rng = np.random.RandomState(3)
    m = 128
    pc = np.stack([rng.uniform(-2, 2, m), rng.uniform(-1.5, 1.5, m),
                   rng.uniform(1.5, 4.5, m)], 1).astype(np.float32)
    cl = cameras.Camera.kb8(*kb_l, device="cpu")
    cr = cameras.Camera.kb8(*kb_r, device="cpu")
    xy_l = cameras.project(cl, torch.as_tensor(pc)).numpy()
    xy_r = cameras.project(cr, torch.as_tensor(pc @ R_rl.T + t_rl)).numpy()
    desc = rng.randn(m, 64).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    inb = ((xy_l[:, 0] > 2) & (xy_l[:, 0] < 638) & (xy_l[:, 1] > 2) &
           (xy_l[:, 1] < 478))

    def fisheye(d):
        T = lambda a: torch.as_tensor(a, device=d)   # noqa: E731
        return frame.stereo_fisheye_depth(
            cameras.Camera.kb8(*kb_l, device=d),
            cameras.Camera.kb8(*kb_r, device=d), T(xy_l), T(desc), T(inb),
            T(xy_r), T(desc), T(inb), T(R_rl), T(t_rl)).cpu().numpy()
    res = both(fisheye)
    got = np.isfinite(res["cpu"])
    f_err = float(np.max(np.abs(res["cuda"][got] - res["cpu"][got]) /
                         res["cpu"][got])) if got.any() else 0.0
    f_same = bool(np.array_equal(np.isfinite(res["cuda"]), got))
    print(f"stereo_fisheye_depth card vs CPU: {int(got.sum())} of "
          f"{int(inb.sum())} triangulated, same set {f_same}, max relative "
          f"difference {f_err:.2e} (limit 1e-4)", flush=True)
    if not (f_same and got.sum() >= 0.8 * inb.sum() and f_err < 1e-4):
        raise SystemExit("stereo_fisheye_depth: card and CPU disagree")

    # the rectifier (tests/test_rectify.py's distorted pair): grids and the
    # remap of one image pair
    from scipy.spatial.transform import Rotation
    Rs = Rotation.from_rotvec([0.01, -0.02, 0.005]).as_matrix()
    Ts = np.array([-0.11, 0.001, -0.002])
    R_gt, t_gt = synthetic.orbit_trajectory(2, radius=10.0, angle_span=0.01)
    left, right, _ = synthetic.make_stereo_image_sequence(
        [500.0, 500.0, 320.0, 240.0], 640, 480, R_gt[:1], t_gt[:1],
        baseline=STEREO_BASELINE)
    img_l, img_r = left[0], right[0]

    def rect(d):
        c_l = cameras.Camera.pinhole(450.0, 452.0, 320.0, 240.0, 640, 480,
                                     dist=(-0.28, 0.07, 1e-4, -2e-5, 0.0),
                                     device=d)
        c_r = cameras.Camera.pinhole(455.0, 457.0, 318.0, 242.0, 640, 480,
                                     dist=(-0.28, 0.07, 1e-5, 2e-5, 0.0),
                                     device=d)
        rc = rectify.build_rectifier(c_l, c_r, Rs, Ts, (640, 480))
        out = rc(torch.as_tensor(img_l, device=d),
                 torch.as_tensor(img_r, device=d))
        return rc.map_l.cpu().numpy(), [o.cpu().numpy() for o in out]
    res = both(rect)
    d_map = float(np.abs(res["cuda"][0] - res["cpu"][0]).max())
    d_img = max(float(np.abs(a - b).max())
                for a, b in zip(res["cuda"][1], res["cpu"][1]))
    print(f"rectifier card vs CPU: grid within {d_map:.2e} px (limit 2e-3), "
          f"remapped pair within {d_img:.3f} gray levels (limit 0.5)",
          flush=True)
    if not (d_map < 2e-3 and d_img < 0.5):
        raise SystemExit("rectifier: card and CPU disagree")

    # extract_multiscale: 8 levels of one bench frame (bf16 SuperPoint on
    # both devices, rounded by other units: keypoints compared per level)
    R_gt, t_gt = synthetic.orbit_trajectory(2, radius=10.0, angle_span=0.01)
    imgs, _, _ = synthetic.make_rgbd_image_sequence(
        [500.0, 500.0, 320.0, 240.0], 640, 480, R_gt[:1], t_gt[:1], seed=0)

    def multiscale(d):
        g = image.to_gray01(torch.as_tensor(imgs[0], device=d))
        o = frontend.extract_multiscale(superpoint.load_default_params(d), g,
                                        n_max=1024, n_levels=8)
        return {k: v.cpu().numpy() for k, v in o.items()}
    res = both(multiscale)
    shares = []
    for lv in range(8):
        keys = [{tuple(np.round(p, 1)) for p, v, o in
                 zip(r["xy"], r["valid"], r["octave"]) if v and o == lv}
                for r in (res["cpu"], res["cuda"])]
        if keys[0]:
            shares.append(len(keys[0] & keys[1]) / len(keys[0]))
    same_oct = bool(np.array_equal(res["cpu"]["octave"],
                                   res["cuda"]["octave"]))
    print(f"extract_multiscale card vs CPU, 8 levels: octaves equal "
          f"{same_oct}, keypoints in common per level "
          f"{[round(x, 3) for x in shares]} (limit 0.9)", flush=True)
    if not (same_oct and min(shares) >= 0.9):
        raise SystemExit("extract_multiscale: card and CPU disagree")


# ---------------------------------------------------------------------------
# Phase 12: bench.py's official-scale pass
# ---------------------------------------------------------------------------

def official_pass(caps, seq, kernels, W, H, f, n_timed=3):
    """bench.py's `official` pass: the main path's configuration with the
    reference-scale nets (yolov5s as the detector, LightGlue 256x9 as the
    matcher). A warm-up pass (which captures the frame graph of these
    nets, and records both kernels' arguments outside the capture), then
    n_timed passes on fresh Systems, every counter set to 0 just before
    each and read just after; bench.py's checks on the last one."""
    import warnings
    import numpy as np
    import torch
    from dani_slam_tpu_torch.models import lightglue, lightglue_official
    from dani_slam_tpu_torch.models import yolo_official
    from dani_slam_tpu_torch.utils import device as devmod
    matcher = lightglue_official.load_official_matcher(W, H, device="cuda")
    det = yolo_official.load_official_detector(device="cuda")
    if matcher is None or det is None:
        raise SystemExit("official-scale weights absent (matcher "
                         f"{matcher is not None}, detector {det is not None})")
    mode = dict(matcher=matcher, pipelined=True)
    outside_capture = lambda a: isinstance(a[6], torch.Tensor) and \
        not torch.cuda.is_current_stream_capturing()   # noqa: E731
    devmod.SYNCS.count = devmod.SYNCS.svd = devmod.ASYNC.waited = 0
    with ArgRecorder(kernels, "window_match_topk2",
                     keep=outside_capture) as wm, \
            ArgRecorder(kernels, "lba_landmark_blocks") as lb, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, n_ok_w, dt_w = run_system("cuda", caps, 1024, seq, W, H, f, mode,
                                     detector=det, sync_debug=True)
    sites = sync_sites(caught)
    waits = uncounted_waits(sites, devmod.SYNCS.count, devmod.SYNCS.svd,
                            devmod.ASYNC.waited)
    print(f"warm-up pass (captures the official nets' frame graph): "
          f"{n_ok_w}/60 tracked in {dt_w:.2f} s; synchronizing calls of its "
          f"frames flagged by torch's sync debug mode: "
          f"{sum(sites.values())}, blocking reads counted: "
          f"{devmod.SYNCS.count} ({devmod.ASYNC.waited} AsyncRead waits); "
          f"flags at the counted lines {waits['flagged']}, expected "
          f"{waits['expected']}; by call site: {sites.most_common(12)}",
          flush=True)
    fps = []
    for _ in range(n_timed):
        kernels.reset_launch_counts()
        lightglue.FORWARDS.count = 0
        devmod.SYNCS.count = devmod.ASYNC.ready = devmod.ASYNC.waited = 0
        sys_, n_ok, dt = run_system("cuda", caps, 1024, seq, W, H, f, mode,
                                    detector=det)
        launches = kernels.launch_counts()
        lg_forwards = lightglue.FORWARDS.count
        syncs = devmod.SYNCS.count
        fps.append(60 / dt)
    tr = sys_.tracker
    n_kf, n_lm = sys_.n_keyframes(), sys_.n_landmarks()
    dyn = float(tr.dynamic_ratio)
    C_est, ate = trajectory_ate(sys_, seq)
    print(f"timed passes: {[round(x, 2) for x in fps]} FPS (median "
          f"{statistics.median(fps):.2f}); the last: tracked {n_ok}/60, "
          f"{n_kf} keyframes ({sys_._kf_count} keyframe steps), {n_lm} "
          f"landmarks, last dyn_ratio {dyn:.3f}, {1e3 / fps[-1]:.1f} "
          f"ms/frame, {syncs / 60:.2f} blocking host syncs/frame, "
          f"{tr.graph_replays} graph replays, {tr.eager_frames} eager image "
          f"frames, {tr.rollbacks} rollbacks, ATE {ate:.4f} m, launches "
          f"{launches}, official LightGlue forwards {lg_forwards}", flush=True)
    checks = {
        "tracked >= 51/60": n_ok >= 51,
        "keyframes >= 5": n_kf >= 5,
        "landmarks >= 1000": n_lm >= 1000,
        "detector fired": dyn > 0.0,
        "poses finite": bool(np.all(np.isfinite(C_est))),
        "graph replays >= 50": tr.graph_replays >= 50,
        "window_match_topk2 ran on every tracked frame":
        launches["window_match_topk2"] >= tr.graph_replays > 0,
        "lba_landmark_blocks launched": launches["lba_landmark_blocks"] > 0,
        "lba_plan launched": launches["lba_plan"] > 0,
        "official LightGlue forwards > 0": lg_forwards > 0,
        "the System ran the official nets":
        sys_.matcher.model is matcher.model and sys_.detector is det,
        "both kernels' arguments recorded": wm.args is not None and
        lb.args is not None,
        f"every host wait of the port counted {waits}": waits["ok"],
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"official-pass checks failed: {failed}")
    return dict(launches=launches, wm_args=wm.args, lba_args=lb.args[:3],
                fps=fps, ate=ate, n_kf=n_kf, n_lm=n_lm)


def replay_costs(width, height):
    """Device time of one replay of each captured 640x480 frame program of
    the bench's configuration (compact and official nets), CUDA events
    around a replay (median of 10), and its kernel count and summed kernel
    time under torch.profiler over 2 replays."""
    from torch.profiler import ProfilerActivity, profile
    from dani_slam_tpu_torch.slam import framegraph
    out = {}
    for g in framegraph._GRAPHS.values():
        if tuple(g.img.shape[:2]) != (height, width) or g.matcher is None \
                or g.st.caps.N != 1024 or g.detector is None:
            continue
        name = (f"{type(g.detector.model).__name__} + "
                f"{type(g.matcher.model).__name__}")
        ms = time_ms(g.graph.replay, reps=10, warmup=2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            g.graph.replay()
            g.graph.replay()
            _sync()
        ks = _kernel_events(prof)
        out[name] = (ms, len(ks) / 2,
                     sum(e.device_time_total for e in ks) / 2e3)
        print(f"  {ms:8.3f} ms a replay, {out[name][1]:7.0f} kernels, "
              f"{out[name][2]:8.3f} ms summed kernel time  frame program "
              f"with {name}", flush=True)
    if len(out) != 2:
        raise SystemExit(f"expected the compact and the official frame "
                         f"programs, found {sorted(out)}")
    return out


def check_official_nets():
    """The official nets on the card against the same modules on the CPU,
    and their eager times: LightGlue 256x9 through match_pairs (probabilities
    within 0.05, match rows differing on at most 30 of 1024: nine bf16
    layers compound the two devices' rounding, where the compact net's six
    are held to 0.03 and 20), and yolov5s's raw heads at 384x512 within
    0.1 + 3 % and 0.02 on average (tests/test_torch_official_models.py's
    bf16 rule)."""
    import numpy as np
    import torch
    from dani_slam_tpu_torch.models import lightglue_official, yolo_official
    times = check_lightglue(
        640, 480, name="official LightGlue 256x9",
        load=lambda dev: lightglue_official.load_official_matcher(
            640, 480, device=dev), prob_tol=0.05, row_tol=30)
    x = np.random.RandomState(2).rand(384, 512, 3).astype(np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = yolo_official.load_official_detector(device=dev).model
        with torch.no_grad():
            outs[dev] = [o.cpu().numpy() for o in
                         model(torch.as_tensor(x, device=dev))]
    excess = max(float((np.abs(g - c) - 0.1 - 0.03 * np.abs(c)).max())
                 for g, c in zip(outs["cuda"], outs["cpu"]))
    mean = max(float(np.abs(g - c).mean())
               for g, c in zip(outs["cuda"], outs["cpu"]))
    print(f"yolov5s card vs CPU, heads at 384x512: largest excess over 0.1 "
          f"+ 3 % {excess:.4f} (must be <= 0), mean difference {mean:.4f} "
          f"(limit 0.02)", flush=True)
    if excess > 0 or mean >= 0.02:
        raise SystemExit("yolov5s on the card disagrees with the CPU")
    model = yolo_official.load_official_detector(device="cuda").model
    xg = torch.as_tensor(x, device="cuda")

    def forward():
        with torch.no_grad():
            model(xg)
    times["yolov5s_384x512"] = time_ms(forward, reps=10)
    print(f"yolov5s forward (eager, CUDA events, median of 10): "
          f"{times['yolov5s_384x512']:.3f} ms at 384x512", flush=True)
    return times


# ---------------------------------------------------------------------------
# Phase 13: the RGB-D runner on a sequence written to disk
# ---------------------------------------------------------------------------

def write_tum_sequence(seq, n, out_dir):
    """The first n frames of the bench sequence as a TUM RGB-D directory:
    rgb/*.ppm (PNM: the card's machine has no PIL), depth/*.pgm (16 bit,
    factor 5000), assoc.txt at epoch-scale timestamps, settings.yaml."""
    import numpy as np
    _, _, imgs, deps, times = seq
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    t0 = 1305031102.175
    lines = []
    for i in range(n):
        rgb, dep = f"rgb/{i:04d}.ppm", f"depth/{i:04d}.pgm"
        h, w = imgs[i].shape[:2]
        with open(os.path.join(out_dir, rgb), "wb") as fh:
            fh.write(f"P6\n{w} {h}\n255\n".encode() +
                     np.ascontiguousarray(imgs[i], np.uint8).tobytes())
        with open(os.path.join(out_dir, dep), "wb") as fh:
            fh.write(f"P5\n{w} {h}\n65535\n".encode() +
                     np.asarray(deps[i], ">u2").tobytes())
        t = t0 + times[i]
        lines.append(f"{t:.6f} {rgb} {t:.6f} {dep}")
    with open(os.path.join(out_dir, "assoc.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(os.path.join(out_dir, "settings.yaml"), "w") as fh:
        fh.write("%YAML:1.0\nCamera1.fx: 500.0\nCamera1.fy: 500.0\n"
                 "Camera1.cx: 320.0\nCamera1.cy: 240.0\nCamera.width: 640\n"
                 "Camera.height: 480\nRGBD.DepthMapFactor: 5000.0\n"
                 "ORBextractor.nFeatures: 1024\n")
    return t0


def runner_pass(seq, n=30):
    """python -m dani_slam_tpu_torch.examples.rgbd_tum on n frames of the
    bench sequence written to disk (detector on, default device cuda), as
    a user runs it: the trajectory must have a row per pose the runner
    reports, at the sequence's timestamps, and the log must name cuda."""
    import numpy as np
    out_dir = os.path.join(ROOT, "build", "chip_smoke_tum")
    t0 = write_tum_sequence(seq, n, out_dir)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dani_slam_tpu_torch.examples.rgbd_tum",
         os.path.join(out_dir, "settings.yaml"), out_dir,
         os.path.join(out_dir, "assoc.txt"), "--out-prefix",
         os.path.join(out_dir, "out_"), "--detector"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    dt = time.perf_counter() - t1
    print("runner output:\n  " + "\n  ".join(proc.stdout.splitlines()[-6:]),
          flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"rgbd_tum runner failed ({proc.returncode}): "
                         f"{proc.stderr[-3000:]}")
    traj = np.loadtxt(os.path.join(out_dir, "out_CameraTrajectory.txt"),
                      ndmin=2)
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("done:")]
    poses = int(done[-1].split(",")[1].split()[0]) if done else -1
    stamps = t0 + np.asarray([i / 30.0 for i in range(n)])
    checks = {
        "the log names cuda": "device cuda" in proc.stdout and
        "on cuda" in proc.stdout,
        "a row per pose the runner reports": traj.shape == (poses, 8),
        "tracked >= 26/30": poses >= 26,
        "rows at the sequence's timestamps": bool(np.all(np.min(np.abs(
            traj[:, :1] - stamps[None]), axis=1) < 1e-3)),
        "poses finite": bool(np.isfinite(traj).all()),
        "ExecMean.txt written": os.path.exists(
            os.path.join(out_dir, "out_ExecMean.txt")),
    }
    print(f"runner: {poses} poses of {n} frames in {dt:.1f} s (process "
          f"start, model loads and kernel loads included); checks "
          f"{checks}", flush=True)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"runner checks failed: {failed}")


def atlas_round_trip():
    """save_atlas / load_atlas on the card, then a frame from a mapped view
    tracks against the loaded map (tests/test_config_io.py's persistence
    case: 12 rendered feature frames, K 32 / L 4096 / N 256 / D 64)."""
    import numpy as np
    import torch
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.core import state as mstate
    from dani_slam_tpu_torch.slam.system import Sensor, System
    from dani_slam_tpu_torch.utils import synthetic
    cam = cameras.Camera.pinhole(500., 500., 320., 240., 640, 480,
                                 device="cuda")
    caps = mstate.MapCaps(K=32, L=4096, N=256, D=64)
    world = synthetic.make_world(1200, desc_dim=64, seed=11)
    R_gt, t_gt = synthetic.orbit_trajectory(12, radius=10., angle_span=0.25)

    def frame(i, seed, tm):
        return synthetic.render_frame(world, cam, R_gt[i], t_gt[i], n_max=256,
                                      noise_px=0.3, seed=seed,
                                      with_depth=True, time=tm)[0]

    def make():
        return System(cam, Sensor.RGBD, caps=caps, n_features=256, seed=3,
                      device="cuda")
    sys1 = make()
    for i in range(12):
        sys1.track_features(frame(i, i, i / 30.0), timestamp=i / 30.0)
    path = os.path.join(ROOT, "build", "chip_smoke_atlas.npz")
    sys1.save_atlas(path)
    sys2 = make()
    sys2.load_atlas(path)
    same = sys2.n_keyframes() == sys1.n_keyframes() and \
        sys2.n_landmarks() == sys1.n_landmarks() and \
        torch.equal(sys2.loop_closer.bow, sys1.loop_closer.bow)
    state, R, t = sys2.track_features(frame(5, 99, 1.0), timestamp=1.0)
    C = -np.asarray(R.cpu()).T @ np.asarray(t.cpu())
    C_gt = R_gt[0] @ (-R_gt[5].T @ t_gt[5]) + t_gt[0]
    err = float(np.linalg.norm(C - C_gt))
    print(f"atlas round trip on the card: {sys1.n_keyframes()} keyframes, "
          f"{sys1.n_landmarks()} landmarks saved and loaded "
          f"({'identical' if same else 'DIFFERENT'}), a frame from "
          f"keyframe 5's view: {state}, centre {err:.4f} m from the truth "
          f"(limit 0.05)", flush=True)
    if not same or state != "OK" or err >= 0.05:
        raise SystemExit("atlas round trip failed")


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
                          ("launch_floor_kernel",))[0]["launch_floor_kernel"]
    print(f"launch floor (an empty kernel through the same kind of C call): "
          f"{floor_ms:.4f} ms a call, {floor_dev:.4f} ms on the device",
          flush=True)
    for name, k in (("window_match_topk2", k1),
                    ("window_match_topk2 (relocalization, 10 px)", k1r),
                    ("window_match_topk2 (relocalization, 3 px)", k1r3),
                    ("lba_landmark_blocks", k2)):
        k["launch_floor_ms"] = floor_ms
        print(f"{name}: kernel {k['ms']:.4f} ms a call, {k['device_ms']:.4f} "
              f"ms on the device ({k['device_launches_recorded']} launches "
              f"recorded), plain {k['plain_ms']:.4f} ms, library "
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

    sensor = {}
    for num, kind, what in (
            (9, "mono", "examples/mono_tum.py's System(MONOCULAR, "
             "pipelined=True, n_levels=8, scale_factor=1.2)"),
            (10, "stereo", "examples/stereo_kitti.py's System(STEREO, "
             "pipelined=True), rectified pair, 0.12 m baseline")):
        phase(f"{num}. {kind} pass: {what}, 60 frames 640x480, loop closing "
              f"and relocalization on, MapCaps()")
        out = sensor_pass(kind, caps, kernels)
        if out["wm_args"] is None or out["lba_args"] is None:
            raise SystemExit(f"{kind} pass: a kernel was never called")
        # both kernels again, on the arguments of the path's own last call
        out["err1"], out["k1"] = check_window_match(
            kernels, timed=True, args=out["wm_args"],
            label=f"the {kind} path's recorded call")
        out["err2"], out["k2"] = check_lba(kernels, timed=True,
                                           args=out["lba_args"])
        for k in (out["k1"], out["k2"]):
            k["launch_floor_ms"] = floor_ms
        la = out["launches"]
        out["k2"]["launches_per_solve"] = la["lba_landmark_blocks"] / \
            max(la["lba_plan"], 1)
        for name, k in (("window_match_topk2", out["k1"]),
                        ("lba_landmark_blocks", out["k2"])):
            print(f"{name} ({kind} path): kernel {k['ms']:.4f} ms a call, "
                  f"{k['device_ms']:.4f} ms on the device "
                  f"({k['device_launches_recorded']} launches recorded), plain "
                  f"{k['plain_ms']:.4f} ms, library {k['library_ms']:.4f} ms, "
                  f"bound {k['bound_ms']:.5f} ms ({k['bound_by']})",
                  flush=True)
        sensor[kind] = out

    phase("11. the monocular and stereo functions on the card against the "
          "CPU")
    check_sensor_functions_card_vs_cpu()

    phase("12. bench.py's official pass: the main path with yolov5s and "
          "LightGlue 256x9, warm-up and three timed passes")
    off = official_pass(caps, seq, kernels, W, H, f)
    off["err1"], off["k1"] = check_window_match(
        kernels, timed=True, args=off["wm_args"],
        label="the official path's recorded call")
    off["err2"], off["k2"] = check_lba(kernels, timed=True,
                                       args=off["lba_args"])
    la = off["launches"]
    for k in (off["k1"], off["k2"]):
        k["launch_floor_ms"] = floor_ms
    off["k2"]["launches_per_solve"] = la["lba_landmark_blocks"] / \
        max(la["lba_plan"], 1)
    for name, k in (("window_match_topk2", off["k1"]),
                    ("lba_landmark_blocks", off["k2"])):
        print(f"{name} (official path): kernel {k['ms']:.4f} ms a call, "
              f"{k['device_ms']:.4f} ms on the device "
              f"({k['device_launches_recorded']} launches recorded), plain "
              f"{k['plain_ms']:.4f} ms, library {k['library_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.5f} ms ({k['bound_by']})", flush=True)
    off_times = check_official_nets()
    replay_costs(W, H)

    phase("13. the RGB-D runner (python -m dani_slam_tpu_torch.examples."
          "rgbd_tum --detector) on 30 frames written to disk; the atlas "
          "saved and loaded on the card")
    runner_pass(seq)
    atlas_round_trip()

    inert = {}
    for num, kind, what in (
            (14, "rgbd", "System(IMU_RGBD, detector=<compact YOLO>, "
             "matcher='auto', pipelined=True) on the bench's images"),
            (15, "stereo", "examples/stereo_inertial_euroc.py's "
             "System(IMU_STEREO, pipelined=True) on phase 10's rectified "
             "pair")):
        phase(f"{num}. IMU {kind} pass: {what}, 60 frames 640x480 at 10 Hz "
              f"with 400 Hz IMU windows of the orbit, loop closing and "
              f"relocalization on, MapCaps()")
        out = inertial_pass(kind, caps, kernels)
        if out["wm_args"] is None or out["lba_args"] is None:
            raise SystemExit(f"IMU {kind} pass: a kernel was never called "
                             f"(window match after the IMU initialization, "
                             f"landmark blocks before it)")
        out["err1"], out["k1"] = check_window_match(
            kernels, timed=True, args=out["wm_args"],
            label=f"the IMU {kind} path's recorded call")
        out["err2"], out["k2"] = check_lba(kernels, timed=True,
                                           args=out["lba_args"])
        for k in (out["k1"], out["k2"]):
            k["launch_floor_ms"] = floor_ms
        out["k2"]["launches_per_solve"] = \
            out["launches"]["lba_landmark_blocks"] / \
            max(out["launches"]["lba_plan"], 1)
        for name, k in (("window_match_topk2", out["k1"]),
                        ("lba_landmark_blocks", out["k2"])):
            print(f"{name} (IMU {kind} path): kernel {k['ms']:.4f} ms a call, "
                  f"{k['device_ms']:.4f} ms on the device "
                  f"({k['device_launches_recorded']} launches recorded), "
                  f"plain {k['plain_ms']:.4f} ms, library "
                  f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms "
                  f"({k['bound_by']})", flush=True)
        inert[kind] = out

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
    for kind, out in sensor.items():
        q, r = out["wm_args"][0], out["wm_args"][6]
        row_lm = out["lba_args"][0]
        kernels_out += [
            dict(name="window_match_topk2", route="cuda",
                 source="dani_slam_tpu_torch/csrc/window_match.cu",
                 replaces="dani_slam_tpu/ops/pallas_kernels.py:168",
                 launches=out["launches"]["window_match_topk2"],
                 max_abs_err=out["err1"],
                 shape=f"{kind} path (recorded call): M {q.shape[0]} x N "
                 f"{out['wm_args'][3].shape[0]} x D {q.shape[1]}, "
                 f"{int(out['wm_args'][2].sum())} live rows, radii "
                 f"{float(r.min()):.1f}-{float(r.max()):.1f} px", **out["k1"]),
            dict(name="lba_landmark_blocks", route="cuda",
                 source="dani_slam_tpu_torch/csrc/lba_blocks.cu",
                 replaces="dani_slam_tpu/ops/pallas_kernels.py:265",
                 launches=out["launches"]["lba_landmark_blocks"],
                 max_abs_err=out["err2"],
                 shape=f"{kind} path (recorded call): P {row_lm.shape[0]} x "
                 f"N {row_lm.shape[1]}, L {out['lba_args'][2]}",
                 **out["k2"])]
    for kind, out in inert.items():
        q, r = out["wm_args"][0], out["wm_args"][6]
        row_lm = out["lba_args"][0]
        kernels_out += [
            dict(name="window_match_topk2", route="cuda",
                 source="dani_slam_tpu_torch/csrc/window_match.cu",
                 replaces="dani_slam_tpu/ops/pallas_kernels.py:168",
                 launches=out["launches"]["window_match_topk2"],
                 max_abs_err=out["err1"],
                 shape=f"IMU {kind} path (recorded call after the IMU "
                 f"initialization): M {q.shape[0]} x N "
                 f"{out['wm_args'][3].shape[0]} x D {q.shape[1]}, "
                 f"{int(out['wm_args'][2].sum())} live rows, radii "
                 f"{float(r.min()):.1f}-{float(r.max()):.1f} px", **out["k1"]),
            dict(name="lba_landmark_blocks", route="cuda",
                 source="dani_slam_tpu_torch/csrc/lba_blocks.cu",
                 replaces="dani_slam_tpu/ops/pallas_kernels.py:265",
                 launches=out["launches"]["lba_landmark_blocks"],
                 max_abs_err=out["err2"],
                 shape=f"IMU {kind} path (a local BA before the IMU "
                 f"initialization): P {row_lm.shape[0]} x N "
                 f"{row_lm.shape[1]}, L {out['lba_args'][2]}", **out["k2"])]
    q, r = off["wm_args"][0], off["wm_args"][6]
    row_lm = off["lba_args"][0]
    kernels_out += [
        dict(name="window_match_topk2", route="cuda",
             source="dani_slam_tpu_torch/csrc/window_match.cu",
             replaces="dani_slam_tpu/ops/pallas_kernels.py:168",
             launches=la["window_match_topk2"], max_abs_err=off["err1"],
             shape=f"official path (recorded call): M {q.shape[0]} x N "
             f"{off['wm_args'][3].shape[0]} x D {q.shape[1]}, "
             f"{int(off['wm_args'][2].sum())} live rows, radii "
             f"{float(r.min()):.1f}-{float(r.max()):.1f} px", **off["k1"]),
        dict(name="lba_landmark_blocks", route="cuda",
             source="dani_slam_tpu_torch/csrc/lba_blocks.cu",
             replaces="dani_slam_tpu/ops/pallas_kernels.py:265",
             launches=la["lba_landmark_blocks"], max_abs_err=off["err2"],
             shape=f"official path (recorded call): P {row_lm.shape[0]} x N "
             f"{row_lm.shape[1]}, L {off['lba_args'][2]}", **off["k2"])]
    print(f"official pass: {[round(x, 2) for x in off['fps']]} FPS, "
          f"{off['n_kf']} keyframes, {off['n_lm']} landmarks, ATE "
          f"{off['ate']:.4f} m; eager official match_pairs "
          f"{off_times['1x1024']:.3f} ms (1 x 1024^2), "
          f"{off_times['5x512']:.3f} ms (5 x 512^2), yolov5s "
          f"{off_times['yolov5s_384x512']:.3f} ms", flush=True)
    print(f"loop pass: median {lp['median_ms']:.2f} ms/keyframe, max "
          f"{lp['max_ms']:.2f} ms; relocalization: {rl['calls']} attempts, "
          f"{rl['launches']} window-match launches; mono "
          f"{sensor['mono']['fps']:.2f} FPS, ATE {sensor['mono']['ate']:.4f} "
          f"m; stereo {sensor['stereo']['fps']:.2f} FPS, ATE "
          f"{sensor['stereo']['ate']:.4f} m; IMU RGB-D "
          f"{inert['rgbd']['fps']:.2f} FPS, init at frame "
          f"{inert['rgbd']['init']}, ATE {inert['rgbd']['ate']:.4f} m; IMU "
          f"stereo {inert['stereo']['fps']:.2f} FPS, init at frame "
          f"{inert['stereo']['init']}, ATE {inert['stereo']['ate']:.4f} m",
          flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
