#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dani_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize(); any failure exits non-zero:
  1. build every CUDA kernel from dani_slam_tpu_torch/csrc (nvcc, sm_90a) and
     print the build seconds;
  2. hold each kernel against its plain PyTorch version on the card at the
     main-path shapes and one ragged shape (window match: distances within
     atol 1e-4, indices up to near-ties, two launches bitwise equal; landmark
     blocks: rtol/atol 1e-5; the reduction plan: exactly equal), and time
     kernel, plain version and a one-call PyTorch yardstick (one call of the
     wrapper between CUDA events, median of 25 after warm-up), the device
     time of the kernel's own launches (torch.profiler) and an empty kernel
     launched the same way (the floor under any separately launched kernel);
  3. drive the port's main path: the 60-frame 640x480 detector-on RGB-D
     sequence of bench.py through System(device="cuda") at MapCaps() =
     K=256/L=32768/N=1024/D=256, 1024 features, non-pipelined, descriptor
     mutual-NN matcher — once to warm up, then a timed pass with every
     kernel launch counter and the host-sync counter set to 0 just before it
     and read just after; bench.py's checks (>= 51/60 frames tracked, >= 5
     keyframes, >= 1000 landmarks, detector fired) plus finite poses and
     the ATE against the ground truth;
  4. agreement on a small input: 4 frames at 320x240 through the same
     System on the CPU (the kernels' plain versions) and on the card;
  5. where the time goes: six steady-state frames under torch.profiler
     (device busy share, kernel launches per frame, top operators).

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
    contains each of `names`: torch.profiler over `reps` calls after warm-up.
    Fails when a name was never launched, so a host-side number can never
    stand in for a device time."""
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
    missing = [n for n in names if count[n] < reps or total[n] <= 0]
    if missing:
        raise SystemExit(f"profiler recorded no device time for {missing}")
    return {n: total[n] / 1e3 / reps for n in names}


def phase(name: str):
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def match_inputs(M, N, D, n_live, seed, dev):
    """Unit descriptors with planted matches, pixel coords in 640x480, a
    valid prefix of n_live rows (the compacted local-map query set) and
    per-query radii 4 * 1.2^level."""
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
    return T(q), T(qxy), T(qv), T(t), T(txy), T(tv), T(r)


def check_window_match(kernels, M, N, D, n_live, seed, timed):
    import torch
    dev = torch.device("cuda")
    args = match_inputs(M, N, D, n_live, seed, dev)
    out_k = kernels.window_match_topk2(*args)
    again = kernels.window_match_topk2(*args)
    ref_dist = kernels.window_match_dist_ref(*args)
    out_r = kernels.window_match_reduce_ref(ref_dist)
    _sync()
    res = kernels.window_match_agreement(out_k, out_r, ref_dist, atol=1e-4)
    same = all(torch.equal(a, b) for a, b in zip(out_k, again))
    ok = res["ok"] and same
    print(f"window_match_topk2 M={M} N={N} D={D} live={n_live}: "
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
    r2 = r * r

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
    nbytes = live_rows * D * 4 + M * (2 * 4 + 1 + 4) + \
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


def make_system(device, caps, n_feat, width, height, f):
    """A fresh System in the slice's configuration, with bench.py's
    keypoint threshold."""
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.models import yolo
    from dani_slam_tpu_torch.slam.system import Sensor, System
    cam = cameras.Camera.pinhole(f, f, width / 2, height / 2, width, height,
                                 device=device)
    sys_ = System(cam, Sensor.RGBD, caps=caps, n_features=n_feat,
                  detector=yolo.load_default_detector(device),
                  matcher=None, pipelined=False, enable_loop_closing=False,
                  enable_relocalization=False, device=device)
    sys_.sp_threshold = 0.012
    return sys_


def frames_on(device, seq):
    """(images, depths, times) of a sequence, the tensors on `device`."""
    import torch
    _, _, imgs, deps, times = seq
    return ([torch.as_tensor(x, device=device) for x in imgs],
            [torch.as_tensor(x.astype("int32"), device=device)
             for x in deps], times)


def run_system(device, caps, n_feat, seq, width, height, f):
    """One pass through a fresh System; returns (system, n_ok, seconds)."""
    sys_ = make_system(device, caps, n_feat, width, height, f)
    imgs, deps, times = frames_on(device, seq)
    if device == "cuda":
        _sync()
    t0 = time.perf_counter()
    n_ok = 0
    for i in range(len(imgs)):
        state, _, _ = sys_.track_rgbd(imgs[i], deps[i], times[i])
        n_ok += state == "OK"
    sys_.shutdown()
    if device == "cuda":
        _sync()
    return sys_, n_ok, time.perf_counter() - t0


def centers(traj):
    import numpy as np
    return np.stack([-R.T @ t for _, R, t in traj])


def profile_main_path(caps, seq, start, n_frames, width, height, f):
    """Frames start .. start+n_frames of the main path (after `start`
    frames run unprofiled) under torch.profiler: host wall time, summed
    device time of the kernels, kernel launches per frame, and the
    operators with the most device time. The profiler's own cost inflates
    the host time; the device sums and launch counts are exact."""
    from torch.profiler import ProfilerActivity, profile
    sys_ = make_system("cuda", caps, 1024, width, height, f)
    imgs, deps, times = frames_on("cuda", seq)
    for i in range(start):
        sys_.track_rgbd(imgs[i], deps[i], times[i])
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(start, start + n_frames):
            sys_.track_rgbd(imgs[i], deps[i], times[i])
        _sync()
        dt = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA" and e.device_time_total > 0]
    dev_ms = sum(e.device_time_total for e in kernels) / 1e3
    print(f"profiled frames {start}..{start + n_frames - 1}: host "
          f"{1e3 * dt / n_frames:.1f} ms/frame under the profiler, device "
          f"kernels {dev_ms / n_frames:.2f} ms/frame (busy share "
          f"{dev_ms / (1e3 * dt):.3f}), {len(kernels) / n_frames:.0f} "
          f"kernel launches/frame", flush=True)
    rows = sorted(prof.key_averages(),
                  key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:12]:
        print(f"  {e.self_device_time_total / 1e3 / n_frames:8.3f} ms/frame "
              f"device, {e.count / n_frames:7.1f} calls/frame  "
              f"{e.key[:90]}", flush=True)


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
    from dani_slam_tpu_torch.utils import eval as ev

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
    err2, k2 = check_lba(kernels, 16, 1024, 2048, 0, True)
    err2b, _ = check_lba(kernels, 16, 1000, 1000, 1, False)
    _sync()
    floor_ms = time_ms(kernels.launch_floor)
    floor_dev = device_ms(kernels.launch_floor,
                          ("launch_floor_kernel",))["launch_floor_kernel"]
    print(f"launch floor (an empty kernel through the same kind of C call): "
          f"{floor_ms:.4f} ms a call, {floor_dev:.4f} ms on the device",
          flush=True)
    for name, k in (("window_match_topk2", k1), ("lba_landmark_blocks", k2)):
        k["launch_floor_ms"] = floor_ms
        print(f"{name}: kernel {k['ms']:.4f} ms a call, {k['device_ms']:.4f} "
              f"ms on the device, plain {k['plain_ms']:.4f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms "
              f"({k['bound_by']})", flush=True)

    phase("3. main path: 60-frame 640x480 detector-on RGB-D sequence")
    caps = mstate.MapCaps()
    n_frames, W, H, f = 60, 640, 480, 500.0
    t0 = time.perf_counter()
    seq = make_sequence(n_frames, W, H, f, 0.35)
    print(f"rendered {n_frames} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _, n_ok_w, dt_w = run_system("cuda", caps, 1024, seq, W, H, f)
    print(f"warm-up pass: {n_ok_w}/{n_frames} tracked in {dt_w:.2f} s",
          flush=True)
    kernels.reset_launch_counts()
    devmod.SYNCS.count = 0
    sys_, n_ok, dt = run_system("cuda", caps, 1024, seq, W, H, f)
    launches = kernels.launch_counts()
    syncs = devmod.SYNCS.count
    n_kf, n_lm = sys_.n_keyframes(), sys_.n_landmarks()
    dyn = float(sys_.tracker.dynamic_ratio)
    traj = sys_.tracker.trajectory
    C_est = centers(traj)
    R_gt, t_gt = seq[0], seq[1]
    idx = np.round(np.asarray([tm for tm, _, _ in traj]) * 30).astype(int)
    C_gt = ev.centers_from_tcw(R_gt[idx], t_gt[idx])
    ate = ev.ate_rmse(C_est, C_gt)
    print(f"timed pass: tracked {n_ok}/{n_frames}, {n_kf} keyframes, "
          f"{n_lm} landmarks, last dyn_ratio {dyn:.3f}, "
          f"{n_frames / dt:.2f} FPS ({1e3 * dt / n_frames:.1f} ms/frame), "
          f"{syncs / n_frames:.2f} host syncs/frame, ATE {ate:.4f} m, "
          f"launches {launches}", flush=True)
    checks = {
        "tracked >= 51/60": n_ok >= 0.85 * n_frames,
        "keyframes >= 5": n_kf >= 5,
        "landmarks >= 1000": n_lm >= 1000,
        "detector fired": dyn > 0.0,
        "poses finite": bool(np.all(np.isfinite(C_est))) and
        C_est.shape == (len(traj), 3),
        "ATE < 0.25 m": ate < 0.25,
        "window_match_topk2 launched": launches["window_match_topk2"] > 0,
        "lba_landmark_blocks launched": launches["lba_landmark_blocks"] > 0,
        "lba_plan launched": launches["lba_plan"] > 0,
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

    phase("4. small input: CPU (plain versions) vs card")
    small = make_sequence(4, 320, 240, 300.0, 0.35 * 4 / 60)
    caps_s = mstate.MapCaps(K=32, L=4096, N=256, D=256)
    sc, n_c, _ = run_system("cpu", caps_s, 256, small, 320, 240, 300.0)
    sg, n_g, _ = run_system("cuda", caps_s, 256, small, 320, 240, 300.0)
    dC = np.abs(centers(sc.tracker.trajectory) -
                centers(sg.tracker.trajectory)).max()
    print(f"cpu {n_c}/4 tracked, {sc.n_keyframes()} kf, {sc.n_landmarks()} "
          f"lm; card {n_g}/4, {sg.n_keyframes()} kf, {sg.n_landmarks()} lm; "
          f"max camera-centre difference {dC:.2e} m (limit 5e-2)",
          flush=True)
    if n_c != 4 or n_g != 4 or dC > 5e-2:
        raise SystemExit("card and CPU disagree on the small input")
    _sync()

    phase("5. where the time goes: torch.profiler over frames 20..25")
    profile_main_path(caps, seq, 20, 6, W, H, f)

    kernels_out = [
        dict(name="window_match_topk2", route="cuda",
             source="dani_slam_tpu_torch/csrc/window_match.cu",
             replaces="dani_slam_tpu/ops/pallas_kernels.py:168",
             launches=launches["window_match_topk2"], max_abs_err=err1,
             **k1),
        dict(name="lba_landmark_blocks", route="cuda",
             source="dani_slam_tpu_torch/csrc/lba_blocks.cu",
             replaces="dani_slam_tpu/ops/pallas_kernels.py:265",
             launches=launches["lba_landmark_blocks"], max_abs_err=err2,
             **k2),
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
