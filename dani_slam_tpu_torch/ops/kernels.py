"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(counterpart of dani_slam_tpu/ops/pallas_kernels.py).

  window_match_topk2   <- pallas_kernels.window_match_topk2 (csrc/window_match.cu)
  lba_landmark_blocks  <- pallas_kernels.lba_landmark_blocks (csrc/lba_blocks.cu)
  lba_plan             the fixed-order reduction plan of lba_landmark_blocks,
                       built on the device without a sort (csrc/lba_blocks.cu)

window_match_topk2 is bound by operations on an H100 (1.6 GFLOP of bf16
products against 4 MB at the main-path shape), so its dot runs on the tensor
cores: the targets are rounded to bf16 once per call into the shared-memory
image of each 128-column tile, a block of two warpgroups keeps 64 query rows
resident in bf16 and sweeps the tiles through a two-stage ring filled by bulk
asynchronous copies on mbarriers, `wgmma` accumulates in f32 registers, and
the masking, the row top-2 and the column winners happen in registers. The
tensor cores add the 256 exact products in another order (and may truncate)
than the plain version's ascending-k sum, so the two agree within atol 1e-4
on distances and in every index except on near-ties, not bit for bit:
`window_match_agreement` states the rule. lba_landmark_blocks is bound by
bytes (a gather-and-add over ~16k observations, 4 MB); it follows a plan
with a fixed summation order (`lba_plan`: integer histogram, scan, fill,
rank — no sort, no float atomics), keeps several observations' loads in
flight, and writes all of H_pl once; it agrees with its plain version
within rtol/atol 1e-5 (another summation order) and is bitwise repeatable.
The source note at the head of each .cu file gives the design in full.

Each CUDA source is compiled at first use with nvcc for sm_90a into a shared
library with a plain C interface under build/kernels/ (one nvcc per source,
all started together) and loaded with ctypes. A wrapper takes its plain
version (`*_ref`) only for tensors on the CPU; for CUDA tensors it launches
its kernel on PyTorch's current stream or raises — there is no fallback. A
call of a wrapper on CUDA tensors is one C call plus the allocation of its
outputs and scratch with torch.empty. Each wrapper counts its launches in
`<wrapper>.launches`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

BIG = 1e9
# a packed column winner no row has reached yet: (float_bits(BIG) << 32) | row 0
_BIG_PACKED = int(np.float32(BIG).view(np.int32)) << 32

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = {"window_match": "window_match.cu", "lba_blocks": "lba_blocks.cu",
           "launch_floor": "launch_floor.cu"}
MAX_D = 256           # descriptor depth window_match.cu holds in shared memory
MAX_P = 128           # keyframe rows lba_blocks.cu stages in shared memory
MAX_L = 25000         # histogram bins lba_plan's kernel holds in shared memory
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}      # library name -> path of the loaded .so
_FNS: dict = {}       # C entry point name -> bound ctypes function


def _nvcc() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _bind(name: str, lib: ctypes.CDLL) -> dict:
    """The C entry points of one library, by function name."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "window_match":
        sigs = {"window_match_topk2_launch":
                ([vp] * 4 + [f] + [vp] * 3 + [i, i, i] + [vp] * 6,
                 ctypes.c_int),
                "window_match_scratch_bytes": ([i, i, i], ctypes.c_long)}
    elif name == "lba_blocks":
        sigs = {"lba_landmark_blocks_launch":
                ([vp] * 3 + [i, i, i] + [vp] * 4, ctypes.c_int),
                "lba_plan_launch": ([vp, i, i, i] + [vp] * 4, ctypes.c_int)}
    else:
        sigs = {"launch_floor_launch": ([vp], ctypes.c_int)}
    fns = {}
    for fname, (argtypes, restype) in sigs.items():
        fn = getattr(lib, fname)
        fn.argtypes = argtypes
        fn.restype = restype
        fns[fname] = fn
    return fns


def build_kernels() -> float:
    """Compile (where not yet built) and load every kernel library. Sources
    are compiled in parallel; a library's file name carries a hash of its
    source, so an edit never reuses a stale build. Returns the seconds
    spent. nvcc's ptxas report (registers, shared memory, spills) is kept
    beside each library as <name>.log."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {}
    for name, src in SOURCES.items():
        if name in _LIBS:
            continue
        path = os.path.join(CSRC, src)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        out = os.path.join(BUILD_DIR, f"{name}_{digest}.so")
        todo[name] = (path, out)
    procs = {}
    for name, (path, out) in todo.items():
        if not os.path.exists(out):
            procs[name] = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", out + ".tmp", path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        out = todo[name][1]
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "wb") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
        else:
            os.replace(out + ".tmp", out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    for name, (_, out) in todo.items():
        _FNS.update(_bind(name, ctypes.CDLL(out)))
        _LIBS[name] = out
    return time.perf_counter() - t0


def _launch_fn(fname: str):
    if fname not in _FNS:
        build_kernels()
    return _FNS[fname]


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if (t.dtype == dtype and t.shape == shape and t.device == device and
            t.is_contiguous()):
        return
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _stream(device: torch.device) -> int:
    """PyTorch's current stream on `device` as the raw handle the C entry
    points take. The private accessor returns it without building a Stream
    object (several microseconds a call); the public path is the fallback."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        idx = device.index
        return raw(torch.cuda.current_device() if idx is None else idx)
    return torch.cuda.current_stream(device).cuda_stream


def launch_counts() -> dict:
    return {"window_match_topk2": window_match_topk2.launches,
            "lba_landmark_blocks": lba_landmark_blocks.launches,
            "lba_plan": lba_plan.launches}


def reset_launch_counts():
    window_match_topk2.launches = 0
    lba_landmark_blocks.launches = 0
    lba_plan.launches = 0


def launch_floor():
    """Launch an empty kernel through the same kind of C entry point as the
    kernels: what any separately launched kernel costs at least."""
    _raise_on(_launch_fn("launch_floor_launch")(
        _stream(torch.device("cuda"))), "launch_floor launch")


# ---------------------------------------------------------------------------
# Kernel 1: masked window match with row top-2 and column winners
# ---------------------------------------------------------------------------

def _radius2(radius, M: int, device) -> torch.Tensor:
    r = torch.as_tensor(radius, dtype=torch.float32, device=device)
    r = torch.broadcast_to(r, (M,))
    return (r * r).contiguous()


def window_match_dist_ref(qdesc, qxy, qvalid, tdesc, txy, tvalid, radius):
    """The plain version's masked distance matrix [M,N]: squared L2 of the
    bf16-rounded descriptors, the dot accumulated in ascending k with one
    rounding per product and per sum, BIG outside the query's window or
    where either side is invalid."""
    M, D = qdesc.shape
    q = qdesc.to(torch.bfloat16).to(torch.float32)
    t = tdesc.to(torch.bfloat16).to(torch.float32)
    dots = torch.zeros((M, t.shape[0]), dtype=torch.float32,
                       device=qdesc.device)
    for k in range(D):
        dots.add_(q[:, k, None] * t[None, :, k])
    dist = torch.clamp(2.0 - 2.0 * dots, min=0.0)
    r2 = _radius2(radius, M, qdesc.device)
    dx = qxy[:, None, 0] - txy[None, :, 0]
    dy = qxy[:, None, 1] - txy[None, :, 1]
    mask = ((dx * dx + dy * dy) <= r2[:, None]) & tvalid[None, :] & \
        qvalid[:, None]
    return torch.where(mask, dist, torch.full_like(dist, BIG))


def window_match_reduce_ref(dist):
    """Row top-2 with argmin and column winners of a masked distance matrix:
    (best [M], second [M], idx [M] i32, col_best [N], col_idx [N] i32)."""
    idx = torch.argmin(dist, dim=1)
    best = torch.amin(dist, dim=1)
    col = torch.arange(dist.shape[1], device=dist.device)[None, :]
    second = torch.amin(torch.where(col == idx[:, None],
                                    torch.full_like(dist, BIG), dist), dim=1)
    cbest = torch.amin(dist, dim=0)
    cidx = torch.argmin(dist, dim=0)
    return (best, second, idx.to(torch.int32), cbest,
            cidx.to(torch.int32))


def window_match_topk2_ref(qdesc, qxy, qvalid, tdesc, txy, tvalid, radius):
    """Plain PyTorch version of window_match_topk2 (port of the reference's
    window_match_topk2_xla oracle), ascending-k f32 sums of the exact bf16
    products. The CUDA kernel adds the same products on the tensor cores in
    another order, so it agrees with this within atol 1e-4, not bit for bit
    (window_match_agreement)."""
    return window_match_reduce_ref(window_match_dist_ref(
        qdesc, qxy, qvalid, tdesc, txy, tvalid, radius))


def window_match_agreement(out, ref_out, ref_dist, atol: float = 1e-4):
    """Hold the five outputs `out` of a window match against the plain
    version's `ref_out` and its masked distance matrix `ref_dist` [M,N].

    The dot's 256 products are exact in f32, so implementations differ only
    in the order and rounding of the sum: |d dist| <= 2 * 255 * 2^-24 *
    sum |q_k t_k| <= 3e-5 for unit descriptors, and an order statistic moves
    by no more than the largest entry-wise change. The rule: best, second
    and col_best within `atol`, with equal found sets (< 1e8); an index may
    differ from the plain version's only on a near-tie, i.e. the plain
    distance at the index given is within `atol` of the plain minimum (rows
    and columns without any admissible pair must give index 0).

    Returns a dict: ok, max_abs_err, idx_differ, col_idx_differ (indices
    that differ, all of them near-ties when ok) and why (the failed checks).
    """
    best, second, idx, cbest, cidx = out
    rbest, rsecond, ridx, rcbest, rcidx = ref_out
    M, N = ref_dist.shape
    why = []
    err = 0.0
    for name, a, b in (("best", best, rbest), ("second", second, rsecond),
                       ("col_best", cbest, rcbest)):
        found = b < 1e8
        if not torch.equal(a < 1e8, found):
            why.append(f"{name}: found set differs")
            continue
        if bool(found.any()):
            e = float(torch.max(torch.abs(a[found] - b[found])))
            err = max(err, e)
            if not e <= atol:
                why.append(f"{name}: max |err| {e:.3g} > {atol}")
    n_diff = []
    for name, i, ri, mn, size, along in (("idx", idx, ridx, rbest, N, 1),
                                         ("col_idx", cidx, rcidx, rcbest, M,
                                          0)):
        i, ri = i.long(), ri.long()
        found = mn < 1e8
        if bool(((i < 0) | (i >= size)).any()):
            why.append(f"{name}: out of range")
            n_diff.append(int((i != ri).sum()))
            continue
        at = torch.gather(ref_dist, along, i[:, None] if along else
                          i[None, :]).reshape(-1)
        bad = torch.where(found, torch.abs(at - mn) > atol, i != 0)
        if bool(bad.any()):
            why.append(f"{name}: {int(bad.sum())} indices off a near-tie")
        n_diff.append(int((i != ri).sum()))
    return dict(ok=not why, max_abs_err=err, idx_differ=n_diff[0],
                col_idx_differ=n_diff[1], why=why)


def window_match_topk2(qdesc, qxy, qvalid, tdesc, txy, tvalid, radius):
    """Fused masked window match. qdesc [M,D] f32, qxy [M,2], qvalid [M]
    bool; tdesc [N,D], txy [N,2], tvalid [N] bool; radius scalar or [M].
    Returns (best [M], second [M], idx [M] i32, col_best [N], col_idx [N]
    i32); SQUARED L2 distances, BIG where no admissible pair exists. Any M
    and N >= 1; an empty target set is refused on every device, D > 256 on
    the card. On CUDA tensors the outputs are views of two buffers (the
    column outputs strided): the wrapper costs the host three allocations,
    four views and one C call."""
    dev = qdesc.device
    if tdesc.shape[0] == 0:
        raise ValueError("window_match_topk2: no targets (N == 0)")
    if dev.type == "cpu":
        return window_match_topk2_ref(qdesc, qxy, qvalid, tdesc, txy, tvalid,
                                      radius)
    if dev.type != "cuda":
        raise ValueError(f"window_match_topk2: unsupported device {dev}")
    M, D = qdesc.shape
    N = tdesc.shape[0]
    if D > MAX_D:
        raise ValueError(f"window_match_topk2: D = {D} > {MAX_D}")
    for t, n, dt, shp in ((qdesc, "qdesc", torch.float32, (M, D)),
                          (qxy, "qxy", torch.float32, (M, 2)),
                          (qvalid, "qvalid", torch.bool, (M,)),
                          (tdesc, "tdesc", torch.float32, (N, D)),
                          (txy, "txy", torch.float32, (N, 2)),
                          (tvalid, "tvalid", torch.bool, (N,))):
        _check(t, n, dt, shp, dev)
    if isinstance(radius, (int, float, np.floating, np.integer)):
        r_ptr, r_scalar = None, float(radius)
    else:
        if not (isinstance(radius, torch.Tensor) and radius.device == dev and
                radius.dtype == torch.float32 and radius.shape == (M,) and
                radius.is_contiguous()):
            radius = torch.broadcast_to(
                torch.as_tensor(radius, dtype=torch.float32, device=dev),
                (M,)).contiguous()
        r_ptr, r_scalar = radius.data_ptr(), 0.0
    fn = _launch_fn("window_match_topk2_launch")
    rows = torch.empty((3, M), dtype=torch.float32, device=dev)
    # packed column winners, one 64-bit word each, as their 32-bit halves
    halves = torch.empty((N, 2), dtype=torch.int32, device=dev)
    scratch = torch.empty(_FNS["window_match_scratch_bytes"](M, N, D),
                          dtype=torch.uint8, device=dev)
    p_rows = rows.data_ptr()
    err = fn(qdesc.data_ptr(), qxy.data_ptr(), qvalid.data_ptr(), r_ptr,
             r_scalar, tdesc.data_ptr(), txy.data_ptr(), tvalid.data_ptr(),
             M, N, D, scratch.data_ptr(), p_rows, p_rows + 4 * M,
             p_rows + 8 * M, halves.data_ptr(), _stream(dev))
    _raise_on(err, "window_match_topk2 launch")
    window_match_topk2.launches += 1
    best, second, idx = rows.unbind(0)
    return (best, second, idx.view(torch.int32)) + _unpack_halves(halves)


def _unpack_halves(halves: torch.Tensor):
    """The 32-bit halves [N,2] of the packed column winners (little-endian:
    the row is the low word) -> (col_best [N] f32, col_idx [N] i32), as
    strided views."""
    col_idx, col_bits = halves.unbind(1)
    return col_bits.view(torch.float32), col_idx


def unpack_col_winners(colwin: torch.Tensor):
    """Packed column winners [N] int64, (float_bits(dist) << 32) | row, ->
    (col_best [N] f32, col_idx [N] i32)."""
    return _unpack_halves(colwin.view(torch.int32).view(-1, 2))


window_match_topk2.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2: local-BA landmark-block reduction
# ---------------------------------------------------------------------------

def lba_plan_ref(row_lm: torch.Tensor, L: int):
    """Plain PyTorch version of lba_plan: a stable sort of the flat
    observation ids by (landmark, row), and a binary search for the
    per-landmark segment offsets."""
    P, N = row_lm.shape
    dev = row_lm.device
    flat = row_lm.reshape(-1).long()
    p = torch.arange(P * N, device=dev) // N
    ok = (flat >= 0) & (flat < L)
    key = torch.where(ok, flat * P + p, torch.full_like(flat, L * P))
    order = torch.argsort(key, stable=True)
    bounds = torch.arange(L + 1, device=dev) * P
    lm_off = torch.searchsorted(key[order], bounds)
    return order.to(torch.int32), lm_off.to(torch.int32)


def lba_plan(row_lm: torch.Tensor, L: int):
    """Fixed-order reduction plan for lba_landmark_blocks: (perm [P*N] i32,
    lm_off [L+1] i32). perm lists the flat observation ids p*N+n landmark by
    landmark, each landmark's segment perm[lm_off[l]:lm_off[l+1]] ascending
    (keyframe rows, then n), followed by the observations without a
    landmark (id < 0 or >= L), ascending. ba_solve builds it once per solve
    (the ids do not change across LM iterations). On CUDA tensors one
    kernel builds it (histogram, scan, row-ordered fill: no sort); on the
    CPU the
    plain version does, and the two are equal."""
    dev = row_lm.device
    if dev.type == "cpu":
        return lba_plan_ref(row_lm, L)
    if dev.type != "cuda":
        raise ValueError(f"lba_plan: unsupported device {dev}")
    P, N = row_lm.shape
    _check(row_lm, "row_lm", torch.int32, (P, N), dev)
    if P * N == 0 or not 0 <= L <= MAX_L:
        raise ValueError(f"lba_plan: P*N = {P * N}, L = {L} (needs P*N >= 1 "
                         f"and 0 <= L <= {MAX_L})")
    fn = _launch_fn("lba_plan_launch")
    buf = torch.empty(2 * P * N + L + 1, dtype=torch.int32, device=dev)
    perm, scratch, lm_off = buf[:P * N], buf[P * N:2 * P * N], buf[2 * P * N:]
    err = fn(row_lm.data_ptr(), P, N, L, perm.data_ptr(), lm_off.data_ptr(),
             scratch.data_ptr(), _stream(dev))
    _raise_on(err, "lba_plan launch")
    lba_plan.launches += 1
    return perm, lm_off


lba_plan.launches = 0


def lba_landmark_blocks_ref(row_lm, vals, L: int):
    """Plain PyTorch version (port of lba_landmark_blocks_xla): one-hot
    contraction in f32. Returns (H_ll [L,3,3], g_l [L,3], H_pl [P,L,6,3])."""
    P, N = row_lm.shape
    ids = torch.where(row_lm >= 0, row_lm, torch.full_like(row_lm, L))
    onehot = (ids[:, :, None] == torch.arange(L, dtype=row_lm.dtype,
                                              device=row_lm.device)
              ).to(vals.dtype)
    out = torch.einsum('pnl,pnc->plc', onehot, vals)             # [P,L,30]
    H_ll = torch.sum(out[..., :9], dim=0).reshape(L, 3, 3)
    g_l = torch.sum(out[..., 9:12], dim=0)
    return H_ll, g_l, out[..., 12:].reshape(P, L, 6, 3)


def lba_landmark_blocks(row_lm, vals, L: int, plan):
    """Landmark-block reduction for ba_solve. row_lm [P,N] int32 local
    landmark id per observation (-1 invalid); vals [P,N,30] f32
    [JtJ_l(9) | b_l(3) | JtJ_pl(18)]; plan = lba_plan(row_lm, L), which the
    caller builds once for all calls on the same ids (the plain version on
    the CPU does not read it). Returns (H_ll [L,3,3], g_l [L,3],
    H_pl [P,L,6,3]). Any L and N on the card, P <= 128."""
    dev = vals.device
    if dev.type == "cpu":
        return lba_landmark_blocks_ref(row_lm, vals, L)
    if dev.type != "cuda":
        raise ValueError(f"lba_landmark_blocks: unsupported device {dev}")
    P, N = row_lm.shape
    if P > MAX_P:
        raise ValueError(f"lba_landmark_blocks: P = {P} > {MAX_P}")
    _check(row_lm, "row_lm", torch.int32, (P, N), dev)
    _check(vals, "vals", torch.float32, (P, N, 30), dev)
    perm, lm_off = plan
    _check(perm, "perm", torch.int32, (P * N,), dev)
    _check(lm_off, "lm_off", torch.int32, (L + 1,), dev)
    fn = _launch_fn("lba_landmark_blocks_launch")
    H_ll = torch.empty((L, 3, 3), dtype=torch.float32, device=dev)
    g_l = torch.empty((L, 3), dtype=torch.float32, device=dev)
    H_pl = torch.empty((P, L, 6, 3), dtype=torch.float32, device=dev)
    err = fn(vals.data_ptr(), perm.data_ptr(), lm_off.data_ptr(), P, L, N,
             H_ll.data_ptr(), g_l.data_ptr(), H_pl.data_ptr(), _stream(dev))
    _raise_on(err, "lba_landmark_blocks launch")
    lba_landmark_blocks.launches += 1
    return H_ll, g_l, H_pl


lba_landmark_blocks.launches = 0
