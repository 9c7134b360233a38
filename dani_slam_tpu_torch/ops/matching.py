"""Data association: projected-window descriptor matching, mutual-NN
matching, fuse candidates (counterpart of dani_slam_tpu/ops/matching.py).

Every search is one masked distance matrix (descriptors are unit-norm, so
L2^2 = 2 - 2 q.t) with the pixel-window / scale / view-angle predicates as a
mask, then row/column argmins with ratio, threshold and mutual tests. The
functions take optional leading batch dims where the JAX package vmaps them
(mapping's batched neighbor searches).

search_by_projection_bind always goes through ops/kernels.window_match_topk2:
on CUDA tensors that launches the CUDA kernel (tensor-core dot) for any M
and N; on the CPU the wrapper runs its plain version, with which the kernel
agrees within atol 1e-4 on distances and in its indices up to near-ties.
Either way the port follows the KERNEL's semantics (bf16 dot, squared
distance against th^2) — the JAX package's TPU path; its CPU path instead
compares f32 sqrt distances against th.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.ops import kernels

TH_HIGH = 0.9
TH_LOW = 0.4
INF = float("inf")


class Matches(NamedTuple):
    """Fixed-size match set: for each query row, the matched target index."""
    idx: torch.Tensor     # [..., M] int64 target index (undefined where ~ok)
    dist: torch.Tensor    # [..., M] descriptor distance
    ok: torch.Tensor      # [..., M] bool


def predict_scale_level(dist, dist_max, scale_factor: float = 1.2,
                        max_level: int = 7):
    """Predicted pyramid level of a landmark at viewing distance `dist`
    (reference: MapPoint::PredictScale)."""
    ratio = torch.clamp(dist_max, min=1e-9) / torch.clamp(dist, min=1e-9)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1.0)) /
                     torch.log(torch.tensor(scale_factor,
                                            dtype=torch.float32)).item())
    return torch.clamp(lvl, 0, max_level)


def desc_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise L2 distance between unit descriptors a [...,M,D], b [...,N,D]
    (f32 matmul; TF32 is off, see System)."""
    dots = torch.matmul(a, b.transpose(-1, -2))
    return torch.sqrt(torch.clamp(2.0 - 2.0 * dots, min=0.0))


def masked_match(dist, mask, th: float = TH_HIGH, ratio=None,
                 mutual: bool = False) -> Matches:
    """Row-wise best match of a masked distance matrix [..., M, N] with
    distance threshold, optional Lowe ratio and mutual-best check."""
    big = torch.where(mask, dist, torch.full_like(dist, INF))
    j = torch.argmin(big, dim=-1)
    d1 = torch.gather(big, -1, j[..., None])[..., 0]
    ok = torch.isfinite(d1) & (d1 < th)
    if ratio is not None:
        col = torch.arange(big.shape[-1], device=big.device)
        d2 = torch.amin(torch.where(col == j[..., None],
                                    torch.full_like(big, INF), big), dim=-1)
        ok = ok & (d1 < ratio * d2)
    if mutual:
        i_best = torch.argmin(big, dim=-2)                      # [..., N]
        ok = ok & (torch.gather(i_best, -1, j) ==
                   torch.arange(big.shape[-2], device=big.device))
    return Matches(j, d1, ok)


def resolve_duplicate_targets(m: Matches, n_targets: int) -> Matches:
    """Keep only the best query per target keypoint (first row wins ties)."""
    M = m.idx.shape[-1]
    iota_t = torch.arange(n_targets, device=m.idx.device)
    hit = (iota_t == m.idx[..., None]) & m.ok[..., None]       # [..., M, T]
    d = torch.where(hit, m.dist[..., None],
                    torch.full_like(hit, INF, dtype=m.dist.dtype))
    win = torch.argmin(d, dim=-2)                              # [..., T]
    keep = m.ok & (torch.gather(win, -1, m.idx) ==
                   torch.arange(M, device=m.idx.device))
    return Matches(m.idx, m.dist, keep)


def _window_mask(proj_xy, proj_valid, kp_xy, kp_valid, radius):
    dx = proj_xy[..., :, None, 0] - kp_xy[..., None, :, 0]
    dy = proj_xy[..., :, None, 1] - kp_xy[..., None, :, 1]
    # a Python radius stays a Python number: a tensor made of it would be a
    # host-to-device copy that waits (torch's sync debug mode flags it)
    r2 = radius * radius if not isinstance(radius, torch.Tensor) else \
        (radius * radius if radius.ndim == 0 else
         (radius * radius)[..., :, None])
    return ((dx * dx + dy * dy) <= r2) & proj_valid[..., :, None] & \
        kp_valid[..., None, :]


def search_by_projection(proj_xy, proj_valid, query_desc, kp_xy, kp_valid,
                         kp_desc, radius, th_desc: float = TH_HIGH,
                         ratio=None, mutual: bool = False) -> Matches:
    """Generic projected-window search (queries [..., M], keypoints
    [..., N]); large query sets (M > 4096) use the dense mutual-best rule,
    small ones the best-per-target rule, as in the reference package."""
    d = desc_distance_matrix(query_desc, kp_desc)
    mask = _window_mask(proj_xy, proj_valid, kp_xy, kp_valid, radius)
    if proj_xy.shape[-2] > 4096:
        return masked_match(d, mask, th=th_desc, ratio=ratio, mutual=True)
    m = masked_match(d, mask, th=th_desc, ratio=ratio, mutual=mutual)
    return resolve_duplicate_targets(m, kp_xy.shape[-2])


def search_by_projection_bind(proj_xy, proj_valid, query_desc, kp_xy,
                              kp_valid, kp_desc, radius,
                              th_desc: float = TH_HIGH):
    """Target-side projected-window search: per KEYPOINT n, (query_idx [N],
    dist [N], ok [N]) — the mutual-best query, or ok=False — through
    kernels.window_match_topk2 (track-local-map; reference
    SearchByProjection LGmatcher.cpp:43)."""
    _, _, j, cbest, ci = kernels.window_match_topk2(
        query_desc, proj_xy, proj_valid, kp_desc, kp_xy, kp_valid, radius)
    cd = torch.sqrt(torch.clamp(cbest, min=0.0))
    ok = (cbest < th_desc * th_desc) & \
        (j[ci.long()] == torch.arange(kp_xy.shape[0], device=j.device))
    return ci.long(), cd, ok


def search_for_initialization(kp0_xy, kp0_valid, desc0, kp1_xy, kp1_valid,
                              desc1, window: float = 100.0,
                              ratio: float = 0.9,
                              th_desc: float = TH_LOW * 2) -> Matches:
    """Monocular-init matching: windowed (100 px) mutual nearest neighbour
    with a ratio test (reference: SearchForInitialization)."""
    return search_by_projection(kp0_xy, kp0_valid, desc0, kp1_xy, kp1_valid,
                                desc1, radius=window, th_desc=th_desc,
                                ratio=ratio, mutual=True)


def project_landmarks(R_cw, t_cw, cam, lm_pos, lm_mask, lm_normal=None,
                      lm_dist_min=None, lm_dist_max=None,
                      min_view_cos: float = 0.5):
    """Project landmarks [..., L, 3] into a frame (R_cw [..., 3, 3]) with the
    reference's isInFrustum predicates. Returns (xy, visible, view_cos,
    dist)."""
    pc = torch.einsum('...ij,...lj->...li', R_cw, lm_pos) + t_cw[..., None, :]
    z = pc[..., 2]
    xy = _cam.project(cam, pc)
    inside = ((xy[..., 0] >= 0) & (xy[..., 0] < cam.width) &
              (xy[..., 1] >= 0) & (xy[..., 1] < cam.height))
    dist = torch.linalg.norm(pc, dim=-1)
    vis = lm_mask & (z > 0.05) & inside
    view_cos = torch.ones_like(z)
    if lm_normal is not None:
        C = -torch.einsum('...ji,...j->...i', R_cw, t_cw)
        po = lm_pos - C[..., None, :]
        view_cos = torch.einsum('...li,...li->...l', po, lm_normal) / \
            torch.clamp(torch.linalg.norm(po, dim=-1) *
                        torch.linalg.norm(lm_normal, dim=-1), min=1e-9)
        vis = vis & (view_cos > min_view_cos)
    if lm_dist_min is not None:
        vis = vis & (dist >= 0.8 * lm_dist_min) & (dist <= 1.2 * lm_dist_max)
    return xy, vis, view_cos, dist


def fuse_candidates(proj_xy, proj_valid, lm_desc, kp_xy, kp_valid, kp_desc,
                    radius: float = 3.0, th_desc: float = TH_LOW * 1.5):
    """Per projected landmark, the keyframe keypoint it should bind to
    (stricter threshold, mutual-best)."""
    return search_by_projection(proj_xy, proj_valid, lm_desc, kp_xy,
                                kp_valid, kp_desc, radius=radius,
                                th_desc=th_desc, mutual=True)
