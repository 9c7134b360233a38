"""Perspective-n-Point RANSAC, vectorized (counterpart of
dani_slam_tpu/ops/pnp.py; reference MLPnPsolver inside a RANSAC loop,
src/Tracking.cc:3714).

All hypotheses are solved at once: a 6-point DLT per hypothesis (batched
SVD of [12, 12] systems), every hypothesis scored against all
correspondences in one masked reduction, and the best one polished with the
LM pose optimizer (ops/solvers.pose_optimize). Works on unprojected rays.

Translation note: the reference draws its minimal sets with
jax.random.categorical over the match mask (+1e-6); here `key` is either a
torch.Generator — the same rule through the Gumbel-max trick, which is what
jax.random.categorical computes, on the generator's own stream — or a
precomputed [n_hypo, 6] index tensor, so that a test can replay the JAX
draws. The SVDs' signs and order may differ between the libraries; the
poses and inlier sets they lead to do not.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.core import scatterless as sless
from dani_slam_tpu_torch.ops import linalg, solvers


class PnPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def draw_samples(key, mask: torch.Tensor, n_hypo: int, k: int):
    """[n_hypo, k] int64 indices, each drawn independently with probability
    proportional to mask + 1e-6 (categorical through Gumbel-max noise from
    the generator `key`); a tensor `key` is taken as the indices
    themselves."""
    if isinstance(key, torch.Tensor):
        return key.to(device=mask.device, dtype=torch.int64)
    N = mask.shape[0]
    logits = torch.log(mask.to(torch.float32) + 1e-6)
    u = torch.rand((n_hypo, k, N), generator=key, device=key.device)
    u = u.to(mask.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


def _dlt_p6(X: torch.Tensor, rays: torch.Tensor):
    """Batched 6-point DLT: world points X (B,6,3), normalized rays (B,6,3)
    -> (R, t) from P = [R|t] up to scale, R projected onto SO(3)."""
    x = rays[..., 0] / rays[..., 2]
    y = rays[..., 1] / rays[..., 2]
    Xh = torch.cat([X, torch.ones(X.shape[:-1] + (1,), dtype=X.dtype,
                                  device=X.device)], dim=-1)   # B,6,4
    zero = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zero, -x[..., None] * Xh], dim=-1)
    r2 = torch.cat([zero, Xh, -y[..., None] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                             # B,12,12
    _, _, Vt = linalg.svd(A)
    P = Vt[..., 11, :].reshape(A.shape[:-2] + (3, 4))
    M = P[..., :3]
    U, S, Vt2 = linalg.svd(M)
    det = torch.linalg.det(U @ Vt2)
    scale = torch.mean(S, dim=-1) * det
    ones = torch.ones_like(det)
    R = U @ torch.diag_embed(torch.stack([ones, ones, det], dim=-1)) @ Vt2
    t = P[..., 3] / scale[..., None]
    return R, t


def pnp_ransac(key, cam, pts_w: torch.Tensor, obs_xy: torch.Tensor,
               mask: torch.Tensor, n_hypo: int = 256,
               th_px: float = 5.991 ** 0.5,
               min_inliers: int = 12) -> PnPResult:
    """Robust pose from 2D-3D matches: pts_w [N,3] world points, obs_xy [N,2]
    pixels, mask [N] valid matches; `key` a torch.Generator or [n_hypo, 6]
    sample indices."""
    N = pts_w.shape[0]
    rays = _cam.unproject(cam, obs_xy)
    idx = draw_samples(key, mask, n_hypo, 6)
    n_hypo = idx.shape[0]
    R, t = _dlt_p6(pts_w[idx], rays[idx])

    pc = torch.einsum('bij,nj->bni', R, pts_w) + t[:, None]
    proj = _cam.project(cam, pc.reshape(-1, 3)).reshape(n_hypo, N, 2)
    err = torch.sum((proj - obs_xy[None]) ** 2, dim=-1)
    inl = (err < th_px ** 2) & mask[None] & (pc[..., 2] > 0)
    counts = torch.sum(inl.to(torch.int32), dim=-1)
    best = torch.argmax(counts)

    res = solvers.pose_optimize(sless.row(R, best), sless.row(t, best), cam,
                                pts_w, obs_xy, sless.row(inl, best))
    ok = res.n_inliers >= min_inliers
    return PnPResult(res.R, res.t, res.inliers, res.n_inliers, ok)
