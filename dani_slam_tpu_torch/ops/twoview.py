"""Two-view reconstruction for monocular initialization (counterpart of
dani_slam_tpu/ops/twoview.py; reference TwoViewReconstruction: 8-point
essential and 4-point homography RANSAC, score-ratio model selection, motion
recovery with the CheckRT triangulation census).

Every hypothesis is evaluated at once: n_hypo 8-point essential matrices and
n_hypo 4-point homographies from batched SVDs, all residuals in one masked
pass, the best of each by argmax; the 4 motions of the chosen model are
censused together.

Translation notes:
  * the hypotheses' minimal sets are drawn as in ops/pnp.draw_samples: `key`
    is a torch.Generator (Gumbel-max over the pair mask + 1e-6, the rule of
    jax.random.categorical) or a pair (idx_e [n_hypo, 8], idx_h [n_hypo, 4])
    of index tensors, so that a test can replay the JAX draws;
  * torch.linalg.svd and jnp.linalg.svd may return singular vectors of
    other signs; E and H are defined up to sign and every score, residual
    and census is sign-free, but the four essential candidates can come out
    in another order: what agrees between the two packages is the chosen
    motion and its census, not a candidate's index;
  * on the card each of the six SVDs of an attempt waits for cuSOLVER's
    status (ops/linalg.svd counts it in utils/device.SYNCS), so an init
    attempt costs six blocking reads beyond the tracker's decisions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.core import lie
from dani_slam_tpu_torch.core import scatterless as sless
from dani_slam_tpu_torch.ops import linalg
from dani_slam_tpu_torch.ops.pnp import draw_samples
from dani_slam_tpu_torch.utils.device import const


class TwoViewResult(NamedTuple):
    R21: torch.Tensor        # (3,3) maps view-1 coordinates to view 2
    t21: torch.Tensor        # (3,) unit-norm translation
    pts3d: torch.Tensor      # [N,3] triangulated points (view-1 frame)
    inliers: torch.Tensor    # [N] bool (triangulation census survivors)
    n_inliers: torch.Tensor  # [] int32
    ok: torch.Tensor         # [] bool: reconstruction accepted
    used_h: torch.Tensor     # [] bool: homography model chosen


def _eight_point(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Batched 8-point essential solve on (B,8,3) ray pairs; (B,3,3) E with
    the singular values projected onto (s, s, 0)."""
    x1, y1, z1 = r1[..., 0], r1[..., 1], r1[..., 2]
    x2, y2, z2 = r2[..., 0], r2[..., 1], r2[..., 2]
    A = torch.stack([x2 * x1, x2 * y1, x2 * z1, y2 * x1, y2 * y1, y2 * z1,
                     z2 * x1, z2 * y1, z2 * z1], dim=-1)        # (B,8,9)
    _, _, Vh = linalg.svd(A, full_matrices=True)
    E = Vh[..., 8, :].reshape(r1.shape[:-2] + (3, 3))
    U, S, Vh2 = linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) / 2
    Sfix = torch.diag_embed(torch.stack([s, s, torch.zeros_like(s)], -1))
    return U @ Sfix @ Vh2


def _four_point_h(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Batched 4-point homography DLT on (B,4,3) normalized rays."""
    x1 = r1[..., 0] / r1[..., 2]
    y1 = r1[..., 1] / r1[..., 2]
    x2 = r2[..., 0] / r2[..., 2]
    y2 = r2[..., 1] / r2[..., 2]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    row1 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    row2 = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], -1)
    A = torch.cat([row1, row2], dim=-2)                         # (B,8,9)
    _, _, Vh = linalg.svd(A, full_matrices=True)
    return Vh[..., 8, :].reshape(r1.shape[:-2] + (3, 3))


def _sampson_sq(E: torch.Tensor, r1: torch.Tensor,
                r2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance of all pairs under each model: E (B,3,3),
    r1/r2 (N,3) -> (B,N)."""
    Ex1 = torch.einsum('bij,nj->bni', E, r1)
    Etx2 = torch.einsum('bji,nj->bni', E, r2)
    x2Ex1 = torch.einsum('ni,bni->bn', r2, Ex1)
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 +
           Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return x2Ex1 ** 2 / torch.clamp(den, min=1e-12)


def _h_transfer_sq(H: torch.Tensor, r1: torch.Tensor,
                   r2: torch.Tensor) -> torch.Tensor:
    """Symmetric squared transfer error of H on normalized coords (B,N)."""
    def transfer(Hm, a, b):
        p = torch.einsum('bij,nj->bni', Hm, a)
        w = torch.where(torch.abs(p[..., 2]) < 1e-12,
                        torch.full_like(p[..., 2], 1e-12), p[..., 2])
        bx = b[..., 0] / b[..., 2]
        by = b[..., 1] / b[..., 2]
        return (p[..., 0] / w - bx) ** 2 + (p[..., 1] / w - by) ** 2
    # inv_ex: the inverse without inv's error check, a host read on the card
    return transfer(H, r1, r2) + transfer(torch.linalg.inv_ex(H).inverse,
                                          r2, r1)


def decompose_essential(E: torch.Tensor):
    """E (...,3,3) -> 4 candidate motions (Ra,t), (Ra,-t), (Rb,t), (Rb,-t):
    Rs (...,4,3,3), ts (...,4,3)."""
    U, _, Vh = linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vh = Vh * torch.sign(torch.linalg.det(Vh))[..., None, None]
    W = const(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
              E.dtype, E.device)
    Ra = U @ W @ Vh
    Rb = U @ W.T @ Vh
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                        min=1e-12)
    return (torch.stack([Ra, Ra, Rb, Rb], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def _decompose_homography(H: torch.Tensor):
    """Calibrated homography motions (4 candidates) of H = R + t n^T after
    normalization by sigma_2 (simplified Zhang/Faugeras decomposition).
    Returns (4,3,3) R and (4,3) unit t."""
    U, S, Vh = linalg.svd(H)
    s1, s2, s3 = S[0], S[1], S[2]
    a2 = torch.clamp(s1 * s1 - s2 * s2, min=0.0)
    b2 = torch.clamp(s2 * s2 - s3 * s3, min=0.0)
    denom = torch.clamp(s1 * s1 - s3 * s3, min=1e-12)
    x1 = torch.sqrt(a2 / denom)
    x3 = torch.sqrt(b2 / denom)
    s2c = torch.clamp(s2, min=1e-12)
    sin_t = (s1 - s3) * x1 * x3 / s2c
    cos_t = (s1 * x3 * x3 + s3 * x1 * x1) / s2c
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)
    Rs, ts = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sn = e1 * e3 * sin_t
            Rp = torch.stack([torch.stack([cos_t, zero, -sn]),
                              torch.stack([zero, one, zero]),
                              torch.stack([sn, zero, cos_t])])
            tp = (s1 - s3) * torch.stack([e1 * x1, zero, -e3 * x3])
            R = U @ Rp @ Vh
            det = torch.linalg.det(R)
            R = R * det            # H is defined up to sign
            t = (U @ tp) * det
            Rs.append(R)
            ts.append(t / torch.clamp(torch.linalg.norm(t), min=1e-9))
    return torch.stack(Rs), torch.stack(ts)


def _check_rt(R21, t21, r1, r2, pair_mask, max_err_sq, min_parallax_cos):
    """Cheirality + reprojection census of C motion hypotheses at once
    (reference: TwoViewReconstruction::CheckRT): R21 (C,3,3), t21 (C,3),
    rays (N,3). Returns (good [C,N], pts3d [C,N,3], n_good [C],
    parallax_ok [C])."""
    C, N = R21.shape[0], r1.shape[0]
    Rb, tb = R21[:, None], t21[:, None]
    X = _cam.triangulate_two_view(r1.expand(C, N, 3), r2.expand(C, N, 3),
                                  Rb, tb)
    z1 = X[..., 2]
    X2 = lie.se3_apply(Rb, tb, X)
    z2 = X2[..., 2]

    def safe(z):
        return torch.where(z == 0, torch.full_like(z, 1e-12), z)

    e1 = ((X[..., 0] / safe(z1) - r1[..., 0] / r1[..., 2]) ** 2 +
          (X[..., 1] / safe(z1) - r1[..., 1] / r1[..., 2]) ** 2)
    e2 = ((X2[..., 0] / safe(z2) - r2[..., 0] / r2[..., 2]) ** 2 +
          (X2[..., 1] / safe(z2) - r2[..., 1] / r2[..., 2]) ** 2)
    C2 = -torch.einsum('cji,cj->ci', R21, t21)       # cam2 centre in view 1
    d2 = X - C2[:, None]
    cosp = torch.einsum('cni,cni->cn', X, d2) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(d2, dim=-1),
        min=1e-12)
    good = (pair_mask & (z1 > 0) & (z2 > 0) & (e1 < max_err_sq) &
            (e2 < max_err_sq) & (cosp < 0.99998))
    # the 50th-smallest parallax cosine among the good points must clear
    # the minimum parallax
    cosp_good = torch.where(good, cosp, torch.ones_like(cosp))
    n_good = torch.sum(good.to(torch.int32), dim=-1)
    kth = torch.sort(cosp_good, dim=-1).values[:, min(50, N - 1)]
    return good, X, n_good, kth < min_parallax_cos


def two_view_init(key, rays1, rays2, pair_mask, focal, n_hypo: int = 256,
                  th_px: float = 3.84 ** 0.5, min_inlier_frac: float = 0.5,
                  min_matches: int = 50,
                  min_parallax_deg: float = 1.0) -> TwoViewResult:
    """Monocular initialization from matched rays [N,3] (z = 1) with their
    pair mask [N]; focal is the pixel focal length (pixel threshold ->
    normalized units). Evaluates n_hypo 8-point E and n_hypo 4-point H
    models; picks H when its robust score dominates (the reference's
    SH/(SH+SF) > 0.4 selection); accepts when the best motion's census holds
    >= min_matches points, more than min_inlier_frac of the E inliers, a
    clear margin over the second motion and enough parallax. `key`: a
    torch.Generator or a pair (idx_e [n_hypo,8], idx_h [n_hypo,4])."""
    th_norm_sq = (th_px / focal) ** 2
    if isinstance(key, torch.Generator):
        idx_e = draw_samples(key, pair_mask, n_hypo, 8)
        idx_h = draw_samples(key, pair_mask, n_hypo, 4)
    else:
        idx_e = draw_samples(key[0], pair_mask, n_hypo, 8)
        idx_h = draw_samples(key[1], pair_mask, n_hypo, 4)

    E = _eight_point(rays1[idx_e], rays2[idx_e])
    d_e = _sampson_sq(E, rays1, rays2)
    inl_e = (d_e < th_norm_sq) & pair_mask[None]
    score_e = torch.sum(torch.where(inl_e, th_norm_sq - d_e,
                                    torch.zeros_like(d_e)), dim=-1)
    be = torch.argmax(score_e)
    E_best = sless.row(E, be)
    inl_e_best = sless.row(inl_e, be)
    s_e = sless.row(score_e, be)

    H = _four_point_h(rays1[idx_h], rays2[idx_h])
    d_h = _h_transfer_sq(H, rays1, rays2)
    inl_h = (d_h < 2 * th_norm_sq) & pair_mask[None]
    score_h = torch.sum(torch.where(inl_h, 2 * th_norm_sq - d_h,
                                    torch.zeros_like(d_h)), dim=-1)
    bh = torch.argmax(score_h)
    s_h = sless.row(score_h, bh)
    use_h = s_h > 0.45 * 2 * (s_h / 2 + s_e)

    Rs_e, ts_e = decompose_essential(E_best)
    H_best = sless.row(H, bh)
    H_n = H_best / linalg.svdvals(H_best)[1]
    Rs_h, ts_h = _decompose_homography(H_n)
    Rs = torch.where(use_h, Rs_h, Rs_e)
    ts = torch.where(use_h, ts_h, ts_e)

    min_cos = float(torch.cos(torch.deg2rad(torch.tensor(
        min_parallax_deg, dtype=torch.float64))))
    good_all, X_all, n_all, par_all = _check_rt(
        Rs, ts, rays1, rays2, pair_mask, 4 * th_norm_sq, min_cos)
    best = torch.argmax(n_all)
    n_best = sless.row(n_all, best)
    n_second = torch.sort(n_all).values[-2]
    n_pairs = torch.sum(pair_mask.to(torch.int32))
    ok = ((n_best >= min_matches) &
          (n_best.to(torch.float32) >
           min_inlier_frac * torch.sum(inl_e_best.to(torch.float32))) &
          (n_second < (0.9 * n_best.to(torch.float32)).to(torch.int32)) &
          sless.row(par_all, best) & (n_pairs >= min_matches))
    return TwoViewResult(sless.row(Rs, best), sless.row(ts, best),
                         sless.row(X_all, best), sless.row(good_all, best),
                         n_best, ok, use_h)
