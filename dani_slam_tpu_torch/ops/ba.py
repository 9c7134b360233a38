"""Bundle adjustment: batched LM with explicit Schur complement (landmark
elimination) — counterpart of dani_slam_tpu/ops/ba.py ba_solve.

Dense fixed-size blocks: H_pp [P,6,6], H_ll [L,3,3] (closed-form 3x3
inverses), H_pl [P,L,6,3]; S = H_pp - H_pl H_ll^-1 H_pl^T is a dense
(6P, 6P) Cholesky solve, landmarks are back-substituted. Observations are a
keyframe-major flat list (obs_kf == repeat(arange(P), N)), so the pose
blocks are reshape-sums and the landmark blocks come from
ops/kernels.lba_landmark_blocks: the CUDA kernel for CUDA tensors, for any L
and N (the JAX package routes to its Pallas kernel only when L % 256 == 0
and N % 128 == 0), its plain version on the CPU, with which the kernel
agrees within rtol/atol 1e-5 (another summation order; two launches are
bitwise equal). The kernel's fixed-order reduction plan (kernels.lba_plan,
built on the device without a sort) is made once per solve, since the ids
never change across LM iterations.

The JAX package runs the LM iterations in a while_loop that stops once an
accepted step barely moves; here the loop runs `iters` times and freezes
the carry once that condition has held — the same result, no host sync.

`reduce` (default None) is the landmark-sharded solve's hook
(parallel/mesh.sharded_ba_solve): each rank passes its own contiguous
range of landmarks and only the observations of those, and `reduce`
sums a tensor over the ranks. The sums over observations and landmarks go
through it (H_pp, g_p, the Schur blocks S and the rhs, the cost, the
`done` test), so every rank solves the same replicated pose step and its
own landmark step. With None the arithmetic is the single-device solve's,
bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.core import lie
from dani_slam_tpu_torch.ops import kernels
from dani_slam_tpu_torch.ops import linalg as dla

CHI2_MONO = 5.991


class BAResult(NamedTuple):
    R: torch.Tensor          # [P,3,3]
    t: torch.Tensor          # [P,3]
    lm_pos: torch.Tensor     # [L,3]
    obs_inlier: torch.Tensor  # [M] bool
    cost: torch.Tensor       # []


def _residuals(R, t, cam, lm_pos, obs_kf, obs_lm, obs_xy):
    """r [M,2], J_pose [M,2,6] (left increment on T_cw), J_pt [M,2,3]."""
    Rk = R[obs_kf]
    X = lm_pos[obs_lm]
    pc = torch.einsum('mij,mj->mi', Rk, X) + t[obs_kf]
    r = _cam.project(cam, pc) - obs_xy
    Jp = _cam.project_jac(cam, pc)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:1] + (3, 3))
    Jpose = torch.einsum('mij,mjk->mik', Jp,
                         torch.cat([eye, -lie.hat(pc)], dim=-1))
    Jpt = torch.einsum('mij,mjk->mik', Jp, Rk)
    return r, Jpose, Jpt


def _inv3x3(A):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    adj = torch.stack([torch.stack([A11, A12, A13], -1),
                       torch.stack([A21, A22, A23], -1),
                       torch.stack([A31, A32, A33], -1)], -2)
    return adj / det[..., None, None]


def _robust_w(c, delta):
    sq = torch.sqrt(torch.clamp(c, min=1e-12))
    return torch.where(sq <= delta, torch.ones_like(c), delta / sq)


def _rho(c, delta):
    sq = torch.sqrt(torch.clamp(c, min=1e-12))
    return torch.where(sq <= delta, c, 2 * delta * sq - delta * delta)


def _diag_damp(H, lam, eps):
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    return H + lam * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) \
        + eps * eye


def ba_solve(R0, t0, pose_fixed, lm0, lm_valid, cam, obs_kf, obs_lm, obs_xy,
             obs_valid, obs_info=None, iters: int = 10, robust: bool = True,
             huber_delta: float = CHI2_MONO ** 0.5, reduce=None) -> BAResult:
    """Joint pose+landmark LM solve. R0,t0 [P,...] T_cw; pose_fixed [P];
    lm0 [L,3], lm_valid [L]; observations in keyframe-major order
    (obs_kf == repeat(arange(P), N)); reduce: the sharded solve's sum over
    ranks (module docstring), or None."""
    P = R0.shape[0]
    L = lm0.shape[0]
    M = obs_kf.shape[0]
    N = M // P
    dev = R0.device
    info = torch.ones(M, device=dev) if obs_info is None else obs_info
    delta = torch.tensor(huber_delta, dtype=torch.float32).item()
    zero_i = torch.zeros_like(obs_kf)
    obs_kf = torch.where(obs_valid, obs_kf, zero_i).long()
    obs_lm = torch.where(obs_valid, obs_lm, torch.zeros_like(obs_lm)).long()
    base_valid = obs_valid & lm_valid[obs_lm]
    ids2d = torch.where(base_valid, obs_lm,
                        torch.full_like(obs_lm, -1)).reshape(P, N) \
        .to(torch.int32).contiguous()
    plan = kernels.lba_plan(ids2d, L)
    fixm = pose_fixed.to(R0.dtype)
    keep = 1.0 - fixm
    ar = torch.arange(P, device=dev)
    eye6 = torch.eye(6, device=dev)

    def rho_sum(c, sel):
        v = _rho(c, delta) if robust else c
        total = torch.sum(torch.where(sel, v, torch.zeros_like(v)))
        return total if reduce is None else reduce(total)

    def lm_iter(carry):
        (R, t, lm, lam, Rp, tp, lmp, rp, Jpp, Jlp, cp, have_prev) = carry
        r, Jpose, Jpt = _residuals(R, t, cam, lm, obs_kf, obs_lm, obs_xy)
        c = torch.sum(r * r, dim=-1) * info
        c_tot = rho_sum(c, base_valid)
        better = ~have_prev | (c_tot < cp)
        R = torch.where(better, R, Rp)
        t = torch.where(better, t, tp)
        lm = torch.where(better, lm, lmp)
        r = torch.where(better, r, rp)
        Jpose = torch.where(better, Jpose, Jpp)
        Jpt = torch.where(better, Jpt, Jlp)
        c = torch.sum(r * r, dim=-1) * info
        c_base = torch.where(better, c_tot, cp)
        lam = torch.clamp(torch.where(have_prev,
                                      torch.where(better, lam * 0.5,
                                                  lam * 4.0), lam),
                          1e-8, 1e8)
        w = (_robust_w(c, delta) if robust else torch.ones_like(c)) * info
        w = torch.where(base_valid, w, torch.zeros_like(w))

        JtJ_p = torch.einsum('mik,m,mil->mkl', Jpose, w, Jpose)
        JtJ_l = torch.einsum('mik,m,mil->mkl', Jpt, w, Jpt)
        JtJ_pl = torch.einsum('mik,m,mil->mkl', Jpose, w, Jpt)
        b_p = torch.einsum('mik,m,mi->mk', Jpose, w, r)
        b_l = torch.einsum('mik,m,mi->mk', Jpt, w, r)

        H_pp = JtJ_p.reshape(P, N, 6, 6).sum(1)
        g_p = b_p.reshape(P, N, 6).sum(1)
        if reduce is not None:
            H_pp, g_p = reduce(H_pp), reduce(g_p)
        vals = torch.cat([JtJ_l.reshape(P, N, 9), b_l.reshape(P, N, 3),
                          JtJ_pl.reshape(P, N, 18)], dim=-1).contiguous()
        H_ll, g_l, H_pl = kernels.lba_landmark_blocks(ids2d, vals, L, plan)

        H_pp = _diag_damp(H_pp, lam, 1e-8)
        H_ll = _diag_damp(H_ll, lam, 1e-8)
        Hll_inv = _inv3x3(H_ll)

        W = torch.einsum('plik,lkj->plij', H_pl, Hll_inv)
        S = -torch.einsum('plik,qljk->pqij', W, H_pl)
        Wg = torch.einsum('plij,lj->pi', W, g_l)
        if reduce is not None:
            S, Wg = reduce(S), reduce(Wg)
        S[ar, ar] = S[ar, ar] + H_pp
        rhs = g_p - Wg
        S = S * keep[:, None, None, None] * keep[None, :, None, None]
        S[ar, ar] = S[ar, ar] + fixm[:, None, None] * eye6
        rhs = rhs * keep[:, None]

        Sd = S.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
        dp = -dla.chol_solve(Sd, rhs.reshape(-1)).reshape(P, 6)
        dp = dp * keep[:, None]
        Hpl_t_dp = torch.einsum('plik,pi->lk', H_pl, dp)
        dl = -torch.einsum('lij,lj->li', Hll_inv, g_l + Hpl_t_dp)
        dl = torch.where(lm_valid[:, None], dl, torch.zeros_like(dl))

        dR, dt = lie.se3_exp(dp)
        R_new = dR @ R
        t_new = torch.einsum('pij,pj->pi', dR, t) + dt
        lm_new = lm + dl
        dl_small = torch.amax(torch.abs(dl)) < 1e-4
        if reduce is not None:
            dl_small = reduce((~dl_small).to(torch.float32)) == 0
        done = (better & have_prev & (torch.amax(torch.abs(dp)) < 1e-4) &
                dl_small)
        return (R_new, t_new, lm_new, lam, R, t, lm, r, Jpose, Jpt, c_base,
                torch.ones((), dtype=torch.bool, device=dev)), done

    # fills, not torch.tensor(...): a copy from host memory would wait
    carry = (R0, t0, lm0, torch.full((), 1e-4, device=dev), R0, t0, lm0,
             torch.zeros((M, 2), device=dev), torch.zeros((M, 2, 6),
                                                          device=dev),
             torch.zeros((M, 2, 3), device=dev),
             torch.full((), float("inf"), device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    active = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        new, done = lm_iter(carry)
        carry = tuple(torch.where(active, a, b) for a, b in zip(new, carry))
        active = active & ~done

    (R_new, t_new, lm_new, _, Rb, tb, lmb, _, _, _, c_base, _) = carry

    def cost_of(R, t, lm):
        r, _, _ = _residuals(R, t, cam, lm, obs_kf, obs_lm, obs_xy)
        c = torch.sum(r * r, dim=-1) * info
        return c, rho_sum(c, base_valid)

    c, total = cost_of(R_new, t_new, lm_new)
    better = total < c_base
    R = torch.where(better, R_new, Rb)
    t = torch.where(better, t_new, tb)
    lm = torch.where(better, lm_new, lmb)
    c = torch.where(better, c, cost_of(Rb, tb, lmb)[0])
    total = torch.where(better, total, c_base)
    inlier = base_valid & (c <= CHI2_MONO)
    return BAResult(R, t, lm, inlier, total)
