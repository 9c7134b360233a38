"""Sim(3) estimation: RANSAC over Horn alignments and the relative-pose
refinement (counterpart of dani_slam_tpu/ops/sim3.py; reference
src/Sim3Solver.cc and Optimizer::OptimizeSim3).

B 3-point hypotheses are solved as one batched Horn alignment and scored in
one masked reduction; the refinement is a fixed-count Gauss-Newton on the
7-D sim(3) tangent with forward-mode Jacobians (ops/linalg.jacfwd) and
Huber weights. `key` is a torch.Generator or precomputed [n_hypo, 3] sample
indices (see ops/pnp.draw_samples).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.core import lie
from dani_slam_tpu_torch.core import scatterless as sless
from dani_slam_tpu_torch.ops import linalg as dla
from dani_slam_tpu_torch.ops import solvers
from dani_slam_tpu_torch.ops.pnp import draw_samples


class Sim3Result(NamedTuple):
    R: torch.Tensor       # rotation of T_12: frame-2 coords -> frame 1
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _horn3(P, Q, fix_scale: bool):
    R, t, s = solvers.horn_align(P, Q, with_scale=not fix_scale)
    if fix_scale:
        s = torch.ones_like(s)
    return R, t, s


def sim3_ransac(key, cam1, cam2, pts1_c: torch.Tensor, pts2_c: torch.Tensor,
                mask: torch.Tensor, n_hypo: int = 128,
                th_px: float = 9.21 ** 0.5, min_inliers: int = 20,
                fix_scale: bool = False) -> Sim3Result:
    """T_12 (pts2 camera frame -> pts1 camera frame) from matched
    camera-frame points [N,3]; inliers project within th_px both ways."""
    N = pts1_c.shape[0]
    idx = draw_samples(key, mask, n_hypo, 3)
    n_hypo = idx.shape[0]
    R, t, s = _horn3(pts2_c[idx], pts1_c[idx], fix_scale)

    p2in1 = s[:, None, None] * torch.einsum('bij,nj->bni', R, pts2_c) + \
        t[:, None]
    proj1 = _cam.project(cam1, p2in1.reshape(-1, 3)).reshape(n_hypo, N, 2)
    obs1 = _cam.project(cam1, pts1_c)
    e1 = torch.sum((proj1 - obs1[None]) ** 2, dim=-1)
    Ri, ti, si = lie.sim3_inv(R, t, s)
    p1in2 = si[:, None, None] * torch.einsum('bij,nj->bni', Ri, pts1_c) + \
        ti[:, None]
    proj2 = _cam.project(cam2, p1in2.reshape(-1, 3)).reshape(n_hypo, N, 2)
    obs2 = _cam.project(cam2, pts2_c)
    e2 = torch.sum((proj2 - obs2[None]) ** 2, dim=-1)
    inl = (e1 < th_px ** 2) & (e2 < th_px ** 2) & mask[None]
    counts = torch.sum(inl.to(torch.int32), dim=-1)
    b = torch.argmax(counts)
    inl_b = sless.row(inl, b)
    n_b = sless.row(counts, b)
    Rf, tf, sf = solvers.horn_align(pts2_c, pts1_c, w=inl_b.to(torch.float32),
                                    with_scale=not fix_scale)
    if fix_scale:
        sf = torch.ones_like(sf)
    return Sim3Result(Rf, tf, sf, inl_b, n_b, n_b >= min_inliers)


def optimize_sim3(cam1, cam2, R0, t0, s0, pts1_c, obs1_xy, pts2_c, obs2_xy,
                  mask, iters: int = 10, fix_scale: bool = False,
                  chi2_th: float = 9.21):
    """Refine a relative Sim3 with reprojection edges both ways and Huber
    kernels (delta sqrt(10)); outliers are gated only in the second half of
    the iterations. Returns (R, t, s, inliers, n_inliers)."""
    dev = pts1_c.device
    xi0 = torch.zeros(7, device=dev)
    delta = 10.0 ** 0.5

    def residuals(xi, R, t, s):
        dR, dt, ds = lie.sim3_exp(xi)
        Rn, tn, sn = lie.sim3_mul(dR, dt, ds, R, t, s)
        p2in1 = lie.sim3_apply(Rn[..., None, :, :], tn[..., None, :],
                               sn[..., None], pts2_c)
        r1 = _cam.project(cam1, p2in1) - obs1_xy
        Ri, ti, si = lie.sim3_inv(Rn, tn, sn)
        p1in2 = lie.sim3_apply(Ri[..., None, :, :], ti[..., None, :],
                               si[..., None], pts1_c)
        r2 = _cam.project(cam2, p1in2) - obs2_xy
        return r1, r2

    def chi2(R, t, s):
        r1, r2 = residuals(xi0, R, t, s)
        return torch.sum(r1 * r1, -1) + torch.sum(r2 * r2, -1)

    def rho(c):
        sq = torch.sqrt(torch.clamp(c, min=1e-12))
        return torch.where(sq <= delta, c, 2 * delta * sq - delta * delta)

    def huber_w(c):
        sq = torch.sqrt(torch.clamp(c, min=1e-12))
        return torch.where(sq <= delta, torch.ones_like(c), delta / sq)

    R, t, s, inl = R0, t0, s0, mask
    for it in range(iters):
        r1c, r2c = residuals(xi0, R, t, s)
        w1 = huber_w(torch.sum(r1c * r1c, -1))
        w2 = huber_w(torch.sum(r2c * r2c, -1))
        wm = inl.to(torch.float32)

        def flat_res(xi):
            r1, r2 = residuals(xi, R, t, s)
            return torch.cat([
                (r1 * (wm * torch.sqrt(w1))[:, None]).flatten(-2),
                (r2 * (wm * torch.sqrt(w2))[:, None]).flatten(-2)], dim=-1)

        r, J = dla.jacfwd(flat_res, xi0)
        if fix_scale:
            J = torch.cat([J[:, :6], torch.zeros_like(J[:, 6:])], dim=1)
        H = J.T @ J + 1e-6 * torch.eye(7, device=dev)
        dx = -dla.chol_solve(H, J.T @ r)
        if fix_scale:
            dx = torch.cat([dx[:6], torch.zeros_like(dx[6:])])
        dR, dt, ds = lie.sim3_exp(dx)
        Rn, tn, sn = lie.sim3_mul(dR, dt, ds, R, t, s)

        def rob_cost(R_, t_, s_):
            c = rho(chi2(R_, t_, s_))
            return torch.sum(torch.where(inl, c, torch.zeros_like(c)))
        better = rob_cost(Rn, tn, sn) < rob_cost(R, t, s)
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        s = torch.where(better, sn, s)
        if it >= iters // 2:
            inl = mask & (chi2(R, t, s) <= 2 * chi2_th)
        else:
            inl = mask
    inl = inl & (chi2(R, t, s) <= chi2_th)
    return R, t, s, inl, torch.sum(inl.to(torch.int32))
