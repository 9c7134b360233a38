"""Motion-only pose optimization: damped Gauss-Newton (LM) on SE(3), and
Horn's closed-form alignment (counterpart of dani_slam_tpu/ops/solvers.py
pose_optimize and horn_align; the inertial solvers come with a later
slice).

Semantics of the reference's Optimizer::PoseOptimization: 4 rounds x up to
10 LM iterations, Huber delta sqrt(chi2) in the first two rounds, chi-square
re-classification of every masked observation between rounds. The JAX
package exits a round's LM loop early once an accepted step barely moves the
pose; here the loop always runs its 10 iterations but freezes the carry once
that exit condition has held (torch.where on a device flag), which returns
exactly the same pose without a host synchronisation per iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.core import lie
from dani_slam_tpu_torch.ops import linalg as dla

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # [] int32
    chi2: torch.Tensor        # [] final cost


def _dpc_dxi(pc):
    """d pc / d xi for a LEFT increment: [I | -hat(pc)]  -> [N,3,6]."""
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    return torch.cat([eye, -lie.hat(pc)], dim=-1)


def _residuals_jac(R, t, cam, pts_w, obs_xy):
    """Reprojection residuals r [N,2] and Jacobian J [N,2,6]."""
    pc = torch.einsum('ij,nj->ni', R, pts_w) + t
    r = _cam.project(cam, pc) - obs_xy
    J = torch.einsum('nij,njk->nik', _cam.project_jac(cam, pc), _dpc_dxi(pc))
    return r, J


def _depth_residual(R, t, pts_w, obs_depth):
    """Depth residual r_z = z - d_obs [N,1], J [N,1,6]; zero where the
    keypoint has no depth reading (inf)."""
    pc = torch.einsum('ij,nj->ni', R, pts_w) + t
    have = torch.isfinite(obs_depth)
    zero = torch.zeros_like(obs_depth)
    r = torch.where(have, pc[:, 2] - torch.where(have, obs_depth, zero),
                    zero)[:, None]
    J = torch.where(have[:, None, None], _dpc_dxi(pc)[:, 2:3, :],
                    torch.zeros((), dtype=pc.dtype, device=pc.device))
    return r, J


def _huber_rho(c, delta):
    sq = torch.sqrt(torch.clamp(c, min=1e-12))
    return torch.where(sq <= delta, c, 2 * delta * sq - delta * delta)


def pose_optimize(R0, t0, cam, pts_w, obs_xy, mask, inv_sigma2=None,
                  obs_depth=None, depth_inv_sigma2: float = 1.0,
                  rounds: int = 4, iters_per_round: int = 10,
                  use_depth: bool = False) -> PoseOptResult:
    """Motion-only LM solve. pts_w [N,3], obs_xy [N,2], mask [N] bool;
    inv_sigma2 [N] per-observation information; obs_depth [N] with
    use_depth=True adds the RGB-D residual (3-DoF chi2 gate)."""
    N = pts_w.shape[0]
    dev = pts_w.device
    w_info = torch.ones(N, device=dev) if inv_sigma2 is None else inv_sigma2
    chi2_th = CHI2_STEREO if use_depth else CHI2_MONO
    delta = torch.sqrt(torch.tensor(chi2_th, dtype=torch.float32)).item()
    eye6 = torch.eye(6, device=dev)

    def cost_terms(R, t):
        r, J = _residuals_jac(R, t, cam, pts_w, obs_xy)
        c = torch.sum(r * r, dim=-1) * w_info
        rd = Jd = None
        if use_depth:
            rd, Jd = _depth_residual(R, t, pts_w, obs_depth)
            c = c + rd[:, 0] ** 2 * depth_inv_sigma2
        return c, r, J, rd, Jd

    def chi2_of(R, t, inl, robust=False):
        c = cost_terms(R, t)[0]
        rho = _huber_rho(c, delta) if robust else c
        return c, torch.sum(torch.where(inl, rho, torch.zeros_like(rho)))

    def lm_iter(R, t, lam, inl, robust):
        c, r, J, rd, Jd = cost_terms(R, t)
        if robust:
            sqrt_c = torch.sqrt(torch.clamp(c, min=1e-12))
            w_rob = torch.where(sqrt_c <= delta, torch.ones_like(c),
                                delta / sqrt_c)
        else:
            w_rob = torch.ones_like(c)
        live = inl & mask
        w = torch.where(live, w_rob * w_info, torch.zeros_like(c))
        H = torch.einsum('nik,n,nil->kl', J, w, J)
        b = torch.einsum('nik,n,ni->k', J, w, r)
        if use_depth:
            wd = torch.where(live, w_rob * depth_inv_sigma2,
                             torch.zeros_like(c))
            H = H + torch.einsum('nik,n,nil->kl', Jd, wd, Jd)
            b = b + torch.einsum('nik,n,ni->k', Jd, wd, rd)
        Hd = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye6
        dx = -dla.chol_solve(Hd, b)
        dR, dt = lie.se3_exp(dx)
        R_new = dR @ R
        t_new = dR @ t + dt
        rho_c = _huber_rho(c, delta) if robust else c
        cost_old = torch.sum(torch.where(live, rho_c, torch.zeros_like(c)))
        _, cost_new = chi2_of(R_new, t_new, live, robust)
        better = cost_new < cost_old
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0),
                          1e-8, 1e6)
        done = better & (torch.sum(dx * dx) < 1e-12)
        return R, t, lam, done

    R, t = R0, t0
    inl = mask
    for rd_i in range(rounds):
        robust = rd_i < 2
        lam = torch.full((), 1e-3, device=dev)
        active = torch.ones((), dtype=torch.bool, device=dev)
        for _ in range(iters_per_round):
            R2, t2, lam2, done = lm_iter(R, t, lam, inl, robust)
            R = torch.where(active, R2, R)
            t = torch.where(active, t2, t)
            lam = torch.where(active, lam2, lam)
            active = active & ~done
        c, _ = chi2_of(R, t, mask)
        inl = mask & (c <= chi2_th)
    _, total = chi2_of(R, t, inl)
    return PoseOptResult(R, t, inl, torch.sum(inl.to(torch.int32)), total)


# ---------------------------------------------------------------------------
# Horn alignment (closed-form absolute orientation; reference Sim3Solver
# ComputeSim3)
# ---------------------------------------------------------------------------

def horn_align(P: torch.Tensor, Q: torch.Tensor, w=None,
               with_scale: bool = False):
    """(R, t, s) minimizing sum w ||Q - (s R P + t)||^2 for P, Q [..., N, 3]
    (batched): SVD of the weighted cross-covariance with the reflection
    fix. The SVD's signs may differ from another library's; R, t and s do
    not."""
    if w is None:
        w = torch.ones(P.shape[:-1], dtype=P.dtype, device=P.device)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    wp = (w / wsum[..., 0:1])[..., None]
    mu_p = torch.sum(P * wp, dim=-2)
    mu_q = torch.sum(Q * wp, dim=-2)
    Pc = P - mu_p[..., None, :]
    Qc = Q - mu_q[..., None, :]
    S = torch.einsum('...ni,...n,...nj->...ij', Qc, w, Pc)
    U, D, Vt = dla.svd(S)
    det = torch.linalg.det(U @ Vt)
    ones = torch.ones_like(det)
    E = torch.diag_embed(torch.stack([ones, ones, det], dim=-1))
    R = U @ E @ Vt
    if with_scale:
        num = torch.sum(D * torch.stack([ones, ones, det], dim=-1), dim=-1)
        den = torch.clamp(torch.einsum('...ni,...n,...ni->...', Pc, w, Pc),
                          min=1e-12)
        s = num / den
    else:
        s = torch.ones(P.shape[:-2], dtype=P.dtype, device=P.device)
    t = mu_q - s[..., None] * torch.einsum('...ij,...j->...i', R, mu_p)
    return R, t, s
