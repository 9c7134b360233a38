"""Motion-only pose optimization: damped Gauss-Newton (LM) on SE(3), its
visual-inertial variants, and Horn's closed-form alignment (counterpart of
dani_slam_tpu/ops/solvers.py pose_optimize, pose_inertial_optimize,
pose_inertial_optimize_marginalized and horn_align).

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
# Visual-inertial motion-only optimization (reference
# Optimizer::PoseInertialOptimizationLastKeyFrame src/Optimizer.cc:4491 /
# ...LastFrame :4875): the frame's 15-DoF state [se3 pose (left increment on
# T_cw), velocity, gyro bias, acc bias] against reprojection edges, the
# preintegration edge and the bias random walk. The JAX package's
# fori_loops run their fixed counts here; jax.jacfwd is linalg.jacfwd.
# ---------------------------------------------------------------------------

def _mv(M, v):
    return torch.einsum('...ij,...j->...i', M, v)


def _apply15(x, R, t, v, bg, ba_):
    """A 15-D perturbation (left se3 on the pose) applied to a state."""
    dR, dt_ = lie.se3_exp(x[..., :6])
    return (dR @ R, _mv(dR, t) + dt_, v + x[..., 6:9], bg + x[..., 9:12],
            ba_ + x[..., 12:15])


def _robust_weight(c, delta):
    sq = torch.sqrt(torch.clamp(c, min=1e-12))
    return torch.where(sq <= delta, torch.ones_like(c), delta / sq)


def pose_inertial_optimize(R0, t0, v0, bg0, ba0, R_prev, t_prev, v_prev,
                           bg_prev, ba_prev, preint, calib, cam, pts_w,
                           obs_xy, mask, obs_depth=None,
                           use_depth: bool = False, iters: int = 12,
                           info_cap: float = 1e6):
    """Joint 15-DoF solve of the current frame's state with the previous
    state as a fixed anchor, the preintegration information the capped
    inverse of its covariance diagonal (the tests' comparison oracle for
    the marginalized solver, as in the reference package). Returns (R, t,
    v, bg, ba, inliers, n_inliers)."""
    from dani_slam_tpu_torch.ops import imu as imu_ops
    dev = pts_w.device
    chi2_th = CHI2_STEREO if use_depth else CHI2_MONO
    delta = torch.sqrt(torch.tensor(chi2_th, dtype=torch.float32)).item()
    covs = torch.diagonal(preint.cov[:9, :9])
    info9 = torch.clamp(1.0 / torch.clamp(covs, min=1e-8), 0.0, info_cap)
    dtp = torch.clamp(preint.dt, min=1e-3)
    info15 = torch.clamp(torch.cat([
        info9,
        (1.0 / torch.clamp(calib.walk_gyro ** 2 * dtp, min=1e-12))
        .expand(3),
        (1.0 / torch.clamp(calib.walk_acc ** 2 * dtp, min=1e-12))
        .expand(3)]), 0.0, info_cap)
    Rw_p, pw_p = imu_ops.body_from_camera(calib.R_bc, calib.t_bc, R_prev,
                                          t_prev)

    def imu_res(dx, R, t, v, bg, ba_):
        R2, t2, v2, bg2, ba2 = _apply15(dx, R, t, v, bg, ba_)
        Rw, pw = imu_ops.body_from_camera(calib.R_bc, calib.t_bc, R2, t2)
        # evaluated at the OPTIMIZED bias through the bias Jacobians
        r9 = imu_ops.inertial_residual(preint, Rw_p, pw_p, v_prev, Rw, pw,
                                       v2, bg2, ba2)
        return torch.cat([r9, bg2 - bg_prev, ba2 - ba_prev], -1)

    def vis_parts(R, t):
        r, J = _residuals_jac(R, t, cam, pts_w, obs_xy)
        c = torch.sum(r * r, dim=-1)
        if use_depth:
            rd, Jd = _depth_residual(R, t, pts_w, obs_depth)
            return r, J, rd, Jd, c + rd[:, 0] ** 2
        return r, J, None, None, c

    z15 = torch.zeros(15, device=dev)

    def total_cost(R, t, v, bg, ba_, inl):
        c = vis_parts(R, t)[-1]
        rho = _huber_rho(c, delta)
        r15 = imu_res(z15, R, t, v, bg, ba_)
        return (torch.sum(torch.where(inl, rho, torch.zeros_like(rho))) +
                torch.sum(r15 * r15 * info15))

    state = (R0, t0, v0, bg0, ba0)
    inl = mask
    lam = torch.full((), 1e-3, device=dev)
    eye15 = torch.eye(15, device=dev)
    for _ in range(iters):
        R, t, v, bg, ba_ = state
        r, J, rd, Jd, c = vis_parts(R, t)
        w = torch.where(inl & mask, _robust_weight(c, delta),
                        torch.zeros_like(c))
        H = torch.zeros(15, 15, device=dev)
        g = torch.zeros(15, device=dev)
        H[:6, :6] = torch.einsum('nik,n,nil->kl', J, w, J)
        g[:6] = torch.einsum('nik,n,ni->k', J, w, r)
        if use_depth:
            H[:6, :6] += torch.einsum('nik,n,nil->kl', Jd, w, Jd)
            g[:6] += torch.einsum('nik,n,ni->k', Jd, w, rd)
        r15 = imu_res(z15, *state)
        _, J15 = dla.jacfwd(lambda dx: imu_res(dx, *state), z15)
        H = H + torch.einsum('ki,k,kj->ij', J15, info15, J15)
        g = g + torch.einsum('ki,k,k->i', J15, info15, r15)
        Hd = H + lam * torch.diag(torch.diag(H)) + 1e-6 * eye15
        dx = -dla.chol_solve(Hd, g)
        cand = _apply15(dx, *state)
        live = inl & mask
        better = total_cost(*cand, live) < total_cost(*state, live)
        state = tuple(torch.where(better, a, b) for a, b in zip(cand, state))
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-8,
                          1e6)
        c2 = vis_parts(state[0], state[1])[-1]
        inl = mask & (c2 <= chi2_th)
    R, t, v, bg, ba_ = state
    return (lie.orthonormalize(R), t, v, bg, ba_, inl,
            torch.sum(inl.to(torch.int32)))


def pose_inertial_optimize_marginalized(
        R0, t0, v0, bg0, ba0, R_p, t_p, v_p, bg_p, ba_p, prior_info,
        preint, calib, cam, pts_w, obs_xy, mask, obs_depth=None,
        use_depth: bool = False, iters: int = 10):
    """Two-frame visual-inertial solve with the marginalized prior
    (reference PoseInertialOptimizationLastFrame consuming EdgePriorPoseImu,
    produced by Optimizer::Marginalize src/Optimizer.cc:2960): the 30-DoF
    state [previous frame, current frame]; robust reprojection (+ depth) on
    the current pose, the preintegration residual weighted by the FULL
    inverse covariance, the bias random walk, and the 15-D prior on the
    previous state. After the iterations the previous block is
    Schur-marginalized out, H_cc - H_cp H_pp^-1 H_pc, and clamped to PSD by
    its eigendecomposition (one counted host wait on the card,
    ops/linalg.eigh). On the card the solve up to the eigendecomposition
    is one CUDA graph replay (utils/graphs). Returns (R, t, v, bg, ba,
    inliers, n_inliers, prior_info_next [15,15])."""
    import dataclasses
    from dani_slam_tpu_torch.ops import imu as imu_ops
    from dani_slam_tpu_torch.utils import graphs
    if obs_depth is None:
        obs_depth = torch.zeros_like(obs_xy[:, 0])
    n_pre, n_cal = len(preint), len(calib)

    def solve(*a):
        pre = imu_ops.Preintegrated(*a[11:11 + n_pre])
        cal = imu_ops.ImuCalib(*a[11 + n_pre:11 + n_pre + n_cal])
        params, dist, pts, xy, msk, depth = a[11 + n_pre + n_cal:]
        return _marginalized_solve(
            *a[:11], pre, cal, dataclasses.replace(cam, params=params,
                                                   dist=dist),
            pts, xy, msk, depth, use_depth, iters)

    args = (R0, t0, v0, bg0, ba0, R_p, t_p, v_p, bg_p, ba_p, prior_info,
            *preint, *calib, cam.params, cam.dist, pts_w, obs_xy, mask,
            obs_depth)
    key = ("pose_inertial_optimize_marginalized", use_depth, iters,
           cam.kind, cam.width, cam.height)
    R, t, v, bg, ba_, inl, n, H_next = graphs.call(key, solve, args)
    evals, evecs = dla.eigh(H_next)
    H_next = (evecs * torch.clamp(evals, min=0.0)) @ evecs.T
    return R, t, v, bg, ba_, inl, n, H_next


def _marginalized_solve(R0, t0, v0, bg0, ba0, R_p, t_p, v_p, bg_p, ba_p,
                        prior_info, preint, calib, cam, pts_w, obs_xy, mask,
                        obs_depth, use_depth: bool, iters: int):
    """pose_inertial_optimize_marginalized up to the PSD clamp: (R, t, v,
    bg, ba, inliers, n_inliers, the symmetrized Schur complement). A
    function without host reads (captured on the card). The terms of the
    cost that depend on the state alone (the per-observation chi2, the
    inertial and prior terms) are carried from the state an iteration kept
    instead of evaluated again: the same function of the same state, summed
    in the same order."""
    from dani_slam_tpu_torch.ops import imu as imu_ops
    dev = pts_w.device
    chi2_th = CHI2_STEREO if use_depth else CHI2_MONO
    delta = torch.sqrt(torch.tensor(chi2_th, dtype=torch.float32)).item()
    cov9 = preint.cov[:9, :9]
    cov9 = 0.5 * (cov9 + cov9.T) + 1e-10 * torch.eye(9, device=dev)
    info9 = dla.chol_inv(cov9)
    info9 = 0.5 * (info9 + info9.T)
    dtp = torch.clamp(preint.dt, min=1e-3)
    rw_info = torch.cat([
        (1.0 / torch.clamp(calib.walk_gyro ** 2 * dtp, min=1e-12))
        .expand(3),
        (1.0 / torch.clamp(calib.walk_acc ** 2 * dtp, min=1e-12))
        .expand(3)])
    R_pi, t_pi = lie.se3_inv(R_p, t_p)

    def imu_res30(x, Rp, tp, vp, bgp, bap, Rc, tc, vc, bgc, bac):
        Rp2, tp2, vp2, bgp2, bap2 = _apply15(x[..., :15], Rp, tp, vp, bgp,
                                             bap)
        Rc2, tc2, vc2, bgc2, bac2 = _apply15(x[..., 15:], Rc, tc, vc, bgc,
                                             bac)
        Rwp, pwp = imu_ops.body_from_camera(calib.R_bc, calib.t_bc, Rp2, tp2)
        Rwc, pwc = imu_ops.body_from_camera(calib.R_bc, calib.t_bc, Rc2, tc2)
        r9 = imu_ops.inertial_residual(preint, Rwp, pwp, vp2, Rwc, pwc, vc2,
                                       bgp2, bap2)
        return torch.cat([r9, bgc2 - bgp2, bac2 - bap2], -1)

    def prior_res(x15, Rp, tp, vp, bgp, bap):
        Rp2, tp2, vp2, bgp2, bap2 = _apply15(x15, Rp, tp, vp, bgp, bap)
        xi = lie.se3_log(*lie.se3_mul(Rp2, tp2, R_pi, t_pi))
        return torch.cat([xi, vp2 - v_p, bgp2 - bg_p, bap2 - ba_p], -1)

    def vis_parts(R, t):
        r, J = _residuals_jac(R, t, cam, pts_w, obs_xy)
        c = torch.sum(r * r, dim=-1)
        if use_depth:
            rd, Jd = _depth_residual(R, t, pts_w, obs_depth)
            return r, J, rd, Jd, c + rd[:, 0] ** 2
        return r, J, None, None, c

    z30 = torch.zeros(30, device=dev)
    z15 = torch.zeros(15, device=dev)

    def build_system(states, inl):
        Rc, tc = states[5], states[6]
        r, J, rd, Jd, c = vis_parts(Rc, tc)
        w = torch.where(inl & mask, _robust_weight(c, delta),
                        torch.zeros_like(c))
        H = torch.zeros(30, 30, device=dev)
        g = torch.zeros(30, device=dev)
        H[15:21, 15:21] = torch.einsum('nik,n,nil->kl', J, w, J)
        g[15:21] = torch.einsum('nik,n,ni->k', J, w, r)
        if use_depth:
            H[15:21, 15:21] += torch.einsum('nik,n,nil->kl', Jd, w, Jd)
            g[15:21] += torch.einsum('nik,n,ni->k', Jd, w, rd)
        r15 = imu_res30(z30, *states)
        _, J30 = dla.jacfwd(lambda x: imu_res30(x, *states), z30)
        H = H + J30[:9].T @ info9 @ J30[:9] \
            + torch.einsum('ki,k,kj->ij', J30[9:], rw_info, J30[9:])
        g = g + J30[:9].T @ info9 @ r15[:9] \
            + torch.einsum('ki,k,k->i', J30[9:], rw_info, r15[9:])
        rp = prior_res(z15, *states[:5])
        _, Jp = dla.jacfwd(lambda x: prior_res(x, *states[:5]), z15)
        H[:15, :15] += Jp.T @ prior_info @ Jp
        g[:15] += Jp.T @ prior_info @ rp
        return H, g

    def cost_terms(states):
        """The per-observation chi2 and the three inertial terms of the
        total cost: functions of the state alone."""
        c = vis_parts(states[5], states[6])[-1]
        r15 = imu_res30(z30, *states)
        rp = prior_res(z15, *states[:5])
        return (c, r15[:9] @ info9 @ r15[:9],
                torch.sum(r15[9:] ** 2 * rw_info), rp @ prior_info @ rp)

    def total_cost(terms, inl):
        c, e9, ewalk, eprior = terms
        rho = _huber_rho(c, delta)
        return (torch.sum(torch.where(inl & mask, rho,
                                      torch.zeros_like(rho))) +
                e9 + ewalk + eprior)

    states = (R_p, t_p, v_p, bg_p, ba_p, R0, t0, v0, bg0, ba0)
    inl = mask
    lam = torch.full((), 1e-3, device=dev)
    eye30 = torch.eye(30, device=dev)
    terms_old = cost_terms(states)
    for _ in range(iters):
        H, g = build_system(states, inl)
        Hd = H + lam * torch.diag(torch.diag(H)) + 1e-6 * eye30
        dx = -dla.chol_solve(Hd, g)
        cand = _apply15(dx[:15], *states[:5]) + \
            _apply15(dx[15:], *states[5:])
        terms_cand = cost_terms(cand)
        better = total_cost(terms_cand, inl) < total_cost(terms_old, inl)
        states = tuple(torch.where(better, a, b)
                       for a, b in zip(cand, states))
        terms_old = tuple(torch.where(better, a, b)
                          for a, b in zip(terms_cand, terms_old))
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-8,
                          1e6)
        inl = mask & (terms_old[0] <= chi2_th)

    H, _ = build_system(states, inl)
    Hpp = H[:15, :15] + 1e-9 * torch.eye(15, device=dev)
    Hcp = H[15:, :15]
    H_next = H[15:, 15:] - Hcp @ dla.chol_inv(Hpp) @ Hcp.T
    H_next = 0.5 * (H_next + H_next.T)
    Rc, tc, vc, bgc, bac = states[5:]
    return (lie.orthonormalize(Rc), tc, vc, bgc, bac, inl,
            torch.sum(inl.to(torch.int32)), H_next)


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
