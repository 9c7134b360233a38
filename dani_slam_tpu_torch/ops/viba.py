"""Visual-inertial bundle adjustment over a temporal keyframe window
(counterpart of dani_slam_tpu/ops/viba.py; reference
Optimizer::LocalInertialBA src/Optimizer.cc:2383).

Each keyframe state is a 15-DoF block [dpose(6) | dv(3) | dbg(3) | dba(3)];
landmarks are Schur-eliminated as in ops/ba.py (reprojection touches only
the pose sub-block), and the inertial chain edges between consecutive
states add their Gauss-Newton blocks into the reduced (15P x 15P) system,
solved densely once per LM iteration. The JAX package forms the landmark
blocks with one-hot contractions, not with its Pallas kernel, and so does
this port (a [P, N, L] one-hot matmul: deterministic, no float atomics).
Poses are camera-from-world in a gravity-aligned world; the inertial edges
act on body states through the extrinsics T_bc.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dani_slam_tpu_torch.core import lie
from dani_slam_tpu_torch.ops import ba as ba_ops
from dani_slam_tpu_torch.ops import imu as imu_ops
from dani_slam_tpu_torch.ops import linalg as dla

CHI2_MONO = 5.991


class VIBAResult(NamedTuple):
    R: torch.Tensor       # [P,3,3]
    t: torch.Tensor       # [P,3]
    v: torch.Tensor       # [P,3]
    bg: torch.Tensor      # [P,3]
    ba: torch.Tensor      # [P,3]
    lm_pos: torch.Tensor  # [L,3]
    cost: torch.Tensor


def _imu_edge_residual(dx_i, dx_j, Ri, ti, vi, bgi, bai, Rj, tj, vj, bgj,
                       baj, preint, R_bc=None, t_bc=None):
    """15-D residual of inertial edges under local increments dx (15 each):
    9 preintegration + 3 gyro-walk + 3 acc-walk (reference EdgeInertial +
    EdgeGyroRW + EdgeAccRW). Broadcasts over leading dims (one per edge)."""
    def apply(dx, R, t, v, bg, ba_):
        dR, dt = lie.se3_exp(dx[..., :6])
        return (dR @ R, torch.einsum('...ij,...j->...i', dR, t) + dt,
                v + dx[..., 6:9], bg + dx[..., 9:12], ba_ + dx[..., 12:15])

    Ri2, ti2, vi2, bgi2, bai2 = apply(dx_i, Ri, ti, vi, bgi, bai)
    Rj2, tj2, vj2, bgj2, baj2 = apply(dx_j, Rj, tj, vj, bgj, baj)
    if R_bc is None:
        R_bc = torch.eye(3, device=Ri.device)
    if t_bc is None:
        t_bc = torch.zeros(3, device=Ri.device)
    Rwi, pwi = imu_ops.body_from_camera(R_bc, t_bc, Ri2, ti2)
    Rwj, pwj = imu_ops.body_from_camera(R_bc, t_bc, Rj2, tj2)
    r9 = imu_ops.inertial_residual(preint, Rwi, pwi, vi2, Rwj, pwj, vj2,
                                   bgi2, bai2)
    return torch.cat([r9, bgj2 - bgi2, baj2 - bai2], -1)


def imu_edge_parts(R, t, v, bg, ba_, preints, calib):
    """(r_e [E,15], Ji [E,15,15], Jj [E,15,15]) of the P-1 chain edges at
    the current states: the residual and its forward-mode Jacobians with
    respect to each end's increment."""
    E = R.shape[0] - 1
    zero = torch.zeros(E, 15, device=R.device)
    args = (R[:-1], t[:-1], v[:-1], bg[:-1], ba_[:-1], R[1:], t[1:], v[1:],
            bg[1:], ba_[1:], preints, calib.R_bc, calib.t_bc)
    r_e = _imu_edge_residual(zero, zero, *args)
    _, Ji = dla.jacfwd(lambda dx: _imu_edge_residual(dx, zero, *args), zero)
    _, Jj = dla.jacfwd(lambda dx: _imu_edge_residual(zero, dx, *args), zero)
    return r_e, Ji, Jj


def viba_solve(R0, t0, v0, bg0, ba0, pose_fixed, lm0, lm_valid, cam, obs_lm,
               obs_xy, obs_valid, preints, edge_valid, calib, iters: int = 8,
               robust: bool = True, full_info: bool = True) -> VIBAResult:
    """Joint VI solve over a temporal window. R0..ba0 [P,...] in temporal
    order; preints stacked over the P-1 pairs (i -> i+1), edge_valid [P-1];
    observations keyframe-major: obs_lm [P,N] local landmark ids (-1 none),
    obs_xy [P,N,2], obs_valid [P,N]. pose_fixed freezes the POSE dofs only
    (anchors keep their velocity and biases free). `iters` LM iterations,
    each step kept only when the total cost drops. On the card the solve is
    one CUDA graph replay per window size (utils/graphs): it holds no host
    read."""
    import dataclasses
    from dani_slam_tpu_torch.utils import graphs
    n_pre, n_cal = len(preints), len(calib)

    def solve(*a):
        pre = imu_ops.Preintegrated(*a[14:14 + n_pre])
        cal = imu_ops.ImuCalib(*a[14 + n_pre:14 + n_pre + n_cal])
        return _viba_solve(*a[:8], dataclasses.replace(cam, params=a[8],
                                                       dist=a[9]),
                           *a[10:13], pre, a[13], cal, iters, robust,
                           full_info)

    args = (R0, t0, v0, bg0, ba0, pose_fixed, lm0, lm_valid, cam.params,
            cam.dist, obs_lm, obs_xy, obs_valid, edge_valid, *preints,
            *calib)
    key = ("viba_solve", iters, robust, full_info, cam.kind, cam.width,
           cam.height)
    return graphs.call(key, solve, args)


def _viba_solve(R0, t0, v0, bg0, ba0, pose_fixed, lm0, lm_valid, cam,
                obs_lm, obs_xy, obs_valid, preints, edge_valid, calib,
                iters, robust, full_info) -> VIBAResult:
    """viba_solve's arithmetic (a function without host reads)."""
    P = R0.shape[0]
    L = lm0.shape[0]
    N = obs_lm.shape[1]
    dev = R0.device
    delta = CHI2_MONO ** 0.5
    okf = torch.arange(P, device=dev).repeat_interleave(N)
    olm_flat = torch.where(obs_valid, obs_lm,
                           torch.zeros_like(obs_lm)).reshape(-1).long()
    ovalid_flat = (obs_valid & (obs_lm >= 0)).reshape(-1)
    oxy_flat = obs_xy.reshape(-1, 2)
    base_valid = ovalid_flat & lm_valid[olm_flat]
    onehot = (torch.where(obs_valid, obs_lm, torch.full_like(obs_lm, -1))
              [:, :, None] == torch.arange(L, device=dev)[None, None, :]
              ).to(torch.float32)                             # [P,N,L]
    edge_W = imu_ops.edge_information(preints, calib,
                                      diag_only=not full_info)
    edge_W = edge_W * edge_valid[:, None, None].to(edge_W.dtype)
    ar = torch.arange(P, device=dev)
    ii = torch.arange(P - 1, device=dev)
    eye3 = torch.eye(3, device=dev)
    eye15 = torch.eye(15, device=dev)

    def visual_cost(R, t, lm):
        r, _, _ = ba_ops._residuals(R, t, cam, lm, okf, olm_flat, oxy_flat)
        c = torch.sum(r * r, dim=-1)
        rho = ba_ops._rho(c, delta) if robust else c
        return torch.sum(torch.where(base_valid, rho, torch.zeros_like(rho)))

    def imu_cost(R, t, v, bg, ba_):
        zero = torch.zeros(P - 1, 15, device=dev)
        r = _imu_edge_residual(
            zero, zero, R[:-1], t[:-1], v[:-1], bg[:-1], ba_[:-1], R[1:],
            t[1:], v[1:], bg[1:], ba_[1:], preints, calib.R_bc, calib.t_bc)
        return torch.sum(torch.einsum('ek,ekl,el->e', r, edge_W, r))

    keep_dim = torch.ones(P, 15, device=dev)
    keep_dim[:, :6] = (~pose_fixed).to(torch.float32)[:, None]
    frozen = 1.0 - keep_dim

    R, t, v, bg, ba_, lm = R0, t0, v0, bg0, ba0, lm0
    lam = torch.full((), 1e-4, device=dev)
    for _ in range(iters):
        r, Jpose, Jpt = ba_ops._residuals(R, t, cam, lm, okf, olm_flat,
                                          oxy_flat)
        c = torch.sum(r * r, dim=-1)
        w = ba_ops._robust_w(c, delta) if robust else torch.ones_like(c)
        w = torch.where(base_valid, w, torch.zeros_like(w))
        JtJ_p = torch.einsum('mik,m,mil->mkl', Jpose, w, Jpose)
        JtJ_l = torch.einsum('mik,m,mil->mkl', Jpt, w, Jpt)
        JtJ_pl = torch.einsum('mik,m,mil->mkl', Jpose, w, Jpt)
        b_p = torch.einsum('mik,m,mi->mk', Jpose, w, r)
        b_l = torch.einsum('mik,m,mi->mk', Jpt, w, r)
        H_pp6 = JtJ_p.reshape(P, N, 6, 6).sum(1)
        g_p6 = b_p.reshape(P, N, 6).sum(1)
        H_ll = torch.einsum('pnl,pnij->lij', onehot,
                            JtJ_l.reshape(P, N, 3, 3))
        H_pl = torch.einsum('pnl,pnik->plik', onehot,
                            JtJ_pl.reshape(P, N, 6, 3))
        g_l = torch.einsum('pnl,pnk->lk', onehot, b_l.reshape(P, N, 3))
        H_ll = H_ll + (lam * torch.diag_embed(
            torch.diagonal(H_ll, dim1=-2, dim2=-1)) + 1e-8 * eye3)
        Hll_inv = ba_ops._inv3x3(H_ll)
        W = torch.einsum('plik,lkj->plij', H_pl, Hll_inv)
        S_off6 = torch.einsum('plik,qljk->pqij', W, H_pl)     # [P,P,6,6]
        rhs6 = g_p6 - torch.einsum('plij,lj->pi', W, g_l)

        S = torch.zeros(P, P, 15, 15, device=dev)
        S[:, :, :6, :6] = -S_off6
        S[ar, ar, :6, :6] += H_pp6
        rhs = torch.zeros(P, 15, device=dev)
        rhs[:, :6] = rhs6

        r_e, Ji, Jj = imu_edge_parts(R, t, v, bg, ba_, preints, calib)
        We = edge_W
        S[ii, ii] += torch.einsum('eki,ekl,elj->eij', Ji, We, Ji)
        S[ii + 1, ii + 1] += torch.einsum('eki,ekl,elj->eij', Jj, We, Jj)
        S[ii, ii + 1] += torch.einsum('eki,ekl,elj->eij', Ji, We, Jj)
        S[ii + 1, ii] += torch.einsum('eki,ekl,elj->eij', Jj, We, Ji)
        rhs[ii] += torch.einsum('eki,ekl,el->ei', Ji, We, r_e)
        rhs[ii + 1] += torch.einsum('eki,ekl,el->ei', Jj, We, r_e)

        S = S * keep_dim[:, None, :, None] * keep_dim[None, :, None, :]
        S[ar, ar] += torch.diag_embed(frozen)
        rhs = rhs * keep_dim
        Sdiag = S[ar, ar]
        Sd = S.clone()
        Sd[ar, ar] += lam * torch.diag_embed(torch.diagonal(
            Sdiag, dim1=-2, dim2=-1)) + 1e-6 * eye15
        Sm = Sd.permute(0, 2, 1, 3).reshape(15 * P, 15 * P)
        dx = -dla.chol_solve(Sm, rhs.reshape(-1)).reshape(P, 15)
        dx = dx * keep_dim

        Hpl_t_dp = torch.einsum('plik,pi->lk', H_pl, dx[:, :6])
        dl = -torch.einsum('lij,lj->li', Hll_inv, g_l + Hpl_t_dp)
        dl = torch.where(lm_valid[:, None], dl, torch.zeros_like(dl))

        dR, dt = lie.se3_exp(dx[:, :6])
        cand = (dR @ R, torch.einsum('pij,pj->pi', dR, t) + dt,
                v + dx[:, 6:9], bg + dx[:, 9:12], ba_ + dx[:, 12:15],
                lm + dl)
        tot_old = visual_cost(R, t, lm) + imu_cost(R, t, v, bg, ba_)
        tot_new = visual_cost(cand[0], cand[1], cand[5]) + \
            imu_cost(*cand[:5])
        better = tot_new < tot_old
        R, t, v, bg, ba_, lm = (torch.where(better, a, b) for a, b in
                                zip(cand, (R, t, v, bg, ba_, lm)))
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-8,
                          1e8)
    return VIBAResult(R, t, v, bg, ba_, lm,
                      visual_cost(R, t, lm) + imu_cost(R, t, v, bg, ba_))
