"""Map-scale bundle adjustment: Schur-free preconditioned conjugate
gradients inside LM (counterpart of the visual part of
dani_slam_tpu/ops/ba_large.py; reference Optimizer::GlobalBundleAdjustemnt).

The explicit Schur solve of ops/ba.py needs a dense [P, L, 6, 3] H_pl, which
at the default capacities (K 256, L 32768) is terabytes. Here the reduced
camera system is never formed: CG needs only S x, which factors into
per-observation products with the sparse H_pl blocks A_m [6, 3].
Landmark-indexed sums (H_ll, g_l, H_pl^T x) follow the reference's
arithmetic — observations sorted by landmark once per problem, segment sums
as differences of an f32 cumulative sum, cs[end] - cs[start]. Over hundreds
of thousands of observations those differences lose low-order bits to
cancellation, in the reference and on the card alike (PyTorch's CPU
cumulative sum accumulates f32 in f64 and loses fewer); for landmarks seen
from one or two keyframes, whose H_ll is nearly singular, those bits
decide the step. Pose-indexed sums are keyframe-major reshape-sums.
full_inertial_ba is the whole-map visual-inertial variant: 15-DoF keyframe
states, the inertial chain and bias priors inside the CG matvec, H_ll and
g_l through the same _segsum (so the same cancellation).
"""
from __future__ import annotations

import torch

from dani_slam_tpu_torch.core import lie
from dani_slam_tpu_torch.ops import ba as ba_ops

CHI2_MONO = 5.991


def _landmark_segments(obs_lm, valid, L: int):
    """Sort of the observations by landmark id (stable). Returns (perm [M],
    starts [L], ends [L]): rows perm[starts[l]:ends[l]] observe l."""
    ids = torch.where(valid, obs_lm.long(), torch.full_like(obs_lm, L,
                                                            dtype=torch.long))
    perm = torch.argsort(ids, stable=True)
    sorted_ids = ids[perm]
    grid = torch.arange(L, dtype=sorted_ids.dtype, device=ids.device)
    starts = torch.searchsorted(sorted_ids, grid, side="left")
    ends = torch.searchsorted(sorted_ids, grid, side="right")
    return perm, starts, ends


def _segsum(vals_sorted, starts, ends):
    """Per-landmark sums of pre-sorted values [M, d] -> [L, d] as
    differences of an exclusive cumulative sum. The scan runs along the
    contiguous dimension of the transposed values: on CUDA a cumulative
    sum along dim 0 of an [M, d] tensor with small d is d sequential scans
    of M elements, along the last dim one parallel scan per row (PERF.md,
    PR 4, has the times)."""
    cs = torch.cumsum(vals_sorted.t().contiguous(), dim=1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1).t()
    return cs[ends] - cs[starts]


def _make_pcg_iter(pose_fixed, lm_valid, cam, obs_kf, obs_lm, obs_xy,
                   obs_valid, obs_info, P: int, L: int, M: int, N: int,
                   cg_iters: int, robust: bool, delta: float):
    """(lm_iter, cost_of, base_valid) of the PCG LM solve over a fixed
    observation problem; lm_iter(carry) -> carry for carry = (R, t, lm,
    lam). Shared by ba_solve_pcg and the time-sliced ba_pcg_chunk."""
    dev = obs_xy.device
    info = torch.ones(M, device=dev) if obs_info is None else obs_info
    obs_kf = torch.where(obs_valid, obs_kf, torch.zeros_like(obs_kf)).long()
    obs_lm_s = torch.where(obs_valid, obs_lm,
                           torch.zeros_like(obs_lm)).long()
    base_valid = obs_valid & lm_valid[obs_lm_s]
    perm, seg_start, seg_end = _landmark_segments(obs_lm_s, base_valid, L)
    olm_2d = obs_lm_s.reshape(P, N)
    keep = (~pose_fixed).to(torch.float32)
    fixed_f = pose_fixed.to(torch.float32)
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)

    def cost_of(R, t, lm):
        r, _, _ = ba_ops._residuals(R, t, cam, lm, obs_kf, obs_lm_s, obs_xy)
        c = torch.sum(r * r, dim=-1) * info
        rho = ba_ops._rho(c, delta) if robust else c
        return c, torch.sum(torch.where(base_valid, rho,
                                        torch.zeros_like(rho)))

    def lm_iter(carry):
        R, t, lm, lam = carry
        r, Jpose, Jpt = ba_ops._residuals(R, t, cam, lm, obs_kf, obs_lm_s,
                                          obs_xy)
        c = torch.sum(r * r, dim=-1) * info
        w = ba_ops._robust_w(c, delta) if robust else torch.ones_like(c)
        w = torch.where(base_valid, w * info, torch.zeros_like(w))

        A = torch.einsum('mki,mk,mkj->mij', Jpose,
                         w[:, None].expand(M, 2), Jpt)
        JtJ_p = torch.einsum('mik,m,mil->mkl', Jpose, w, Jpose)
        JtJ_l = torch.einsum('mik,m,mil->mkl', Jpt, w, Jpt)
        g_p_m = torch.einsum('mik,m,mi->mk', Jpose, w, r)
        g_l_m = torch.einsum('mik,m,mi->mk', Jpt, w, r)

        H_pp = JtJ_p.reshape(P, N, 6, 6).sum(1)
        g_p = g_p_m.reshape(P, N, 6).sum(1)
        H_ll = _segsum(JtJ_l.reshape(M, 9)[perm], seg_start,
                       seg_end).reshape(L, 3, 3)
        g_l = _segsum(g_l_m[perm], seg_start, seg_end)

        H_pp_d = H_pp + lam * torch.diag_embed(
            torch.diagonal(H_pp, dim1=-2, dim2=-1)) + 1e-8 * eye6
        H_ll_d = H_ll + lam * torch.diag_embed(
            torch.diagonal(H_ll, dim1=-2, dim2=-1)) + 1e-8 * eye3
        Hll_inv = ba_ops._inv3x3(H_ll_d)
        A4 = A.reshape(P, N, 6, 3)

        def matvec(x):                       # x [P,6] -> S x (gauge-masked)
            x = x * keep[:, None]
            u = torch.einsum('pnij,pi->pnj', A4, x)          # H_pl^T x
            y = _segsum(u.reshape(M, 3)[perm], seg_start, seg_end)
            z = torch.einsum('lij,lj->li', Hll_inv, y)
            w2 = torch.einsum('pnij,pnj->pni', A4, z[olm_2d])
            Sx = torch.einsum('pij,pj->pi', H_pp_d, x) - w2.sum(1)
            return Sx * keep[:, None] + x * fixed_f[:, None]

        hg = torch.einsum('lij,lj->li', Hll_inv, g_l)
        rhs = g_p - torch.einsum('pnij,pnj->pni', A4, hg[olm_2d]).sum(1)
        rhs = rhs * keep[:, None]
        prec = 1.0 / torch.clamp(torch.diagonal(H_pp_d, dim1=-2, dim2=-1),
                                 min=1e-8)
        prec = torch.where(pose_fixed[:, None], torch.ones_like(prec), prec)

        b = -rhs
        x = torch.zeros((P, 6), device=dev)
        rvec = b
        p = prec * b
        rz = torch.sum(b * p)
        zero = torch.zeros((), device=dev)
        for _ in range(cg_iters):
            Ap = matvec(p)
            pAp = torch.sum(p * Ap)
            alpha = torch.where(pAp > 1e-20, rz / pAp, zero)
            x = x + alpha * p
            rvec = rvec - alpha * Ap
            z = prec * rvec
            rz_new = torch.sum(rvec * z)
            beta = torch.where(rz > 1e-20, rz_new / rz, zero)
            p = z + beta * p
            rz = rz_new
        dp = x * keep[:, None]

        u = torch.einsum('pnij,pi->pnj', A4, dp)
        y = _segsum(u.reshape(M, 3)[perm], seg_start, seg_end)
        dl = -torch.einsum('lij,lj->li', Hll_inv, g_l + y)
        dl = torch.where(lm_valid[:, None], dl, torch.zeros_like(dl))

        dR, dt = lie.se3_exp(dp)
        R_new = dR @ R
        t_new = torch.einsum('pij,pj->pi', dR, t) + dt
        lm_new = lm + dl

        _, c_old = cost_of(R, t, lm)
        _, c_new = cost_of(R_new, t_new, lm_new)
        better = c_new < c_old
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)
        lm = torch.where(better, lm_new, lm)
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0),
                          1e-8, 1e8)
        return (R, t, lm, lam)

    return lm_iter, cost_of, base_valid


def ba_solve_pcg(R0, t0, pose_fixed, lm0, lm_valid, cam, obs_kf, obs_lm,
                 obs_xy, obs_valid, obs_info=None, iters: int = 10,
                 cg_iters: int = 40, robust: bool = True,
                 huber_delta: float = CHI2_MONO ** 0.5) -> ba_ops.BAResult:
    """ops/ba.ba_solve at map scale, same keyframe-major observation layout
    (obs_kf == repeat(arange(P), N)); memory O(M)."""
    P, L, M = R0.shape[0], lm0.shape[0], obs_kf.shape[0]
    lm_iter, cost_of, base_valid = _make_pcg_iter(
        pose_fixed, lm_valid, cam, obs_kf, obs_lm, obs_xy, obs_valid,
        obs_info, P, L, M, M // P, cg_iters, robust, huber_delta)
    carry = (R0, t0, lm0, torch.full((), 1e-4, device=R0.device))
    for _ in range(iters):
        carry = lm_iter(carry)
    R, t, lm, _ = carry
    c, total = cost_of(R, t, lm)
    return ba_ops.BAResult(R, t, lm, base_valid & (c <= CHI2_MONO), total)


def ba_pcg_chunk(carry, pose_fixed, lm_valid, cam, obs_kf, obs_lm, obs_xy,
                 obs_valid, obs_info=None, iters: int = 2, cg_iters: int = 40,
                 robust: bool = True,
                 huber_delta: float = CHI2_MONO ** 0.5):
    """`iters` LM iterations of the PCG solve from carry (R, t, lm, lam):
    the step of the time-sliced global BA, which spreads a full GBA over
    keyframe intervals."""
    R0, _, lm0, _ = carry
    P, L, M = R0.shape[0], lm0.shape[0], obs_kf.shape[0]
    lm_iter, _, _ = _make_pcg_iter(
        pose_fixed, lm_valid, cam, obs_kf, obs_lm, obs_xy, obs_valid,
        obs_info, P, L, M, M // P, cg_iters, robust, huber_delta)
    for _ in range(iters):
        carry = lm_iter(carry)
    return carry


# ---------------------------------------------------------------------------
# Full (whole-map) visual-inertial BA (reference Optimizer::FullInertialBA
# src/Optimizer.cc:392)
# ---------------------------------------------------------------------------

def full_inertial_ba(R0, t0, v0, bg0, ba0, pose_fixed, lm0, lm_valid, cam,
                     obs_lm, obs_xy, obs_valid, preints, edge_valid, calib,
                     prior_g: float = 0.0, prior_a: float = 0.0,
                     iters: int = 8, cg_iters: int = 50, robust: bool = True,
                     full_info: bool = True):
    """Whole-map VI BA: every keyframe's 15-DoF state in temporal order and
    every landmark, the inertial chain between consecutive keyframes and
    bias priors toward zero with the staged weights (prior_g, prior_a) of
    the IMU initialization. obs_lm [P,N] GLOBAL landmark ids (-1 none),
    obs_xy [P,N,2]; preints stacked over the P-1 pairs, edge_valid [P-1];
    pose_fixed freezes only the pose dofs. The reduced system is never
    formed: CG's matvec applies the visual Schur complement through the
    sparse H_pl blocks and the inertial chain as a block-tridiagonal term.
    Returns ops/viba.VIBAResult."""
    from dani_slam_tpu_torch.ops import imu as imu_ops
    from dani_slam_tpu_torch.ops import viba as viba_ops

    P, N = obs_lm.shape
    L = lm0.shape[0]
    M = P * N
    dev = R0.device
    delta = CHI2_MONO ** 0.5
    obs_kf = torch.arange(P, device=dev).repeat_interleave(N)
    olm_flat = torch.where(obs_valid, obs_lm,
                           torch.zeros_like(obs_lm)).reshape(-1).long()
    ovalid_flat = (obs_valid & (obs_lm >= 0)).reshape(-1)
    oxy_flat = obs_xy.reshape(-1, 2)
    base_valid = ovalid_flat & lm_valid[olm_flat]
    perm, seg_start, seg_end = _landmark_segments(olm_flat, base_valid, L)
    olm_2d = olm_flat.reshape(P, N)
    edge_W = imu_ops.edge_information(preints, calib,
                                      diag_only=not full_info)
    edge_W = edge_W * edge_valid[:, None, None].to(edge_W.dtype)
    prior_diag = torch.cat([torch.zeros(9, device=dev),
                            torch.full((3,), float(prior_g), device=dev),
                            torch.full((3,), float(prior_a), device=dev)])
    eye3 = torch.eye(3, device=dev)
    keep = torch.ones(P, 15, device=dev)
    keep[:, :6] = (~pose_fixed).to(torch.float32)[:, None]
    zero = torch.zeros((), device=dev)

    def vis_cost(R, t, lm):
        r, _, _ = ba_ops._residuals(R, t, cam, lm, obs_kf, olm_flat,
                                    oxy_flat)
        c = torch.sum(r * r, dim=-1)
        rho = ba_ops._rho(c, delta) if robust else c
        return torch.sum(torch.where(base_valid, rho, torch.zeros_like(rho)))

    def total_cost(R, t, v, bg, ba_, lm):
        zero15 = torch.zeros(P - 1, 15, device=dev)
        r_e = viba_ops._imu_edge_residual(
            zero15, zero15, R[:-1], t[:-1], v[:-1], bg[:-1], ba_[:-1], R[1:],
            t[1:], v[1:], bg[1:], ba_[1:], preints, calib.R_bc, calib.t_bc)
        ci = torch.einsum('ek,ekl,el->', r_e, edge_W, r_e)
        cp = torch.sum((bg * bg) * prior_g + (ba_ * ba_) * prior_a)
        return vis_cost(R, t, lm) + ci + cp

    R, t, v, bg, ba_, lm = R0, t0, v0, bg0, ba0, lm0
    lam = torch.full((), 1e-4, device=dev)
    for _ in range(iters):
        r, Jpose, Jpt = ba_ops._residuals(R, t, cam, lm, obs_kf, olm_flat,
                                          oxy_flat)
        c = torch.sum(r * r, dim=-1)
        w = ba_ops._robust_w(c, delta) if robust else torch.ones_like(c)
        w = torch.where(base_valid, w, torch.zeros_like(w))
        A = torch.einsum('mki,mk,mkj->mij', Jpose, w[:, None].expand(M, 2),
                         Jpt)
        JtJ_p = torch.einsum('mik,m,mil->mkl', Jpose, w, Jpose)
        JtJ_l = torch.einsum('mik,m,mil->mkl', Jpt, w, Jpt)
        g_p_m = torch.einsum('mik,m,mi->mk', Jpose, w, r)
        g_l_m = torch.einsum('mik,m,mi->mk', Jpt, w, r)
        H_pp = JtJ_p.reshape(P, N, 6, 6).sum(1)
        g_p6 = g_p_m.reshape(P, N, 6).sum(1)
        H_ll = _segsum(JtJ_l.reshape(M, 9)[perm], seg_start,
                       seg_end).reshape(L, 3, 3)
        g_l = _segsum(g_l_m[perm], seg_start, seg_end)
        H_ll_d = H_ll + (lam * torch.diag_embed(
            torch.diagonal(H_ll, dim1=-2, dim2=-1)) + 1e-8 * eye3)
        Hll_inv = ba_ops._inv3x3(H_ll_d)
        A4 = A.reshape(P, N, 6, 3)

        r_e, Ji, Jj = viba_ops.imu_edge_parts(R, t, v, bg, ba_, preints,
                                              calib)
        We = edge_W

        hg = torch.einsum('lij,lj->li', Hll_inv, g_l)
        rhs6 = g_p6 - torch.einsum('pnij,pnj->pni', A4, hg[olm_2d]).sum(1)
        rhs = torch.zeros(P, 15, device=dev)
        rhs[:, :6] = rhs6
        rhs[:-1] += torch.einsum('eki,ekl,el->ei', Ji, We, r_e)
        rhs[1:] += torch.einsum('eki,ekl,el->ei', Jj, We, r_e)
        rhs = rhs + prior_diag * torch.cat(
            [torch.zeros(P, 9, device=dev), bg, ba_], 1)
        rhs = rhs * keep

        diag_v = torch.zeros(P, 15, device=dev)
        diag_v[:, :6] = torch.diagonal(H_pp, dim1=-2, dim2=-1)
        diag_i = torch.zeros(P, 15, device=dev)
        diag_i[:-1] += torch.einsum('eki,ekl,eli->ei', Ji, We, Ji)
        diag_i[1:] += torch.einsum('eki,ekl,eli->ei', Jj, We, Jj)
        diag_all = diag_v + diag_i + prior_diag
        diag_damped = diag_all * (1.0 + lam) + 1e-6
        prec = torch.where(keep > 0,
                           1.0 / torch.clamp(diag_damped, min=1e-8),
                           torch.ones_like(diag_damped))

        def matvec(x):
            x = x * keep
            x6 = x[:, :6]
            u = torch.einsum('pnij,pi->pnj', A4, x6)
            y = _segsum(u.reshape(M, 3)[perm], seg_start, seg_end)
            z = torch.einsum('lij,lj->li', Hll_inv, y)
            w2 = torch.einsum('pnij,pnj->pni', A4, z[olm_2d]).sum(1)
            Sx6 = torch.einsum('pij,pj->pi', H_pp, x6) - w2
            ve = (torch.einsum('eij,ej->ei', Ji, x[:-1]) +
                  torch.einsum('eij,ej->ei', Jj, x[1:]))
            wve = torch.einsum('ekl,el->ek', We, ve)
            Sx = torch.cat([Sx6, torch.zeros(P, 9, device=dev)], 1)
            Sx = Sx + torch.cat([torch.einsum('eij,ei->ej', Ji, wve),
                                 torch.zeros(1, 15, device=dev)], 0)
            Sx = Sx + torch.cat([torch.zeros(1, 15, device=dev),
                                 torch.einsum('eij,ei->ej', Jj, wve)], 0)
            Sx = Sx + prior_diag * x
            Sx = Sx + (lam * diag_all + 1e-6) * x
            return Sx * keep + x * (1.0 - keep)

        b = -rhs
        x = torch.zeros(P, 15, device=dev)
        rvec = b
        pv = prec * b
        rz = torch.sum(b * pv)
        for _ in range(cg_iters):
            Ap = matvec(pv)
            pAp = torch.sum(pv * Ap)
            alpha = torch.where(pAp > 1e-20, rz / pAp, zero)
            x = x + alpha * pv
            rvec = rvec - alpha * Ap
            z = prec * rvec
            rz_new = torch.sum(rvec * z)
            beta = torch.where(rz > 1e-20, rz_new / rz, zero)
            pv = z + beta * pv
            rz = rz_new
        dx = x * keep

        u = torch.einsum('pnij,pi->pnj', A4, dx[:, :6])
        y = _segsum(u.reshape(M, 3)[perm], seg_start, seg_end)
        dl = -torch.einsum('lij,lj->li', Hll_inv, g_l + y)
        dl = torch.where(lm_valid[:, None], dl, torch.zeros_like(dl))

        dR, dt = lie.se3_exp(dx[:, :6])
        cand = (dR @ R, torch.einsum('pij,pj->pi', dR, t) + dt,
                v + dx[:, 6:9], bg + dx[:, 9:12], ba_ + dx[:, 12:15],
                lm + dl)
        better = total_cost(*cand) < total_cost(R, t, v, bg, ba_, lm)
        R, t, v, bg, ba_, lm = (torch.where(better, a, b_) for a, b_ in
                                zip(cand, (R, t, v, bg, ba_, lm)))
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-8,
                          1e8)
    return viba_ops.VIBAResult(R, t, v, bg, ba_, lm,
                               total_cost(R, t, v, bg, ba_, lm))
