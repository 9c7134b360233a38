"""Sim(3) pose-graph (essential graph) optimization (counterpart of
dani_slam_tpu/ops/posegraph.py; reference Optimizer::OptimizeEssentialGraph
and its 4-DoF inertial variant).

The graph is dense and fixed-size: nodes are the K keyframe slots (masked),
edges a boolean [K, K] mask with relative measurements [K, K, ...]. Every
(i, j) pair is linearized (forward-mode Jacobians over the whole K x K grid,
ops/linalg.jacfwd), the Hessian is assembled densely by einsum (each pair
occurs once, so no scatter is needed), and each Gauss-Newton step is one
dense (7K, 7K) solve in f32 — torch.linalg.solve_ex, which reports a
singular system in a tensor instead of synchronising to raise; the system
is damped (1e-6 I, identity rows for fixed or empty nodes).
"""
from __future__ import annotations

import torch

from dani_slam_tpu_torch.core import lie
from dani_slam_tpu_torch.ops import linalg as dla


def relative_sim3(Ra, ta, sa, Rb, tb, sb):
    """T_ab = T_a * T_b^-1 for camera-from-world sim3s (broadcasting)."""
    return lie.sim3_mul(Ra, ta, sa, *lie.sim3_inv(Rb, tb, sb))


def _assemble(W, r, Ji, Jj, fixed, node_mask, d: int):
    """Dense normal equations over all (i, j) pairs: H [K, K, d, d] (the
    off-diagonal blocks of each edge and its transpose, the diagonal blocks
    of both ends), g [K, d]; fixed or empty nodes get identity rows."""
    K = W.shape[0]
    H = torch.einsum('ij,ijrk,ijrl->ijkl', W, Ji, Jj)
    H = H + H.permute(1, 0, 3, 2)
    diag = (torch.einsum('ij,ijrk,ijrl->ikl', W, Ji, Ji) +
            torch.einsum('ij,ijrk,ijrl->jkl', W, Jj, Jj))
    eyeK = torch.eye(K, dtype=H.dtype, device=H.device)
    H = H + eyeK[:, :, None, None] * diag[:, None]
    g = (torch.einsum('ij,ijrk,ijr->ik', W, Ji, r) +
         torch.einsum('ij,ijrk,ijr->jk', W, Jj, r))
    freeze = fixed | ~node_mask
    keep = (~freeze).to(H.dtype)
    H = H * keep[:, None, None, None] * keep[None, :, None, None]
    eye_d = torch.eye(d, dtype=H.dtype, device=H.device)
    H = H + eyeK[:, :, None, None] * \
        (freeze.to(H.dtype)[:, None, None] * eye_d)[:, None]
    return H, g * keep[:, None], keep


def _solve(H, g, keep, d: int):
    K = H.shape[0]
    Hd = H.permute(0, 2, 1, 3).reshape(d * K, d * K)
    Hd = Hd + 1e-6 * torch.eye(d * K, dtype=H.dtype, device=H.device)
    dx = -torch.linalg.solve_ex(Hd, g.reshape(-1, 1))[0].reshape(K, d)
    return dx * keep[:, None]


def optimize_essential_graph(R, t, s, edge_mask, R_meas, t_meas, s_meas,
                             fixed, node_mask, iters: int = 12,
                             fix_scale: bool = False):
    """Optimize sim3 nodes (R [K,3,3], t [K,3], s [K], camera-from-world) so
    that the relative transforms of the edges (edge_mask [K,K]) match the
    measurements [K,K,...]: each edge adds the residual
    log(T_meas_ij^-1 * T_i * T_j^-1); `fixed` [K] are gauge anchors."""
    K = R.shape[0]
    W = (edge_mask & node_mask[:, None] & node_mask[None, :]).to(R.dtype)
    Rmi, tmi, smi = lie.sim3_inv(R_meas, t_meas, s_meas)
    x0 = torch.zeros((K, K, 14), dtype=R.dtype, device=R.device)

    for _ in range(iters):
        def residual(x):
            dRi, dti, dsi = lie.sim3_exp(x[..., :7])
            dRj, dtj, dsj = lie.sim3_exp(x[..., 7:])
            Ri, ti, si = lie.sim3_mul(dRi, dti, dsi, R[:, None], t[:, None],
                                      s[:, None])
            Rj, tj, sj = lie.sim3_mul(dRj, dtj, dsj, R[None], t[None],
                                      s[None])
            Rr, tr, sr = relative_sim3(Ri, ti, si, Rj, tj, sj)
            return lie.sim3_log(*lie.sim3_mul(Rmi, tmi, smi, Rr, tr, sr))

        r, J = dla.jacfwd(residual, x0)             # [K,K,7], [K,K,7,14]
        H, g, keep = _assemble(W, r, J[..., :7], J[..., 7:], fixed,
                               node_mask, 7)
        if fix_scale:
            six = torch.arange(7, device=R.device) == 6
            H = torch.where(six[:, None] | six[None, :],
                            torch.zeros_like(H), H)
            eyeK = torch.eye(K, dtype=torch.bool, device=R.device)
            H = torch.where(eyeK[:, :, None, None] & six[:, None] &
                            six[None, :], torch.ones_like(H), H)
            g = torch.where(six, torch.zeros_like(g), g)
        dx = _solve(H, g, keep, 7)
        R, t, s = lie.sim3_mul(*lie.sim3_exp(dx), R, t, s)
    return R, t, s


def optimize_essential_graph_4dof(R, t, edge_mask, R_meas, t_meas, fixed,
                                  node_mask, iters: int = 12):
    """Yaw + translation pose graph for gravity-aligned maps: SE3 nodes,
    per-node update a world-frame yaw about gravity plus a world
    translation, edge residual [rotation log, camera-origin difference]
    (reference Edge4DoF)."""
    K = R.shape[0]
    W = (edge_mask & node_mask[:, None] & node_mask[None, :]).to(R.dtype)
    x0 = torch.zeros((K, K, 8), dtype=R.dtype, device=R.device)

    def apply(xi, Rn, tn):
        z2 = torch.zeros(xi.shape[:-1] + (2,), dtype=xi.dtype,
                         device=xi.device)
        Rz = lie.so3_exp(torch.cat([z2, xi[..., :1]], dim=-1))
        Rwc = Rn.transpose(-1, -2)
        C = -torch.einsum('...ij,...j->...i', Rwc, tn)
        R2 = (Rz @ Rwc).transpose(-1, -2)
        return R2, -torch.einsum('...ij,...j->...i', R2, C + xi[..., 1:4])

    for _ in range(iters):
        def residual(x):
            Ri, ti = apply(x[..., :4], R[:, None], t[:, None])
            Rj, tj = apply(x[..., 4:], R[None], t[None])
            er = lie.so3_log(Ri @ Rj.transpose(-1, -2) @
                             R_meas.transpose(-1, -2))
            Cj = -torch.einsum('...ji,...j->...i', Rj, tj)
            et = torch.einsum('...ij,...j->...i', Ri, Cj) + ti - t_meas
            return torch.cat([er, et], dim=-1)

        r, J = dla.jacfwd(residual, x0)             # [K,K,6], [K,K,6,8]
        H, g, keep = _assemble(W, r, J[..., :4], J[..., 4:], fixed,
                               node_mask, 4)
        dx = _solve(H, g, keep, 4)
        R, t = apply(dx, R, t)
        R = lie.orthonormalize(R)
    return R, t


def build_essential_edges(covis, spanning_parent, loop_edges, kf_mask,
                          covis_th: int = 100):
    """Edge mask of the essential graph: spanning tree + loop edges +
    covisibility of at least covis_th (reference rule set)."""
    K = covis.shape[0]
    rows = torch.arange(K, device=covis.device)
    par_valid = spanning_parent >= 0
    par = torch.where(par_valid, spanning_parent,
                      torch.zeros_like(spanning_parent)).long()
    tree = (rows[None, :] == par[:, None]) & par_valid[:, None]
    e = (covis >= covis_th) | tree | tree.T
    e = e | loop_edges | loop_edges.T
    e = e & kf_mask[:, None] & kf_mask[None, :]
    return e & (rows[:, None] != rows[None, :])
