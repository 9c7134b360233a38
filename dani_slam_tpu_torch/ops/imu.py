"""IMU preintegration and inertial residuals (counterpart of
dani_slam_tpu/ops/imu.py; reference src/ImuTypes.cc IMU::Preintegrated and
src/G2oTypes.cc EdgeInertial).

Preintegration accumulates the delta rotation / velocity / position of a
window of IMU samples with its 15x15 covariance and the first-order bias
Jacobians, so a bias change is a closed-form correction, not a replay.
The JAX package runs it as a lax.scan over a fixed, padded window with a
validity mask; here it is a loop over the same window with the mask applied
per sample, in the same order of operations, and no host read inside. A
masked sample leaves the carry exactly as it was, so trailing padding may
be skipped (`n_steps`) without changing a bit of the result. The
per-sample quantities that do not depend on the carry (the rotation
increment, its right Jacobian, the skew of the corrected acceleration) are
computed for the whole window at once before the loop.

All functions broadcast over leading dims where the JAX package vmaps.
Gravity is (0, 0, -9.81) as in the reference (include/ImuTypes.h:43).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dani_slam_tpu_torch.core import lie
from dani_slam_tpu_torch.ops import linalg as dla
from dani_slam_tpu_torch.utils.device import const

GRAVITY = 9.81
G_VEC = (0.0, 0.0, -GRAVITY)


def g_vec(like: torch.Tensor) -> torch.Tensor:
    """The gravity vector on `like`'s device (staged once per device)."""
    return const(G_VEC, torch.float32, like.device)


class ImuCalib(NamedTuple):
    """Noise densities (continuous) and the camera-IMU extrinsics T_bc
    (reference IMU::Calib, include/ImuTypes.h:92-127)."""
    noise_gyro: torch.Tensor    # [] rad/s/sqrt(Hz)
    noise_acc: torch.Tensor     # [] m/s^2/sqrt(Hz)
    walk_gyro: torch.Tensor
    walk_acc: torch.Tensor
    R_bc: torch.Tensor          # [3,3] body-from-camera rotation
    t_bc: torch.Tensor          # [3]

    @staticmethod
    def default(device="cuda") -> "ImuCalib":
        return calib_from_numpy(dict(noise_gyro=1.7e-4, noise_acc=2e-3,
                                     walk_gyro=1.9e-5, walk_acc=3e-3,
                                     R_bc=np.eye(3), t_bc=np.zeros(3)),
                                device)

    def to(self, device) -> "ImuCalib":
        return ImuCalib(*(x.to(device) for x in self))


def calib_from_numpy(src, device="cuda") -> ImuCalib:
    """ImuCalib from numbers or arrays: a dict with the field names, or any
    object with those attributes (the JAX package's ImuCalib included)."""
    get = (src.__getitem__ if isinstance(src, dict)
           else lambda k: getattr(src, k))
    return ImuCalib(*(torch.as_tensor(np.asarray(get(k), np.float32),
                                      device=device)
                      for k in ImuCalib._fields))


class Preintegrated(NamedTuple):
    """Accumulated deltas between two frames / keyframes; every field may
    carry leading batch dims (one per inertial edge)."""
    dR: torch.Tensor      # (3,3)
    dV: torch.Tensor      # (3,)
    dP: torch.Tensor      # (3,)
    dt: torch.Tensor      # [] total time
    cov: torch.Tensor     # (15,15) [phi, v, p, bg, ba]
    JRg: torch.Tensor     # (3,3) d dR / d bias_gyro
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bias_g: torch.Tensor  # (3,) linearization bias
    bias_a: torch.Tensor


def preint_from_numpy(src, device="cuda") -> Preintegrated:
    """Preintegrated from arrays: a dict with the field names, or any
    object with those attributes (the JAX package's Preintegrated)."""
    get = (src.__getitem__ if isinstance(src, dict)
           else lambda k: getattr(src, k))
    return Preintegrated(*(torch.as_tensor(np.asarray(get(k), np.float32),
                                           device=device)
                           for k in Preintegrated._fields))


def identity_preintegration(device="cuda") -> Preintegrated:
    z3 = torch.zeros(3, device=device)
    z33 = torch.zeros(3, 3, device=device)
    return Preintegrated(torch.eye(3, device=device), z3, z3.clone(),
                         torch.zeros((), device=device),
                         torch.zeros(15, 15, device=device), z33,
                         z33.clone(), z33.clone(), z33.clone(), z33.clone(),
                         z3.clone(), z3.clone())


def stack_preints(preints) -> Preintegrated:
    """A list of Preintegrated -> one with a leading edge dim."""
    return Preintegrated(*(torch.stack(xs) for xs in zip(*preints)))


def preintegrate(gyro, acc, dts, valid, bias_g, bias_a, calib: ImuCalib,
                 n_steps: Optional[int] = None) -> Preintegrated:
    """Integrate a padded window of IMU samples (gyro/acc [S,3], dts [S],
    valid [S] bool) at the linearization biases (reference discrete model,
    ImuTypes.cc:177-238): position and velocity use the orientation BEFORE
    the sample's update; the [phi, v, p] covariance propagates through the
    A/B matrices, the bias blocks by the random walk; the bias Jacobians
    accumulate first-order sensitivities. `n_steps` (host int): only the
    first n_steps samples are visited — exact when every later sample is
    masked, as in windows made by slam/inertial.make_window."""
    dev = gyro.device
    S = gyro.shape[0] if n_steps is None else min(n_steps, gyro.shape[0])
    ng2 = calib.noise_gyro ** 2
    na2 = calib.noise_acc ** 2
    eye3 = torch.eye(3, device=dev)
    zero = torch.zeros((), device=dev)
    # per-sample quantities that do not depend on the carry
    dt_all = torch.where(valid[:S], dts[:S], zero)
    w_c = gyro[:S] - bias_g
    a_c = acc[:S] - bias_a
    phi = w_c * dt_all[:, None]
    dRi_all = lie.so3_exp(phi)
    Jr_all = lie.so3_right_jacobian(phi)
    acc_hat_all = lie.hat(a_c)
    dt2_all = dt_all * dt_all
    dt_safe = torch.clamp(dt_all, min=1e-9)
    nga_all = torch.diag_embed(torch.cat([
        (ng2 / dt_safe)[:, None].expand(S, 3),
        (na2 / dt_safe)[:, None].expand(S, 3)], 1))
    ok_all = valid[:S]

    dR = eye3
    dV = torch.zeros(3, device=dev)
    dP = torch.zeros(3, device=dev)
    T = zero
    cov = torch.zeros(15, 15, device=dev)
    JRg = torch.zeros(3, 3, device=dev)
    JVg, JVa, JPg, JPa = JRg, JRg, JRg, JRg
    for i in range(S):
        ok = ok_all[i]
        dt, dt2 = dt_all[i], dt2_all[i]
        dRi, Jr, acc_hat = dRi_all[i], Jr_all[i], acc_hat_all[i]
        Ra = dR @ a_c[i]
        dP_new = dP + dV * dt + 0.5 * Ra * dt2
        dV_new = dV + Ra * dt
        dRah = dR @ acc_hat
        z3 = torch.zeros_like(eye3)
        A = torch.cat([
            torch.cat([dRi.T, z3, z3], 1),
            torch.cat([-dRah * dt, eye3, z3], 1),
            torch.cat([-0.5 * dRah * dt2, eye3 * dt, eye3], 1)], 0)
        B = torch.cat([
            torch.cat([Jr * dt, z3], 1),
            torch.cat([z3, dR * dt], 1),
            torch.cat([z3, 0.5 * dR * dt2], 1)], 0)
        Nga = nga_all[i]
        cov9 = cov[0:9, 0:9]
        cov9_new = A @ cov9 @ A.T + B @ Nga @ B.T
        top = torch.where(ok, cov9_new, cov9)
        wg = torch.where(ok, calib.walk_gyro ** 2 * dt, zero) * eye3
        wa = torch.where(ok, calib.walk_acc ** 2 * dt, zero) * eye3
        cov = torch.cat([
            torch.cat([top, cov[0:9, 9:]], 1),
            torch.cat([cov[9:12, 0:9], cov[9:12, 9:12] + wg,
                       cov[9:12, 12:]], 1),
            torch.cat([cov[12:, 0:12], cov[12:, 12:] + wa], 1)], 0)
        dRahJ = dRah @ JRg
        JPa_new = JPa + JVa * dt - 0.5 * dR * dt2
        JPg_new = JPg + JVg * dt - 0.5 * dRahJ * dt2
        JVa_new = JVa - dR * dt
        JVg_new = JVg - dRahJ * dt
        JRg_new = dRi.T @ JRg - Jr * dt
        dR_new = dR @ dRi
        dR = torch.where(ok, dR_new, dR)
        dV = torch.where(ok, dV_new, dV)
        dP = torch.where(ok, dP_new, dP)
        T = torch.where(ok, T + dt, T)
        JRg = torch.where(ok, JRg_new, JRg)
        JVg = torch.where(ok, JVg_new, JVg)
        JVa = torch.where(ok, JVa_new, JVa)
        JPg = torch.where(ok, JPg_new, JPg)
        JPa = torch.where(ok, JPa_new, JPa)
    return Preintegrated(dR, dV, dP, T, cov, JRg, JVg, JVa, JPg, JPa,
                         bias_g, bias_a)


def body_from_camera(R_bc, t_bc, R_cw, t_cw):
    """World-from-body state (R_wb, p_wb) of camera-from-world poses under
    the extrinsics T_bc: R_wb = R_wc R_bc^T, p_wb = C_cam - R_wb t_bc
    (reference ImuCamPose, include/G2oTypes.h:130). Batched."""
    R_wc = R_cw.transpose(-1, -2)
    C = -torch.einsum('...ij,...j->...i', R_wc, t_cw)
    R_wb = R_wc @ R_bc.transpose(-1, -2)
    p_wb = C - torch.einsum('...ij,...j->...i', R_wb, t_bc)
    return R_wb, p_wb


def camera_from_body(R_bc, t_bc, R_wb, p_wb):
    """Inverse of body_from_camera: T_cw from a world-from-body state."""
    R_wc = R_wb @ R_bc
    R_cw = R_wc.transpose(-1, -2)
    C = p_wb + torch.einsum('...ij,...j->...i', R_wb, t_bc)
    t_cw = -torch.einsum('...ij,...j->...i', R_cw, C)
    return R_cw, t_cw


def corrected_deltas(p: Preintegrated, bias_g, bias_a):
    """Bias-corrected deltas through the stored Jacobians (reference
    GetDeltaRotation/Velocity/Position, ImuTypes.cc:283-310)."""
    mv = lambda M, v: torch.einsum('...ij,...j->...i', M, v)  # noqa: E731
    dbg = bias_g - p.bias_g
    dba = bias_a - p.bias_a
    dR = p.dR @ lie.so3_exp(mv(p.JRg, dbg))
    dV = p.dV + mv(p.JVg, dbg) + mv(p.JVa, dba)
    dP = p.dP + mv(p.JPg, dbg) + mv(p.JPa, dba)
    return dR, dV, dP


def edge_information(preints: Preintegrated, calib: ImuCalib,
                     cap: float = 1e6, diag_only: bool = False):
    """[E,15,15] information per inertial edge: the FULL inverse of the
    9x9 preintegration covariance (plus cap^-1 on its diagonal, bounding
    the information) for the preintegration rows, 1/(sigma_walk^2 dt) on
    the bias-walk rows (reference EdgeInertial / EdgeGyroRW / EdgeAccRW).
    diag_only=True: the diagonal approximation 1/diag(cov)."""
    E = preints.dt.shape[0]
    dev = preints.dt.device
    dts = torch.clamp(preints.dt, min=1e-3)
    info_bg = torch.clamp(1.0 / torch.clamp(calib.walk_gyro ** 2 * dts,
                                            min=1e-12), 0.0, cap)
    info_ba = torch.clamp(1.0 / torch.clamp(calib.walk_acc ** 2 * dts,
                                            min=1e-12), 0.0, cap)
    walk = torch.cat([info_bg[:, None].expand(E, 3),
                      info_ba[:, None].expand(E, 3)], 1)
    if diag_only:
        covs = torch.diagonal(preints.cov[:, :9, :9], dim1=-2, dim2=-1)
        info9_d = torch.clamp(1.0 / torch.clamp(covs, min=1e-8), 0.0, cap)
        return torch.diag_embed(torch.cat([info9_d, walk], 1))
    cov9 = preints.cov[:, :9, :9]
    cov9 = 0.5 * (cov9 + cov9.transpose(1, 2)) \
        + (1.0 / cap) * torch.eye(9, device=dev)
    info9 = dla.chol_inv(cov9)
    info9 = 0.5 * (info9 + info9.transpose(1, 2))
    W = torch.zeros(E, 15, 15, device=dev)
    W[:, :9, :9] = info9
    W[:, 9:, 9:] = torch.diag_embed(walk)
    return W


def inertial_residual(p: Preintegrated, R1, t1, v1, R2, t2, v2, bias_g,
                      bias_a):
    """9-D preintegration residual between world-from-body states 1 and 2
    (reference EdgeInertial::computeError). Batched over leading dims."""
    dR, dV, dP = corrected_deltas(p, bias_g, bias_a)
    dt = p.dt[..., None]
    g = g_vec(R1)
    R1T = R1.transpose(-1, -2)
    mv = lambda M, v: torch.einsum('...ij,...j->...i', M, v)  # noqa: E731
    er = lie.so3_log(dR.transpose(-1, -2) @ R1T @ R2)
    ev = mv(R1T, v2 - v1 - g * dt) - dV
    ep = mv(R1T, t2 - t1 - v1 * dt - 0.5 * g * dt * dt) - dP
    return torch.cat([er, ev, ep], dim=-1)


# ---------------------------------------------------------------------------
# Gravity / scale initialization (reference Optimizer::InertialOptimization
# src/Optimizer.cc:3042-3496, LocalMapping::InitializeIMU:1175)
# ---------------------------------------------------------------------------

def inertial_init(R_wb, t_wb, dts, preints: Preintegrated, iters: int = 30,
                  optimize_scale: bool = True, prior_gyro: float = 1e2,
                  prior_acc: float = 1e2, t_off=None):
    """Gravity direction, velocities, one shared bias and (optimize_scale)
    the scale of a keyframe chain: Gauss-Newton on [log s, theta_g(2),
    bg(3), ba(3), v(3K)] with forward-mode Jacobians. R_wb [K,3,3]
    world-from-body rotations; t_wb [K,3] the scale-dependent body position
    (the camera centres); t_off [K,3] the metric extrinsic offset, so
    p_body(s) = s t_wb + t_off; preints stacked over the K-1 edges. `dts`
    is unused, as in the reference package. Returns a dict of scale,
    gravity, bias_g, bias_a, velocities, residual_norm."""
    K = R_wb.shape[0]
    dev = R_wb.device
    if t_off is None:
        t_off = torch.zeros_like(t_wb)
    G = g_vec(R_wb)
    n = 9 + 3 * K
    mv = lambda M, v: torch.einsum('...ij,...j->...i', M, v)  # noqa: E731

    def unpack(x):
        s = torch.exp(x[..., 0])
        th = x[..., 1:3]
        bg = x[..., 3:6]
        ba = x[..., 6:9]
        v = x[..., 9:].reshape(x.shape[:-1] + (K, 3))
        Rg = lie.so3_exp(torch.cat([th, torch.zeros_like(th[..., :1])], -1))
        g = mv(Rg, G)
        return s, g, bg, ba, v

    def residuals(x):                          # x [..., n] -> [..., m]
        s, g, bg, ba, v = unpack(x)
        lead = x.shape[:-1]
        bg_e, ba_e = bg[..., None, :], ba[..., None, :]     # [...,1,3]
        dR, dV, dP = corrected_deltas(preints, bg_e, ba_e)   # [...,E,...]
        dt = preints.dt[..., None]
        R1 = R_wb[:-1]
        p = s[..., None, None] * t_wb + t_off               # [...,K,3]
        p1, p2 = p[..., :-1, :], p[..., 1:, :]
        v1, v2 = v[..., :-1, :], v[..., 1:, :]
        g_e = g[..., None, :]
        R1T = R1.transpose(-1, -2)
        er = lie.so3_log(dR.transpose(-1, -2) @ R1T @ R_wb[1:])
        ev = mv(R1T, v2 - v1 - g_e * dt) - dV
        ep = mv(R1T, p2 - p1 - v1 * dt - 0.5 * g_e * dt * dt) - dP
        chain = torch.cat([er, ev, ep], -1).reshape(lead + (-1,))
        prior = torch.cat([prior_gyro ** 0.5 * bg, prior_acc ** 0.5 * ba],
                          -1)
        return torch.cat([chain, prior], -1)

    x = torch.zeros(n, device=dev)
    eye = torch.eye(n, device=dev)
    keep = torch.cat([torch.full((1,), float(optimize_scale), device=dev),
                      torch.ones(n - 1, device=dev)])
    e0 = eye[0]
    for _ in range(iters):
        r, J = dla.jacfwd(residuals, x)
        H = J.T @ J + 1e-6 * eye
        g_v = J.T @ r
        if not optimize_scale:
            H = H * keep[:, None] * keep[None, :] + e0[:, None] * e0[None, :]
            g_v = g_v * keep
        x = x - dla.chol_solve(H, g_v)
    s, g, bg, ba, v = unpack(x)
    r = residuals(x)
    return dict(scale=s, gravity=g, bias_g=bg, bias_a=ba, velocities=v,
                residual_norm=torch.linalg.norm(r))
