"""Lie-group operations on SO(3)/SE(3)/Sim(3) — the subset the tracking,
mapping, loop-closing and inertial paths use (counterpart of
dani_slam_tpu/core/lie.py).

Conventions as in the reference package: rotations are 3x3 matrices, poses
are (R, t) pairs, every function broadcasts over leading batch dims, tangent
ordering for se3 is [rho (trans), phi (rot)], small-angle branches are
torch.where Taylor expansions (no data-dependent host control flow).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def vee(Phi: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]],
                       dim=-1)


def _sinc_terms(theta2: torch.Tensor):
    """(sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) with Taylor fallbacks."""
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return a, b, c


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation matrix."""
    theta2 = torch.sum(phi * phi, dim=-1)
    a, b, _ = _sinc_terms(theta2)
    K = hat(phi)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Matrix log: (...,3,3) -> (...,3) axis-angle, through the quaternion
    (stable near theta = 0 and theta = pi)."""
    return quat_to_axis_angle(mat_to_quat(R))


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    _, b, c = _sinc_terms(theta2)
    K = hat(phi)
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r(phi) = J_l(-phi) (IMU preintegration)."""
    return so3_left_jacobian(-phi)


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < _EPS
    half = 0.5 * theta
    # 1/theta^2 - (1+cos)/(2 theta sin) == (1 - half*cot(half))/theta^2
    cot_coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half))
        / torch.clamp(theta2, min=1e-24))
    K = hat(phi)
    return _eye_like(K) - 0.5 * K + cot_coef[..., None, None] * (K @ K)


def so3_right_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    return so3_left_jacobian_inv(-phi)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (...,4) wxyz -> rotation matrix (...,3,3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> unit quaternion (...,4) wxyz, w >= 0
    (branch-free Shepperd: the candidate with the largest pivot wins)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)        # (...,4 cands,4)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion wxyz -> axis-angle (...,3)."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vnorm, w)
    # theta / sin(theta/2) with its Taylor fallback
    scale = torch.where(vnorm < 1e-8, 2.0 / torch.clamp(w, min=1e-8),
                        theta / torch.clamp(vnorm, min=1e-24))
    return v * scale[..., None]


def se3_exp(xi: torch.Tensor):
    """se(3) exp: (...,6) [rho, phi] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    return R, torch.einsum('...ij,...j->...i', V, rho)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> (...,6) [rho, phi]."""
    phi = so3_log(R)
    rho = torch.einsum('...ij,...j->...i', so3_left_jacobian_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def se3_inv(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum('...ij,...j->...i', Rt, t)


def se3_mul(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb)."""
    return Ra @ Rb, torch.einsum('...ij,...j->...i', Ra, tb) + ta


def se3_apply(R, t, p):
    """Apply pose to points: R p + t. p: (...,3)."""
    return torch.einsum('...ij,...j->...i', R, p) + t


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) via a quaternion round trip
    (f32 pose-velocity feedback otherwise amplifies det(R) drift)."""
    return quat_to_mat(mat_to_quat(R))


# ---------------------------------------------------------------------------
# Sim(3) as (R, t, s) triples: action p -> s R p + t
# ---------------------------------------------------------------------------

def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The W matrix of the Sim(3) exp, t = W rho: A*Omega + B*Omega^2 + C*I
    with the small-angle / small-scale Taylor branches of the reference
    package (Strasdat/Sophus form, branch-free)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    s = torch.exp(sigma)
    Omega = hat(phi)
    Omega2 = Omega @ Omega
    eye = _eye_like(Omega)
    one = torch.ones_like(sigma)

    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta2 < _EPS
    sig_safe = torch.where(small_sig, one, sigma)
    th_safe = torch.where(small_th, one, theta)
    th2_safe = torch.where(small_th, one, theta2)

    # sigma ~ 0
    A_ss = torch.where(small_th, 0.5 * one,
                       (1.0 - torch.cos(th_safe)) / th2_safe)
    B_ss = torch.where(small_th, one / 6.0,
                       (th_safe - torch.sin(th_safe)) / (th2_safe * th_safe))
    C_ss = one

    # sigma != 0
    C_gen = (s - 1.0) / sig_safe
    sig2 = sig_safe * sig_safe
    A_s0 = ((sig_safe - 1.0) * s + 1.0) / sig2               # theta ~ 0
    B_s0 = (s * 0.5 * sig2 + s - 1.0 - sig_safe * s) / (sig2 * sig_safe)
    a_ = s * torch.sin(th_safe)
    b_ = s * torch.cos(th_safe)
    c_ = th2_safe + sigma * sigma
    A_g = (a_ * sigma + (1.0 - b_) * th_safe) / (th_safe * c_)
    B_g = (C_gen - ((b_ - 1.0) * sigma + a_ * th_safe) / c_) / th2_safe
    A_gen = torch.where(small_th, A_s0, A_g)
    B_gen = torch.where(small_th, B_s0, B_g)

    A = torch.where(small_sig, A_ss, A_gen)
    B = torch.where(small_sig, B_ss, B_gen)
    C = torch.where(small_sig, C_ss, C_gen)
    return (A[..., None, None] * Omega + B[..., None, None] * Omega2
            + C[..., None, None] * eye)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for (...,3,3) A by the adjugate: elementwise, differentiable
    in forward mode, and without the host read that torch.linalg.solve
    makes to check for a singular matrix (the reference package calls a
    general solve)."""
    c0 = torch.linalg.cross(A[..., 1, :], A[..., 2, :])
    c1 = torch.linalg.cross(A[..., 2, :], A[..., 0, :])
    c2 = torch.linalg.cross(A[..., 0, :], A[..., 1, :])
    det = torch.sum(A[..., 0, :] * c0, dim=-1)
    adj_b = c0 * b[..., 0:1] + c1 * b[..., 1:2] + c2 * b[..., 2:3]
    return adj_b / det[..., None]


def sim3_exp(xi: torch.Tensor):
    """sim(3) exp: (...,7) [rho, phi, sigma] -> (R, t, s)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(phi)
    W = _sim3_W(phi, sigma)
    return R, torch.einsum('...ij,...j->...i', W, rho), torch.exp(sigma)


def sim3_log(R, t, s) -> torch.Tensor:
    """(R, t, s) -> (...,7) [rho, phi, sigma]."""
    phi = so3_log(R)
    sigma = torch.log(s)
    rho = _solve3(_sim3_W(phi, sigma), t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_inv(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return (Rt, -s_inv[..., None] * torch.einsum('...ij,...j->...i', Rt, t),
            s_inv)


def sim3_mul(Ra, ta, sa, Rb, tb, sb):
    """(Ra,ta,sa) * (Rb,tb,sb): action p -> sa Ra (sb Rb p + tb) + ta."""
    return (Ra @ Rb,
            sa[..., None] * torch.einsum('...ij,...j->...i', Ra, tb) + ta,
            sa * sb)


def sim3_apply(R, t, s, p):
    return s[..., None] * torch.einsum('...ij,...j->...i', R, p) + t
