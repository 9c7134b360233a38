"""Lie-group operations on SO(3)/SE(3) — the subset the RGB-D tracking and
local-mapping path uses (counterpart of dani_slam_tpu/core/lie.py).

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


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    _, b, c = _sinc_terms(theta2)
    K = hat(phi)
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)


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


def se3_exp(xi: torch.Tensor):
    """se(3) exp: (...,6) [rho, phi] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    return R, torch.einsum('...ij,...j->...i', V, rho)


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
