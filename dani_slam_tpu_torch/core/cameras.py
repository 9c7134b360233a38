"""Camera models: pinhole and Kannala-Brandt-8 fisheye, radial-tangential
distortion, and the two-view geometry helpers (counterpart of
dani_slam_tpu/core/cameras.py).

Parameter layouts as in the reference package: PINHOLE [fx, fy, cx, cy],
KB8 [fx, fy, cx, cy, k0, k1, k2, k3], dist [k1, k2, p1, p2, k3]. The pinhole
projection Jacobian is written in closed form (the JAX package derives it
with jacfwd; the expressions are identical, including the |z| < 1e-9 guard,
whose branch has zero derivative); the KB8 one is taken by forward-mode
differentiation of the projection (ops/linalg.jacfwd), as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from dani_slam_tpu_torch.ops import linalg
from dani_slam_tpu_torch.utils.device import resolve_device

PINHOLE = 0
KB8 = 1


@dataclasses.dataclass(frozen=True)
class Camera:
    """Intrinsics on a device. `width`/`height`/`kind` are plain ints."""
    params: torch.Tensor              # (4,) pinhole | (8,) KB8, float32
    dist: torch.Tensor                # (5,) radtan (zeros ok)
    width: int = 640
    height: int = 480
    kind: int = PINHOLE

    @staticmethod
    def pinhole(fx, fy, cx, cy, width, height, dist=None, device="cuda"):
        device = resolve_device(device)
        d = (torch.zeros(5, dtype=torch.float32, device=device) if dist is None
             else torch.as_tensor(dist, dtype=torch.float32, device=device))
        p = torch.tensor([fx, fy, cx, cy], dtype=torch.float32, device=device)
        return Camera(p, d, int(width), int(height), PINHOLE)

    @staticmethod
    def kb8(fx, fy, cx, cy, k0, k1, k2, k3, width, height, device="cuda"):
        device = resolve_device(device)
        p = torch.tensor([fx, fy, cx, cy, k0, k1, k2, k3],
                         dtype=torch.float32, device=device)
        return Camera(p, torch.zeros(5, dtype=torch.float32, device=device),
                      int(width), int(height), KB8)

    @property
    def device(self) -> torch.device:
        return self.params.device


def _z_safe(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: Camera, pts3d: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3-D points (...,3) -> pixels (...,2)."""
    if cam.kind == KB8:
        return _kb8_project(cam.params, pts3d)
    p = cam.params
    z = _z_safe(pts3d[..., 2])
    u = p[0] * pts3d[..., 0] / z + p[2]
    v = p[1] * pts3d[..., 1] / z + p[3]
    return torch.stack([u, v], dim=-1)


def _kb8_project(p, x):
    """Equidistant (Kannala-Brandt) projection: theta_d = theta (1 + k0
    theta^2 + ... + k3 theta^8), pixel = f x theta_d / r + c."""
    z = x[..., 2]
    r = torch.sqrt(torch.clamp(x[..., 0] ** 2 + x[..., 1] ** 2, min=1e-18))
    theta = torch.atan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1 + t2 * (p[4] + t2 * (p[5] + t2 * (p[6] +
                                                          t2 * p[7]))))
    scale = torch.where(r < 1e-9, 1.0 / _z_safe(z), theta_d / r)
    return torch.stack([p[0] * x[..., 0] * scale + p[2],
                        p[1] * x[..., 1] * scale + p[3]], dim=-1)


def project_jac(cam: Camera, pts3d: torch.Tensor) -> torch.Tensor:
    """d(pixel)/d(point): (...,2,3); closed form of the pinhole projection
    u = fx x / z_s + cx with z_s = where(|z| < 1e-9, 1e-9, z), forward-mode
    derivatives of the KB8 projection."""
    if cam.kind == KB8:
        return linalg.jacfwd(lambda q: _kb8_project(cam.params, q),
                             pts3d)[1]
    p = cam.params
    x, y, z = pts3d[..., 0], pts3d[..., 1], pts3d[..., 2]
    live = torch.abs(z) >= 1e-9
    zs = _z_safe(z)
    zero = torch.zeros_like(x)
    du_dx = p[0] / zs
    dv_dy = p[1] / zs
    # d/dz of (f * x / z_s): -f x / z_s^2, times d z_s / d z (0 in the guard)
    du_dz = torch.where(live, -(p[0] * x) / (zs * zs), zero)
    dv_dz = torch.where(live, -(p[1] * y) / (zs * zs), zero)
    return torch.stack([torch.stack([du_dx, zero, du_dz], dim=-1),
                        torch.stack([zero, dv_dy, dv_dz], dim=-1)], dim=-2)


def unproject(cam: Camera, px: torch.Tensor) -> torch.Tensor:
    """Pixels (...,2) -> unit-depth camera rays (...,3) with z=1."""
    if cam.kind == KB8:
        return _kb8_unproject(cam.params, px)
    p = cam.params
    mx = (px[..., 0] - p[2]) / p[0]
    my = (px[..., 1] - p[3]) / p[1]
    return torch.stack([mx, my, torch.ones_like(mx)], dim=-1)


def _kb8_unproject(p, px, iters: int = 10):
    """Invert the equidistant distortion by a fixed number of Newton steps
    from theta = theta_d (clipped to +-pi/2)."""
    mx = (px[..., 0] - p[2]) / p[0]
    my = (px[..., 1] - p[3]) / p[1]
    theta_d = torch.sqrt(mx * mx + my * my)
    theta_d_c = torch.clamp(theta_d, -torch.pi / 2, torch.pi / 2)
    theta = theta_d_c
    for _ in range(iters):
        t2 = theta * theta
        k_part = p[4] + t2 * (p[5] + t2 * (p[6] + t2 * p[7]))
        f = theta * (1 + t2 * k_part) - theta_d_c
        fp = 1 + t2 * (3 * p[4] + t2 * (5 * p[5] + t2 * (7 * p[6] +
                                                         9 * t2 * p[7])))
        theta = theta - f / torch.where(torch.abs(fp) < 1e-9,
                                        torch.full_like(fp, 1e-9), fp)
    scale = torch.where(theta_d < 1e-9, torch.ones_like(theta_d),
                        torch.tan(theta) / theta_d)
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def unproject_bearing(cam: Camera, px: torch.Tensor) -> torch.Tensor:
    """Pixels -> unit-norm bearing vectors."""
    ray = unproject(cam, px)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def radtan_distort(dist: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Normalized coords (...,2) -> distorted normalized coords (...,2)
    (OpenCV radial-tangential model)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def radtan_undistort(dist: torch.Tensor, xd: torch.Tensor,
                      iters: int = 8) -> torch.Tensor:
    """Fixed-point inversion of radtan distortion (cv::undistortPoints)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        xn = torch.stack([(xd[..., 0] - dx) / radial,
                          (xd[..., 1] - dy) / radial], dim=-1)
    return xn


def undistort_keypoints(cam: Camera, px: torch.Tensor) -> torch.Tensor:
    """Pixel keypoints -> undistorted pixel keypoints (no-op up to rounding
    when dist == 0)."""
    p = cam.params
    mx = (px[..., 0] - p[2]) / p[0]
    my = (px[..., 1] - p[3]) / p[1]
    xn = radtan_undistort(cam.dist, torch.stack([mx, my], dim=-1))
    return torch.stack([xn[..., 0] * p[0] + p[2], xn[..., 1] * p[1] + p[3]],
                       dim=-1)


def triangulate_midpoint(ray1: torch.Tensor, ray2: torch.Tensor,
                         R21: torch.Tensor, t21: torch.Tensor):
    """Closed-form midpoint triangulation of matched rays; X in cam1.
    R21/t21 may carry leading batch dims matching ray1/ray2's."""
    d1 = ray1
    d2 = torch.einsum('...ji,...nj->...ni', R21, ray2)       # ray2 in cam1
    C2 = -torch.einsum('...ji,...j->...i', R21, t21)[..., None, :]
    a = torch.sum(d1 * d1, -1)
    b = torch.sum(d1 * d2, -1)
    c = torch.sum(d2 * d2, -1)
    e = torch.sum(d1 * C2, -1)
    f = torch.sum(d2 * C2, -1)
    den = a * c - b * b
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12),
                      den)
    s = (e * c - b * f) / den
    u = (e * b - a * f) / den
    return 0.5 * (s[..., None] * d1 + C2 + u[..., None] * d2)


def epipolar_error(cam1: Camera, cam2: Camera, kp1: torch.Tensor,
                   kp2: torch.Tensor, R12: torch.Tensor,
                   t12: torch.Tensor) -> torch.Tensor:
    """Squared point-to-epipolar-line distance of kp2 with respect to
    (R12, t12), on unprojected rays (either camera model)."""
    z = torch.zeros_like(t12[..., 0])
    t12x = torch.stack([
        torch.stack([z, -t12[..., 2], t12[..., 1]], -1),
        torch.stack([t12[..., 2], z, -t12[..., 0]], -1),
        torch.stack([-t12[..., 1], t12[..., 0], z], -1)], -2)
    E = t12x @ R12
    r1 = unproject(cam1, kp1)
    r2 = unproject(cam2, kp2)
    l2 = torch.einsum('...ij,...j->...i', E, r1)       # epipolar line in cam2
    num = torch.einsum('...i,...i->...', r2, l2) ** 2
    den = l2[..., 0] ** 2 + l2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def triangulate_two_view(ray1: torch.Tensor, ray2: torch.Tensor,
                         R21: torch.Tensor, t21: torch.Tensor):
    """DLT triangulation of matched rays [...,3] between two cameras with
    relative pose (R21, t21) mapping cam1 coordinates to cam2: the null
    vector of the 4x4 system of P1 = [I|0] and P2 = [R21|t21], by an SVD of
    the system itself (on the card a counted host wait, ops/linalg.svd).
    Returns X in cam1."""
    def rows(ray, P):
        x, y, z = ray[..., 0], ray[..., 1], ray[..., 2]
        return torch.stack([x[..., None] * P[..., 2, :] -
                            z[..., None] * P[..., 0, :],
                            y[..., None] * P[..., 2, :] -
                            z[..., None] * P[..., 1, :]], dim=-2)
    batch = ray1.shape[:-1]
    eye = torch.eye(3, dtype=ray1.dtype, device=ray1.device)
    P1 = torch.cat([eye, torch.zeros((3, 1), dtype=ray1.dtype,
                                     device=ray1.device)], dim=1)
    P1 = P1.expand(batch + (3, 4))
    P2 = torch.cat([R21, t21[..., None]], dim=-1).expand(batch + (3, 4))
    A = torch.cat([rows(ray1, P1), rows(ray2, P2)], dim=-2)
    _, _, Vh = linalg.svd(A)
    X = Vh[..., 3, :]
    w = X[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w_safe[..., None]


def stereo_depth_from_disparity(fx, baseline, disparity: torch.Tensor):
    """Metric depth fx * baseline / disparity (inf where disparity <= 0)."""
    d = torch.where(disparity <= 0, torch.full_like(disparity, float("inf")),
                    disparity)
    return fx * baseline / d
