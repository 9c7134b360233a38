"""Stereo rectification: row-aligned virtual cameras and remap grids
(counterpart of dani_slam_tpu/ops/rectify.py; reference: Settings
precomputes the maps with cv::stereoRectify + cv::initUndistortRectifyMap,
System::TrackStereo applies cv::remap per frame).

The rotations are computed once on the host in float64 numpy (Bouguet's
half-rotation construction with shared mean intrinsics, the reference
package's own simplification); the per-pixel source grids are built on the
camera's device, and the per-frame remap is ops/image.remap_bilinear.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.ops import image as image_ops


def _rodrigues(om: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(om))
    if th < 1e-12:
        return np.eye(3)
    k = om / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _rotvec(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    th = float(np.arccos(cos))
    if th < 1e-12:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * v


def stereo_rectify(K1, D1, K2, D2, R, T, size):
    """Bouguet rectification for x2 = R x1 + T (cam2 from cam1). Returns
    (R1, R2, K_new, baseline): the rectifying rotations (x_rect = R_i
    x_cam), the shared rectified pinhole intrinsics and the rectified
    baseline in metres. D1/D2 are not used (the grids carry distortion)."""
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    W, H = size
    om = _rotvec(R)
    r_half_pos = _rodrigues(0.5 * om)
    r_half_neg = _rodrigues(-0.5 * om)
    # half the rotation on each camera leaves a pure translation between
    # the frames; its direction becomes the new x axis
    t_new = r_half_neg @ T
    e1 = t_new / max(np.linalg.norm(t_new), 1e-12)
    if e1[0] < 0:
        e1 = -e1
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    e2 = np.array([0.0, 1.0, 0.0]) if n2 < 1e-9 else e2 / n2
    e3 = np.cross(e1, e2)
    Rw = np.stack([e1, e2, e3], axis=0)
    f_new = 0.5 * (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 2
    K_new = np.array([[f_new, 0, (W - 1) / 2], [0, f_new, (H - 1) / 2],
                      [0, 0, 1.0]])
    return Rw @ r_half_pos, Rw @ r_half_neg, K_new, float(
        np.linalg.norm(t_new))


def rectify_map(cam: _cam.Camera, R_rect, K_new, size) -> torch.Tensor:
    """Source-pixel grid [H,W,2] of one camera: for each RECTIFIED pixel the
    raw image coordinate to sample (cv::initUndistortRectifyMap), through
    the original camera model `cam` (pinhole or KB8)."""
    W, H = size
    dev = cam.device
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    Kinv = torch.as_tensor(np.linalg.inv(K_new), dtype=torch.float32,
                           device=dev)
    rays = torch.stack([u, v, torch.ones_like(u)], dim=-1) @ Kinv.T
    # rectified rays back into the original camera frame: R^T ray
    rays_cam = rays @ torch.as_tensor(R_rect, dtype=torch.float32,
                                      device=dev)
    return _cam.project(cam, rays_cam.reshape(-1, 3)).reshape(H, W, 2)


class StereoRectifier(NamedTuple):
    """Precomputed rectification: the two source grids, the rectified
    pinhole camera the whole pipeline then uses, and the baseline [m]."""
    map_l: torch.Tensor       # [H,W,2] raw coords per rectified pixel (left)
    map_r: torch.Tensor
    cam: _cam.Camera
    baseline: float

    def __call__(self, img_l, img_r):
        return (image_ops.remap_bilinear(img_l, self.map_l[..., 0],
                                         self.map_l[..., 1]),
                image_ops.remap_bilinear(img_r, self.map_r[..., 0],
                                         self.map_r[..., 1]))


def build_rectifier(cam_l: _cam.Camera, cam_r: _cam.Camera, R, T,
                    size) -> StereoRectifier:
    """cam_l/cam_r: the original camera models; R, T: cam_r from cam_l."""
    def K_of(c):
        fx, fy, cx, cy = (float(x) for x in c.params[:4].cpu())
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    R1, R2, K_new, baseline = stereo_rectify(K_of(cam_l), None, K_of(cam_r),
                                             None, R, T, size)
    cam_new = _cam.Camera.pinhole(float(K_new[0, 0]), float(K_new[1, 1]),
                                  float(K_new[0, 2]), float(K_new[1, 2]),
                                  size[0], size[1], device=cam_l.device)
    return StereoRectifier(rectify_map(cam_l, R1, K_new, size),
                           rectify_map(cam_r, R2, K_new, size), cam_new,
                           baseline)
