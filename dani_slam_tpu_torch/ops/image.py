"""Image preprocessing (counterpart of dani_slam_tpu/ops/image.py): gray
conversion, antialiased bilinear resize, the scale pyramid, the remap of
stereo rectification, TUM depth decoding. Images keep the JAX package's HWC
layout at these public functions."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """RGB (...,H,W,3) uint8/float -> grayscale (...,H,W) float32 in [0,1]."""
    img = img.to(torch.float32)
    if img.shape[-1] == 3:
        g = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    else:
        g = img[..., 0]
    return g / 255.0


def to_gray01(img: torch.Tensor) -> torch.Tensor:
    """Accept HxW, HxWx1 or HxWx3, uint8 or float; return HxW float32 [0,1]."""
    if img.ndim >= 3 and img.shape[-1] in (1, 3):
        return rgb_to_gray(img)
    img = img.to(torch.float32)
    return torch.where(torch.max(img) > 1.5, img / 255.0, img)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (H,W) or (H,W,C) with half-pixel centres and, when
    downsampling, a triangle filter widened by the scale — the semantics of
    jax.image.resize(..., "bilinear") (antialias=True by default there)."""
    x = img.to(torch.float32)
    chw = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(chw, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=True)[0]
    return y[0] if img.ndim == 2 else y.permute(1, 2, 0)


def gaussian_pyramid(img: torch.Tensor, n_levels: int, scale: float = 1.2):
    """Image pyramid as a list: level l is img resized to
    (round(H / scale^l), round(W / scale^l)) by resize_bilinear."""
    H, W = img.shape[:2]
    levels = [img]
    for lv in range(1, n_levels):
        s = scale ** lv
        levels.append(resize_bilinear(img, int(round(H / s)),
                                      int(round(W / s))))
    return levels


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """cv::remap: sample img (H,W) or (H,W,C) bilinearly at float
    coordinates (map_x, map_y) [h,w]; 0 where a coordinate lies outside
    [0, W-1] x [0, H-1]. The result is float32."""
    H, W = img.shape[:2]
    x = img.to(torch.float32)
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = torch.clamp(x0.long(), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y0i = torch.clamp(y0.long(), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    v00, v01 = x[y0i, x0i], x[y0i, x1i]
    v10, v11 = x[y1i, x0i], x[y1i, x1i]
    inside = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & \
        (map_y <= H - 1)
    if img.ndim == 3:
        fx, fy, inside = fx[..., None], fy[..., None], inside[..., None]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return torch.where(inside, out, torch.zeros_like(out))


def depth_from_encoded(depth_raw: torch.Tensor,
                       depth_factor) -> torch.Tensor:
    """Decode 16-bit TUM-style depth to meters (<= 0 -> inf)."""
    d = depth_raw.to(torch.float32) / depth_factor
    return torch.where(d <= 0, torch.full_like(d, float("inf")), d)
