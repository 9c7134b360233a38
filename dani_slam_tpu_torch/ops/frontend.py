"""Keypoint selection front-end (counterpart of dani_slam_tpu/ops/frontend.py):
NMS, spatially-balanced top-k, dynamic-box suppression, descriptor sampling,
the multi-level pyramid extraction.

Fixed shapes throughout: the output is always (n_max, ...) with a validity
mask. Every "top-k" is a STABLE descending sort: the reference's
jax.lax.top_k / argsort keep the lower index first among equal scores, and
after NMS the heatmap holds many equal (zero) scores, so torch.topk's
unspecified tie order would pick other padding slots.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dani_slam_tpu_torch.models import superpoint
from dani_slam_tpu_torch.ops import image as image_ops


def nms_heatmap(heat: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Zero out non-local-maxima within a (2r+1)^2 window (SAME padding with
    -inf, as max_pool2d pads)."""
    k = 2 * radius + 1
    m = F.max_pool2d(heat[None, None], k, stride=1, padding=radius)[0, 0]
    return torch.where(heat >= m, heat, torch.zeros_like(heat))


def select_keypoints(heat: torch.Tensor, n_max: int = 1024,
                     threshold=0.007, cell: int = 16, k_cell: int = 8,
                     border: int = 8, nms_radius: int = 4):
    """Select up to n_max spatially-spread keypoints from a heatmap [H,W].
    Returns (xy [n_max,2] f32 (x,y), score [n_max], valid [n_max] bool),
    sorted by descending score: NMS + per-cell top-k_cell + global top-n_max
    over the cell survivors with a score threshold."""
    H, W = heat.shape
    dev = heat.device
    h = nms_heatmap(heat, nms_radius)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inb = (xx >= border) & (xx < W - border) & (yy >= border) & \
        (yy < H - border)
    h = torch.where(inb, h, torch.zeros_like(h))
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    hp = F.pad(h, (0, Wp - W, 0, Hp - H))
    nCy, nCx = Hp // cell, Wp // cell
    cells = hp.reshape(nCy, cell, nCx, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(nCy * nCx, cell * cell)
    cs, ci = torch.sort(cells, dim=1, descending=True, stable=True)
    cs, ci = cs[:, :k_cell], ci[:, :k_cell]
    cell_ids = torch.arange(nCy * nCx, device=dev)[:, None]
    cy = (cell_ids // nCx) * cell + ci // cell
    cx = (cell_ids % nCx) * cell + ci % cell
    flat_s, flat_x, flat_y = cs.reshape(-1), cx.reshape(-1), cy.reshape(-1)
    n_cand = flat_s.shape[0]
    if n_cand < n_max:
        pad = (0, n_max - n_cand)
        flat_s, flat_x, flat_y = (F.pad(flat_s, pad), F.pad(flat_x, pad),
                                  F.pad(flat_y, pad))
    top_i = torch.argsort(-flat_s, stable=True)[:n_max]
    top_s = flat_s[top_i]
    xy = torch.stack([flat_x[top_i], flat_y[top_i]], dim=-1).to(torch.float32)
    return xy, top_s, top_s > threshold


def suppress_in_boxes(xy: torch.Tensor, valid: torch.Tensor,
                      boxes: torch.Tensor, box_mask: torch.Tensor):
    """Invalidate keypoints inside any active dynamic box (xyxy)."""
    x, y = xy[..., 0, None], xy[..., 1, None]
    inside = ((x >= boxes[..., 0]) & (x <= boxes[..., 2]) &
              (y >= boxes[..., 1]) & (y <= boxes[..., 3]))
    return valid & ~torch.any(inside & box_mask, dim=-1)


def sample_descriptors(desc_map: torch.Tensor, xy: torch.Tensor,
                       stride: int = 8) -> torch.Tensor:
    """Bilinearly sample the dense descriptor map (Hc, Wc, D) at keypoint
    pixel coords and re-normalize (gather-4 + lerp)."""
    Hc, Wc, _ = desc_map.shape
    gx = (xy[..., 0] + 0.5) / stride - 0.5
    gy = (xy[..., 1] + 0.5) / stride - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0)[..., None]
    fy = (gy - y0)[..., None]
    x0i = torch.clamp(x0.long(), 0, Wc - 1)
    x1i = torch.clamp(x0i + 1, 0, Wc - 1)
    y0i = torch.clamp(y0.long(), 0, Hc - 1)
    y1i = torch.clamp(y0i + 1, 0, Hc - 1)
    v00, v01 = desc_map[y0i, x0i], desc_map[y0i, x1i]
    v10, v11 = desc_map[y1i, x0i], desc_map[y1i, x1i]
    d = ((v00 * (1 - fx) + v01 * fx) * (1 - fy) +
         (v10 * (1 - fx) + v11 * fx) * fy)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                           min=1e-8)


def extract(heat: torch.Tensor, desc_map: torch.Tensor, n_max: int = 1024,
            threshold=0.007, boxes=None, box_mask=None):
    """Heatmap + dense descriptors -> fixed-size keypoint set:
    dict(xy [N,2], score [N], desc [N,D], valid [N])."""
    xy, score, valid = select_keypoints(heat, n_max=n_max,
                                        threshold=threshold)
    if boxes is not None:
        valid = suppress_in_boxes(xy, valid, boxes, box_mask)
    desc = sample_descriptors(desc_map, xy)
    return dict(xy=xy, score=score, desc=desc, valid=valid)


def extract_multiscale(sp_model, gray: torch.Tensor, n_max: int = 1024,
                       n_levels: int = 3, scale_factor: float = 1.2,
                       threshold=0.007):
    """Multi-level pyramid extraction: SuperPoint once per level, per-level
    budgets n_max * s^-l / sum_k s^-k (rounded, at least 1, the remainder
    on level 0), keypoints rescaled to level-0 pixels. Returns dict(xy,
    score, desc, valid, octave int8) of n_max rows, level 0 first."""
    levels = image_ops.gaussian_pyramid(gray, n_levels, scale_factor)
    inv = [scale_factor ** -lv for lv in range(n_levels)]
    denom = sum(inv)
    budgets = [max(int(round(n_max * w / denom)), 1) for w in inv]
    budgets[0] += n_max - sum(budgets)
    outs = []
    for lvl, (img, budget) in enumerate(zip(levels, budgets)):
        heat, dm = superpoint.apply(sp_model, img)
        out = extract(heat, dm, n_max=budget, threshold=threshold)
        out["xy"] = out["xy"] * scale_factor ** lvl
        out["octave"] = torch.full((budget,), lvl, dtype=torch.int8,
                                   device=gray.device)
        outs.append(out)
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
