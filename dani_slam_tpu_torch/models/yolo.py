"""Compact YOLO detector for dynamic-region masking (counterpart of
dani_slam_tpu/models/yolo.py): a CSP-style conv backbone with three anchor
heads, decode, class-aware greedy NMS, RefineDynamicBoxes and the dynamic
area ratio — all fixed-shape tensor code with no host round trip.

Translation notes:
  * Flax `padding="SAME"` pads the extra row/column at the bottom/right when
    the total padding is odd (a stride-2 3x3 conv on an even input); torch's
    symmetric `padding=k//2` would shift the output by a pixel, so every conv
    pads explicitly with F.pad (same_pad) and convolves with padding=0.
  * convs run in bfloat16 with float32 parameters, activations stay bf16
    between layers, heads leave in float32 (as in the reference package).
  * jax.image.resize(..., "bilinear") antialiases when downsampling:
    ops/image.resize_bilinear.
  * argsort/argmax tie order: stable sorts, first-index argmax.
Public functions keep the JAX layouts: head outputs (H, W, 3, 5+nc), boxes
xyxy in pixels.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dani_slam_tpu_torch.models import convert
from dani_slam_tpu_torch.ops import image as image_ops
from dani_slam_tpu_torch.utils.device import const, resolve_device

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "..",
                       "dani_slam_tpu", "weights", "yolo_synthetic.npz")

DYNAMIC_CLASS_IDS = (0, 1, 2, 3, 5, 6, 7, 8, 14, 15, 16, 17, 18, 19)

ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
STRIDES = (8, 16, 32)


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Flax/TF "SAME" padding for an NCHW input: out = ceil(n/s), the odd
    extra row/column goes to the bottom/right."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):           # F.pad order: W then H
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ConvAct(nn.Module):
    """Bias-free conv + SiLU (the reference's `_conv_bn`, which carries no
    BatchNorm)."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1):
        super().__init__()
        self.k, self.s = k, s
        self.conv = nn.Conv2d(cin, cout, k, stride=s, bias=False)

    def forward(self, x):
        w = self.conv.weight.to(x.dtype)
        return F.silu(F.conv2d(same_pad(x, self.k, self.s), w,
                               stride=self.s))


class C3Block(nn.Module):
    """Simplified CSP bottleneck (C3)."""

    def __init__(self, cin: int, ch: int, n: int = 1):
        super().__init__()
        h = ch // 2
        self.n = n
        self.cv1 = ConvAct(cin, h, 1)
        self.cv2 = ConvAct(cin, h, 1)
        for i in range(n):
            setattr(self, f"m{i}a", ConvAct(h, h, 1))
            setattr(self, f"m{i}b", ConvAct(h, h, 3))
        self.cv3 = ConvAct(2 * h, ch, 1)

    def forward(self, x):
        a = self.cv1(x)
        b = self.cv2(x)
        for i in range(self.n):
            a = a + getattr(self, f"m{i}b")(getattr(self, f"m{i}a")(a))
        return self.cv3(torch.cat([a, b], dim=1))


class YoloNet(nn.Module):
    """Compact YOLOv5-style detector: 3 scales x 3 anchors x (5+nc).
    Input one image (H, W, 3) float; output [(H/s, W/s, 3, 5+nc)] f32."""

    def __init__(self, num_classes: int = 80, width: int = 32,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        w = width
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.stem = ConvAct(3, w, 6, 2)
        self.d1 = ConvAct(w, 2 * w, 3, 2)
        self.c1 = C3Block(2 * w, 2 * w, 1)
        self.d2 = ConvAct(2 * w, 4 * w, 3, 2)
        self.c2 = C3Block(4 * w, 4 * w, 2)
        self.d3 = ConvAct(4 * w, 8 * w, 3, 2)
        self.c3 = C3Block(8 * w, 8 * w, 2)
        self.d4 = ConvAct(8 * w, 16 * w, 3, 2)
        self.c4 = C3Block(16 * w, 16 * w, 1)
        no = 3 * (5 + num_classes)
        for i, c in enumerate((4 * w, 8 * w, 16 * w)):
            setattr(self, f"head{i}", nn.Conv2d(c, no, 1))

    def forward(self, img: torch.Tensor):
        x = img.permute(2, 0, 1)[None].to(self.compute_dtype)
        x = self.c1(self.d1(self.stem(x)))
        p3 = self.c2(self.d2(x))
        p4 = self.c3(self.d3(p3))
        p5 = self.c4(self.d4(p4))
        outs = []
        for i, p in enumerate((p3, p4, p5)):
            head = getattr(self, f"head{i}")
            h = F.conv2d(p, head.weight.to(p.dtype), head.bias.to(p.dtype))
            h = h.to(torch.float32)[0].permute(1, 2, 0)      # (H, W, no)
            outs.append(h.reshape(h.shape[0], h.shape[1], 3,
                                  5 + self.num_classes))
        return outs


def decode_predictions(outs, top_k: int = 256, anchors_per_scale=ANCHORS,
                       strides=STRIDES):
    """Raw head outputs -> (boxes xyxy [M,4], score [M], cls [M]), top_k by
    objectness * class score (YOLOv5 decode semantics)."""
    all_boxes, all_scores, all_cls = [], [], []
    for out, anchors, stride in zip(outs, anchors_per_scale, strides):
        H, W = out.shape[0], out.shape[1]
        dev = out.device
        p = torch.sigmoid(out)
        gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None, None]
        gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
        aw = const(tuple(float(a[0]) for a in anchors), torch.float32, dev)
        ah = const(tuple(float(a[1]) for a in anchors), torch.float32, dev)
        cx = (2 * p[..., 0] - 0.5 + gx) * stride
        cy = (2 * p[..., 1] - 0.5 + gy) * stride
        bw = (2 * p[..., 2]) ** 2 * aw
        bh = (2 * p[..., 3]) ** 2 * ah
        score = p[..., 4, None] * p[..., 5:]
        best_cls = torch.argmax(score, dim=-1)
        best_score = torch.amax(score, dim=-1)
        boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                             cy + bh / 2], dim=-1)
        all_boxes.append(boxes.reshape(-1, 4))
        all_scores.append(best_score.reshape(-1))
        all_cls.append(best_cls.reshape(-1))
    boxes = torch.cat(all_boxes)
    scores = torch.cat(all_scores)
    cls = torch.cat(all_cls)
    k = min(top_k, scores.shape[0])
    top_i = torch.argsort(-scores, stable=True)[:k]
    return boxes[top_i], scores[top_i], cls[top_i]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of boxes a [M,4] vs b [N,4] (xyxy) -> [M,N]."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[:, 2] - a[:, 0], min=0) * \
        torch.clamp(a[:, 3] - a[:, 1], min=0)
    area_b = torch.clamp(b[:, 2] - b[:, 0], min=0) * \
        torch.clamp(b[:, 3] - b[:, 1], min=0)
    return inter / torch.clamp(area_a[:, None] + area_b[None] - inter,
                               min=1e-9)


def nms(boxes, scores, cls, score_th=0.4, iou_th: float = 0.5,
        max_det: int = 32):
    """Class-aware greedy NMS, max_det fixed picks on a live-score vector
    (reference: non_max_suppression, score 0.4 / IoU 0.5)."""
    live = torch.where(scores >= score_th, scores,
                       torch.full_like(scores, -1.0))
    suppress = (box_iou(boxes, boxes) > iou_th) & \
        (cls[:, None] == cls[None, :])
    picks, oks = [], []
    for _ in range(max_det):
        b = torch.argmax(live)
        # b is a 0-d device tensor: gather/index_select keep it on the
        # device, `live[b]` would read it back to the host
        ok = torch.gather(live, 0, b[None])[0] > 0
        picks.append(torch.where(ok, b, torch.full_like(b, -1)))
        oks.append(ok)
        live = torch.where(
            ok & torch.index_select(suppress, 0, b[None])[0],
            torch.full_like(live, -1.0), live)
        live = live.index_fill(0, b[None], -1.0)
    keep_idx = torch.stack(picks)
    keep_ok = torch.stack(oks)
    safe = torch.where(keep_ok, keep_idx, torch.zeros_like(keep_idx))
    return boxes[safe], scores[safe], cls[safe], keep_ok


def refine_dynamic_boxes(dyn_boxes, dyn_ok, stat_boxes, stat_ok):
    """Subtract overlapping static boxes from each dynamic box, keeping the
    largest residual rectangle (reference: RefineDynamicBoxes); one pass per
    static box, all dynamic boxes at once."""
    d = dyn_boxes
    for j in range(stat_boxes.shape[0]):
        x1, y1, x2, y2 = d.unbind(-1)
        sx1, sy1, sx2, sy2 = stat_boxes[j].unbind(-1)
        overlap = ((torch.maximum(x1, sx1) < torch.minimum(x2, sx2)) &
                   (torch.maximum(y1, sy1) < torch.minimum(y2, sy2)) &
                   stat_ok[j])
        cands = torch.stack([
            torch.stack([x1, y1, torch.clamp(sx1, x1, x2), y2], -1),
            torch.stack([torch.clamp(sx2, x1, x2), y1, x2, y2], -1),
            torch.stack([x1, y1, x2, torch.clamp(sy1, y1, y2)], -1),
            torch.stack([x1, torch.clamp(sy2, y1, y2), x2, y2], -1),
        ], dim=1)                                           # [M,4,4]
        areas = torch.clamp(cands[..., 2] - cands[..., 0], min=0) * \
            torch.clamp(cands[..., 3] - cands[..., 1], min=0)
        best = torch.gather(cands, 1, torch.argmax(areas, dim=1)[:, None,
                                                                 None]
                            .expand(-1, 1, 4))[:, 0]
        d = torch.where(overlap[:, None], best, d)
    area = torch.clamp(d[:, 2] - d[:, 0], min=0) * \
        torch.clamp(d[:, 3] - d[:, 1], min=0)
    return d, dyn_ok & (area > 1.0)


def dynamic_area_ratio(boxes, ok, width: int, height: int, grid: int = 64):
    """Fraction of the image covered by the union of dynamic boxes, on an
    occupancy grid."""
    dev = boxes.device
    gx = (torch.arange(grid, device=dev) + 0.5) * (width / grid)
    gy = (torch.arange(grid, device=dev) + 0.5) * (height / grid)
    X = gx[None, :, None]
    Y = gy[None, None, :]
    inside = ((X >= boxes[:, 0, None, None]) &
              (X <= boxes[:, 2, None, None]) &
              (Y >= boxes[:, 1, None, None]) &
              (Y <= boxes[:, 3, None, None]))
    covered = torch.any(inside & ok[:, None, None], dim=0)
    return torch.mean(covered.to(torch.float32))


def _detect_program(model, img, ih: int, iw: int, score_th=0.4,
                    anchors=ANCHORS):
    """resize -> forward -> decode -> NMS -> rescale to the original image."""
    H, W = img.shape[0], img.shape[1]
    x = image_ops.resize_bilinear(img.to(torch.float32) / 255.0, ih, iw)
    with torch.no_grad():
        outs = model(x)
    boxes, scores, cls = decode_predictions(outs, anchors_per_scale=anchors)
    b, s, c, ok = nms(boxes, scores, cls, score_th=score_th)
    scale = const((W / iw, H / ih, W / iw, H / ih), torch.float32, b.device)
    return b * scale, s, c, ok


def _mask_program(model, img, dyn_ids, ih: int, iw: int, score_th=0.4,
                  anchors=ANCHORS):
    """detect -> split dynamic/static -> RefineDynamicBoxes -> union area
    ratio. Returns (boxes [32,4], dyn_ok [32], ratio [])."""
    b, s, c, ok = _detect_program(model, img, ih, iw, score_th=score_th,
                                  anchors=anchors)
    dyn_cls = torch.isin(c, dyn_ids)
    dyn_ok = ok & dyn_cls
    stat_ok = ok & ~dyn_cls
    b2, dyn_ok2 = refine_dynamic_boxes(b, dyn_ok, b, stat_ok)
    return b2, dyn_ok2, dynamic_area_ratio(b2, dyn_ok2, img.shape[1],
                                           img.shape[0])


class Detector:
    """Detector bundle: model on a device, input size, score threshold,
    anchors and the ids of the movable classes."""

    def __init__(self, model: YoloNet, input_hw=(384, 640),
                 dynamic_class_ids=DYNAMIC_CLASS_IDS, score_th: float = 0.4,
                 anchors=ANCHORS):
        self.model = model
        self.input_hw = tuple(input_hw)
        self.score_th = score_th
        self.anchors = tuple(tuple(tuple(a) for a in s) for s in anchors)
        dev = next(model.parameters()).device
        self.dyn_ids = torch.tensor(dynamic_class_ids, device=dev)

    def detect(self, img: torch.Tensor):
        """RGB (H,W,3) [0..255] -> (boxes xyxy, scores, classes, valid)."""
        return _detect_program(self.model, img, *self.input_hw,
                               score_th=self.score_th, anchors=self.anchors)

    def dynamic_mask_inputs(self, img: torch.Tensor):
        """-> (boxes, box_mask, dynamic_ratio) for the frontend."""
        return _mask_program(self.model, img, self.dyn_ids, *self.input_hw,
                             score_th=self.score_th, anchors=self.anchors)


@functools.lru_cache(maxsize=4)
def load_default_detector(device="cuda") -> Detector:
    """The shipped synthetic-scene-trained detector (yolo_synthetic.npz,
    read by path; its __meta__ holds width, classes, input h, w). Class 0 is
    the movable class; score_th 0.75 as in the reference package."""
    device = resolve_device(device)
    params = convert.load_params(WEIGHTS)
    meta = params.pop("__meta__")
    width, num_classes, ih, iw = (int(v) for v in np.asarray(meta))
    model = YoloNet(num_classes=num_classes, width=width)
    convert.yolo_from_flax(model, params)
    model = model.to(device).eval().requires_grad_(False)
    return Detector(model, input_hw=(ih, iw), dynamic_class_ids=(0,),
                    score_th=0.75)
