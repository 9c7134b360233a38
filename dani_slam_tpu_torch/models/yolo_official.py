"""Official YOLOv5 architecture (counterpart of
dani_slam_tpu/models/yolo_official.py): the v6.0 yolov5 graph the reference
deploys (src/YoloDetect.cpp:9, yolov5s = depth 0.33 / width 0.50): the k6
stem, C3 blocks, SPPF, the PAN neck and the three-scale Detect head.

BatchNorm is folded into each conv at conversion (eps 1e-3, ultralytics'),
so the graph is conv(bias) + SiLU throughout. Convolutions run in bfloat16
with float32 parameters (the product rounded to bf16, then the bf16 bias
added, as a Flax Conv(dtype=bf16)); activations stay bf16 between layers and
the heads leave in float32. Padding is symmetric (k // 2, 2 for the k6
stem), as in the JAX module's explicit pads. The net has the output contract
of models.yolo.YoloNet: one image (H, W, 3) in, a list of (H/s, W/s, 3,
5+nc) maps for strides 8/16/32 out, so models.yolo.Detector and the whole
dynamic-masking program take it as they take the compact net.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dani_slam_tpu_torch.models import convert
from dani_slam_tpu_torch.models.yolo import (ANCHORS, Detector, head_out,
                                             to_nchw)
from dani_slam_tpu_torch.utils.device import resolve_device

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "..",
                       "dani_slam_tpu", "weights",
                       "yolo_official_synthetic.npz")

BN_EPS = 1e-3        # ultralytics BatchNorm2d(eps=0.001)


def _make_divisible(x: float, div: int = 8) -> int:
    return max(div, int(round(x / div) * div))


def _conv_bf16(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    y = F.conv2d(x, conv.weight.to(dt), None, stride=conv.stride,
                 padding=conv.padding)
    return y + conv.bias.to(dt)[:, None, None]


class FoldedConv(nn.Module):
    """yolov5 Conv (conv + BN + SiLU) with the BN folded into weight and
    bias."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=s,
                              padding=2 if k == 6 else k // 2)

    def forward(self, x):
        return F.silu(_conv_bf16(self.conv, x))


class Bottleneck(nn.Module):
    def __init__(self, ch: int, shortcut: bool = True):
        super().__init__()
        self.shortcut = shortcut
        self.cv1 = FoldedConv(ch, ch, 1)
        self.cv2 = FoldedConv(ch, ch, 3)

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs (yolov5 C3, e=0.5)."""

    def __init__(self, cin: int, ch: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        c_ = ch // 2
        self.cv1 = FoldedConv(cin, c_, 1)
        self.cv2 = FoldedConv(cin, c_, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, shortcut) for _ in range(n)))
        self.cv3 = FoldedConv(2 * c_, ch, 1)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast (three chained k5 max pools)."""

    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.cv1 = FoldedConv(cin, cin // 2, 1)
        self.cv2 = FoldedConv(2 * cin, ch, 1)

    def forward(self, x):
        x = self.cv1(x)
        y1 = F.max_pool2d(x, 5, 1, 2)
        y2 = F.max_pool2d(y1, 5, 1, 2)
        y3 = F.max_pool2d(y2, 5, 1, 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YoloV5Net(nn.Module):
    """The yolov5 v6.0 graph; module names carry the checkpoint's layer
    indices (m0 ... m23, det0-2)."""

    def __init__(self, num_classes: int = 80, depth_multiple: float = 0.33,
                 width_multiple: float = 0.50,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        ch = lambda c: _make_divisible(c * width_multiple)   # noqa: E731
        n_ = lambda n: max(round(n * depth_multiple), 1)     # noqa: E731
        self.m0 = FoldedConv(3, ch(64), 6, 2)
        self.m1 = FoldedConv(ch(64), ch(128), 3, 2)
        self.m2 = C3(ch(128), ch(128), n_(3))
        self.m3 = FoldedConv(ch(128), ch(256), 3, 2)
        self.m4 = C3(ch(256), ch(256), n_(6))
        self.m5 = FoldedConv(ch(256), ch(512), 3, 2)
        self.m6 = C3(ch(512), ch(512), n_(9))
        self.m7 = FoldedConv(ch(512), ch(1024), 3, 2)
        self.m8 = C3(ch(1024), ch(1024), n_(3))
        self.m9 = SPPF(ch(1024), ch(1024))
        self.m10 = FoldedConv(ch(1024), ch(512), 1)
        self.m13 = C3(2 * ch(512), ch(512), n_(3), shortcut=False)
        self.m14 = FoldedConv(ch(512), ch(256), 1)
        self.m17 = C3(2 * ch(256), ch(256), n_(3), shortcut=False)
        self.m18 = FoldedConv(ch(256), ch(256), 3, 2)
        self.m20 = C3(2 * ch(256), ch(512), n_(3), shortcut=False)
        self.m21 = FoldedConv(ch(512), ch(512), 3, 2)
        self.m23 = C3(2 * ch(512), ch(1024), n_(3), shortcut=False)
        no = 3 * (5 + num_classes)
        for i, c in enumerate((ch(256), ch(512), ch(1024))):
            setattr(self, f"det{i}", nn.Conv2d(c, no, 1))

    @staticmethod
    def flax_path(name: str) -> list:
        """Each FoldedConv's 'conv' (Bottleneck j of a C3 under 'm{j}'),
        the heads 'det{i}': nn.Sequential 'm.<j>' <- 'm<j>'."""
        out = []
        parts = name.split(".")
        for part, nxt in zip(parts, parts[1:] + [None]):
            if part == "m" and nxt is not None and nxt.isdigit():
                continue
            out.append(f"m{part}" if part.isdigit() else part)
        return out

    def forward(self, img: torch.Tensor):
        x = to_nchw(img).to(self.compute_dtype)
        x = self.m2(self.m1(self.m0(x)))
        p3 = self.m4(self.m3(x))
        p4 = self.m6(self.m5(p3))
        x = self.m9(self.m8(self.m7(p4)))
        t10 = self.m10(x)
        x = self.m13(torch.cat([_upsample2(t10), p4], dim=1))
        t14 = self.m14(x)
        o3 = self.m17(torch.cat([_upsample2(t14), p3], dim=1))
        o4 = self.m20(torch.cat([self.m18(o3), t14], dim=1))
        o5 = self.m23(torch.cat([self.m21(o4), t10], dim=1))
        outs = []
        for i, p in enumerate((o3, o4, o5)):
            outs.append(head_out(_conv_bf16(getattr(self, f"det{i}"), p),
                                 self.num_classes, img.dim() == 4))
        return outs


# ---------------------------------------------------------------------------
# Public-checkpoint converter
# ---------------------------------------------------------------------------

def _normalize_keys(sd: dict) -> dict:
    """Strip wrapper prefixes so keys start at 'model.<i>.' (ultralytics
    checkpoints commonly nest as 'model.model.<i>.')."""
    out = {}
    for k, v in sd.items():
        kk = k
        while not (kk.startswith("model.") and kk.split(".")[1].isdigit()):
            if "." in kk:
                kk = kk.split(".", 1)[1]
            else:
                break
        out[kk] = v
    return out


def fold_bn(sd: dict, prefix: str):
    """conv (+ BN) under `prefix` of a normalized float32 numpy state dict
    -> (weight [O,I,kh,kw], bias [O]) with the BN folded in."""
    w = sd[prefix + ".conv.weight"]
    if prefix + ".bn.weight" not in sd:
        return w, sd.get(prefix + ".conv.bias",
                         np.zeros(w.shape[0], np.float32))
    g, b = sd[prefix + ".bn.weight"], sd[prefix + ".bn.bias"]
    mu, var = sd[prefix + ".bn.running_mean"], sd[prefix + ".bn.running_var"]
    s = g / np.sqrt(var + BN_EPS)
    return w * s[:, None, None, None], b - mu * s


def load_yolov5_state_dict(sd: dict):
    """An ultralytics yolov5 state dict (any depth / width multiple, BN not
    folded, torch tensors or numpy arrays) -> (YoloV5Net on the CPU,
    anchors in pixels, strides); the multiples are read from the stem
    width and the repeat count of C3 m2, the classes from the head."""
    sd = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v,
                        np.float32)
          for k, v in _normalize_keys(sd).items()}
    gw = sd["model.0.conv.weight"].shape[0] / 64.0
    gd = (1 + max((int(k.split(".")[3]) for k in sd
                   if k.startswith("model.2.m.")), default=0)) / 3.0
    det = next((i for i in (24, 33) if f"model.{i}.m.0.weight" in sd), None)
    if det is None:
        raise ValueError("Detect head not found in the state dict")
    nc = sd[f"model.{det}.m.0.weight"].shape[0] // 3 - 5
    model = YoloV5Net(num_classes=nc, depth_multiple=gd, width_multiple=gw)
    state = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, FoldedConv):
            continue
        # m<i>.cv1 / m<i>.m.<j>.cv2 -> model.<i>.cv1 / model.<i>.m.<j>.cv2
        prefix = "model." + name[1:]
        w, b = fold_bn(sd, prefix)
        state[f"{name}.conv.weight"], state[f"{name}.conv.bias"] = w, b
    for j in range(3):
        state[f"det{j}.weight"] = sd[f"model.{det}.m.{j}.weight"]
        state[f"det{j}.bias"] = sd[f"model.{det}.m.{j}.bias"]
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in state.items()})
    strides = (8, 16, 32)
    anchors = ANCHORS
    if f"model.{det}.anchors" in sd:
        a = sd[f"model.{det}.anchors"]                  # [3,3,2] / stride
        anchors = tuple(tuple((float(a[i, j, 0] * strides[i]),
                               float(a[i, j, 1] * strides[i]))
                              for j in range(3)) for i in range(3))
    return model, anchors, strides


def load_yolov5_pt(path: str, input_hw=(384, 640), score_th: float = 0.4,
                   device="cuda") -> Detector:
    """A yolov5 checkpoint file (TorchScript archive as the reference
    loads, an ultralytics .pt dict or a plain state dict) -> Detector on
    `device` (reference: src/YoloDetect.cpp:6-20; score 0.4 as its
    non_max_suppression)."""
    device = resolve_device(device)
    model, anchors, _ = load_yolov5_state_dict(
        convert.read_torch_checkpoint(path))
    return Detector(model.to(device).eval().requires_grad_(False),
                    input_hw=input_hw, score_th=score_th, anchors=anchors)


@functools.lru_cache(maxsize=4)
def _load_official(device: torch.device, path: str):
    params = convert.load_params(path)
    _, nc, ih, iw = (int(v) for v in np.asarray(params.pop("__meta__")))
    model = convert.from_flax(YoloV5Net(num_classes=nc), params)
    # synthetic scenes: class 0 is the movable class; score 0.6 is the JAX
    # package's threshold calibrated for these weights
    return Detector(model.to(device).eval().requires_grad_(False),
                    input_hw=(ih, iw), dynamic_class_ids=(0,), score_th=0.6)


def load_official_detector(device="cuda", path: str = WEIGHTS):
    """The shipped reference-scale detector (yolo_official_synthetic.npz of
    the JAX package's weights/ directory, read by path: yolov5s, 80-class
    head, trained on the synthetic movable-object scenes; or the npz at
    `path` that `yolo_train --official` writes) as a Detector on `device`,
    or None when the file is absent. Memoized per device and path."""
    device = resolve_device(device)
    if not os.path.exists(path):
        return None
    return _load_official(device, path)
