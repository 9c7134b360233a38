"""SuperPoint feature network (counterpart of
dani_slam_tpu/models/superpoint.py): VGG encoder conv1a..conv4b with
64/64/128/128 channels, a 65-channel detector head softmaxed and
pixel-shuffled to a full-resolution heatmap, and a 256-D descriptor head.

As in the reference package the convs run in bfloat16 with float32
parameters (cast at each call) and the heads leave the network in float32.
Public outputs keep the JAX layout: heat [H, W], desc [H/8, W/8, 256].
"""
from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F
from torch import nn

from dani_slam_tpu_torch.models import convert
from dani_slam_tpu_torch.utils.device import resolve_device

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "..",
                       "dani_slam_tpu", "weights", "superpoint_synthetic.npz")

_LAYERS = (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
           ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
           ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
           ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
           ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
           ("convDa", 128, 256, 3), ("convDb", 256, 256, 1))


class SuperPoint(nn.Module):
    """gray (B,1,H,W) -> (heat (B,H,W), desc (B,H/8,W/8,256) L2-normalized)."""

    def __init__(self, descriptor_dim: int = 256,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        for name, cin, cout, k in _LAYERS:
            if name == "convDb":
                cout = descriptor_dim
            setattr(self, name, nn.Conv2d(cin, cout, k, padding=k // 2))

    @staticmethod
    def flax_path(name: str) -> list:
        return [name]

    def _conv(self, name, x):
        conv = getattr(self, name)
        dt = self.compute_dtype
        return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                        padding=conv.padding)

    def logits(self, x: torch.Tensor):
        """gray (B,1,H,W) -> (raw 65-channel detector logits (B,65,H/8,W/8)
        f32, desc (B,H/8,W/8,D) L2-normalized)."""
        x = x.to(self.compute_dtype)
        for stage in (("conv1a", "conv1b"), ("conv2a", "conv2b"),
                      ("conv3a", "conv3b")):
            for name in stage:
                x = F.relu(self._conv(name, x))
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(self._conv("conv4a", x))
        feat = F.relu(self._conv("conv4b", x))              # (B,128,H/8,W/8)

        cPa = F.relu(self._conv("convPa", feat))
        semi = self._conv("convPb", cPa).to(torch.float32)
        cDa = F.relu(self._conv("convDa", feat))
        desc = self._conv("convDb", cDa).to(torch.float32).permute(0, 2, 3, 1)
        desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1,
                                                    keepdim=True), min=1e-8)
        return semi, desc

    def forward(self, x: torch.Tensor):
        semi, desc = self.logits(x)
        prob = torch.softmax(semi, dim=1)[:, :64]          # drop dustbin
        B, _, Hc, Wc = prob.shape
        heat = prob.permute(0, 2, 3, 1).reshape(B, Hc, Wc, 8, 8)
        heat = heat.permute(0, 1, 3, 2, 4).reshape(B, Hc * 8, Wc * 8)
        return heat, desc


def init_params(seed: int = 0, device="cuda") -> SuperPoint:
    """A SuperPoint with Flax's initialization (lecun-normal kernels, zero
    biases; convert.flax_init) drawn from torch.Generator(seed), on
    `device` (counterpart of superpoint.init_params)."""
    device = resolve_device(device)
    return convert.flax_init(SuperPoint(), seed).to(device)


@functools.lru_cache(maxsize=4)
def load_default_params(device="cuda", path: str = WEIGHTS) -> SuperPoint:
    """The shipped synthetic-corner-trained weights (read by path from the
    JAX package's weights/ directory; or the npz at `path`, which
    superpoint_train.save_params writes) in a SuperPoint on `device`.
    Memoized per device and path: the module is read-only at inference."""
    device = resolve_device(device)
    model = SuperPoint()
    convert.from_flax(model, convert.load_params(path))
    return model.to(device).eval().requires_grad_(False)


def apply(model: SuperPoint, gray: torch.Tensor):
    """Single-image forward: gray (H,W) [0,1] -> (heat (H,W),
    desc (H/8,W/8,256))."""
    with torch.no_grad():
        heat, desc = model(gray[None, None])
    return heat[0], desc[0]


def load_magicleap_pt(path: str, device="cuda") -> SuperPoint:
    """A public SuperPoint checkpoint (MagicLeap layout: a state dict, or a
    module holding one, with conv1a.weight [out,in,kh,kw] ... convDb.bias)
    -> SuperPoint on `device`; the layer names are this module's own."""
    device = resolve_device(device)
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model = SuperPoint()
    model.load_state_dict({f"{name}.{p}": sd[f"{name}.{p}"]
                           for name, *_ in _LAYERS
                           for p in ("weight", "bias")})
    return model.to(device).eval().requires_grad_(False)
