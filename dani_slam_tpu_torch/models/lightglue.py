"""LightGlue attention matcher (counterpart of
dani_slam_tpu/models/lightglue.py): fixed-size padded keypoint sets with
validity masks, self-attention with 2-D rotary positions (learned Fourier
frequencies over normalized coords), cross-attention without positions, a
dual-softmax assignment with learned matchability gates.

Precision follows the reference package layer by layer: the q/k/v/proj
projections and the eight MLP layers of each block run in bfloat16 (inputs,
weights and bias cast at the call, bf16 out, widened to f32 before the
residual add); in_proj, the assignment head and the similarity product are
f32. Attention logits and the attention-times-value product multiply
bf16-rounded operands and accumulate in f32 (the operands are widened to f32
after rounding, so every product is exact); the softmax is f32. Masked keys
get NEG = -1e9, not -inf: a fully masked row is a uniform softmax, never NaN,
and masked queries are zeroed afterwards.

The attention is plain PyTorch here because it is plain jnp.einsum there: it
is not one of the package's hand-written kernels.
"""
from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F
from torch import nn

from dani_slam_tpu_torch.models import convert
from dani_slam_tpu_torch.utils.device import resolve_device

NEG = -1e9

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "..",
                       "dani_slam_tpu", "weights", "lightglue_synthetic.npz")


class _Counter:
    """Forwards of the matcher (one per match_pairs call, whatever the batch);
    a captured frame program adds its own share per replay."""

    def __init__(self):
        self.count = 0


FORWARDS = _Counter()


def normalize_keypoints(xy: torch.Tensor, width: int,
                        height: int) -> torch.Tensor:
    """Pixels -> [-1,1]-ish coords, aspect preserved."""
    shifted = torch.stack([xy[..., 0] - width / 2.0,
                           xy[..., 1] - height / 2.0], dim=-1)
    return shifted / (max(width, height) / 2.0)


def _rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Pairwise rotation of even/odd channels. x: (..., n, d) with d even;
    angles: (..., n, d/2)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    c = torch.cos(angles)
    s = torch.sin(angles)
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape)


def _dense_bf16(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A Linear with f32 parameters run in bfloat16: product rounded to bf16,
    then the bf16 bias added (two roundings, as a Flax Dense(dtype=bf16))."""
    dt = torch.bfloat16
    return F.linear(x.to(dt), lin.weight.to(dt)) + lin.bias.to(dt)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q_in, kv_in, q_mask, kv_mask, q_angles=None,
                kv_angles=None):
        D, H = self.dim, self.heads
        hd = D // H
        dt = torch.bfloat16
        q = _dense_bf16(self.q, q_in)
        k = _dense_bf16(self.k, kv_in)
        v = _dense_bf16(self.v, kv_in)
        if q_angles is not None:
            # angles are f32, so the rotation widens q, k to f32; they are
            # rounded back to bf16 after it
            q = _rotary(q.float(), q_angles.repeat(1, 1, H))
            k = _rotary(k.float(), kv_angles.repeat(1, 1, H))

        def heads(x):            # (B,n,D) -> (B,H,n,hd), bf16-rounded f32
            return x.reshape(x.shape[:-1] + (H, hd)).to(dt).float() \
                .transpose(-2, -3)

        q, k, v = heads(q), heads(k), heads(v)
        logits = torch.matmul(q, k.transpose(-1, -2)) / (hd ** 0.5)
        logits = torch.where(kv_mask[..., None, None, :], logits,
                             torch.full_like(logits, NEG))
        attn = torch.softmax(logits, dim=-1)
        out = torch.matmul(attn.to(dt).float(), v)           # (B,H,n,hd)
        out = out.transpose(-2, -3).reshape(out.shape[0], -1, D)
        out = torch.where(q_mask[..., None], out, torch.zeros_like(out))
        return _dense_bf16(self.proj, out)


class GlueLayer(nn.Module):
    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.self_attn = Attention(dim, heads)
        self.cross_attn = Attention(dim, heads)
        for kind in ("self", "cross"):
            for side in (0, 1):
                setattr(self, f"{kind}_mlp{side}a", nn.Linear(2 * dim,
                                                              2 * dim))
                setattr(self, f"{kind}_mlp{side}b", nn.Linear(2 * dim, dim))

    def _mlp(self, kind: str, side: int, d, msg):
        a = getattr(self, f"{kind}_mlp{side}a")
        b = getattr(self, f"{kind}_mlp{side}b")
        x = torch.cat([d.to(torch.bfloat16), msg], dim=-1)
        x = F.gelu(_dense_bf16(a, x), approximate="tanh")
        return d + _dense_bf16(b, x).float()

    def forward(self, d0, d1, m0, m1, ang0, ang1):
        sa, ca = self.self_attn, self.cross_attn
        d0 = self._mlp("self", 0, d0, sa(d0, d0, m0, m0, ang0, ang0))
        d1 = self._mlp("self", 1, d1, sa(d1, d1, m1, m1, ang1, ang1))
        # cross-attention, shared weights both directions, both computed
        # before either side is updated
        c0 = ca(d0, d1, m0, m1)
        c1 = ca(d1, d0, m1, m0)
        d0 = self._mlp("cross", 0, d0, c0)
        d1 = self._mlp("cross", 1, d1, c1)
        return d0, d1


class LightGlue(nn.Module):
    """Match two padded keypoint sets.

    Inputs: xy0/xy1 normalized coords (B,N,2), desc0/desc1 (B,N,D_in),
    mask0/mask1 (B,N) bool. Output: log assignment scores (B,N0,N1) plus
    the raw matchability logits (B,N) per side.
    """

    def __init__(self, dim: int = 128, depth: int = 6, heads: int = 4,
                 input_dim: int = 256):
        super().__init__()
        self.dim, self.depth, self.heads = dim, depth, heads
        self.in_proj = nn.Linear(input_dim, dim)     # shared for both sides
        self.pos_freq = nn.Parameter(torch.randn(2, dim // heads // 2))
        self.layers = nn.ModuleList(GlueLayer(dim, heads)
                                    for _ in range(depth))
        self.final_proj0 = nn.Linear(dim, dim)
        self.final_proj1 = nn.Linear(dim, dim)
        self.match0 = nn.Linear(dim, 1)
        self.match1 = nn.Linear(dim, 1)

    def forward(self, xy0, xy1, desc0, desc1, mask0, mask1):
        d0 = self.in_proj(desc0)
        d1 = self.in_proj(desc1)
        ang0 = torch.matmul(xy0, self.pos_freq) * 6.2832
        ang1 = torch.matmul(xy1, self.pos_freq) * 6.2832
        for layer in self.layers:
            d0, d1 = layer(d0, d1, mask0, mask1, ang0, ang1)
        p0 = self.final_proj0(d0)
        p1 = self.final_proj1(d1)
        sim = torch.matmul(p0, p1.transpose(-1, -2)) / (self.dim ** 0.5)
        sim = torch.where(mask0[..., :, None] & mask1[..., None, :], sim,
                          torch.full_like(sim, NEG))
        z0 = self.match0(d0)[..., 0]
        z1 = self.match1(d1)[..., 0]
        scores = (torch.log_softmax(sim, dim=-1) +
                  torch.log_softmax(sim, dim=-2) +
                  F.logsigmoid(z0)[..., :, None] +
                  F.logsigmoid(z1)[..., None, :])
        return scores, z0, z1


class MatcherState:
    """A LightGlue on its device plus the image size its keypoints are
    normalized by."""

    def __init__(self, model: LightGlue, width: int, height: int):
        self.model = model
        self.width = width
        self.height = height


@functools.lru_cache(maxsize=4)
def _load_default_model(device: torch.device, input_dim: int, dim: int,
                        depth: int) -> LightGlue:
    model = LightGlue(dim=dim, depth=depth, input_dim=input_dim)
    convert.lightglue_from_flax(model, convert.load_params(WEIGHTS))
    return model.to(device).eval().requires_grad_(False)


def load_default_matcher(width: int = 640, height: int = 480,
                         device="cuda", input_dim: int = 256, dim: int = 128,
                         depth: int = 6) -> MatcherState:
    """The shipped synthetic-homography-trained weights (read by path from
    the JAX package's weights/ directory) in a LightGlue on `device`; the
    module is memoized per device and read-only at inference."""
    device = resolve_device(device)
    return MatcherState(_load_default_model(device, input_dim, dim, depth),
                        width, height)


def match_pairs(model: LightGlue, xy0, desc0, mask0, xy1, desc1, mask1,
                width: int, height: int, threshold: float = 0.05):
    """Batched matching: xy0/xy1 [B,N,2], desc [B,N,D], mask [B,N] -> (idx
    [B,N0] int32 best target per query, score [B,N0], ok [B,N0]); accepted
    when mutual, score >= threshold and both ends valid. One forward for all
    B pairs."""
    FORWARDS.count += 1
    with torch.no_grad():
        scores, _, _ = model(normalize_keypoints(xy0, width, height),
                             normalize_keypoints(xy1, width, height),
                             desc0, desc1, mask0, mask1)
    s = torch.exp(scores)
    best, idx = torch.max(s, dim=-1)
    rev = torch.argmax(s, dim=-2)
    # the mutual check compares ROW indices (rev lives in [0, N0)), so the
    # arange spans the query axis
    rows = torch.arange(s.shape[-2], device=s.device)
    mutual = torch.gather(rev, -1, idx) == rows
    ok = mutual & (best >= threshold) & mask0 & torch.gather(mask1, -1, idx)
    return idx.to(torch.int32), best, ok


def match_pair(model: LightGlue, xy0, desc0, mask0, xy1, desc1, mask1,
               width: int, height: int, threshold: float = 0.05):
    """Single-pair variant of match_pairs (unbatched [N,...] inputs)."""
    idx, best, ok = match_pairs(model, xy0[None], desc0[None], mask0[None],
                                xy1[None], desc1[None], mask1[None], width,
                                height, threshold)
    return idx[0], best[0], ok[0]


def match(ms: MatcherState, xy0, desc0, mask0, xy1, desc1, mask1,
          threshold: float = 0.05):
    """Match two single-image keypoint sets -> (idx [N], score [N], ok [N])
    per query in image 0."""
    return match_pair(ms.model, xy0, desc0, mask0, xy1, desc1, mask1,
                      ms.width, ms.height, threshold)
