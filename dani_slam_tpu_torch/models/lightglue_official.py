"""Official-architecture LightGlue (counterpart of
dani_slam_tpu/models/lightglue_official.py): the public cvg/LightGlue graph
the reference deploys (src/LightGlue.cpp:9): descriptor_dim 256, 9
transformer layers, 4 heads, fused-QKV self-attention with learnable-Fourier
rotary positions, bidirectional cross-attention from one shared similarity,
LayerNorm FFNs, and the last layer's assignment head (fixed depth, no token
pruning, as the reference's TorchScript export runs).

The forward has the call and return contract of models.lightglue.LightGlue
(log-assignment scores [B,N0,N1] plus the matchability logits per side), so
match_pairs, match_pair, match and every caller of the System take it as
they take the compact matcher.

Precision follows the JAX module: the dense layers of both blocks run in
bfloat16 (bf16 product, then the bf16 bias, as Flax Dense(dtype=bf16)), input_proj,
the positional angles, final_proj and the matchability head are f32; the
attention logits and the attention-times-value product multiply
bf16-rounded operands and accumulate in f32, the softmax and the LayerNorms
(eps 1e-6, Flax's) are f32, the GELU exact. Attention is written as
matmuls, not scaled_dot_product_attention, so that the arithmetic follows
the JAX einsums. Masked keys get NEG = -1e9; masked queries are not zeroed
(the JAX module does not zero them either).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dani_slam_tpu_torch.models import convert
from dani_slam_tpu_torch.models.lightglue import MatcherState
from dani_slam_tpu_torch.utils.device import resolve_device

NEG = -1e9
LN_EPS = 1e-6                 # flax.linen.LayerNorm's default

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "..",
                       "dani_slam_tpu", "weights",
                       "lightglue_official_synthetic.npz")


def _rotary_heads(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate consecutive channel pairs (2k, 2k+1) of per-head features by
    ang[..., k]. x: (..., n, H, hd); ang: (..., n, 1, hd/2)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    c = torch.cos(ang)
    s = torch.sin(ang)
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape)


def _dense(lin: nn.Linear, x: torch.Tensor, dt) -> torch.Tensor:
    """A Linear with f32 parameters run in `dt` (a Flax Dense(dtype=dt)):
    the product rounded to dt, then the dt bias added."""
    return F.linear(x.to(dt), lin.weight.to(dt)) + lin.bias.to(dt)


def _rounded(x: torch.Tensor, dt) -> torch.Tensor:
    """Round to `dt` and widen back: f32 products of bf16-rounded operands
    are exact, and the matmul accumulates them in f32."""
    return x.to(dt).float()


def _attend(q, k, v, key_mask, dt):
    """softmax(q k^T / sqrt(hd)) v over heads, masked keys at NEG.
    q (B,n,H,hd), k/v (B,m,H,hd) dt-rounded f32; key_mask (B,m) ->
    (B,n,H,hd) f32."""
    hd = q.shape[-1]
    logits = torch.matmul(q.transpose(-2, -3),
                          k.transpose(-2, -3).transpose(-1, -2)) / hd ** 0.5
    logits = torch.where(key_mask[..., None, None, :], logits,
                         torch.full_like(logits, NEG))
    attn = torch.softmax(logits, dim=-1)
    return torch.matmul(_rounded(attn, dt), v.transpose(-2, -3)) \
        .transpose(-2, -3)


class _FFN(nn.Module):
    """concat[x, message] -> Linear(2D, 2D) -> LayerNorm -> GELU ->
    Linear(2D, D), added to x (the official ffn.0 / ffn.1 / ffn.3)."""

    def __init__(self, dim: int, dt):
        super().__init__()
        self.dt = dt
        self.ffn0 = nn.Linear(2 * dim, 2 * dim)
        self.ffn1 = nn.LayerNorm(2 * dim, eps=LN_EPS)
        self.ffn3 = nn.Linear(2 * dim, dim)

    def forward(self, x, msg):
        y = torch.cat([x, msg.float()], dim=-1)
        y = _dense(self.ffn0, y, self.dt).float()
        y = F.gelu(self.ffn1(y))
        return x + _dense(self.ffn3, y, self.dt).float()


class SelfBlock(nn.Module):
    """Fused Wqkv ([H, hd, 3] channel layout), rotary on q/k, out_proj,
    then the FFN; shared by both sides."""

    def __init__(self, dim: int, heads: int, dt):
        super().__init__()
        self.dim, self.heads, self.dt = dim, heads, dt
        self.Wqkv = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)
        self.ffn = _FFN(dim, dt)

    def forward(self, x, mask, ang):
        H = self.heads
        hd, dt = self.dim // H, self.dt
        qkv = _dense(self.Wqkv, x, dt)
        qkv = qkv.reshape(qkv.shape[:-1] + (H, hd, 3))
        # the f32 angles widen q, k to f32; the logits round them to dt
        q = _rotary_heads(qkv[..., 0].float(), ang)
        k = _rotary_heads(qkv[..., 1].float(), ang)
        ctx = _attend(_rounded(q, dt), _rounded(k, dt), qkv[..., 2].float(),
                      mask, dt)
        msg = _dense(self.out_proj, ctx.reshape(ctx.shape[:-2] +
                                                (self.dim,)), dt)
        return self.ffn(x, msg)


class CrossBlock(nn.Module):
    """Shared to_qk for both sides (queries are keys): one similarity,
    softmaxed along each axis for the two directions; shared to_out and
    FFN."""

    def __init__(self, dim: int, heads: int, dt):
        super().__init__()
        self.dim, self.heads, self.dt = dim, heads, dt
        self.to_qk = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)
        self.ffn = _FFN(dim, dt)

    def forward(self, x0, x1, m0, m1):
        H = self.heads
        hd, dt = self.dim // H, self.dt

        def heads(lin, x):               # (B,n,D) -> (B,H,n,hd), dt in f32
            y = _dense(lin, x, dt).float()
            return y.reshape(y.shape[:-1] + (H, hd)).transpose(-2, -3)

        qk0, qk1 = heads(self.to_qk, x0), heads(self.to_qk, x1)
        v0, v1 = heads(self.to_v, x0), heads(self.to_v, x1)
        sim = torch.matmul(qk0, qk1.transpose(-1, -2)) / hd ** 0.5
        l01 = torch.where(m1[..., None, None, :], sim,
                          torch.full_like(sim, NEG))
        l10 = torch.where(m0[..., None, None, :], sim.transpose(-1, -2),
                          torch.full_like(sim, NEG))
        ctx0 = torch.matmul(_rounded(torch.softmax(l01, dim=-1), dt), v1)
        ctx1 = torch.matmul(_rounded(torch.softmax(l10, dim=-1), dt), v0)

        def msg(ctx):                     # (B,H,n,hd) -> (B,n,D)
            ctx = ctx.transpose(-2, -3)
            return _dense(self.to_out,
                          ctx.reshape(ctx.shape[:-2] + (self.dim,)), dt)

        return self.ffn(x0, msg(ctx0)), self.ffn(x1, msg(ctx1))


class LightGlueOfficial(nn.Module):
    """The public LightGlue graph at fixed depth. Inputs: xy0/xy1
    normalized coords (B,N,2), desc0/desc1 (B,N,input_dim), mask0/mask1
    (B,N) bool. Output: (scores [B,N0,N1], z0 [B,N0], z1 [B,N1]).
    compute_dtype is the dense layers' (bf16 in production, f32 for the
    converter equivalence tests, as in the JAX module)."""

    def __init__(self, dim: int = 256, depth: int = 9, heads: int = 4,
                 input_dim: int = 256, compute_dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.depth, self.heads = dim, depth, heads
        self.input_proj = nn.Linear(input_dim, dim)
        # learnable Fourier angles = xy @ Wr, no 2*pi factor; one set of
        # angles for every head
        self.posenc_Wr = nn.Parameter(torch.randn(2, dim // heads // 2))
        self.self_blocks = nn.ModuleList(SelfBlock(dim, heads, compute_dtype)
                                         for _ in range(depth))
        self.cross_blocks = nn.ModuleList(
            CrossBlock(dim, heads, compute_dtype) for _ in range(depth))
        self.final_proj = nn.Linear(dim, dim)
        self.matchability = nn.Linear(dim, 1)

    def forward(self, xy0, xy1, desc0, desc1, mask0, mask1):
        d0 = self.input_proj(desc0)
        d1 = self.input_proj(desc1)
        ang0 = torch.matmul(xy0, self.posenc_Wr)[..., None, :]
        ang1 = torch.matmul(xy1, self.posenc_Wr)[..., None, :]
        for sa, ca in zip(self.self_blocks, self.cross_blocks):
            d0 = sa(d0, mask0, ang0)
            d1 = sa(d1, mask1, ang1)
            d0, d1 = ca(d0, d1, mask0, mask1)
        p0 = self.final_proj(d0) / self.dim ** 0.25
        p1 = self.final_proj(d1) / self.dim ** 0.25
        sim = torch.matmul(p0, p1.transpose(-1, -2))
        sim = torch.where(mask0[..., :, None] & mask1[..., None, :], sim,
                          torch.full_like(sim, NEG))
        z0 = self.matchability(d0)[..., 0]
        z1 = self.matchability(d1)[..., 0]
        scores = (torch.log_softmax(sim, dim=-1) +
                  torch.log_softmax(sim, dim=-2) +
                  F.logsigmoid(z0)[..., :, None] +
                  F.logsigmoid(z1)[..., None, :])
        return scores, z0, z1


# ---------------------------------------------------------------------------
# Public-checkpoint converter
# ---------------------------------------------------------------------------

def _normalize_keys(sd: dict) -> dict:
    """Strip wrapper prefixes ('matcher.', 'model.', ...) so keys start at
    'input_proj./posenc./transformers./log_assignment.'."""
    roots = ("input_proj.", "posenc.", "transformers.", "log_assignment.",
             "token_confidence.")
    out = {}
    for k, v in sd.items():
        kk = k
        for _ in range(4):
            if kk.startswith(roots):
                break
            if "." in kk:
                kk = kk.split(".", 1)[1]
            else:
                break
        out[kk] = v
    return out


def load_lightglue_state_dict(sd: dict, compute_dtype=torch.bfloat16
                              ) -> LightGlueOfficial:
    """A public-LightGlue state dict (torch tensors or numpy arrays, any of
    the usual key prefixes) -> LightGlueOfficial on the CPU with the LAST
    log_assignment head (full-depth inference); depth, width, heads and
    input width are read from the dict."""
    sd = {k: torch.as_tensor(np.asarray(
        v.detach().cpu() if hasattr(v, "detach") else v, np.float32))
        for k, v in _normalize_keys(sd).items()}
    depth = 1 + max(int(k.split(".")[1]) for k in sd
                    if k.startswith("transformers."))
    dim, input_dim = sd["input_proj.weight"].shape
    hd2 = sd["posenc.Wr.weight"].shape[0]           # head_dim / 2
    model = LightGlueOfficial(dim=dim, depth=depth, heads=dim // (2 * hd2),
                              input_dim=input_dim,
                              compute_dtype=compute_dtype)
    last = f"log_assignment.{depth - 1}"
    src = {"input_proj": "input_proj", "final_proj": f"{last}.final_proj",
           "matchability": f"{last}.matchability"}
    for i in range(depth):
        t = f"transformers.{i}"
        for name in ("Wqkv", "out_proj"):
            src[f"self_blocks.{i}.{name}"] = f"{t}.self_attn.{name}"
        for name in ("to_qk", "to_v", "to_out"):
            src[f"cross_blocks.{i}.{name}"] = f"{t}.cross_attn.{name}"
        for kind, blocks in (("self_attn", "self_blocks"),
                             ("cross_attn", "cross_blocks")):
            for j in (0, 1, 3):
                src[f"{blocks}.{i}.ffn.ffn{j}"] = f"{t}.{kind}.ffn.{j}"
    state = {"posenc_Wr": sd["posenc.Wr.weight"].T}  # [hd/2,2] -> [2,hd/2]
    for mine, theirs in src.items():
        w = sd[f"{theirs}.weight"]
        state[f"{mine}.weight"] = w
        state[f"{mine}.bias"] = sd.get(f"{theirs}.bias",
                                       torch.zeros(w.shape[0]))
    model.load_state_dict(state)
    return model


def load_lightglue_pt(path: str, width: int = 640, height: int = 480,
                      device="cuda") -> MatcherState:
    """A public LightGlue checkpoint file -> MatcherState on `device` for
    the System (reference: src/LightGlue.cpp:7-12)."""
    device = resolve_device(device)
    model = load_lightglue_state_dict(convert.read_torch_checkpoint(path))
    return MatcherState(model.to(device).eval().requires_grad_(False),
                        width, height)


def from_flax(model: LightGlueOfficial, params: dict) -> LightGlueOfficial:
    """Fill a LightGlueOfficial from the JAX module's Flax parameter tree
    ({'params': {'input_proj', 'posenc_Wr' [2, hd/2], 'self{i}': {'Wqkv',
    'out_proj', 'ffn0', 'ffn1' (LayerNorm scale/bias), 'ffn3'}, 'cross{i}':
    {'to_qk', 'to_v', 'to_out', 'ffn0', 'ffn1', 'ffn3'}, 'final_proj',
    'matchability'}})."""
    p = params["params"]
    with torch.no_grad():
        model.posenc_Wr.copy_(torch.from_numpy(
            np.asarray(p["posenc_Wr"], np.float32)))
    for name in ("input_proj", "final_proj", "matchability"):
        convert.load_dense(getattr(model, name), p[name])
    for i in range(model.depth):
        for prefix, block, names in (
                ("self", model.self_blocks[i], ("Wqkv", "out_proj")),
                ("cross", model.cross_blocks[i], ("to_qk", "to_v",
                                                  "to_out"))):
            tree = p[f"{prefix}{i}"]
            for name in names:
                convert.load_dense(getattr(block, name), tree[name])
            convert.load_dense(block.ffn.ffn0, tree["ffn0"])
            convert.load_dense(block.ffn.ffn3, tree["ffn3"])
            convert.load_layernorm(block.ffn.ffn1, tree["ffn1"])
    return model


@functools.lru_cache(maxsize=4)
def _load_official_model(device: torch.device):
    model = from_flax(LightGlueOfficial(), convert.load_params(WEIGHTS))
    return model.to(device).eval().requires_grad_(False)


def load_official_matcher(width: int = 640, height: int = 480,
                          device="cuda"):
    """The shipped reference-scale matcher (lightglue_official_synthetic.npz
    of the JAX package's weights/ directory, read by path: 256-dim x 9
    layers trained on the synthetic homography task) as a MatcherState on
    `device`, or None when the file is absent. The module is memoized per
    device and read-only at inference."""
    device = resolve_device(device)
    if not os.path.exists(WEIGHTS):
        return None
    return MatcherState(_load_official_model(device), width, height)
