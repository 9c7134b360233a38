"""Weights of the JAX package's Flax models -> this port's nn.Modules.

The JAX package stores parameter trees as npz files whose keys are
'/'-joined tree paths ('params/conv1a/kernel'); `load_params` reads such a
file by path into nested dicts of numpy arrays (a local copy of the
reference package's npz loader — the port imports none of its code).
Convolution kernels are HWIO there and OIHW here.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def load_params(path: str) -> dict:
    """npz of '/'-joined tree paths -> nested dicts of numpy arrays."""
    out = {}
    with np.load(path) as data:
        for k in data.files:
            parts = k.split("/")
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = np.asarray(data[k])
    return out


def read_torch_checkpoint(path: str) -> dict:
    """A public checkpoint file's state dict: a TorchScript archive (as the
    reference loads its models), an ultralytics checkpoint ({'model':
    module}), a pickled module, a {'state_dict': ...} wrapper or a plain
    state dict. Only files the user names are read."""
    try:
        return torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:                 # not a TorchScript archive
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def hwio_to_oihw(kernel) -> torch.Tensor:
    """Flax conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)))


def load_conv(conv: nn.Conv2d, tree: dict):
    """Copy a Flax Conv's {'kernel'[, 'bias']} into an nn.Conv2d."""
    with torch.no_grad():
        conv.weight.copy_(hwio_to_oihw(tree["kernel"]))
        if conv.bias is not None:
            conv.bias.copy_(torch.from_numpy(
                np.asarray(tree["bias"], np.float32)))


def superpoint_from_flax(model, params: dict):
    """Fill a models.superpoint.SuperPoint from a Flax parameter tree
    ({'params': {'conv1a': {'kernel', 'bias'}, ...}})."""
    p = params["params"]
    for name, conv in model.named_children():
        load_conv(conv, p[name])
    return model


def yolo_from_flax(model, params: dict):
    """Fill a models.yolo.YoloNet from a Flax parameter tree: bias-free
    '{name}_conv/kernel' convs (inside C3 blocks one level deeper) and the
    biased 'head{i}' convs."""
    p = params["params"]
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Conv2d):
            continue
        parts = name.split(".")
        if parts[-1] == "conv":              # ConvAct 'x.conv' <- 'x_conv'
            parts = parts[:-2] + [parts[-2] + "_conv"]
        tree = p
        for part in parts:
            tree = tree[part]
        load_conv(mod, tree)
    return model


def load_dense(lin: nn.Linear, tree: dict):
    """Copy a Flax Dense's {'kernel' [in, out], 'bias'} into an nn.Linear
    (weight [out, in])."""
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.asarray(tree["kernel"], np.float32).T)))
        lin.bias.copy_(torch.from_numpy(np.asarray(tree["bias"], np.float32)))


def load_layernorm(ln: nn.LayerNorm, tree: dict):
    """Copy a Flax LayerNorm's {'scale', 'bias'} into an nn.LayerNorm."""
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(np.asarray(tree["scale"],
                                                    np.float32)))
        ln.bias.copy_(torch.from_numpy(np.asarray(tree["bias"], np.float32)))


def lightglue_from_flax(model, params: dict):
    """Fill a models.lightglue.LightGlue from a Flax parameter tree
    ({'params': {'in_proj', 'pos_freq' [2, head_dim/2], 'layer{i}':
    {'self_attn': {'q','k','v','proj'}, 'self_mlp0a', ...}, 'final_proj0',
    ...}}): the module paths are the tree paths, with 'layers.{i}' for
    'layer{i}'."""
    p = params["params"]
    with torch.no_grad():
        model.pos_freq.copy_(torch.from_numpy(
            np.asarray(p["pos_freq"], np.float32)))
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Linear):
            continue
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer{parts[1]}"] + parts[2:]
        tree = p
        for part in parts:
            tree = tree[part]
        load_dense(mod, tree)
    return model
