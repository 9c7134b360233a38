"""Weights between the JAX package's Flax models and this port's
nn.Modules, both ways.

The JAX package stores parameter trees as npz files whose keys are
'/'-joined tree paths ('params/conv1a/kernel'); `load_params` reads such a
file by path into nested dicts of numpy arrays and `save_params` writes one
(local copies of the reference package's npz loader and saver — the port
imports none of its code). Convolution kernels are HWIO there and OIHW
here, dense kernels [in, out] there and [out, in] here.

Each model names where its layers live in the Flax tree with a static
method `flax_path(module_name) -> [key, ...]` and lists its bare parameters
(rotary frequencies) in `FLAX_RAW` as (attribute, key) pairs; `from_flax`
and `to_flax` walk every conv, dense and layer-norm module through it, so
a checkpoint trained by the port loads in both packages.
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


def save_params(path: str, params: dict):
    """Nested dicts of arrays -> npz of '/'-joined tree paths (the layout
    the JAX package's save_params writes and load_params reads)."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)
    walk(params, ())
    np.savez_compressed(path, **flat)


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


def _leaves(model):
    """(Flax path, module) of every conv, dense and layer-norm module."""
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear, nn.LayerNorm)):
            yield model.flax_path(name), mod


def from_flax(model, params: dict):
    """Fill a model of the port from a Flax parameter tree ({'params':
    ...}) through its flax_path / FLAX_RAW."""
    p = params["params"]
    for path, mod in _leaves(model):
        tree = p
        for key in path:
            tree = tree[key]
        if isinstance(mod, nn.Conv2d):
            load_conv(mod, tree)
        elif isinstance(mod, nn.Linear):
            load_dense(mod, tree)
        else:
            load_layernorm(mod, tree)
    with torch.no_grad():
        for attr, key in getattr(model, "FLAX_RAW", ()):
            getattr(model, attr).copy_(torch.from_numpy(
                np.asarray(p[key], np.float32)))
    return model


def to_flax(model) -> dict:
    """The Flax parameter tree ({'params': ...}, numpy f32) of a model of
    the port: the inverse of from_flax."""
    out = {}

    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy()
    for path, mod in _leaves(model):
        leaf = out
        for key in path:
            leaf = leaf.setdefault(key, {})
        w = arr(mod.weight)
        if isinstance(mod, nn.Conv2d):
            leaf["kernel"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        elif isinstance(mod, nn.Linear):
            leaf["kernel"] = np.ascontiguousarray(w.T)
        else:
            leaf["scale"] = w
        if mod.bias is not None:
            leaf["bias"] = arr(mod.bias)
    for attr, key in getattr(model, "FLAX_RAW", ()):
        out[key] = arr(getattr(model, attr))
    return {"params": out}


def flax_init(model, seed: int):
    """Flax's default initialization, drawn from torch.Generator(seed):
    lecun-normal kernels (a normal truncated at two standard deviations,
    stddev sqrt(1 / fan_in) / 0.8796, fan_in = kh * kw * in for a conv, in
    for a dense layer), zero biases, unit layer-norm scales, standard
    normal FLAX_RAW parameters. Returns the model."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, mod in _leaves(model):
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
            else:
                fan_in = mod.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / .87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
            if mod.bias is not None:
                mod.bias.zero_()
        for attr, _ in getattr(model, "FLAX_RAW", ()):
            getattr(model, attr).normal_(generator=gen)
    return model
