"""Map checkpoints (counterpart of dani_slam_tpu/utils/checkpoint.py): the
map is a fixed-capacity set of tensors, so a checkpoint is one npz write of
every field, plus optionally the place-recognition codebook with its SHA-256
and the BoW database (reference: System::SaveAtlas / LoadAtlas with the
vocabulary checksum gate, src/System.cc:1413-1556). The file format is the
JAX package's: either package reads the other's maps.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from dani_slam_tpu_torch.core import state as mstate
from dani_slam_tpu_torch.utils.device import resolve_device


def codebook_checksum(codebook) -> str:
    """SHA-256 of the codebook's raw bytes (the value stored beside a
    shipped vocabulary)."""
    if isinstance(codebook, torch.Tensor):
        codebook = codebook.detach().cpu().numpy()
    return hashlib.sha256(np.asarray(codebook).tobytes()).hexdigest()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def save_map(path: str, st: mstate.MapState, codebook=None, bow=None,
             extra: dict | None = None):
    """Write the map (and optionally the place-recognition database) to an
    npz."""
    fields = mstate.map_state_to_numpy(st)
    fields["_caps"] = np.asarray(list(st.caps), np.int64)
    if codebook is not None:
        fields["_codebook"] = _np(codebook)
        fields["_codebook_sha"] = np.frombuffer(
            codebook_checksum(codebook).encode(), np.uint8)
    if bow is not None:
        fields["_bow"] = _np(bow)
    for k, v in (extra or {}).items():
        fields[f"_extra_{k}"] = _np(v)
    np.savez_compressed(path, **fields)


def load_map(path: str, expect_codebook=None, device="cuda"):
    """Load a map checkpoint onto `device`. With expect_codebook, the stored
    checksum must match it (the reference's vocabulary gate on LoadAtlas),
    else ValueError. A checkpoint without the landmarks' observation
    bitmask has it rebuilt from the observation table. Returns (MapState,
    dict of extras: 'codebook' and 'bow' as tensors on `device`, the rest
    numpy)."""
    device = resolve_device(device)
    with np.load(path) as data:
        caps = mstate.MapCaps(*[int(x) for x in data["_caps"]])
        fields = {n: data[n] for n in mstate.TENSOR_FIELDS if n in data}
        rebuild_bits = "lm_obs_bits" not in fields
        if rebuild_bits:
            fields["lm_obs_bits"] = np.zeros((caps.L, (caps.K + 31) // 32),
                                             np.int32)
        st = mstate.map_state_from_numpy(fields, device=device)
        if rebuild_bits:
            st = mstate.rebuild_obs_bits(st)
        extras = {}
        if "_codebook" in data:
            extras["codebook"] = torch.as_tensor(data["_codebook"],
                                                 device=device)
            if expect_codebook is not None:
                stored = bytes(data["_codebook_sha"]).decode()
                if stored != codebook_checksum(expect_codebook):
                    raise ValueError(
                        "codebook checksum mismatch: this map was built with "
                        "a different place-recognition codebook")
        if "_bow" in data:
            extras["bow"] = torch.as_tensor(data["_bow"], device=device)
        for k in data.files:
            if k.startswith("_extra_"):
                extras[k[len("_extra_"):]] = data[k]
    return st, extras
