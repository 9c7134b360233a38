"""Id-indexed reductions (counterpart of dani_slam_tpu/core/scatterless.py).

The JAX package writes these as dense [size, B] compare-and-reduce passes
because TPU scatters serialize. On a GPU (and the CPU) a scatter is the cheap
form, so each helper here is one scatter into a buffer with a spare "dump"
slot at index `size` for rows that do not take part — no boolean-mask
indexing, which would synchronise with the host. Every helper keeps the
reference semantics exactly, including the tie rules (first j wins in
id_lookup), so map states compare slot by slot.
"""
from __future__ import annotations

import torch


def _dump_idx(ids: torch.Tensor, ok: torch.Tensor, size: int):
    # ids outside [0, size) never match in the dense formulation either
    ok = ok & (ids >= 0) & (ids < size)
    return torch.where(ok, ids, torch.full_like(ids, size)).long()


def row(t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """t[k] for a 0-d index tensor k without a host read: plain indexing
    turns a 0-d integer tensor into a Python int first, which waits for the
    device (and cannot be captured in a CUDA graph)."""
    return torch.index_select(t, 0, k.reshape(1).long()).squeeze(0)


def set_rows(t: torch.Tensor, idx: torch.Tensor,
             rows: torch.Tensor) -> torch.Tensor:
    """Out-of-place `t.at[idx].set(rows)` with the reference's duplicate rule
    (XLA's scatter applies updates in order, so the LAST row written to a
    repeated index wins). Every duplicate is handed the last row's value
    first, so the write order of the device scatter cannot matter."""
    idx = idx.long()
    last = torch.full((t.shape[0],), -1, dtype=torch.int64, device=t.device)
    last.scatter_reduce_(0, idx, torch.arange(idx.shape[0], device=t.device),
                         "amax", include_self=True)
    out = t.clone()
    out[idx] = rows[last[idx]]
    return out


def id_mask(ids: torch.Tensor, ok: torch.Tensor, size: int) -> torch.Tensor:
    """Bool [size]: out[s] = any(ok & (ids == s))."""
    out = torch.zeros(size + 1, dtype=torch.bool, device=ids.device)
    # index_fill_ takes the value as a kernel argument; `out[idx] = True`
    # would stage a host scalar tensor and copy it to the device
    out.index_fill_(0, _dump_idx(ids, ok, size), True)
    return out[:size]


def id_count(ids: torch.Tensor, ok: torch.Tensor, size: int) -> torch.Tensor:
    """Int32 [size]: out[s] = sum(ok & (ids == s)) (integer adds, so the
    result does not depend on the order of the atomic updates)."""
    out = torch.zeros(size + 1, dtype=torch.int32, device=ids.device)
    out.index_add_(0, _dump_idx(ids, ok, size),
                   torch.ones_like(ids, dtype=torch.int32))
    return out[:size]


def id_sum(ids: torch.Tensor, ok: torch.Tensor, vals: torch.Tensor,
           size: int) -> torch.Tensor:
    """[size, ...]: out[s] = sum over j of vals[j] (rows of [B, ...]) where
    ok[j] & ids[j]==s. Integer vals: one scatter-add (exact in any order).
    Float vals: the reference's dense form, a [size, B] one-hot matmul —
    atomic float adds would make the sum depend on their order, and the
    result must not change from run to run."""
    okb = ok.reshape(ok.shape + (1,) * (vals.ndim - 1))
    vals = torch.where(okb, vals, torch.zeros_like(vals))
    if vals.dtype.is_floating_point:
        iota = torch.arange(size, device=ids.device)
        onehot = ((ids[None, :] == iota[:, None]) & ok[None, :]).to(
            vals.dtype)
        return (onehot @ vals.reshape(vals.shape[0], -1)).reshape(
            (size,) + vals.shape[1:])
    out = torch.zeros((size + 1,) + vals.shape[1:], dtype=vals.dtype,
                      device=ids.device)
    out.index_add_(0, _dump_idx(ids, ok, size), vals)
    return out[:size]


def id_max(ids: torch.Tensor, ok: torch.Tensor, vals: torch.Tensor,
           size: int, fill) -> torch.Tensor:
    """[size]: out[s] = max(fill, max over j of vals[j] where ok[j] &
    ids[j]==s) — `fill` takes part in the max, as in the reference."""
    out = torch.full((size + 1,), fill, dtype=vals.dtype, device=ids.device)
    out.scatter_reduce_(0, _dump_idx(ids, ok, size), vals, "amax",
                        include_self=True)
    return out[:size]


def id_lookup(ids: torch.Tensor, ok: torch.Tensor, vals: torch.Tensor,
              size: int, default: torch.Tensor) -> torch.Tensor:
    """[size]: out[s] = vals[j*] for the FIRST j with ok[j] & ids[j]==s,
    else default[s] (set semantics; first j on duplicates)."""
    B = ids.shape[0]
    first = torch.full((size + 1,), B, dtype=torch.int64, device=ids.device)
    first.scatter_reduce_(0, _dump_idx(ids, ok, size),
                          torch.arange(B, device=ids.device), "amin",
                          include_self=True)
    first = first[:size]
    hit = first < B
    picked = vals[torch.clamp(first, max=B - 1)]
    if picked.ndim > 1:
        hit = hit.reshape(hit.shape + (1,) * (picked.ndim - 1))
    return torch.where(hit, picked, default)


def scatter_rows_dense(free: torch.Tensor, cand_valid: torch.Tensor, B: int):
    """Placement plan for appending up to B candidate rows into the free
    slots of a mask (first-free-first). Returns (recv [size] bool, src
    [size] int64 candidate row per receiving slot, placed [B] bool); slot s
    receives candidate r = rank of s among free slots (exclusive cumsum)."""
    freei = free.to(torch.int32)
    rank = torch.cumsum(freei, 0) - freei
    recv = free & (rank < B)
    src = torch.where(recv, rank, torch.zeros_like(rank)).long()
    recv = recv & cand_valid[src]
    n_free = torch.sum(freei)
    placed = cand_valid & (torch.arange(B, device=free.device) < n_free)
    return recv, src, placed
