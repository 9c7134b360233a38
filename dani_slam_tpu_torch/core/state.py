"""Functional SLAM map state: fixed-capacity padded tensors + masks
(counterpart of dani_slam_tpu/core/state.py).

MapState carries the same field names, shapes, dtypes, masks and first-free
slot allocation as the JAX package's, so two map states compare slot by slot
(map_state_from_numpy / map_state_to_numpy move one across). Updates are
out of place — a function returns a new MapState and never writes into the
tensors of the one it was given — because the tracker keeps earlier states
alive (an initialization whose depth gate fails is simply dropped).

Capacities (MapCaps): K keyframes, L landmarks, N keypoints per frame, D
descriptor dim. Poses are T_cw (camera from world). obs_lm[K, N] holds the
landmark id seen by keypoint n of keyframe k (-1 none); lm_obs_bits[L, K/32]
is the observer bitmask (bit k of word k//32 set when keyframe slot k
observes the landmark), a conservative superset of the obs table.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from dani_slam_tpu_torch.core import scatterless as sless
from dani_slam_tpu_torch.utils.device import const, resolve_device


class MapCaps(NamedTuple):
    """Static capacities."""
    K: int = 256
    L: int = 32768
    N: int = 1024
    D: int = 256


@dataclasses.dataclass
class MapState:
    """One map (reference: src/Map.cc)."""
    kf_mask: torch.Tensor        # [K] bool
    kf_R: torch.Tensor           # [K,3,3] T_cw rotation
    kf_t: torch.Tensor           # [K,3]
    kf_time: torch.Tensor        # [K] f32
    kf_frame_id: torch.Tensor    # [K] i32
    kf_kp: torch.Tensor          # [K,N,2]
    kf_kp_mask: torch.Tensor     # [K,N] bool
    kf_desc: torch.Tensor        # [K,N,D]
    kf_depth: torch.Tensor       # [K,N] (inf = none)
    kf_octave: torch.Tensor      # [K,N] i8
    obs_lm: torch.Tensor         # [K,N] i32
    kf_vel: torch.Tensor         # [K,3]
    kf_bias_g: torch.Tensor      # [K,3]
    kf_bias_a: torch.Tensor      # [K,3]
    lm_mask: torch.Tensor        # [L] bool
    lm_pos: torch.Tensor         # [L,3]
    lm_desc: torch.Tensor        # [L,D]
    lm_normal: torch.Tensor      # [L,3]
    lm_dist_min: torch.Tensor    # [L]
    lm_dist_max: torch.Tensor    # [L]
    lm_ref_kf: torch.Tensor      # [L] i32
    lm_n_obs: torch.Tensor       # [L] i32
    lm_found: torch.Tensor       # [L] i32
    lm_visible: torch.Tensor     # [L] i32
    lm_first_kf: torch.Tensor    # [L] i32
    lm_obs_bits: torch.Tensor    # [L, ceil(K/32)] i32
    covis: torch.Tensor          # [K,K] i32
    spanning_parent: torch.Tensor  # [K] i32
    loop_edges: torch.Tensor     # [K,K] bool
    next_kf_counter: torch.Tensor  # [] i32
    imu_initialized: torch.Tensor  # [] bool
    imu_ba1: torch.Tensor          # [] bool
    imu_ba2: torch.Tensor          # [] bool
    caps: MapCaps = MapCaps()


TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(MapState)
                      if f.name != "caps")

# bit k of an int32 word (bit 31 is the sign bit: -2**31)
_BITS = tuple(int(b) for b in
              np.left_shift(np.int32(1), np.arange(32, dtype=np.int32)))


def _bits(device) -> torch.Tensor:
    return const(_BITS, torch.int32, device)


def empty_map(caps: MapCaps = MapCaps(), device="cuda") -> MapState:
    K, L, N, D = caps
    device = resolve_device(device)
    f32, i32 = torch.float32, torch.int32

    def z(*s, dtype=f32):
        return torch.zeros(s, dtype=dtype, device=device)

    def full(s, v, dtype):
        return torch.full(s, v, dtype=dtype, device=device)

    return MapState(
        kf_mask=z(K, dtype=torch.bool),
        kf_R=torch.eye(3, device=device).expand(K, 3, 3).clone(),
        kf_t=z(K, 3), kf_time=z(K), kf_frame_id=full((K,), -1, i32),
        kf_kp=z(K, N, 2), kf_kp_mask=z(K, N, dtype=torch.bool),
        kf_desc=z(K, N, D), kf_depth=full((K, N), float("inf"), f32),
        kf_octave=z(K, N, dtype=torch.int8), obs_lm=full((K, N), -1, i32),
        kf_vel=z(K, 3), kf_bias_g=z(K, 3), kf_bias_a=z(K, 3),
        lm_mask=z(L, dtype=torch.bool), lm_pos=z(L, 3), lm_desc=z(L, D),
        lm_normal=z(L, 3), lm_dist_min=z(L), lm_dist_max=z(L),
        lm_ref_kf=full((L,), -1, i32), lm_n_obs=z(L, dtype=i32),
        lm_found=z(L, dtype=i32), lm_visible=z(L, dtype=i32),
        lm_first_kf=full((L,), -1, i32),
        lm_obs_bits=z(L, (K + 31) // 32, dtype=i32),
        covis=z(K, K, dtype=i32), spanning_parent=full((K,), -1, i32),
        loop_edges=z(K, K, dtype=torch.bool),
        next_kf_counter=z(dtype=i32), imu_initialized=z(dtype=torch.bool),
        imu_ba1=z(dtype=torch.bool), imu_ba2=z(dtype=torch.bool), caps=caps)


def map_state_to_numpy(st: MapState) -> dict:
    """{field name: numpy array} of every tensor field."""
    return {name: getattr(st, name).detach().cpu().numpy()
            for name in TENSOR_FIELDS}


def map_state_from_numpy(src, device="cuda") -> MapState:
    """Build a MapState from numpy arrays: a dict keyed by field name, or an
    object with those attributes (e.g. `jax.device_get` of the JAX package's
    MapState). Capacities are read from the shapes."""
    get = src.__getitem__ if isinstance(src, dict) else \
        (lambda n: getattr(src, n))
    K, N, D = np.shape(get("kf_desc"))
    device = resolve_device(device)
    L = np.shape(get("lm_mask"))[0]
    return MapState(**{n: torch.as_tensor(np.array(get(n)), device=device)
                       for n in TENSOR_FIELDS},
                    caps=MapCaps(int(K), int(L), int(N), int(D)))


# ---------------------------------------------------------------------------
# Slot allocation
# ---------------------------------------------------------------------------

def first_free_slot(mask: torch.Tensor) -> torch.Tensor:
    """Index (0-d int64) of the first False in mask; size-1 if full."""
    free = ~mask
    first = torch.argmax(free.to(torch.int8))
    return torch.where(torch.any(free), first,
                       torch.full_like(first, mask.shape[0] - 1))


def free_slots(mask: torch.Tensor, count: int) -> torch.Tensor:
    """Indices (int64) of the first `count` free slots in ascending order,
    followed by occupied slots in ascending order once the free ones run
    out."""
    idx = torch.arange(mask.shape[0], device=mask.device)
    key = torch.where(mask, mask.shape[0] + idx, idx)
    return torch.argsort(key, stable=True)[:count]


def num_keyframes(st: MapState) -> torch.Tensor:
    return torch.sum(st.kf_mask.to(torch.int32))


def num_landmarks(st: MapState) -> torch.Tensor:
    return torch.sum(st.lm_mask.to(torch.int32))


def _set(t: torch.Tensor, k: torch.Tensor, v) -> torch.Tensor:
    """Out-of-place t[k] = v for a 0-d index tensor k, without reading k
    back to the host (`out[k] = v` would): a tensor v is broadcast to one
    row, a Python number goes in as a fill value."""
    out = t.clone()
    idx = k.reshape(1).long()
    if isinstance(v, torch.Tensor):
        out.index_copy_(0, idx, v.to(t.dtype).expand(t.shape[1:])[None])
    else:
        out.index_fill_(0, idx, v)
    return out


# ---------------------------------------------------------------------------
# Keyframe insertion
# ---------------------------------------------------------------------------

def _kf_bit_words(k: torch.Tensor, n_words: int) -> torch.Tensor:
    """[n_words] int32 (or [..., n_words] for batched k): bit k set."""
    k = k.long()
    ar = torch.arange(n_words, device=k.device)
    bit = torch.index_select(_bits(k.device), 0,
                             (k % 32).reshape(-1)).reshape(k.shape)
    return torch.where(ar == (k // 32)[..., None], bit[..., None],
                       torch.zeros((), dtype=torch.int32, device=k.device))


def _set_obs_bits(bits: torch.Tensor, k: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """Set bit k on the rows selected by rows [L] bool."""
    words = _kf_bit_words(k, bits.shape[1])
    return torch.where(rows[:, None], bits | words[None, :], bits)


def insert_keyframe(st: MapState, R, t, time, frame_id, kp, kp_mask, desc,
                    depth, octave, obs_lm):
    """Insert a keyframe into the first free slot. Returns (state, slot).
    obs_lm: [N] landmark ids already bound to the keypoints (-1 none);
    covisibility, observation counts and observer bits update in one shot
    (reference: KeyFrame::UpdateConnections + MapPoint::AddObservation)."""
    k = first_free_slot(st.kf_mask)
    L = st.caps.L
    valid = obs_lm >= 0
    lm_idx = torch.where(valid, obs_lm, torch.zeros_like(obs_lm))
    dn = sless.id_count(lm_idx, valid, L)
    seen = sless.id_mask(lm_idx, valid, L)
    bits = st.lm_obs_bits & ~_kf_bit_words(k, st.lm_obs_bits.shape[1])[None]
    bits = _set_obs_bits(bits, k, seen)
    kf_valid = st.obs_lm >= 0
    kf_lm = torch.where(kf_valid, st.obs_lm, torch.zeros_like(st.obs_lm))
    shared = torch.sum(seen[kf_lm.long()] & kf_valid, dim=1).to(torch.int32)
    shared = torch.where(st.kf_mask, shared, torch.zeros_like(shared))
    at_k = torch.arange(st.caps.K, device=k.device) == k
    covis = torch.where(at_k[:, None], shared[None, :], st.covis)
    covis = torch.where(at_k[None, :], shared[:, None], covis)
    covis = torch.where(at_k[:, None] & at_k[None, :],
                        torch.zeros_like(covis), covis)
    parent = torch.where(torch.any(shared > 0), torch.argmax(shared),
                         torch.full_like(k, -1)).to(torch.int32)
    dev = st.kf_R.device
    z3 = torch.zeros(3, device=dev)
    st2 = dataclasses.replace(
        st,
        kf_mask=_set(st.kf_mask, k, True),
        kf_R=_set(st.kf_R, k, R),
        kf_t=_set(st.kf_t, k, t),
        kf_time=_set(st.kf_time, k, time),
        kf_frame_id=_set(st.kf_frame_id, k, frame_id),
        kf_kp=_set(st.kf_kp, k, kp),
        kf_kp_mask=_set(st.kf_kp_mask, k, kp_mask),
        kf_desc=_set(st.kf_desc, k, desc),
        kf_depth=_set(st.kf_depth, k, depth),
        kf_octave=_set(st.kf_octave, k, octave.to(torch.int8)),
        obs_lm=_set(st.obs_lm, k, torch.where(kp_mask, obs_lm,
                                              torch.full_like(obs_lm, -1))),
        kf_vel=_set(st.kf_vel, k, z3),
        kf_bias_g=_set(st.kf_bias_g, k, z3),
        kf_bias_a=_set(st.kf_bias_a, k, z3),
        lm_n_obs=st.lm_n_obs + dn,
        lm_obs_bits=bits,
        covis=covis,
        spanning_parent=_set(st.spanning_parent, k, parent),
        next_kf_counter=st.next_kf_counter + 1,
    )
    return st2, k


def rebuild_obs_bits(st: MapState) -> MapState:
    """Recompute lm_obs_bits exactly from the obs table (after an atlas
    merge, where every source slot id moved): bit k of landmark l is set
    when a live keyframe k holds l in its obs row. One scatter over the
    [K, N] table into a bool [L, K] grid, packed into words."""
    K, L = st.caps.K, st.caps.L
    dev = st.obs_lm.device
    n_words = st.lm_obs_bits.shape[1]
    valid = (st.obs_lm >= 0) & st.kf_mask[:, None]
    kf = torch.arange(K, device=dev)[:, None].expand_as(st.obs_lm)
    flat = torch.where(valid, st.obs_lm.long() * K + kf,
                       torch.full_like(kf, L * K))
    grid = torch.zeros(L * K + 1, dtype=torch.bool, device=dev)
    grid.index_fill_(0, flat.reshape(-1), True)
    grid = grid[:L * K].reshape(L, K)
    pad = n_words * 32 - K
    if pad:
        grid = torch.cat([grid, torch.zeros((L, pad), dtype=torch.bool,
                                            device=dev)], dim=1)
    bits = _bits(dev)
    # disjoint bits: the int64 sum equals the OR, and fits back in int32
    words = torch.sum(torch.where(grid.reshape(L, n_words, 32),
                                  bits[None, None, :],
                                  torch.zeros_like(bits)[None, None, :]),
                      dim=2).to(torch.int32)
    return dataclasses.replace(st, lm_obs_bits=words)


# ---------------------------------------------------------------------------
# Landmark insertion / culling
# ---------------------------------------------------------------------------

def insert_landmarks(st: MapState, pos, desc, normal, dist_min, dist_max,
                     ref_kf, first_kf, valid):
    """Insert up to B candidate landmarks: candidate r lands in the r-th
    free slot (cumsum rank), only where valid[r]. Returns (state, slots
    [B] int32, -1 where not placed)."""
    B = pos.shape[0]
    L = st.caps.L
    free = ~st.lm_mask
    recv, src, placed = sless.scatter_rows_dense(free, valid, B)

    def put(old, cand):
        r = recv.reshape((L,) + (1,) * (old.ndim - 1))
        return torch.where(r, cand[src], old)

    def const(v):
        return torch.full((B,), v, dtype=torch.int32, device=pos.device)

    st2 = dataclasses.replace(
        st,
        lm_mask=st.lm_mask | recv,
        lm_pos=put(st.lm_pos, pos),
        lm_desc=put(st.lm_desc, desc),
        lm_normal=put(st.lm_normal, normal),
        lm_dist_min=put(st.lm_dist_min, dist_min),
        lm_dist_max=put(st.lm_dist_max, dist_max),
        lm_ref_kf=put(st.lm_ref_kf, ref_kf.to(torch.int32)),
        lm_first_kf=put(st.lm_first_kf, first_kf.to(torch.int32)),
        lm_n_obs=put(st.lm_n_obs, const(0)),
        lm_found=put(st.lm_found, const(1)),
        lm_visible=put(st.lm_visible, const(1)),
        lm_obs_bits=torch.where(recv[:, None],
                                torch.zeros_like(st.lm_obs_bits),
                                st.lm_obs_bits),
    )
    freei = free.to(torch.int32)
    rank = torch.cumsum(freei, 0) - freei
    slots = sless.id_lookup(
        torch.where(free, rank, torch.full_like(rank, B)), free,
        torch.arange(L, dtype=torch.int32, device=pos.device), B,
        torch.full((B,), L - 1, dtype=torch.int32, device=pos.device))
    return st2, torch.where(placed, slots, torch.full_like(slots, -1))


def add_observations(st: MapState, kf, kp_idx, lm_idx, valid) -> MapState:
    """Bind keypoints kp_idx of keyframe kf to landmarks lm_idx."""
    N = st.obs_lm.shape[1]
    lm_safe = torch.where(valid, lm_idx, torch.zeros_like(lm_idx))
    new_row = sless.id_lookup(kp_idx, valid, lm_safe.to(torch.int32), N,
                              sless.row(st.obs_lm, kf))
    dn = sless.id_count(lm_safe, valid, st.caps.L)
    bits = _set_obs_bits(st.lm_obs_bits, kf,
                         sless.id_mask(lm_safe, valid, st.caps.L))
    return dataclasses.replace(st, obs_lm=_set(st.obs_lm, kf, new_row),
                               lm_n_obs=st.lm_n_obs + dn, lm_obs_bits=bits)


def add_observations_multi(st: MapState, kfs, kp_idx, lm_idx,
                           valid) -> MapState:
    """Bind observations in several keyframes at once: keypoint kp_idx[i,j]
    of keyframe kfs[i] observes landmark lm_idx[j] where valid[i,j]. A
    landmark may be bound by several keyframes (one count and one observer
    bit per binding). Rows are written with the reference's last-wins rule
    for repeated kfs (padding entries of a neighbor list)."""
    nn, N = kp_idx.shape
    L = st.caps.L
    dev = kp_idx.device
    lm_safe = torch.where(lm_idx >= 0, lm_idx,
                          torch.zeros_like(lm_idx)).to(torch.int32)
    off = torch.arange(nn, device=dev)[:, None]
    # per-row id_lookup, batched by offsetting each row into its own segment
    rows = sless.id_lookup(
        (kp_idx.long() + off * N).reshape(-1), valid.reshape(-1),
        lm_safe.expand(nn, N).reshape(-1), nn * N,
        st.obs_lm[kfs.long()].reshape(-1)).reshape(nn, N)
    dn = sless.id_count(lm_safe.expand(nn, N).reshape(-1), valid.reshape(-1),
                        L)
    words = _kf_bit_words(kfs, st.lm_obs_bits.shape[1])          # [nn,W]
    masks = sless.id_mask((lm_safe.long()[None, :] + off * L).reshape(-1),
                          valid.reshape(-1), nn * L).reshape(nn, L)
    delta = torch.zeros_like(st.lm_obs_bits)
    for i in range(nn):
        delta = delta | torch.where(masks[i][:, None], words[i][None, :],
                                    torch.zeros_like(words[i])[None, :])
    return dataclasses.replace(
        st, obs_lm=sless.set_rows(st.obs_lm, kfs, rows),
        lm_n_obs=st.lm_n_obs + dn, lm_obs_bits=st.lm_obs_bits | delta)


def cull_landmarks(st: MapState, kill: torch.Tensor) -> MapState:
    """Remove landmarks where kill[l] (reference: MapPoint::SetBadFlag)."""
    obs_valid = st.obs_lm >= 0
    obs_safe = torch.where(obs_valid, st.obs_lm, torch.zeros_like(st.obs_lm))
    dead_obs = obs_valid & kill[obs_safe.long()]
    return dataclasses.replace(
        st, lm_mask=st.lm_mask & ~kill,
        obs_lm=torch.where(dead_obs, torch.full_like(st.obs_lm, -1),
                           st.obs_lm),
        lm_obs_bits=torch.where(kill[:, None],
                                torch.zeros_like(st.lm_obs_bits),
                                st.lm_obs_bits))


def replace_landmarks(st: MapState, kill, keep, valid) -> MapState:
    """Merge duplicate landmarks: observations of kill[i] are redirected to
    keep[i], counters combined, kill[i] removed (reference:
    MapPoint::Replace). Each kill id appears at most once among valid."""
    L = st.caps.L
    dev = kill.device
    kill_s = torch.where(valid, kill, torch.full_like(kill, L - 1)).long()
    keep_s = torch.where(valid, keep, torch.full_like(keep, L - 1)).long()
    iota = torch.arange(L, dtype=torch.int32, device=dev)
    redirect = sless.id_lookup(kill_s, valid, keep_s.to(torch.int32), L,
                               iota)
    obs_valid = st.obs_lm >= 0
    obs_safe = torch.where(obs_valid, st.obs_lm, torch.zeros_like(st.obs_lm))
    new_obs = torch.where(obs_valid, redirect[obs_safe.long()], st.obs_lm)
    dn = sless.id_sum(keep_s, valid, st.lm_n_obs[kill_s], L)
    df = sless.id_sum(keep_s, valid, st.lm_found[kill_s], L)
    dv = sless.id_sum(keep_s, valid, st.lm_visible[kill_s], L)
    kill_mask = sless.id_mask(kill_s, valid, L)
    # kept landmark inherits the killed one's observer bits; padding rows go
    # to a dump row (reference: out-of-range index, mode="drop"); repeated
    # keep ids follow the last-wins scatter rule
    merged = st.lm_obs_bits[keep_s] | st.lm_obs_bits[kill_s]
    keep_w = torch.where(valid, keep_s, torch.full_like(keep_s, L))
    bits = sless.set_rows(
        torch.cat([st.lm_obs_bits, st.lm_obs_bits[:1]]), keep_w, merged)[:L]
    return dataclasses.replace(
        st, obs_lm=new_obs, lm_mask=st.lm_mask & ~kill_mask,
        lm_n_obs=st.lm_n_obs + dn, lm_found=st.lm_found + df,
        lm_visible=st.lm_visible + dv,
        lm_obs_bits=torch.where(kill_mask[:, None], torch.zeros_like(bits),
                                bits))


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def best_covisible(st: MapState, k, n: int):
    """Top-n covisible keyframes of k by shared-observation count (stable
    order on ties, as the reference's argsort)."""
    row = sless.row(st.covis, k)
    w = torch.where(st.kf_mask, row, torch.full_like(row, -1))
    w = _set(w, k, -1)
    idx = torch.argsort(-w, stable=True)[:n]
    return idx, w[idx]


def local_map_landmark_mask(st: MapState, kf_sel: torch.Tensor):
    """Bool [L]: landmarks observed by any keyframe in kf_sel (bool [K]),
    answered from the observer bitmask."""
    K = st.caps.K
    sel = kf_sel & st.kf_mask
    n_words = st.lm_obs_bits.shape[1]
    pad = n_words * 32 - K
    if pad:
        sel = torch.cat([sel, torch.zeros(pad, dtype=torch.bool,
                                          device=sel.device)])
    bits = _bits(sel.device)
    # disjoint bits: the int64 sum equals the OR, and fits back in int32
    words = torch.sum(torch.where(sel.reshape(n_words, 32), bits[None, :],
                                  torch.zeros_like(bits)[None, :]),
                      dim=1).to(torch.int32)
    hit = torch.any((st.lm_obs_bits & words[None, :]) != 0, dim=1)
    return hit & st.lm_mask
