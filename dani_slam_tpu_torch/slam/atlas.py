"""Atlas: multi-map management and map merging (counterpart of
dani_slam_tpu/slam/atlas.py).

A "map" is one MapState; the Atlas is a host list of them (swapping maps is
swapping references). Merging is two device steps: (1) sim3-transform every
pose and landmark of the source map, (2) copy them into the free slots of
the target map with an id-translation table.

Translation note: the JAX package writes the merge as scatters in which
unused source rows target slot K-1 / L-1 and rewrite the value found there.
A scatter with repeated indices has no defined order here, so the merge is
written from the destination's side instead — each target slot gathers the
one source slot mapped onto it, or keeps its value — which makes the unused
rows a no-op by construction.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from dani_slam_tpu_torch.core import lie, state as mstate
from dani_slam_tpu_torch.utils.device import pull


def transform_map(st: mstate.MapState, R, t, s) -> mstate.MapState:
    """Apply a world-frame sim3 to a whole map: x_new = s R x_old + t.
    Camera-from-world poses become R_k' = R_k R^T, t_k' = s t_k - R_k' t
    (camera-frame depths rescale by s with the landmarks), and the landmark
    distance bands scale by s."""
    lm = lie.sim3_apply(R, t, s, st.lm_pos)
    Rk = st.kf_R @ R.transpose(-1, -2)[None]
    tk = s * st.kf_t - torch.einsum('kij,j->ki', Rk, t)
    return dataclasses.replace(
        st, lm_pos=torch.where(st.lm_mask[:, None], lm, st.lm_pos),
        kf_R=torch.where(st.kf_mask[:, None, None], lie.orthonormalize(Rk),
                         st.kf_R),
        kf_t=torch.where(st.kf_mask[:, None], tk, st.kf_t),
        lm_dist_min=st.lm_dist_min * s, lm_dist_max=st.lm_dist_max * s)


def _slot_map(target_mask, source_mask, size: int):
    """(map [size] i32: source slot -> target slot, -1 for unused source
    slots; inv [size] i64: target slot -> source slot; has [size] bool: the
    target slot receives a source row). Live source slots take the target's
    free slots in ascending order."""
    slots = mstate.free_slots(target_mask, size)
    rank = torch.cumsum(source_mask.to(torch.int64), 0) - 1
    dst = slots[torch.clamp(rank, 0, size - 1)]
    smap = torch.where(source_mask, dst, torch.full_like(dst, -1))
    inv = torch.full((size + 1,), -1, dtype=torch.int64,
                     device=target_mask.device)
    inv[torch.where(source_mask, dst, torch.full_like(dst, size))] = \
        torch.arange(size, device=target_mask.device)
    inv = inv[:size]
    return smap.to(torch.int32), torch.clamp(inv, min=0), inv >= 0


def merge_into(target: mstate.MapState, source: mstate.MapState):
    """Copy all keyframes/landmarks of `source` into free slots of `target`.

    Assumes `source` was already transformed into target world coordinates.
    Returns (merged_state, kf_slot_map [K], lm_slot_map [L], ok) — ok False
    if the target lacks capacity (the caller keeps the maps separate then).
    """
    K, L = target.caps.K, target.caps.L
    n_kf_src = torch.sum(source.kf_mask.to(torch.int32))
    n_lm_src = torch.sum(source.lm_mask.to(torch.int32))
    kf_free = K - torch.sum(target.kf_mask.to(torch.int32))
    lm_free = L - torch.sum(target.lm_mask.to(torch.int32))
    ok = (n_kf_src <= kf_free) & (n_lm_src <= lm_free)

    kf_map, kf_inv, kf_has = _slot_map(target.kf_mask, source.kf_mask, K)
    lm_map, lm_inv, lm_has = _slot_map(target.lm_mask, source.lm_mask, L)

    def take(dst_arr, src_arr, inv, has):
        h = has.reshape(has.shape + (1,) * (src_arr.ndim - 1))
        return torch.where(h, src_arr[inv], dst_arr)

    def kf(name, src_arr=None):
        src_arr = getattr(source, name) if src_arr is None else src_arr
        return take(getattr(target, name), src_arr, kf_inv, kf_has)

    def lm(name, src_arr=None):
        src_arr = getattr(source, name) if src_arr is None else src_arr
        return take(getattr(target, name), src_arr, lm_inv, lm_has)

    def translate(ids, table, size):
        """Slot ids of the source -> slot ids of the target (-1 kept)."""
        return torch.where(ids >= 0,
                           table[torch.clamp(ids, 0, size - 1).long()],
                           torch.full_like(ids, -1))

    both = kf_has[:, None] & kf_has[None, :]
    t2 = dataclasses.replace(
        target,
        kf_mask=target.kf_mask | kf_has,
        kf_R=kf("kf_R"), kf_t=kf("kf_t"), kf_time=kf("kf_time"),
        kf_frame_id=kf("kf_frame_id"), kf_kp=kf("kf_kp"),
        kf_kp_mask=kf("kf_kp_mask"), kf_desc=kf("kf_desc"),
        kf_depth=kf("kf_depth"), kf_octave=kf("kf_octave"),
        obs_lm=kf("obs_lm", translate(source.obs_lm, lm_map, L)),
        kf_vel=kf("kf_vel"), kf_bias_g=kf("kf_bias_g"),
        kf_bias_a=kf("kf_bias_a"),
        lm_mask=target.lm_mask | lm_has,
        lm_pos=lm("lm_pos"), lm_desc=lm("lm_desc"),
        lm_normal=lm("lm_normal"), lm_dist_min=lm("lm_dist_min"),
        lm_dist_max=lm("lm_dist_max"),
        lm_ref_kf=lm("lm_ref_kf", translate(source.lm_ref_kf, kf_map, K)),
        lm_n_obs=lm("lm_n_obs"), lm_found=lm("lm_found"),
        lm_visible=lm("lm_visible"),
        # lm_first_kf is the monotone creation COUNTER (not a slot): source
        # counters are shifted past the target's so relative ages stay
        # consistent on the merged timeline
        lm_first_kf=lm("lm_first_kf", torch.where(
            source.lm_first_kf >= 0,
            source.lm_first_kf + target.next_kf_counter,
            torch.full_like(source.lm_first_kf, -1))),
        # covisibility: the source block moves as a block; cross-map links
        # grow later through fuse
        covis=torch.where(both, source.covis[kf_inv[:, None],
                                             kf_inv[None, :]], target.covis),
        spanning_parent=kf("spanning_parent",
                           translate(source.spanning_parent, kf_map, K)),
        next_kf_counter=target.next_kf_counter + source.next_kf_counter,
    )
    # observer bitmask: every source slot id moved — rebuild from the merged
    # obs table (rare path)
    t2 = mstate.rebuild_obs_bits(t2)
    return t2, kf_map, lm_map, ok


class Atlas:
    """Host-side multi-map container."""

    def __init__(self, caps: mstate.MapCaps):
        self.caps = caps
        self.stored: List[dict] = []      # [{"st":..., "bow":...}]

    def stash(self, st: mstate.MapState, bow=None):
        """Store the active map (called when tracking is lost beyond
        recovery and a fresh map starts)."""
        self.stored.append(dict(st=st, bow=bow))

    def n_maps(self) -> int:
        return len(self.stored)

    def try_merge(self, active_st: mstate.MapState, cam, active_kf: int,
                  qbow, key, verify_fn, min_inliers: int = 25):
        """Look for the active keyframe in stored maps; on a verified hit,
        transform + weld the ACTIVE map into the stored one and return the
        merged state, else None.

        qbow: BoW vector of the active keyframe (selects the candidate
        keyframe inside each stored map; without it or without a stored
        database the newest slot is the candidate); verify_fn(st_a, st_b,
        kf_a, kf_b, key) -> ((R, t, s), n, ok) is the cross-map geometric
        verifier (slots as host ints; slam/loopclosing.
        verify_cross_map_candidate behind the System's gates); `key` is
        handed through to it.
        """
        from dani_slam_tpu_torch.models import vocab as vocab_mod

        dev = active_st.kf_R.device
        one = torch.ones((), device=dev)
        for i, entry in enumerate(self.stored):
            stored_st = entry["st"]
            bow = entry.get("bow")
            if bow is None or qbow is None:
                ar = torch.arange(self.caps.K, device=dev)
                cand_kf = int(pull(torch.argmax(
                    torch.where(stored_st.kf_mask, ar,
                                torch.full_like(ar, -1)))))
            else:
                sc = vocab_mod.bow_l1_score(bow, qbow[None])
                scores = pull(torch.where(stored_st.kf_mask, sc,
                                          torch.full_like(sc, -1.0)))
                cand_kf = int(scores.argmax())
                if float(scores[cand_kf]) <= 0.0:
                    continue
            T12, n, ok = verify_fn(active_st, stored_st, int(active_kf),
                                   cand_kf, key)
            if not bool(pull(ok) if isinstance(ok, torch.Tensor) else ok):
                continue
            R, t, s = T12
            # the verifier returns the relative sim3 between the two
            # keyframes; the world-frame alignment stored <- active is
            # T_cand_cw^-1 * T12^-1 * T_active_cw
            Rc, tc = stored_st.kf_R[cand_kf], stored_st.kf_t[cand_kf]
            Ra, ta = active_st.kf_R[active_kf], active_st.kf_t[active_kf]
            Ri, ti, si = lie.sim3_inv(R, t, s)
            Rw, tw, sw = lie.sim3_mul(*lie.sim3_inv(Rc, tc, one),
                                      *lie.sim3_mul(Ri, ti, si, Ra, ta, one))
            src_t = transform_map(active_st, Rw, tw, sw)
            merged, kf_map, lm_map, cap_ok = merge_into(stored_st, src_t)
            if not bool(pull(cap_ok)):
                continue
            del self.stored[i]
            return dict(st=merged,
                        new_active_kf=int(pull(kf_map[active_kf])),
                        kf_map=kf_map, lm_map=lm_map, cand_kf=cand_kf,
                        stored_bow=bow)
        return None
