"""Visual-inertial bundle adjustment over the MapState (counterpart of
dani_slam_tpu/slam/inertial_mapping.py).

Once the IMU is initialized, local mapping switches from the covisibility
local BA to the TEMPORAL-window LocalInertialBA (reference
src/LocalMapping.cc:150-151 -> src/Optimizer.cc:2383: Nd = 10 keyframes,
the oldest one the fixed anchor), and the IMU initialization stages run a
whole-map FullInertialBA (src/Optimizer.cc:392). These functions gather
those problems from the map, solve them (ops/viba.viba_solve,
ops/ba_large.full_inertial_ba) and write the states back.
"""
from __future__ import annotations

import dataclasses

import torch

from dani_slam_tpu_torch.core import scatterless as sless
from dani_slam_tpu_torch.core import state as mstate
from dani_slam_tpu_torch.ops import ba_large, viba


def _write_back(st, safe, mask, vals, K):
    """`st_field.at[where(mask, safe, K-1)].set(where(mask, vals, old))`
    with the reference's last-write rule on a repeated index."""
    idx = torch.where(mask, safe, torch.full_like(safe, K - 1))
    m = mask.reshape(mask.shape + (1,) * (vals.ndim - 1))
    return sless.set_rows(st, idx, torch.where(m, vals, st[idx]))


def full_inertial_ba_map(st: mstate.MapState, cam, kf_slots, slot_valid,
                         preints, edge_valid, calib, prior_g: float = 0.0,
                         prior_a: float = 0.0, iters: int = 8,
                         cg_iters: int = 50) -> mstate.MapState:
    """Whole-map VI BA over the temporal keyframe chain. kf_slots [P]: every
    alive keyframe in temporal order (padded in front; slot_valid [P]);
    preints [P-1] keyframe-to-keyframe preintegrations (windows merged
    across culled keyframes); prior_g / prior_a the staged bias-prior
    weights. Landmarks at full capacity (the PCG solver never forms
    per-pair blocks). The oldest alive keyframe's pose is the gauge anchor;
    its velocity and biases are updated too."""
    P = kf_slots.shape[0]
    K = st.caps.K
    safe = torch.where(slot_valid, kf_slots,
                       torch.zeros_like(kf_slots)).long()
    alive = slot_valid & st.kf_mask[safe]
    obs = st.obs_lm[safe]
    obs_lm_rows = torch.where((obs >= 0) & st.kf_kp_mask[safe] &
                              alive[:, None], obs, torch.full_like(obs, -1))
    obs_xy = st.kf_kp[safe]
    first_pos = torch.argmax(alive.to(torch.int8))
    ar = torch.arange(P, device=safe.device)
    pose_fixed = (ar == first_pos) | ~alive
    res = ba_large.full_inertial_ba(
        st.kf_R[safe], st.kf_t[safe], st.kf_vel[safe], st.kf_bias_g[safe],
        st.kf_bias_a[safe], pose_fixed, st.lm_pos, st.lm_mask, cam,
        obs_lm_rows, obs_xy, obs_lm_rows >= 0, preints,
        edge_valid & alive[:-1] & alive[1:], calib, prior_g=prior_g,
        prior_a=prior_a, iters=iters, cg_iters=cg_iters)
    upd = alive & ~pose_fixed
    return dataclasses.replace(
        st,
        kf_R=_write_back(st.kf_R, safe, upd, res.R, K),
        kf_t=_write_back(st.kf_t, safe, upd, res.t, K),
        kf_vel=_write_back(st.kf_vel, safe, alive, res.v, K),
        kf_bias_g=_write_back(st.kf_bias_g, safe, alive, res.bg, K),
        kf_bias_a=_write_back(st.kf_bias_a, safe, alive, res.ba, K),
        lm_pos=torch.where(st.lm_mask[:, None], res.lm_pos, st.lm_pos))


def local_inertial_ba(st: mstate.MapState, cam, kf_slots, slot_valid,
                      preints, edge_valid, calib, L_loc: int = 1024,
                      iters: int = 6) -> mstate.MapState:
    """kf_slots [P]: the temporal window of keyframe slots (oldest first,
    padded in front; slot_valid [P]); preints stacked over the P-1 pairs;
    edge_valid [P-1]. The window's landmarks are the first L_loc of those
    its keyframes observe (ascending ids); the oldest alive slot is the
    fixed anchor (the reference fixes the keyframe before the window)."""
    P = kf_slots.shape[0]
    K, L = st.caps.K, st.caps.L
    dev = kf_slots.device
    safe = torch.where(slot_valid, kf_slots,
                       torch.zeros_like(kf_slots)).long()
    alive = slot_valid & st.kf_mask[safe]
    kf_sel = sless.id_mask(safe, alive, K)
    lm_sel = mstate.local_map_landmark_mask(st, kf_sel)
    arL = torch.arange(L, device=dev)
    lkey = torch.where(lm_sel, arL, L + arL)
    loc_lm = torch.argsort(lkey)[:L_loc]
    loc_valid = lm_sel[loc_lm]
    inv = torch.full((L,), -1, dtype=torch.int64, device=dev)
    inv = inv.scatter(0, loc_lm, torch.arange(L_loc, device=dev))
    inv = torch.where(lm_sel, inv, torch.full_like(inv, -1))

    obs = st.obs_lm[safe]                                     # [P,N]
    row_valid = (obs >= 0) & st.kf_kp_mask[safe] & alive[:, None]
    row_loc = inv[torch.where(obs >= 0, obs, torch.zeros_like(obs)).long()]
    row_valid = row_valid & (row_loc >= 0)
    obs_xy = st.kf_kp[safe]
    first_pos = torch.argmax(alive.to(torch.int8))
    pose_fixed = (torch.arange(P, device=dev) == first_pos) | ~alive
    res = viba.viba_solve(
        st.kf_R[safe], st.kf_t[safe], st.kf_vel[safe], st.kf_bias_g[safe],
        st.kf_bias_a[safe], pose_fixed, st.lm_pos[loc_lm], loc_valid, cam,
        torch.where(row_valid, row_loc, torch.full_like(row_loc, -1)),
        obs_xy, row_valid, preints, edge_valid & alive[:-1] & alive[1:],
        calib, iters=iters)
    upd = alive & ~pose_fixed
    lm_new = st.lm_pos.clone()
    lm_new[loc_lm] = torch.where(loc_valid[:, None], res.lm_pos,
                                 st.lm_pos[loc_lm])
    return dataclasses.replace(
        st,
        kf_R=_write_back(st.kf_R, safe, upd, res.R, K),
        kf_t=_write_back(st.kf_t, safe, upd, res.t, K),
        kf_vel=_write_back(st.kf_vel, safe, upd, res.v, K),
        kf_bias_g=_write_back(st.kf_bias_g, safe, upd, res.bg, K),
        kf_bias_a=_write_back(st.kf_bias_a, safe, upd, res.ba, K),
        lm_pos=lm_new)
