"""Local mapping: keyframe processing, landmark creation, fuse, local BA,
culling (counterpart of dani_slam_tpu/slam/mapping.py; triangulation matches
through LightGlue when a matcher is given, by descriptor mutual-NN otherwise).

Mirrors the reference's LocalMapping pipeline per keyframe: insert ->
landmarks from depth -> triangulation against covisible neighbors -> fuse
into neighbors (both directions, replace arm) -> local BA -> landmark and
keyframe culling. The JAX package's vmaps over neighbors are a leading
batch dim here.
"""
from __future__ import annotations

import dataclasses

import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.core import lie, scatterless as sless
from dani_slam_tpu_torch.core import state as mstate
from dani_slam_tpu_torch.ops import ba as ba_ops
from dani_slam_tpu_torch.ops import matching

CHI2_MONO = 5.991


def _first_occurrence(keys: torch.Tensor) -> torch.Tensor:
    """bool mask of the first occurrence of each key (stable sort by key +
    neighbor difference, mapped back through the inverse permutation)."""
    order = torch.argsort(keys, stable=True)
    ks = keys[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=keys.device),
                       ks[1:] != ks[:-1]])
    return first[torch.argsort(order)]


def create_new_landmarks(st: mstate.MapState, cam, kf_new,
                         n_neighbors: int = 5, th_desc: float = 0.7,
                         reproj_px: float = 2.0,
                         min_parallax_cos: float = 0.99995, matcher=None):
    """Triangulate new landmarks between kf_new and its best covisible
    neighbors, batched over all pairs: matches on unbound keypoints,
    midpoint triangulation with reprojection / parallax / depth gates, one
    winning neighbor per keypoint (best quality), one masked insert.

    With a matcher (models.lightglue.MatcherState) the wide-baseline
    association is ONE batched LightGlue forward over the n_neighbors pairs,
    on both sides compacted to their unbound keypoints (attention is
    quadratic in tokens; Nc = max(N/2, 256) slots, overflow keypoints wait
    for a later keyframe); otherwise descriptor mutual-NN."""
    nn = n_neighbors
    dev = st.kf_R.device
    neigh, w = mstate.best_covisible(st, kf_new, nn)
    R1, t1 = sless.row(st.kf_R, kf_new), sless.row(st.kf_t, kf_new)
    kp1, d1 = sless.row(st.kf_kp, kf_new), sless.row(st.kf_desc, kf_new)
    N = kp1.shape[0]
    unb1 = (sless.row(st.obs_lm, kf_new) < 0) & \
        sless.row(st.kf_kp_mask, kf_new)
    unb2 = (st.obs_lm[neigh] < 0) & st.kf_kp_mask[neigh]        # [nn,N]
    pair_ok = (w > 0) & st.kf_mask[neigh]

    if matcher is not None:
        from dani_slam_tpu_torch.models import lightglue as lg
        Nc = max(N // 2, 256)
        # unbound-first stable permutations, and kf_new's inverse
        perm1 = torch.argsort((~unb1).to(torch.int8), stable=True)
        sel1 = perm1[:Nc]
        inv1 = torch.argsort(perm1, stable=True)                 # [N] pos
        sel2 = torch.argsort((~unb2).to(torch.int8), dim=1,
                             stable=True)[:, :Nc]                # [nn,Nc]
        kp2n, d2n = st.kf_kp[neigh], st.kf_desc[neigh]
        idxc, scorec, okc = lg.match_pairs(
            matcher.model,
            kp1[sel1].expand(nn, -1, -1), d1[sel1].expand(nn, -1, -1),
            unb1[sel1].expand(nn, -1),
            torch.gather(kp2n, 1, sel2[..., None].expand(-1, -1, 2)),
            torch.gather(d2n, 1, sel2[..., None].expand(-1, -1,
                                                        d2n.shape[-1])),
            torch.gather(unb2, 1, sel2), cam.width, cam.height)
        # back to FULL indexing: neighbor ids through sel2, query rows
        # through each keypoint's position in the unbound-first permutation
        idx_fullc = torch.gather(sel2, 1, torch.clamp(idxc, min=0).long())
        g = torch.clamp(inv1, max=Nc - 1)                        # [N]
        in1 = (inv1 < Nc) & unb1
        idxb = idx_fullc[:, g]                                   # [nn,N]
        okb = okc[:, g] & in1[None, :]
        quality = torch.where(okb, scorec[:, g],
                              torch.full_like(scorec[:, g], -float("inf")))
    else:
        dmat = matching.desc_distance_matrix(d1, st.kf_desc[neigh])
        m = matching.masked_match(dmat,
                                  unb1[None, :, None] & unb2[:, None, :],
                                  th=th_desc, mutual=True)
        idxb, okb, quality = m.idx, m.ok, -m.dist

    # batched two-view triangulation + gates over all pairs
    r1 = _cam.unproject(cam, kp1)
    R1i, t1i = lie.se3_inv(R1, t1)
    R2, t2 = st.kf_R[neigh], st.kf_t[neigh]
    kp2 = torch.gather(st.kf_kp[neigh], 1, idxb[..., None].expand(-1, -1, 2))
    R21, t21 = lie.se3_mul(R2, t2, R1i, t1i)                     # [nn,...]
    X1 = _cam.triangulate_midpoint(r1, _cam.unproject(cam, kp2), R21, t21)
    X2 = torch.einsum('bij,bnj->bni', R21, X1) + t21[:, None, :]
    e1 = _cam.project(cam, X1) - kp1
    e2 = _cam.project(cam, X2) - kp2
    gate = reproj_px ** 2 * CHI2_MONO
    ok_rep = (torch.sum(e1 * e1, -1) < gate) & (torch.sum(e2 * e2, -1) < gate)
    C2 = -torch.einsum('bji,bj->bi', R21, t21)
    dir2 = X1 - C2[:, None, :]
    cosp = torch.einsum('bni,bni->bn', X1, dir2) / torch.clamp(
        torch.linalg.norm(X1, dim=-1) * torch.linalg.norm(dir2, dim=-1),
        min=1e-9)
    goodb = ((X1[..., 2] > 0) & (X2[..., 2] > 0) & ok_rep &
             (cosp < min_parallax_cos))
    goodb = goodb & okb & pair_ok[:, None]

    # one winning neighbor per keypoint
    q = torch.where(goodb, quality, torch.full_like(quality, -float("inf")))
    winner = torch.argmax(q, dim=0)
    win_ok = torch.any(goodb, dim=0)
    arange = torch.arange(N, device=dev)
    X1w = X1[winner, arange]

    Xw = lie.se3_apply(R1i, t1i, X1w)
    C1w = -torch.einsum('ji,j->i', R1, t1)
    vnorm = Xw - C1w
    dist = torch.clamp(torch.linalg.norm(vnorm, dim=-1), min=1e-9)
    st, slots = mstate.insert_landmarks(
        st, Xw, d1, vnorm / dist[:, None], dist * 0.8, dist * 1.3,
        torch.broadcast_to(kf_new, (N,)),
        torch.broadcast_to(st.next_kf_counter, (N,)), win_ok)
    bound = win_ok & (slots >= 0)
    st = mstate.add_observations(st, kf_new, arange, slots, bound)
    sel = bound[None, :] & (winner[None, :] ==
                            torch.arange(nn, device=dev)[:, None])
    return mstate.add_observations_multi(st, neigh, idxb, slots, sel)


def create_depth_landmarks(st: mstate.MapState, cam, kf_new,
                           max_depth: float = 1e9, close_depth: float = 3.0,
                           max_create: int = 100):
    """Landmarks from measured depth for unbound keypoints: every point
    closer than close_depth plus the closest remaining until max_create
    (reference: CreateNewKeyFrame's depth-sorted 100-point cap)."""
    kp = sless.row(st.kf_kp, kf_new)
    depth = sless.row(st.kf_depth, kf_new)
    N = kp.shape[0]
    unb = (sless.row(st.obs_lm, kf_new) < 0) & sless.row(st.kf_kp_mask, kf_new)
    good = unb & torch.isfinite(depth) & (depth > 0) & (depth < max_depth)
    order = torch.argsort(torch.where(good, depth,
                                      torch.full_like(depth, float("inf"))),
                          stable=True)
    rank = torch.argsort(order, stable=True)
    good = good & ((depth < close_depth) | (rank < max_create))
    R1, t1 = sless.row(st.kf_R, kf_new), sless.row(st.kf_t, kf_new)
    Xc = _cam.unproject(cam, kp) * depth[:, None]
    Xw = lie.se3_apply(*lie.se3_inv(R1, t1), Xc)
    vnorm = Xw - (-torch.einsum('ji,j->i', R1, t1))
    dist = torch.clamp(torch.linalg.norm(vnorm, dim=-1), min=1e-9)
    st, slots = mstate.insert_landmarks(
        st, Xw, sless.row(st.kf_desc, kf_new), vnorm / dist[:, None],
        dist * 0.8, dist * 1.3, torch.broadcast_to(kf_new, (N,)),
        torch.broadcast_to(st.next_kf_counter, (N,)), good)
    return mstate.add_observations(st, kf_new,
                                   torch.arange(N, device=kp.device), slots,
                                   good & (slots >= 0))


def fuse_into_neighbors(st: mstate.MapState, cam, kf_new,
                        n_neighbors: int = 5, radius: float = 3.0,
                        n_neighbors2: int = 0):
    """Both fuse directions of the reference's SearchInNeighbors: kf_new's
    landmarks into neighbor keyframes (bind free keypoints; replace arm for
    keypoints bound to a different live landmark — the better-observed one
    absorbs the other) and the neighbors' landmarks back into kf_new.
    n_neighbors2 > 0 adds up to that many best covisibles of each one-hop
    neighbor (deduped)."""
    K, L = st.caps.K, st.caps.L
    dev = st.kf_R.device
    neigh, w = mstate.best_covisible(st, kf_new, n_neighbors)
    pair_ok = (w > 0) & st.kf_mask[neigh]

    if n_neighbors2:
        excl = sless.id_mask(torch.cat([neigh, kf_new[None]]),
                             torch.cat([pair_ok, torch.ones(1, dtype=torch.bool,
                                                            device=dev)]), K)
        rows = torch.where((st.kf_mask & ~excl)[None, :], st.covis[neigh],
                           torch.full_like(st.covis[neigh], -1))
        rows = torch.where(pair_ok[:, None], rows, torch.full_like(rows, -1))
        idx2 = torch.argsort(-rows, dim=1, stable=True)[:, :n_neighbors2]
        w2 = torch.gather(rows, 1, idx2)
        cand = idx2.reshape(-1)
        cok = w2.reshape(-1) > 0
        cok = cok & _first_occurrence(torch.where(cok, cand,
                                                  torch.full_like(cand, K)))
        neigh = torch.cat([neigh, cand])
        pair_ok = torch.cat([pair_ok, cok])

    obs_new = sless.row(st.obs_lm, kf_new)
    has_lm = obs_new >= 0
    lm_ids = torch.where(has_lm, obs_new, torch.zeros_like(obs_new))
    li = lm_ids.long()
    lm_pos, lm_desc = st.lm_pos[li], st.lm_desc[li]
    base_mask = has_lm & st.lm_mask[li]

    # forward: all neighbors at once, against ALL valid keypoints
    nn_f = neigh.shape[0]
    xy, vis, _, _ = matching.project_landmarks(
        st.kf_R[neigh], st.kf_t[neigh], cam, lm_pos.expand(nn_f, -1, -1),
        base_mask[None, :] & pair_ok[:, None])
    m = matching.fuse_candidates(xy, vis, lm_desc.expand(nn_f, -1, -1),
                                 st.kf_kp[neigh], st.kf_kp_mask[neigh],
                                 st.kf_desc[neigh], radius=radius)
    idxs, oks = m.idx, m.ok
    tgts = torch.gather(st.obs_lm[neigh], 1, idxs)               # [nn,N]
    tgt_live = (tgts >= 0) & st.lm_mask[torch.clamp(tgts, min=0).long()]
    st = mstate.add_observations_multi(st, neigh, idxs, lm_ids,
                                       oks & (tgts < 0))
    # replace arm (MapPoint::Replace): keep the better-observed landmark
    src_f = lm_ids.expand(nn_f, -1).reshape(-1).long()
    tgt_f = torch.clamp(tgts, min=0).reshape(-1).long()
    pair_valid = (oks & tgt_live & (tgts != lm_ids[None, :])).reshape(-1)
    n_src, n_tgt = st.lm_n_obs[src_f], st.lm_n_obs[tgt_f]
    keep_f = torch.where(n_src >= n_tgt, src_f, tgt_f)
    kill_f = torch.where(n_src >= n_tgt, tgt_f, src_f)
    # each kill id at most once; no kill-keep chains in one pass
    pair_valid = pair_valid & _first_occurrence(
        torch.where(pair_valid, kill_f, torch.full_like(kill_f, L)))
    killed = sless.id_mask(torch.where(pair_valid, kill_f,
                                       torch.full_like(kill_f, L - 1)),
                           pair_valid, L)
    pair_valid = pair_valid & ~killed[keep_f]
    st = mstate.replace_landmarks(st, kill_f, keep_f, pair_valid)

    # reverse: the targets' landmarks projected into kf_new
    obs_n = st.obs_lm[neigh]
    has_n = (obs_n >= 0) & st.kf_kp_mask[neigh] & pair_ok[:, None]
    lm2 = torch.where(has_n, obs_n, torch.zeros_like(obs_n)).reshape(-1)
    l2 = lm2.long()
    has2 = has_n.reshape(-1) & st.lm_mask[l2]
    word = sless.row(st.lm_obs_bits.t(), kf_new // 32)[l2]
    has2 = has2 & (((word >> (kf_new % 32).to(torch.int32)) & 1) == 0)
    has2 = has2 & _first_occurrence(torch.where(has2, l2,
                                                torch.full_like(l2, L)))
    xy2, vis2, _, _ = matching.project_landmarks(
        sless.row(st.kf_R, kf_new), sless.row(st.kf_t, kf_new), cam,
        st.lm_pos[l2], has2)
    unb_new = (obs_new < 0) & sless.row(st.kf_kp_mask, kf_new)
    m2 = matching.fuse_candidates(xy2, vis2, st.lm_desc[l2],
                                  sless.row(st.kf_kp, kf_new), unb_new,
                                  sless.row(st.kf_desc, kf_new), radius=radius)
    return mstate.add_observations(st, kf_new, m2.idx, lm2, m2.ok)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 words (as their unsigned 32-bit pattern)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _lba_window_select(st: mstate.MapState, center_kf, P_opt: int,
                       L_loc: int):
    """Local-BA window: center + its P_opt-1 best covisible keyframes, and
    up to L_loc landmarks ranked by how many window keyframes observe them
    (observer-bitmask popcount). Returns (opt_idx, opt_real, win_cnt,
    lm_sel, loc_lm, loc_lm_valid, inv)."""
    L = st.caps.L
    dev = st.kf_R.device
    crow = sless.row(st.covis, center_kf)
    wrow = torch.where(st.kf_mask, crow, torch.full_like(crow, -1))
    wrow = mstate._set(wrow, center_kf, -1)
    top_idx = torch.argsort(-wrow, stable=True)[:P_opt - 1]
    opt_idx = torch.cat([center_kf.reshape(1), top_idx])
    opt_real = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          wrow[top_idx] > 0]) & st.kf_mask[opt_idx]
    n_words = st.lm_obs_bits.shape[1]
    opt_words = mstate._kf_bit_words(opt_idx, n_words)           # [P_opt,nw]
    win_bits = torch.sum(torch.where(opt_real[:, None], opt_words,
                                     torch.zeros_like(opt_words)),
                         dim=0).to(torch.int32)                  # disjoint
    win_cnt = torch.sum(_popcount32(st.lm_obs_bits & win_bits[None, :]),
                        dim=1).to(torch.int32)
    lm_sel = st.lm_mask & (win_cnt > 0)
    lkey = torch.where(lm_sel, win_cnt, torch.full_like(win_cnt, -1))
    loc_lm = torch.argsort(-lkey, stable=True)[:L_loc]
    loc_lm_valid = lm_sel[loc_lm]
    inv = sless.id_lookup(loc_lm, loc_lm_valid,
                          torch.arange(L_loc, dtype=torch.int32, device=dev),
                          L, torch.full((L,), -1, dtype=torch.int32,
                                        device=dev))
    inv = torch.where(lm_sel, inv, torch.full_like(inv, -1))
    return opt_idx, opt_real, win_cnt, lm_sel, loc_lm, loc_lm_valid, inv


def lba_window_stats(st: mstate.MapState, center_kf, P_opt: int = 8,
                     P_fix: int = 8, L_loc: int = 2048) -> torch.Tensor:
    """The local-BA window's coverage, int32 [4] (the same selection as
    local_bundle_adjustment): [0] landmarks observed by the optimized
    keyframes, [1] of those, landmarks admitted into the L_loc slots, [2]
    the window's observations, [3] those kept after the landmark cap."""
    center_kf = torch.as_tensor(center_kf, device=st.kf_R.device).long()
    (opt_idx, opt_real, _, lm_sel, loc_lm, loc_lm_valid,
     _) = _lba_window_select(st, center_kf, P_opt, L_loc)
    kept = torch.zeros(st.caps.L, dtype=torch.bool, device=st.kf_R.device)
    kept = kept.scatter(0, loc_lm, loc_lm_valid)
    obs_w = st.obs_lm[opt_idx]
    valid_w = (obs_w >= 0) & st.kf_kp_mask[opt_idx] & opt_real[:, None]
    obs_flat = torch.where(valid_w, obs_w, torch.zeros_like(obs_w))
    i32 = torch.int32
    return torch.stack([
        lm_sel.to(i32).sum(), kept.to(i32).sum(), valid_w.to(i32).sum(),
        (valid_w & kept[obs_flat.long()]).to(i32).sum()]).to(i32)


def local_bundle_adjustment(st: mstate.MapState, cam, center_kf,
                            P_opt: int = 8, P_fix: int = 8,
                            L_loc: int = 2048, iters: int = 5):
    """Optimize the covisibility window around center_kf: P_opt keyframes
    optimized, the P_fix next-best observers of the window's landmarks as
    fixed anchors, up to L_loc landmarks (reference:
    Optimizer::LocalBundleAdjustment, first 5-iteration phase)."""
    K, N = st.obs_lm.shape
    dev = st.kf_R.device
    (opt_idx, opt_real, _, _, loc_lm, loc_lm_valid,
     inv) = _lba_window_select(st, center_kf, P_opt, L_loc)

    obs_valid = st.obs_lm >= 0
    obs_safe = torch.where(obs_valid, st.obs_lm, torch.zeros_like(st.obs_lm))
    sees_local = obs_valid & (inv[obs_safe.long()] >= 0)
    observer_cnt = torch.sum(sees_local, dim=1).to(torch.int32)
    kf_sel = sless.id_mask(opt_idx, opt_real, K)
    observer_cnt = torch.where(st.kf_mask & ~kf_sel, observer_cnt,
                               torch.zeros_like(observer_cnt))
    fix_idx = torch.argsort(-observer_cnt, stable=True)[:P_fix]
    fix_real = observer_cnt[fix_idx] > 0

    all_idx = torch.cat([opt_idx, fix_idx])
    all_real = torch.cat([opt_real, fix_real])
    P = P_opt + P_fix
    # gauge: out-of-window observers are fixed; the map origin (smallest
    # occupied slot) is pinned when inside the window; with no real
    # external anchor the two oldest window slots are pinned (6 DoF + scale)
    big = torch.full_like(opt_idx, K + 1)
    oldest_key = torch.where(opt_real, opt_idx, big)
    oldest_pos = torch.argmin(oldest_key)
    origin_kf = torch.argmax(st.kf_mask.to(torch.int8))
    origin_in_win = opt_real & (opt_idx == origin_kf)
    no_anchor = torch.sum(fix_real.to(torch.int32)) == 0
    pose_fixed = torch.cat([origin_in_win,
                            torch.ones(P_fix, dtype=torch.bool, device=dev)])
    pose_fixed = mstate._set(pose_fixed, oldest_pos,
                             sless.row(pose_fixed, oldest_pos) | no_anchor)
    second_key = mstate._set(oldest_key, oldest_pos, K + 1)
    second_pos = torch.argmin(second_key)
    pose_fixed = mstate._set(pose_fixed, second_pos,
                             sless.row(pose_fixed, second_pos) | no_anchor)

    okf = torch.arange(P, device=dev).repeat_interleave(N)
    row_lm = st.obs_lm[all_idx].reshape(-1)
    row_xy = st.kf_kp[all_idx].reshape(-1, 2)
    row_valid = ((row_lm >= 0) & st.kf_kp_mask[all_idx].reshape(-1) &
                 all_real.repeat_interleave(N))
    row_loc = inv[torch.clamp(row_lm, min=0).long()]
    row_valid = row_valid & (row_loc >= 0)
    row_info = 1.2 ** (-2.0 * st.kf_octave[all_idx].reshape(-1)
                       .to(torch.float32))

    res = ba_ops.ba_solve(
        st.kf_R[all_idx], st.kf_t[all_idx], pose_fixed | ~all_real,
        st.lm_pos[loc_lm], loc_lm_valid, cam, okf,
        torch.where(row_valid, row_loc, torch.zeros_like(row_loc)), row_xy,
        row_valid, obs_info=row_info, iters=iters)

    # write back (safe_idx routes non-updated rows to slot K-1 with its own
    # value, last-wins as in the reference's scatter)
    upd = all_real & ~pose_fixed
    safe_idx = torch.where(upd, all_idx, torch.full_like(all_idx, K - 1))
    new_R = sless.set_rows(st.kf_R, safe_idx,
                           torch.where(upd[:, None, None], res.R,
                                       st.kf_R[safe_idx]))
    new_t = sless.set_rows(st.kf_t, safe_idx,
                           torch.where(upd[:, None], res.t,
                                       st.kf_t[safe_idx]))
    inv_l = torch.clamp(inv, min=0).long()
    upd_lm = (inv >= 0) & loc_lm_valid[inv_l]
    new_lm = torch.where(upd_lm[:, None], res.lm_pos[inv_l], st.lm_pos)
    out_rows = (row_valid & ~res.obs_inlier).reshape(P, N)
    obs_upd = sless.set_rows(st.obs_lm, all_idx,
                             torch.where(out_rows,
                                         torch.full_like(out_rows, -1,
                                                         dtype=torch.int32),
                                         st.obs_lm[all_idx]))
    return dataclasses.replace(st, kf_R=new_R, kf_t=new_t, lm_pos=new_lm,
                               obs_lm=obs_upd)


def inertial_gate(st: mstate.MapState, k, killed, nd_window: int = 21):
    """Temporal-chain guards of one culling candidate k (0-d slot tensor)
    given the kills so far (reference KeyFrameCulling's inertial branch,
    src/LocalMapping.cc:1012-1045): the map holds more than nd_window
    keyframes, k is not one of the two newest, both temporal neighbors
    exist, and the gap t_next - t_prev they would leave is below 3 s with
    the IMU initialized and k older than the nd_window newest, or below
    0.5 s, or (before VIBA2) k sits within 2 cm of its predecessor with a
    gap below 3 s. Returns a 0-d bool."""
    K = st.caps.K
    arangeK = torch.arange(K, device=st.kf_time.device)
    alive = st.kf_mask & ~killed
    t_all = st.kf_time
    t_k = sless.row(t_all, k)
    others = alive & (arangeK != k)
    inf = torch.full_like(t_all, float("inf"))
    prev_key = torch.where(others & (t_all < t_k), t_all, -inf)
    next_key = torch.where(others & (t_all > t_k), t_all, inf)
    t_prev = torch.max(prev_key)
    t_next = torch.min(next_key)
    has_chain = torch.isfinite(t_prev) & torch.isfinite(t_next)
    tgap = t_next - t_prev
    sorted_t = -torch.sort(torch.where(alive, -t_all, inf)).values
    not_newest2 = t_k < sorted_t[min(1, K - 1)]
    older_than_window = t_k < sorted_t[min(nd_window, K - 1)]
    ok_t = ((st.imu_initialized & older_than_window & (tgap < 3.0)) |
            (tgap < 0.5))
    prev_slot = torch.argmax(prev_key)
    C_k = -torch.einsum('ji,j->i', sless.row(st.kf_R, k),
                        sless.row(st.kf_t, k))
    C_p = -torch.einsum('ji,j->i', sless.row(st.kf_R, prev_slot),
                        sless.row(st.kf_t, prev_slot))
    ok_d = (~st.imu_ba2 & (torch.linalg.norm(C_k - C_p) < 0.02) &
            (tgap < 3.0))
    n_alive = torch.sum(alive.to(torch.int32))
    return (n_alive > nd_window) & not_newest2 & has_chain & (ok_t | ok_d)


def cull_redundant_keyframes(st: mstate.MapState, center_kf,
                             n_check: int = 10, redundancy: float = 0.9,
                             max_kills: int = 2, inertial: bool = False,
                             close_only: bool = False,
                             close_depth: float = 3.0, nd_window: int = 21):
    """Remove up to max_kills covisible neighbors of center_kf whose
    landmarks are >= `redundancy` observed by >= 3 other keyframes, scored
    sequentially (earlier kills' observations discounted) and applied in
    one update (reference: LocalMapping::KeyFrameCulling). close_only counts
    only close points (measured depth in (0, close_depth)) toward the
    fraction, the stereo / RGB-D policy; `inertial` adds the temporal-chain
    guards of inertial_gate to every kill (the preintegration windows
    merge across a culled keyframe in the System)."""
    K, L = st.caps.K, st.caps.L
    dev = st.kf_R.device
    neigh, w = mstate.best_covisible(st, center_kf, n_check)
    obs_valid = st.obs_lm >= 0
    obs_safe = torch.where(obs_valid, st.obs_lm,
                           torch.zeros_like(st.obs_lm)).long()
    origin = torch.argmax(st.kf_mask.to(torch.int8))
    arangeK = torch.arange(K, device=dev)

    count_valid = obs_valid
    if close_only:
        d = st.kf_depth
        count_valid = obs_valid & torch.isfinite(d) & (d > 0) & \
            (d < close_depth)
    row_valid = count_valid[neigh]                              # [nc,N]
    lm = obs_safe[neigh]
    n_total = torch.sum(row_valid.to(torch.int32), dim=1)
    protected = (neigh == center_kf) | (neigh == origin) | (n_total < 30)
    base_ok = st.kf_mask[neigh] & ~protected & (w[0] >= 0)

    adj = torch.zeros(L, dtype=torch.int32, device=dev)
    killed = torch.zeros(K, dtype=torch.bool, device=dev)
    kills, kflags = [], []
    for _ in range(max_kills):
        n_obs = st.lm_n_obs[lm] - adj[lm]
        redundant = row_valid & (n_obs >= 4)
        frac = torch.sum(redundant.to(torch.int32), dim=1).to(torch.float32) \
            / torch.clamp(n_total, min=1)
        alive = base_ok & ~killed[neigh]
        fracs = torch.where(alive, frac, torch.full_like(frac, -1.0))
        i = torch.argmax(fracs)
        k_i = sless.row(neigh, i)
        kill = sless.row(fracs, i) >= redundancy
        if inertial:
            kill = kill & inertial_gate(st, k_i, killed, nd_window)
        adj = adj + sless.id_count(sless.row(obs_safe, k_i),
                                   sless.row(obs_valid, k_i) & kill, L)
        killed = killed | (kill & (arangeK == k_i))
        kills.append(k_i)
        kflags.append(kill)

    n_words = st.lm_obs_bits.shape[1]
    words = mstate._kf_bit_words(torch.stack(kills), n_words)
    clear = torch.zeros_like(words[0])
    parents = st.spanning_parent
    for i in range(max_kills):
        clear = clear | torch.where(kflags[i], words[i],
                                    torch.zeros_like(words[i]))
    for i in range(max_kills):
        p_of_k = sless.row(parents, kills[i])
        parents = torch.where(kflags[i] & (parents == kills[i]), p_of_k,
                              parents)
        parents = torch.where(kflags[i] & (arangeK == kills[i]),
                              torch.full_like(parents, -1), parents)
    return dataclasses.replace(
        st,
        kf_mask=st.kf_mask & ~killed,
        obs_lm=torch.where(killed[:, None], torch.full_like(st.obs_lm, -1),
                           st.obs_lm),
        lm_n_obs=st.lm_n_obs - adj,
        lm_obs_bits=st.lm_obs_bits & ~clear[None, :],
        covis=torch.where(killed[:, None] | killed[None, :],
                          torch.zeros_like(st.covis), st.covis),
        spanning_parent=parents)


def cull_bad_landmarks(st: mstate.MapState, current_kf_counter,
                       min_found_ratio: float = 0.25):
    """Remove recent landmarks (created <= 3 keyframes ago, not init-map)
    with found/visible < 0.25 or < 2 observations after 2 keyframes
    (reference: LocalMapping::MapPointCulling)."""
    ratio = st.lm_found.to(torch.float32) / torch.clamp(
        st.lm_visible.to(torch.float32), min=1.0)
    age = current_kf_counter - st.lm_first_kf
    recent = (age <= 3) & (st.lm_first_kf > 0)
    kill = st.lm_mask & recent & ((ratio < min_found_ratio) |
                                  ((age >= 2) & (st.lm_n_obs < 2)))
    return mstate.cull_landmarks(st, kill)


def keyframe_step(st: mstate.MapState, cam, feat_xy, feat_valid, feat_desc,
                  feat_depth, bind, R, t, time, frame_id,
                  use_depth: bool = False, do_ba: bool = True,
                  do_aux: bool = True, max_depth: float = 40.0,
                  n_neighbors: int = 5, feat_octave=None, chain=None,
                  ba_iters: int = 5, cull_redundancy: float = 0.9,
                  cull_inertial: bool = False,
                  cull_max_kills: int = 2, cull_close_only: bool = False,
                  cull_close_depth: float = 3.0, fuse_two_hop: int = 0,
                  matcher=None):
    """Insert a keyframe and run the mapping pipeline: landmarks from depth
    (use_depth: stereo and RGB-D), triangulated landmarks, fuse, local BA,
    culling. Returns
    (st, kf_slot, n_tracked, chain') where chain' re-anchors the tracker's
    pose chain (R_cur, t_cur, R_last, t_last) onto the BA-refined keyframe
    pose: (R_cur', t_cur', R_last', t_last', corr_R, corr_t), its
    rotations projected onto SO(3) (the JAX package's keyframe_step returns
    them as the products give them)."""
    N = feat_xy.shape[0]
    octave = (feat_octave if feat_octave is not None else
              torch.zeros((N,), dtype=torch.int8, device=feat_xy.device))
    st, k = mstate.insert_keyframe(st, R, t, time, frame_id, feat_xy,
                                   feat_valid, feat_desc, feat_depth, octave,
                                   bind)
    if use_depth:
        st = create_depth_landmarks(st, cam, k, max_depth=max_depth)
    st = create_new_landmarks(st, cam, k, n_neighbors=n_neighbors,
                              matcher=matcher)
    if do_aux:
        st = fuse_into_neighbors(st, cam, k, n_neighbors=n_neighbors,
                                 n_neighbors2=fuse_two_hop)
    if do_ba:
        st = local_bundle_adjustment(st, cam, k, iters=ba_iters)
    if do_aux:
        st = cull_bad_landmarks(st, st.next_kf_counter)
        st = cull_redundant_keyframes(st, k, redundancy=cull_redundancy,
                                      max_kills=cull_max_kills,
                                      inertial=cull_inertial,
                                      close_only=cull_close_only,
                                      close_depth=cull_close_depth)
    chain_out = None
    if chain is not None:
        R_cur, t_cur, R_last, t_last = chain
        # corr and the chain are projected onto SO(3). Unprojected, a
        # pipelined run's next keyframe pose (a pending frame's, which corr
        # moved: tracking.apply_chain_correction) carries corr's error, and
        # R^T standing in for R^-1 doubles it in that keyframe's corr:
        # about threefold a keyframe, until an inertial run's marginalized
        # prior turns non-finite
        cR, ct = lie.se3_mul(*lie.se3_inv(R, t), sless.row(st.kf_R, k),
                             sless.row(st.kf_t, k))
        cR = lie.orthonormalize(cR)
        R_c, t_c = lie.se3_mul(R_cur, t_cur, cR, ct)
        R_l, t_l = lie.se3_mul(R_last, t_last, cR, ct)
        chain_out = (lie.orthonormalize(R_c), t_c, lie.orthonormalize(R_l),
                     t_l, cR, ct)
    return st, k, torch.sum((bind >= 0).to(torch.int32)), chain_out
