"""Loop closing and relocalization (counterpart of
dani_slam_tpu/slam/loopclosing.py; reference src/LoopClosing.cc and
Tracking::Relocalization).

Place recognition is the dense BoW database of models/vocab.py. A loop
candidate is verified by one device computation per candidate (landmark
descriptor matching -> batched Horn Sim3 RANSAC -> Gauss-Newton
refinement); the correction transforms every keyframe and landmark with
per-node corrections from the dense Sim3 essential graph (ops/posegraph),
then fuses duplicates and runs global BA (ops/ba_large). Both the correction
and the global BA are time-sliced: bounded chunks run over a snapshot at the
following keyframes and the result is welded back into the live map through
the spanning tree and each landmark's reference keyframe — the single-device
form of the reference's LoopClosing and GBA threads. Three points depart
from the JAX package on purpose: the sliced correction's last chunk is cut
so that the pose graph runs pg_iters iterations, as correct_loop does (the
JAX package runs whole chunks: 12 for 10); a sliced loop is counted, and
its cooldown starts, when its weld lands with both loop ends still holding
their keyframes; and when a correction and its GBA weld at one call
(finish_gba), the tracker receives both corrections composed, not the
last one alone.

Relocalization matches the lost frame against a BoW candidate's landmarks
(mutual-NN or LightGlue), solves PnP RANSAC, and refines with two
projected-window searches through the window-match kernel
(matching.search_by_projection_bind, radius 10 px then 3 px).

Translation notes: keyframe slots are Python ints where the host knows them
and 0-d device tensors where it does not (the keyframe step's slot, the
relocalization candidates); a 0-d tensor is never used as a plain index,
which would read it back to the host (core/scatterless.row). The loop
closer's host decisions read the device only through utils/device.pull
(blocking) and AsyncRead (started at one keyframe, read at the next), so
SYNCS / ASYNC count them. RANSAC draws come from explicit torch.Generators
(ops/pnp.draw_samples).
"""
from __future__ import annotations

import dataclasses

import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.core import lie
from dani_slam_tpu_torch.core import scatterless as sless
from dani_slam_tpu_torch.core import state as mstate
from dani_slam_tpu_torch.models import vocab
from dani_slam_tpu_torch.ops import ba_large, matching, pnp, posegraph
from dani_slam_tpu_torch.ops import sim3 as sim3_ops
from dani_slam_tpu_torch.ops import solvers
from dani_slam_tpu_torch.utils import verbose
from dani_slam_tpu_torch.utils.device import AsyncRead, pull

_INT32_MAX = 2 ** 31 - 1


def _at(t: torch.Tensor, k):
    """t[k] for a host int or a 0-d device tensor k (no host read)."""
    if isinstance(k, torch.Tensor):
        return sless.row(t, k)
    return t[int(k)]


def _slot(k, device) -> torch.Tensor:
    """A 0-d int64 device tensor of slot k: a fill kernel with the value as
    its argument, no copy from host memory."""
    if isinstance(k, torch.Tensor):
        return k.reshape(()).long()
    return torch.full((), int(k), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# Loop candidate verification
# ---------------------------------------------------------------------------

def match_kf_landmarks(st: mstate.MapState, kf_a, kf_b, th: float = 0.7):
    """Mutual-NN match between the landmark descriptors bound in two
    keyframes. Returns (camera-frame points of a, of b, ok, keypoints of a,
    matched keypoints of b, landmark ids of a, matched landmark ids of b)."""
    obs_a, obs_b = _at(st.obs_lm, kf_a), _at(st.obs_lm, kf_b)
    has_a = (obs_a >= 0) & _at(st.kf_kp_mask, kf_a)
    has_b = (obs_b >= 0) & _at(st.kf_kp_mask, kf_b)
    la = torch.where(has_a, obs_a, torch.zeros_like(obs_a)).long()
    lb = torch.where(has_b, obs_b, torch.zeros_like(obs_b)).long()
    d = matching.desc_distance_matrix(st.lm_desc[la], st.lm_desc[lb])
    m = matching.masked_match(d, has_a[:, None] & has_b[None, :], th=th,
                              mutual=True)
    pa = lie.se3_apply(_at(st.kf_R, kf_a), _at(st.kf_t, kf_a), st.lm_pos[la])
    pb_ids = lb[m.idx]
    pb = lie.se3_apply(_at(st.kf_R, kf_b), _at(st.kf_t, kf_b),
                       st.lm_pos[pb_ids])
    return (pa, pb, m.ok, _at(st.kf_kp, kf_a), _at(st.kf_kp, kf_b)[m.idx],
            la, pb_ids)


def _window_landmarks(st: mstate.MapState, kf, cam, n_window: int):
    """Landmarks observed by kf and its top covisible neighbors (the weld
    window), each landmark once (its first row). Returns (lm_ids [W*N],
    points in kf's camera frame, their pixels, valid)."""
    K, L = st.caps.K, st.caps.L
    dev = st.covis.device
    ar = torch.arange(K, device=dev)
    cov = torch.where(st.kf_mask, _at(st.covis, kf),
                      torch.full_like(st.covis[0], -1))
    cov = torch.where(ar == kf, torch.full_like(cov, _INT32_MAX), cov)
    order = torch.argsort(-cov, stable=True)[:n_window]
    ok_kf = cov[order] > 0
    obs = st.obs_lm[order]                                    # [W,N]
    has = (obs >= 0) & st.kf_kp_mask[order] & ok_kf[:, None]
    lm = torch.where(has, obs, torch.full_like(obs, -1)).reshape(-1)
    has = has.reshape(-1) & st.lm_mask[torch.clamp(lm, min=0).long()]
    # first-occurrence mask: stable sort by id, keep the first of each run
    keys = torch.where(has, lm, torch.full_like(lm, L))
    order2 = torch.argsort(keys, stable=True)
    ks = keys[order2]
    first_sorted = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                              ks[1:] != ks[:-1]])
    first = torch.empty_like(first_sorted).scatter_(0, order2, first_sorted)
    has = has & first
    lid = torch.where(has, lm, torch.zeros_like(lm)).long()
    p_c = lie.se3_apply(_at(st.kf_R, kf), _at(st.kf_t, kf), st.lm_pos[lid])
    px = _cam.project(cam, p_c)
    in_img = ((p_c[:, 2] > 0.2) & (px[:, 0] >= 0) & (px[:, 1] >= 0) &
              (px[:, 0] < cam.width) & (px[:, 1] < cam.height))
    return lid, p_c, px, has & in_img


def verify_cross_map_candidate(st_a: mstate.MapState, st_b: mstate.MapState,
                               cam, kf_a, kf_b, key, fix_scale: bool = False,
                               min_inliers: int = 25, n_window: int = 4):
    """Geometric verification between keyframes of two different maps, the
    matches widened over both anchors' covisible windows. Returns (T_ab =
    (R, t, s) from b-camera to a-camera coordinates, n_inliers, ok)."""
    la, pa, pxa, has_a = _window_landmarks(st_a, kf_a, cam, n_window)
    lb, pb_all, pxb, has_b = _window_landmarks(st_b, kf_b, cam, n_window)
    d = matching.desc_distance_matrix(st_a.lm_desc[la], st_b.lm_desc[lb])
    m = matching.masked_match(d, has_a[:, None] & has_b[None, :], th=0.7,
                              mutual=True)
    pb = pb_all[m.idx]
    res = sim3_ops.sim3_ransac(key, cam, cam, pa, pb, m.ok,
                               fix_scale=fix_scale, min_inliers=min_inliers)
    R, t, s, _, n = sim3_ops.optimize_sim3(
        cam, cam, res.R, res.t, res.s, pa, pxa, pb, pxb[m.idx],
        m.ok & res.inliers, fix_scale=fix_scale)
    return (R, t, s), n, res.ok & (n >= min_inliers)


def refine_loop_from_hypothesis(st: mstate.MapState, cam, kf_new, kf_cand,
                                T12, fix_scale: bool = False,
                                min_inliers: int = 20, n_window: int = 4,
                                radius: float = 8.0):
    """Projection-guided re-verification of a loop hypothesis at a newer
    keyframe: the candidate window's landmarks go through T12 (candidate
    camera -> kf_new camera) into kf_new, are window-matched, and the Sim3
    is re-optimized on pairs whose kf_new keypoint is bound to a landmark.
    Returns (T12', n, ok)."""
    lb, pb, _, has_b = _window_landmarks(st, kf_cand, cam, n_window)
    R12, t12, s12 = T12
    p_new = lie.sim3_apply(R12, t12, s12, pb)
    px_new = _cam.project(cam, p_new)
    vis = (has_b & (p_new[:, 2] > 0.2) & (px_new[:, 0] >= 0) &
           (px_new[:, 1] >= 0) & (px_new[:, 0] < cam.width) &
           (px_new[:, 1] < cam.height))
    m = matching.search_by_projection(
        px_new, vis, st.lm_desc[lb], _at(st.kf_kp, kf_new),
        _at(st.kf_kp_mask, kf_new), _at(st.kf_desc, kf_new), radius=radius)
    obs_new = _at(st.obs_lm, kf_new)[m.idx]
    la = torch.where(m.ok, obs_new, torch.zeros_like(obs_new)).long()
    pair_ok = m.ok & (obs_new >= 0) & st.lm_mask[la]
    pa = lie.se3_apply(_at(st.kf_R, kf_new), _at(st.kf_t, kf_new),
                       st.lm_pos[la])
    pxa = _at(st.kf_kp, kf_new)[m.idx]
    pxb = _cam.project(cam, pb)
    R, t, s, _, n = sim3_ops.optimize_sim3(
        cam, cam, R12, t12, s12, pa, pxa, pb, pxb, pair_ok,
        fix_scale=fix_scale)
    return (R, t, s), n, n >= min_inliers


def propagate_hypothesis(st: mstate.MapState, kf_new, kf_prev, T12):
    """Carry a loop hypothesis through odometry:
    T_{new<-cand} = T_new_w o T_prev_w^-1 o T_{prev<-cand}."""
    one = torch.ones((), device=st.kf_R.device)
    Rr, tr, sr = lie.sim3_mul(_at(st.kf_R, kf_new), _at(st.kf_t, kf_new), one,
                              *lie.sim3_inv(_at(st.kf_R, kf_prev),
                                            _at(st.kf_t, kf_prev), one))
    return lie.sim3_mul(Rr, tr, sr, *T12)


def verify_loop_candidate(st: mstate.MapState, cam, kf_cur, kf_cand, key,
                          fix_scale: bool = False, min_inliers: int = 20):
    """Full geometric verification of one loop candidate. Returns (T12 =
    (R, t, s) candidate camera -> current camera, n_inliers, ok)."""
    pa, pb, ok, kpa, kpb, _, _ = match_kf_landmarks(st, kf_cur, kf_cand)
    res = sim3_ops.sim3_ransac(key, cam, cam, pa, pb, ok,
                               fix_scale=fix_scale, min_inliers=min_inliers)
    R, t, s, _, n = sim3_ops.optimize_sim3(
        cam, cam, res.R, res.t, res.s, pa, kpa, pb, kpb, ok & res.inliers,
        fix_scale=fix_scale)
    return (R, t, s), n, res.ok & (n >= min_inliers)


# ---------------------------------------------------------------------------
# Loop correction
# ---------------------------------------------------------------------------

def _pair(K: int, i, j, device) -> torch.Tensor:
    """bool [K, K], True at (i, j) only (i, j host ints or 0-d tensors)."""
    ar = torch.arange(K, device=device)
    return (ar == i)[:, None] & (ar == j)[None, :]


def loop_pg_chunk(st: mstate.MapState, kf_cur, kf_cand, T12, carry,
                  iters: int = 3, fix_scale: bool = False,
                  four_dof: bool = False):
    """`iters` Gauss-Newton iterations of the loop essential graph over the
    snapshot `st`, from carry (R [K,3,3], t [K,3], s [K]). Edges and
    relative measurements are rebuilt from the snapshot's pre-correction
    poses at each call, so chunks compose like one long solve; the loop
    edge carries T12 and the candidate is the gauge anchor."""
    K = st.caps.K
    dev = st.kf_R.device
    R12, t12, s12 = T12
    R_all, t_all = st.kf_R, st.kf_t
    s_all = torch.ones((K,), device=dev)
    R_c, t_c, s_c = carry
    cur_cand = _pair(K, kf_cur, kf_cand, dev)
    cand_cur = _pair(K, kf_cand, kf_cur, dev)
    edges = posegraph.build_essential_edges(
        st.covis, st.spanning_parent, st.loop_edges | cur_cand, st.kf_mask,
        covis_th=30)
    fixed = torch.arange(K, device=dev) == kf_cand

    def put(x, mask, v):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
        return torch.where(m, v, x)

    if four_dof:
        # Edge4DoF convention: dR = Ri Rj^T, dt = origin of cam j in cam i
        Rm = torch.einsum('iab,jcb->ijac', R_all, R_all)
        Cj_in_i = (-torch.einsum('ijab,jb->ija', Rm, t_all) +
                   t_all[:, None, :])
        Ri12, ti12, _ = lie.sim3_inv(R12, t12, torch.ones((), device=dev))
        Rm = put(put(Rm, cur_cand, R12), cand_cur, Ri12)
        Cj_in_i = put(put(Cj_in_i, cur_cand, t12), cand_cur, ti12)
        R_new, t_new = posegraph.optimize_essential_graph_4dof(
            R_c, t_c, edges, Rm, Cj_in_i, fixed, st.kf_mask, iters=iters)
        return R_new, t_new, torch.ones((K,), device=dev)
    Rm, tm, sm = posegraph.relative_sim3(
        R_all[:, None], t_all[:, None], s_all[:, None], R_all[None],
        t_all[None], s_all[None])
    Ri12, ti12, si12 = lie.sim3_inv(R12, t12, s12)
    Rm = put(put(Rm, cur_cand, R12), cand_cur, Ri12)
    tm = put(put(tm, cur_cand, t12), cand_cur, ti12)
    sm = put(put(sm, cur_cand, s12), cand_cur, si12)
    return posegraph.optimize_essential_graph(
        R_c, t_c, s_c, edges, Rm, tm, sm, fixed, st.kf_mask, iters=iters,
        fix_scale=fix_scale)


def loop_correction_apply(st: mstate.MapState, carry):
    """A finished pose-graph iterate -> the corrected snapshot arrays:
    landmarks through their reference keyframe's Sim3 correction
    (X' = S_k'^-1 (T_k X)), poses T_k = [R_k, t_k / s_k], distance bands
    scaled by 1 / s of the reference keyframe. Returns (R, t, lm_pos,
    dist_min, dist_max)."""
    K = st.caps.K
    R_new, t_new, s_new = carry
    ref = torch.clamp(st.lm_ref_kf, 0, K - 1).long()
    Xc = torch.einsum('lij,lj->li', st.kf_R[ref], st.lm_pos) + st.kf_t[ref]
    X_new = lie.sim3_apply(*lie.sim3_inv(R_new[ref], t_new[ref], s_new[ref]),
                           Xc)
    lm_pos = torch.where(st.lm_mask[:, None], X_new, st.lm_pos)
    R_out = lie.orthonormalize(R_new)
    t_out = t_new / torch.clamp(s_new[:, None], min=1e-9)
    inv_s = 1.0 / torch.clamp(s_new[ref], min=1e-9)
    dist_min = torch.where(st.lm_mask, st.lm_dist_min * inv_s,
                           st.lm_dist_min)
    dist_max = torch.where(st.lm_mask, st.lm_dist_max * inv_s,
                           st.lm_dist_max)
    return R_out, t_out, lm_pos, dist_min, dist_max


def correct_loop(st: mstate.MapState, cam, kf_cur, kf_cand, T12,
                 pg_iters: int = 10, fix_scale: bool = False,
                 four_dof: bool = False):
    """Apply a verified loop closure synchronously: essential graph with the
    loop edge (loop_pg_chunk, pg_iters iterations), then the write-back
    (loop_correction_apply) — the composition the time-sliced path
    reproduces when no keyframe interleaves."""
    K = st.caps.K
    carry = (st.kf_R, st.kf_t, torch.ones((K,), device=st.kf_R.device))
    carry = loop_pg_chunk(st, kf_cur, kf_cand, T12, carry, iters=pg_iters,
                          fix_scale=fix_scale, four_dof=four_dof)
    R_out, t_out, lm_pos, dmin, dmax = loop_correction_apply(st, carry)
    return dataclasses.replace(
        st, kf_R=R_out, kf_t=t_out, lm_pos=lm_pos, lm_dist_min=dmin,
        lm_dist_max=dmax,
        loop_edges=st.loop_edges | _pair(K, kf_cur, kf_cand,
                                         st.kf_R.device))


def search_and_fuse(st: mstate.MapState, cam, kf_cur, kf_cand,
                    n_neighbors: int = 4, radius: float = 4.0):
    """After a correction: project the current keyframe's landmarks into the
    candidate and its best covisible keyframes and merge duplicates (the
    better-observed twin is kept), or add the observation where the matched
    keypoint is free (reference SearchAndFuse + MapPoint::Replace)."""
    dev = st.kf_R.device
    obs_cur = _at(st.obs_lm, kf_cur)
    has_cur = (obs_cur >= 0) & _at(st.kf_kp_mask, kf_cur)
    lm_ids = torch.where(has_cur, obs_cur, torch.zeros_like(obs_cur))
    li = lm_ids.long()
    cand = _slot(kf_cand, dev)
    neigh, w = mstate.best_covisible(st, cand, n_neighbors - 1)
    targets = torch.cat([cand[None], neigh])
    target_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           w > 0])
    for i in range(n_neighbors):
        kc = targets[i]
        ok_i = target_ok[i] & sless.row(st.kf_mask, kc)
        xy, vis, _, _ = matching.project_landmarks(
            sless.row(st.kf_R, kc), sless.row(st.kf_t, kc), cam,
            st.lm_pos[li], has_cur & ok_i & st.lm_mask[li])
        m = matching.fuse_candidates(
            xy, vis, st.lm_desc[li], sless.row(st.kf_kp, kc),
            sless.row(st.kf_kp_mask, kc), sless.row(st.kf_desc, kc),
            radius=radius)
        tgt_lm = sless.row(st.obs_lm, kc)[m.idx]
        bound = (tgt_lm >= 0) & (tgt_lm != lm_ids) & m.ok
        free = (tgt_lm < 0) & m.ok
        n_cur = st.lm_n_obs[li]
        n_tgt = torch.where(bound, st.lm_n_obs[torch.clamp(tgt_lm,
                                                           min=0).long()],
                            torch.zeros_like(n_cur))
        keep = torch.where(n_cur >= n_tgt, lm_ids, tgt_lm)
        kill = torch.where(n_cur >= n_tgt, tgt_lm, lm_ids)
        st = mstate.replace_landmarks(st, torch.clamp(kill, min=0),
                                      torch.clamp(keep, min=0), bound)
        st = mstate.add_observations(st, kc, m.idx, lm_ids, free)
    return st


def _gba_problem(st_snap: mstate.MapState):
    """Observation problem of global BA: gauge anchors (the first live
    keyframe and its strongest covisible partner — pinning the second
    keeps the scale gauge explicit) and the keyframe-major observation
    list. Ties resolve to the first index, as argmax does in both
    libraries."""
    K, N = st_snap.obs_lm.shape
    dev = st_snap.obs_lm.device
    ar = torch.arange(K, device=dev)
    first = torch.argmax(st_snap.kf_mask.to(torch.int8))
    cov_row = torch.where(st_snap.kf_mask & (ar != first),
                          sless.row(st_snap.covis, first),
                          torch.full_like(st_snap.covis[0], -1))
    second = torch.argmax(cov_row)
    pose_fixed = ((~st_snap.kf_mask) | (ar == first) |
                  ((ar == second) & (sless.row(cov_row, second) > 0)))
    okf = torch.arange(K, device=dev).repeat_interleave(N)
    olm = st_snap.obs_lm.reshape(-1)
    oxy = st_snap.kf_kp.reshape(-1, 2)
    ovalid = (olm >= 0) & st_snap.kf_kp_mask.reshape(-1)
    obs_info = torch.pow(1.2, -2.0 * st_snap.kf_octave.reshape(-1).to(
        torch.float32))
    return (pose_fixed, okf, torch.where(ovalid, olm, torch.zeros_like(olm)),
            oxy, ovalid, obs_info)


def global_bundle_adjustment(st: mstate.MapState, cam, iters: int = 10):
    """Whole-map BA (reference RunGlobalBundleAdjustment, 10 iterations) with
    the Schur-free PCG solver."""
    pose_fixed, okf, olm, oxy, ovalid, obs_info = _gba_problem(st)
    res = ba_large.ba_solve_pcg(st.kf_R, st.kf_t, pose_fixed, st.lm_pos,
                                st.lm_mask, cam, okf, olm, oxy, ovalid,
                                obs_info=obs_info, iters=iters)
    return dataclasses.replace(
        st, kf_R=torch.where(st.kf_mask[:, None, None], res.R, st.kf_R),
        kf_t=torch.where(st.kf_mask[:, None], res.t, st.kf_t),
        lm_pos=torch.where(st.lm_mask[:, None], res.lm_pos, st.lm_pos))


def gba_chunk(st_snap: mstate.MapState, cam, carry, iters: int = 2):
    """`iters` LM iterations of global BA over the snapshot from carry (R,
    t, lm, lam): one slice of the time-sliced GBA."""
    pose_fixed, okf, olm, oxy, ovalid, obs_info = _gba_problem(st_snap)
    return ba_large.ba_pcg_chunk(carry, pose_fixed, st_snap.lm_mask, cam,
                                 okf, olm, oxy, ovalid, obs_info=obs_info,
                                 iters=iters)


def apply_gba(st: mstate.MapState, snap_kf_mask, snap_kf_fid, snap_lm_mask,
              snap_lm_first, R_gba, t_gba, lm_gba, chain_ref):
    """Weld a finished time-sliced GBA into the live map: keyframes that
    took part (same slot, same frame id) take their GBA poses, keyframes
    made since follow their spanning-tree parent (8 passes), landmarks take
    their GBA positions or, if new, move with their reference keyframe.
    Returns (st', corr_R, corr_t) with the correction old^-1 o new of
    `chain_ref` for the tracker's pose chain."""
    K = st.caps.K
    part = snap_kf_mask & st.kf_mask & (st.kf_frame_id == snap_kf_fid)
    R_new = torch.where(part[:, None, None], R_gba, st.kf_R)
    t_new = torch.where(part[:, None], t_gba, st.kf_t)
    corrected = part
    par = torch.clamp(st.spanning_parent, 0, K - 1).long()
    has_par = (st.spanning_parent >= 0) & st.kf_mask
    Rp_old, tp_old = st.kf_R[par], st.kf_t[par]
    Rrel = torch.einsum('kij,klj->kil', st.kf_R, Rp_old)        # R Rp^T
    trel = st.kf_t - torch.einsum('kij,kj->ki', Rrel, tp_old)
    for _ in range(8):
        fix = has_par & ~corrected & corrected[par]
        Rc = torch.einsum('kij,kjl->kil', Rrel, R_new[par])
        tc = torch.einsum('kij,kj->ki', Rrel, t_new[par]) + trel
        R_new = torch.where(fix[:, None, None], Rc, R_new)
        t_new = torch.where(fix[:, None], tc, t_new)
        corrected = corrected | fix
    lm_part = snap_lm_mask & st.lm_mask & (st.lm_first_kf == snap_lm_first)
    ref = torch.clamp(st.lm_ref_kf, 0, K - 1).long()
    ref_ok = st.lm_mask & ~lm_part & corrected[ref]
    Xc = torch.einsum('lij,lj->li', st.kf_R[ref], st.lm_pos) + st.kf_t[ref]
    Xw = torch.einsum('lji,lj->li', R_new[ref], Xc - t_new[ref])
    lm_new = torch.where(lm_part[:, None], lm_gba,
                         torch.where(ref_ok[:, None], Xw, st.lm_pos))
    cR, ct = lie.se3_mul(*lie.se3_inv(_at(st.kf_R, chain_ref),
                                      _at(st.kf_t, chain_ref)),
                         _at(R_new, chain_ref), _at(t_new, chain_ref))
    st2 = dataclasses.replace(st, kf_R=R_new, kf_t=t_new, lm_pos=lm_new)
    return st2, cR, ct


def apply_loop_weld(st: mstate.MapState, snap_kf_mask, snap_kf_fid,
                    snap_lm_mask, snap_lm_first, R_corr, t_corr, lm_corr,
                    dmin_corr, dmax_corr, kf_cur, kf_cand, cur_fid, cand_fid,
                    chain_ref):
    """Weld a finished time-sliced loop correction into the live map: the
    propagation of apply_gba, plus the corrected distance bands of the
    landmarks that took part and the loop edge (guarded by the frame ids of
    both ends, since culled slots are reused). Returns (st', corr_R,
    corr_t)."""
    st2, cR, ct = apply_gba(st, snap_kf_mask, snap_kf_fid, snap_lm_mask,
                            snap_lm_first, R_corr, t_corr, lm_corr,
                            chain_ref)
    lm_part = snap_lm_mask & st.lm_mask & (st.lm_first_kf == snap_lm_first)
    dmin = torch.where(lm_part, dmin_corr, st.lm_dist_min)
    dmax = torch.where(lm_part, dmax_corr, st.lm_dist_max)
    edge_ok = ((_at(st.kf_frame_id, kf_cur) == cur_fid) &
               (_at(st.kf_frame_id, kf_cand) == cand_fid))
    loop_edges = st.loop_edges | \
        (_pair(st.caps.K, kf_cur, kf_cand, st.kf_R.device) & edge_ok)
    return (dataclasses.replace(st2, lm_dist_min=dmin, lm_dist_max=dmax,
                                loop_edges=loop_edges), cR, ct)


# ---------------------------------------------------------------------------
# Relocalization (reference: Tracking::Relocalization)
# ---------------------------------------------------------------------------

def _reloc_refine(st: mstate.MapState, cam, kf, feat_xy, feat_desc,
                  feat_valid, R0, t0, bind0, pnp_ok):
    """Pose-optimize the PnP solution, widen the matches with a 10 px
    projected-window search over the candidate keyframe's landmarks (the
    window-match kernel), re-optimize, a 3 px search, optimize again; the
    final inlier count (>= max(5 % of N, 20)) gates acceptance. Returns
    (R, t, bind, n_good, ok)."""
    N = feat_xy.shape[0]
    obs = _at(st.obs_lm, kf)
    has = (obs >= 0) & _at(st.kf_kp_mask, kf)
    lm_ids = torch.where(has, obs, torch.zeros_like(obs))
    pts_all = st.lm_pos[lm_ids.long()]
    lm_desc = st.lm_desc[lm_ids.long()].contiguous()
    feat_xy = feat_xy.contiguous()
    feat_desc = feat_desc.contiguous()

    def opt(R, t, bind):
        has_b = bind >= 0
        pts = st.lm_pos[torch.where(has_b, bind,
                                    torch.zeros_like(bind)).long()]
        out = solvers.pose_optimize(R, t, cam, pts, feat_xy,
                                    has_b & feat_valid)
        return (out.R, out.t,
                torch.where(out.inliers, bind, torch.full_like(bind, -1)),
                out.n_inliers)

    def widen(R, t, bind, radius):
        pc = torch.einsum('ij,nj->ni', R, pts_all) + t
        xy = _cam.project(cam, pc)
        vis = has & (pc[:, 2] > 0.05)
        ci, _, cok = matching.search_by_projection_bind(
            xy, vis, lm_desc, feat_xy, feat_valid & (bind < 0), feat_desc,
            radius=radius)
        return torch.where(bind >= 0, bind,
                           torch.where(cok, lm_ids[ci].to(bind.dtype),
                                       torch.full_like(bind, -1)))

    R1, t1, bind1, _ = opt(R0, t0, bind0)
    R2, t2, bind2, _ = opt(R1, t1, widen(R1, t1, bind1, 10.0))
    R3, t3, bind3, n3 = opt(R2, t2, widen(R2, t2, bind2, 3.0))
    th_accept = max(int(0.05 * N), 20)
    return R3, t3, bind3, n3, pnp_ok & (n3 >= th_accept)


def _reloc_from_matches(st, cam, kf, feat_xy, feat_desc, feat_valid, key,
                        idx, ok, has, lm_ids):
    N = feat_xy.shape[0]
    res = pnp.pnp_ransac(key, cam, st.lm_pos[lm_ids.long()], feat_xy[idx],
                         ok & has, min_inliers=15)
    bind = sless.id_max(idx, ok & res.inliers, lm_ids, N, -1)
    return _reloc_refine(st, cam, kf, feat_xy, feat_desc, feat_valid,
                         res.R, res.t, bind, res.ok)


def relocalize_against_kf(st: mstate.MapState, cam, kf, feat_xy, feat_desc,
                          feat_valid, key):
    """Match the lost frame against one candidate keyframe's landmarks
    (mutual NN with ratio test), PnP RANSAC, then _reloc_refine. Returns
    (R, t, bindings, n_inliers, ok)."""
    obs = _at(st.obs_lm, kf)
    has = (obs >= 0) & _at(st.kf_kp_mask, kf)
    lm_ids = torch.where(has, obs, torch.zeros_like(obs))
    d = matching.desc_distance_matrix(st.lm_desc[lm_ids.long()], feat_desc)
    m = matching.masked_match(d, has[:, None] & feat_valid[None, :],
                              th=matching.TH_HIGH, ratio=0.9, mutual=True)
    m = matching.resolve_duplicate_targets(m, feat_xy.shape[0])
    return _reloc_from_matches(st, cam, kf, feat_xy, feat_desc, feat_valid,
                               key, m.idx, m.ok, has, lm_ids)


def relocalize_against_kf_lightglue(st: mstate.MapState, cam, kf, feat_xy,
                                    feat_desc, feat_valid, key, matcher):
    """relocalize_against_kf with the LightGlue matcher
    (models.lightglue.MatcherState) between the keyframe's keypoints and
    the frame's."""
    from dani_slam_tpu_torch.models import lightglue as lg
    obs = _at(st.obs_lm, kf)
    has = (obs >= 0) & _at(st.kf_kp_mask, kf)
    lm_ids = torch.where(has, obs, torch.zeros_like(obs))
    idx, _, ok = lg.match(matcher, _at(st.kf_kp, kf),
                          st.lm_desc[lm_ids.long()], has, feat_xy, feat_desc,
                          feat_valid)
    return _reloc_from_matches(st, cam, kf, feat_xy, feat_desc, feat_valid,
                               key, idx.long(), ok, has, lm_ids)


def inertial_loop_gate(st: mstate.MapState, kf: int, cand: int, T12,
                       ba2: bool = False, max_tilt: float = 0.008,
                       max_yaw: float = 0.349):
    """Gravity-consistency gate for loops on inertial maps: the implied
    world correction must not pitch or roll (< max_tilt) and its yaw stays
    below max_yaw; after the second inertial BA the correction is clamped
    to yaw only with scale 1 (the caller then takes the 4-DoF graph).
    Returns (T12', four_dof, good). One blocking read of the rotation."""
    one = torch.ones((), device=st.kf_R.device)
    Scw = lie.sim3_mul(*T12, st.kf_R[cand], st.kf_t[cand], one)
    Twc = lie.sim3_inv(st.kf_R[kf], st.kf_t[kf], one)
    Rww, tww, _ = lie.sim3_mul(*Twc, *Scw)
    phi = pull(lie.so3_log(Rww))
    if not (abs(phi[0]) < max_tilt and abs(phi[1]) < max_tilt and
            abs(phi[2]) < max_yaw):
        return T12, False, False
    if ba2:
        Rww_c = lie.so3_exp(torch.tensor([0.0, 0.0, float(phi[2])],
                                         device=one.device))
        Scw_c = lie.sim3_mul(st.kf_R[kf], st.kf_t[kf], one, Rww_c, tww, one)
        return (lie.sim3_mul(*Scw_c, *lie.sim3_inv(st.kf_R[cand],
                                                   st.kf_t[cand], one)),
                True, True)
    return T12, False, True


def _verify_stats_fresh(st: mstate.MapState, n, ok, cand, kfv):
    """A fresh verification's host-decision scalars in one tensor:
    [n_inliers, ok, frame_id(cand), frame_id(kfv)]."""
    return torch.stack([n.to(torch.int32), ok.to(torch.int32),
                        _at(st.kf_frame_id, cand).to(torch.int32),
                        _at(st.kf_frame_id, kfv).to(torch.int32)])


def _verify_stats_refine(st: mstate.MapState, n, ok, cand, kfv, kf_prev,
                         cand_fid, prev_fid):
    """Refine-pass stats with the slot-reuse guard folded in on the device:
    ok only if the hypothesis's candidate and chain keyframes still hold
    the frame ids recorded when it was stored."""
    g = ((_at(st.kf_frame_id, cand) == cand_fid) &
         (_at(st.kf_frame_id, kf_prev) == prev_fid))
    return torch.stack([n.to(torch.int32), (ok & g).to(torch.int32),
                        _at(st.kf_frame_id, cand).to(torch.int32),
                        _at(st.kf_frame_id, kfv).to(torch.int32)])


class LoopCloser:
    """Host orchestration of place recognition and loop closing, called by
    the System after each keyframe step. The BoW database lives on the
    device; `codebook` is a [V, D] tensor, None (the shipped vocabulary
    when its width is caps.D, else a random one trained on the map's own
    descriptors after train_codebook_after keyframes) or "live" (always the
    random, self-trained one)."""

    def __init__(self, cam, caps: mstate.MapCaps, codebook=None, seed=0,
                 min_kf_gap: int = 10, min_inliers: int = 25,
                 run_gba: bool = True, fix_scale: bool = False):
        self.cam = cam
        dev = cam.device
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        live = isinstance(codebook, str) and codebook == "live"
        if live:
            self.codebook = vocab.random_codebook(self.gen, 512, caps.D)
            codebook = None
        elif codebook is None:
            codebook = vocab.load_default_codebook(caps.D, device=dev)
            self.codebook = codebook if codebook is not None else \
                vocab.random_codebook(self.gen, 512, caps.D)
        else:
            self.codebook = codebook
        self.bow = torch.zeros((caps.K, self.codebook.shape[0]), device=dev)
        self._codebook_trained = codebook is not None and not live
        self.train_codebook_after = 8
        self.min_kf_gap = min_kf_gap
        self.min_inliers = min_inliers
        self.run_gba = run_gba
        self.fix_scale = fix_scale
        self.last_loop_kf = -10 ** 9
        self.n_loops = 0
        # False: only the BoW database is kept (relocalization's)
        self.detect_loops = True
        # a hypothesis must hold over this many consecutive keyframes
        self.consistency_needed = 3
        # (cand slot, T12 new<-cand, hypothesis kf slot, coincidences,
        # cand frame id, kf frame id)
        self._hyp = None
        self._pending_cand = None   # (AsyncReads of idx/vals, query slot)
        self._pending_verify = None  # (cand, T12, kf, AsyncRead, n_coin)
        # time-sliced global BA: gba_chunk_iters LM iterations per keyframe
        self.gba_async = True
        self.gba_chunk_iters = 2
        self.gba_iters = 10
        self._gba = None            # (snapshot MapState, carry, iters done)
        self.chain_corr = None      # set by a weld, for the System
        # time-sliced loop correction: pg_chunk_iters per keyframe
        self.corr_async = True
        self.pg_chunk_iters = 3
        self.pg_iters = 10
        self._pgc = None
        # counts for the bench and the chip smoke run
        self.stats = dict(bow_updates=0, detections=0, verifications=0,
                          refines=0, pg_chunks=0, gba_chunks=0, welds=0)

    def _gba_step(self, st: mstate.MapState, chain_ref):
        """Advance the time-sliced GBA by one chunk; weld back when done."""
        snap, carry, done = self._gba
        if done < self.gba_iters:
            carry = gba_chunk(snap, self.cam, carry,
                              iters=self.gba_chunk_iters)
            self.stats["gba_chunks"] += 1
            self._gba = (snap, carry, done + self.gba_chunk_iters)
            return st
        R, t, lm, _ = carry
        verbose.print_mess("LoopClosing: global BA finished, welding back",
                           verbose.VERBOSE)
        st, cR, ct = apply_gba(st, snap.kf_mask, snap.kf_frame_id,
                               snap.lm_mask, snap.lm_first_kf, R, t, lm,
                               chain_ref)
        self.stats["welds"] += 1
        self._add_chain_corr(cR, ct)
        self._gba = None
        return st

    def _add_chain_corr(self, cR, ct):
        """Record a weld's correction of the tracker's pose chain after the
        one not yet applied, if any: draining a correction and its GBA
        welds twice (pose graph, then GBA), and the tracker must receive
        both, in that order."""
        if self.chain_corr is not None:
            cR, ct = lie.se3_mul(*self.chain_corr, cR, ct)
        self.chain_corr = (cR, ct)

    def _start_gba(self, st: mstate.MapState):
        if not self.run_gba:
            return st
        if self.gba_async:
            carry = (st.kf_R, st.kf_t, st.lm_pos,
                     torch.full((), 1e-4, device=st.kf_R.device))
            self._gba = (st, carry, 0)
            return st
        return global_bundle_adjustment(st, self.cam)

    def _pgc_step(self, st: mstate.MapState, chain_ref):
        """Advance the time-sliced loop correction by one chunk (the last one
        shorter, so that the pose graph runs exactly pg_iters iterations, as
        correct_loop does); when the pose graph is done, weld back, and if
        both loop ends still hold their keyframes count the loop, fuse
        duplicates; then start the GBA."""
        c = self._pgc
        if c["done"] < self.pg_iters:
            n = min(self.pg_chunk_iters, self.pg_iters - c["done"])
            c["carry"] = loop_pg_chunk(
                c["snap"], c["kf"], c["cand"], c["T12"], c["carry"],
                iters=n, fix_scale=self.fix_scale, four_dof=c["four_dof"])
            self.stats["pg_chunks"] += 1
            c["done"] += n
            return st
        snap = c["snap"]
        R_out, t_out, lm_pos, dmin, dmax = loop_correction_apply(
            snap, c["carry"])
        verbose.print_mess("LoopClosing: sliced correction finished, "
                           "welding back", verbose.VERBOSE)
        st, cR, ct = apply_loop_weld(
            st, snap.kf_mask, snap.kf_frame_id, snap.lm_mask,
            snap.lm_first_kf, R_out, t_out, lm_pos, dmin, dmax, c["kf"],
            c["cand"], c["cur_fid"], c["cand_fid"], chain_ref)
        self.stats["welds"] += 1
        self._add_chain_corr(cR, ct)
        self._pgc = None
        # count the loop (and start its cooldown) and fuse only if both
        # loop ends still hold the same keyframes: the guard under which
        # the weld added the loop edge
        live_kf, live_cf = (int(x) for x in pull(torch.stack([
            st.kf_frame_id[c["kf"]], st.kf_frame_id[c["cand"]]])))
        if live_kf == c["cur_fid"] and live_cf == c["cand_fid"]:
            self.n_loops += 1
            self.last_loop_kf = c["kf_count"]
            st = search_and_fuse(st, self.cam, c["kf"], c["cand"])
        return self._start_gba(st)

    def finish_gba(self, st: mstate.MapState, chain_ref):
        """Drain a pending time-sliced correction and GBA."""
        while self._pgc is not None:
            st = self._pgc_step(st, chain_ref)
        while self._gba is not None:
            st = self._gba_step(st, chain_ref)
        return st

    def abort_gba(self):
        """Drop a pending GBA and time-sliced correction (map reset, merge,
        new loop)."""
        self._gba = None
        self._pgc = None

    def drop_pending(self):
        """Forget every in-flight stage, whose keyframe slots are about to
        mean other keyframes (a merge remaps the active map's slots; a new
        map starts from empty slots)."""
        self.abort_gba()
        self._hyp = None
        self._pending_cand = None
        self._pending_verify = None

    def on_keyframe(self, st: mstate.MapState, kf: int,
                    kf_count: int | None = None, kf_dev=None,
                    chain_ref=None):
        """Add keyframe slot kf to the database and advance the detection
        pipeline; returns the (possibly corrected) state. kf_count is the
        caller's keyframe counter (else one blocking read), kf_dev the
        device copy of the slot, chain_ref the tracker's reference keyframe
        for the weld's chain correction.

        Each stage is dispatched at one keyframe and its scalars read at the
        next: A detect_candidates (every keyframe); B the candidate read ->
        the full Sim3 verification; C the verification read -> open or
        advance the hypothesis, whose geometric refine is dispatched at the
        same call; a correction starts once consistency_needed coincidences
        landed."""
        dev = st.kf_R.device
        if kf_dev is None:
            kf_dev = _slot(kf, dev)
        self.chain_corr = None
        ref = chain_ref if chain_ref is not None else kf_dev
        if self._pgc is not None:
            st = self._pgc_step(st, ref)
        elif self._gba is not None:
            st = self._gba_step(st, ref)
        if (not self._codebook_trained and kf_count is not None and
                kf_count >= self.train_codebook_after):
            desc = st.kf_desc.reshape(-1, st.kf_desc.shape[-1])
            dmask = (st.kf_kp_mask & st.kf_mask[:, None]).reshape(-1)
            self.codebook = vocab.train_codebook(desc, dmask, self.codebook)
            self._codebook_trained = True
            self.bow = vocab.rebuild_bow_rows(st.kf_desc, st.kf_kp_mask,
                                              st.kf_mask, self.codebook)
        self.bow, row = vocab.update_bow_row(
            self.bow, st.kf_desc, st.kf_kp_mask, kf_dev, self.codebook)
        self.stats["bow_updates"] += 1

        if not self.detect_loops:
            return st
        if kf_count is None:
            kf_count = int(pull(st.next_kf_counter))

        st, corrected = self._resolve_verify(st, kf, kf_count)
        if corrected:
            return st
        if (self._pgc is not None or kf_count < 12 or
                kf_count - self.last_loop_kf < self.min_kf_gap):
            # no fresh detection while a correction is in flight or during
            # the post-loop cooldown
            self._pending_cand = None
            return st

        # active hypothesis: dispatch its geometric re-verification here
        if self._hyp is not None and self._pending_verify is None:
            (cand, T12_prev, kf_prev, n_coin, cand_fid,
             prev_fid) = self._hyp
            self._hyp = None
            T12p = propagate_hypothesis(st, kf, kf_prev, T12_prev)
            T12r, n, okr = refine_loop_from_hypothesis(
                st, self.cam, kf, cand, T12p, fix_scale=self.fix_scale,
                min_inliers=self.min_inliers)
            self.stats["refines"] += 1
            stats = _verify_stats_refine(st, n, okr, cand, kf, kf_prev,
                                         cand_fid, prev_fid)
            self._pending_verify = (cand, T12r, kf, AsyncRead(stats), n_coin)

        # read last keyframe's candidates; a plausible fresh one gets the
        # full Sim3 verification (coincidence 1 opens a hypothesis)
        prev = self._pending_cand
        idx_d, vals_d = vocab.detect_candidates(
            self.bow, st.kf_mask, row, st.covis, kf_dev, n_best=3)
        self.stats["detections"] += 1
        self._pending_cand = ((AsyncRead(idx_d), AsyncRead(vals_d)), kf)
        if prev is None or self._pending_verify is not None:
            return st
        (r_idx, r_vals), kfq = prev
        idx, vals = r_idx.get(), r_vals.get()
        best = int(idx[0])
        if float(vals[0]) <= 0.0 or best == kfq:
            return st
        T12, n, ok = verify_loop_candidate(
            st, self.cam, kfq, best, self.gen, min_inliers=self.min_inliers,
            fix_scale=self.fix_scale)
        self.stats["verifications"] += 1
        stats = _verify_stats_fresh(st, n, ok, best, kfq)
        self._pending_verify = (best, T12, kfq, AsyncRead(stats), 0)
        return st

    def _resolve_verify(self, st: mstate.MapState, kf: int, kf_count: int):
        """Read the previous keyframe's verification; open or advance the
        hypothesis, and once consistency_needed coincidences landed in a
        row, start the correction at this keyframe (the stored Sim3
        propagated through odometry). Returns (st, corrected)."""
        if self._pending_verify is None:
            return st, False
        cand, T12, kf_v, read, n_coin = self._pending_verify
        self._pending_verify = None
        n, ok, cand_fid, vkf_fid = (int(x) for x in read.get())
        if not ok:
            return st, False
        n_coin += 1
        if n_coin < self.consistency_needed:
            self._hyp = (cand, T12, kf_v, n_coin, cand_fid, vkf_fid)
            return st, False
        # slot-reuse guard at resolution time, plus the inertial flag: one
        # blocking read (this path runs once per closed loop)
        cf, pf, kf_fid, imu, ba2 = (int(x) for x in pull(torch.stack([
            st.kf_frame_id[cand], st.kf_frame_id[kf_v], st.kf_frame_id[kf],
            st.imu_initialized.to(torch.int32),
            st.imu_ba2.to(torch.int32)])))
        if cf != cand_fid or pf != vkf_fid:
            return st, False
        T12c = propagate_hypothesis(st, kf, kf_v, T12)
        four_dof = False
        if imu:
            T12c, four_dof, good = inertial_loop_gate(st, kf, cand, T12c,
                                                      ba2=bool(ba2))
            if not good:
                return st, False
        verbose.print_mess(
            f"LoopClosing: loop detected KF slot {kf} <-> {cand} "
            f"({n} inliers), correcting")
        # a new verified loop supersedes any in-flight GBA or correction
        self.abort_gba()
        if self.corr_async:
            # counted when its weld lands (_pgc_step)
            K = st.caps.K
            carry = (st.kf_R, st.kf_t, torch.ones((K,), device=st.kf_R.device))
            self._pgc = {"snap": st, "kf": kf, "cand": cand, "T12": T12c,
                         "four_dof": four_dof, "carry": carry, "done": 0,
                         "cur_fid": kf_fid, "cand_fid": cf,
                         "kf_count": kf_count}
            return st, True
        self.last_loop_kf = kf_count
        self.n_loops += 1
        st = correct_loop(st, self.cam, kf, cand, T12c,
                          pg_iters=self.pg_iters, fix_scale=self.fix_scale,
                          four_dof=four_dof)
        st = search_and_fuse(st, self.cam, kf, cand)
        return self._start_gba(st), True
