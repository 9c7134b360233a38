"""Tracking: per-frame state machine and device steps (counterpart of
dani_slam_tpu/slam/tracking.py for the monocular, stereo and RGB-D paths,
plain and pipelined, with and without an IMU).

Covered reference behaviors (src/Tracking.cc): MonocularInitialization
(two-view reconstruction between a reference frame and the current one,
median-depth scale) and StereoInitialization from depth,
TrackWithMotionModel (window 15, widened to 30 on failure),
TrackReferenceKeyFrame (LightGlue when a matcher is given, descriptor
mutual-NN otherwise), TrackLocalMap (covisible local map, target-side
projected search through the window-match kernel), NeedNewKeyFrame /
CreateNewKeyFrame, localization-mode visual odometry on the last frame's
depth points, and the relocalization attempt of a lost frame (through the
System's reloc_fn, on both the plain and the pipelined path). With an
initialized IMU (Tracker.inertial, set by the System for IMU sensors):
PredictStateIMU replaces the constant-velocity prediction, every tracked
frame is refined by the visual-inertial two-frame solve with the
marginalized prior (PoseInertialOptimizationLastFrame + Marginalize), and
a RECENTLY_LOST frame coasts on the IMU prediction.

Pipelined mode defers each frame's lost/keyframe decision by pipeline_depth
frames: the tracker state advances optimistically from device references,
the frame's counts start an asynchronous copy to the host, and the decision
is taken when that copy has long finished; a lost frame rolls the state back
to its snapshot and hands the lost frame's features to relocalization. On
the image path a tracked frame is one function with no
host read inside (rgbd_frame_fused), run as a captured CUDA graph on the
card (slam/framegraph.py).

Translation notes:
  * the JAX package's lax.cond fallbacks inside track_frame_step (widened
    motion-model search, reference-keyframe tracking) exist in two forms
    here. select_on_device=False: host branches on an inlier count, each a
    counted blocking pull (the non-pipelined path). select_on_device=True:
    all three candidates are computed and torch.where picks by the same
    predicates — what lax.cond of pure functions computes — so a frame
    holds no host read and can be captured;
  * lax.reduce(..., bitwise_or) over observer words has no torch
    counterpart: the [N, K/32] int32 words are unpacked to bool [N, K] with
    shifts and `& 1` (int32 `>>` is arithmetic, so the mask after the shift
    matters for bit 31) and reduced with `any`;
  * jnp.nonzero(size=LQ, fill_value=0) becomes a cumsum-rank compaction
    into a fixed [LQ] buffer (torch.nonzero would sync and has a dynamic
    shape);
  * `.at[].max` with duplicate indices becomes an id_mask scatter.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.core import lie, scatterless as sless
from dani_slam_tpu_torch.core import state as mstate
from dani_slam_tpu_torch.ops import matching, solvers, stats, twoview
from dani_slam_tpu_torch.slam.frame import FrameFeatures
from dani_slam_tpu_torch.utils.device import AsyncRead, pull

SCALE_FACTOR = 1.2
LQ = 4096          # compacted local-map query capacity


class TrackStepOut(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    bindings: torch.Tensor   # [N] landmark id per keypoint (-1 none)
    n_inliers: torch.Tensor
    st: mstate.MapState


# ---------------------------------------------------------------------------
# Monocular initialization
# ---------------------------------------------------------------------------

def match_for_init(f0: FrameFeatures, f1: FrameFeatures) -> matching.Matches:
    return matching.search_for_initialization(
        f0.xy, f0.valid, f0.desc, f1.xy, f1.valid, f1.desc)


def two_view_from_matches(key, cam, f0: FrameFeatures, f1: FrameFeatures,
                          m: matching.Matches) -> twoview.TwoViewResult:
    """Two-view reconstruction of the init matches; `key` as for
    twoview.two_view_init (a Generator or the two index sets)."""
    r0 = _cam.unproject(cam, f0.xy)
    r1 = _cam.unproject(cam, f1.xy[m.idx])
    return twoview.two_view_init(key, r0, r1, m.ok, cam.params[0])


def build_initial_map(st: mstate.MapState, cam, f0: FrameFeatures,
                      f1: FrameFeatures, m: matching.Matches,
                      tv: twoview.TwoViewResult, frame_id0, frame_id):
    """The initial two-keyframe map (reference: CreateInitialMapMonocular):
    the census survivors as landmarks, scaled so that their median depth
    is 1 (an averaging median, as jnp.nanmedian), and both keyframes.
    Returns (st, k0, k1, bind1, R21, t21)."""
    good = m.ok & tv.inliers
    med = stats.nanmedian(torch.where(good, tv.pts3d[:, 2],
                                      torch.full_like(tv.pts3d[:, 2],
                                                      float("nan"))))
    scale = 1.0 / torch.clamp(med, min=1e-6)
    pts = tv.pts3d * scale
    t21 = tv.t21 * scale
    N = f0.xy.shape[0]
    dev = f0.xy.device
    dist = torch.clamp(torch.linalg.norm(pts, dim=-1), min=1e-9)
    zeros = torch.zeros((N,), dtype=torch.int32, device=dev)
    st, slots = mstate.insert_landmarks(
        st, pts, f0.desc, pts / dist[:, None], dist * 0.8, dist * 1.3,
        zeros, zeros, good)
    placed = good & (slots >= 0)
    bind0 = torch.where(placed, slots, torch.full_like(slots, -1))
    # bindings of the frame's keypoints, formed target-side (no scatter)
    bind1 = sless.id_lookup(m.idx, placed, slots, N,
                            torch.full((N,), -1, dtype=slots.dtype,
                                       device=dev))
    st, k0 = mstate.insert_keyframe(
        st, torch.eye(3, device=dev), torch.zeros(3, device=dev), f0.time,
        frame_id0, f0.xy, f0.valid, f0.desc, f0.depth, f0.octave_or_zeros(),
        bind0)
    st, k1 = mstate.insert_keyframe(
        st, tv.R21, t21, f1.time, frame_id, f1.xy, f1.valid, f1.desc,
        f1.depth, f1.octave_or_zeros(), bind1)
    return st, k0, k1, bind1, tv.R21, t21


# ---------------------------------------------------------------------------
# RGB-D / stereo initialization
# ---------------------------------------------------------------------------

def build_initial_map_rgbd(st: mstate.MapState, cam, f0: FrameFeatures,
                           frame_id: int):
    """Landmarks from depth for every valid keypoint + the first keyframe
    (reference: StereoInitialization). Returns (st, k0, bind0, stats) with
    stats = [n_depth, k0, n_bound] bundled for one host pull."""
    N = f0.xy.shape[0]
    dev = f0.xy.device
    good = f0.valid & torch.isfinite(f0.depth) & (f0.depth > 0)
    pts = _cam.unproject(cam, f0.xy) * f0.depth[:, None]
    dist = torch.clamp(torch.linalg.norm(pts, dim=-1), min=1e-9)
    zeros = torch.zeros((N,), dtype=torch.int32, device=dev)
    st, slots = mstate.insert_landmarks(
        st, pts, f0.desc, pts / dist[:, None], dist * 0.8, dist * 1.3,
        zeros, zeros, good)
    bind0 = torch.where(good & (slots >= 0), slots, torch.full_like(slots, -1))
    st, k0 = mstate.insert_keyframe(
        st, torch.eye(3, device=dev), torch.zeros(3, device=dev), f0.time,
        frame_id, f0.xy, f0.valid, f0.desc, f0.depth, f0.octave_or_zeros(),
        bind0)
    stats = torch.stack([torch.sum(good.to(torch.int32)), k0.to(torch.int32),
                         torch.sum((bind0 >= 0).to(torch.int32))])
    return st, k0, bind0, stats


def _optimize_with_bindings(st, cam, feat, bind, R0, t0, use_depth,
                            rounds: int = 4):
    has = (bind >= 0) & st.lm_mask[torch.clamp(bind, min=0).long()]
    lm_pos = st.lm_pos[torch.where(has, bind, torch.zeros_like(bind)).long()]
    octv = feat.octave_or_zeros().to(torch.float32)
    inv_sigma2 = SCALE_FACTOR ** (-2.0 * octv)
    res = solvers.pose_optimize(
        R0, t0, cam, lm_pos, feat.xy, has, inv_sigma2=inv_sigma2,
        obs_depth=feat.depth if use_depth else None, use_depth=use_depth,
        rounds=rounds)
    bind = torch.where(res.inliers | ~has, bind, torch.full_like(bind, -1))
    return TrackStepOut(res.R, res.t, bind, res.n_inliers, st)


def track_motion_model(st: mstate.MapState, cam, feat: FrameFeatures,
                       last_bind, R_pred, t_pred, radius: float = 15.0,
                       use_depth: bool = False,
                       rounds: int = 2) -> TrackStepOut:
    """Project the last frame's landmarks with the constant-velocity
    prediction and match in an octave-scaled window (reference:
    TrackWithMotionModel)."""
    has = (last_bind >= 0) & \
        st.lm_mask[torch.clamp(last_bind, min=0).long()]
    lm_ids = torch.where(has, last_bind, torch.zeros_like(last_bind))
    li = lm_ids.long()
    xy, vis, _, dist = matching.project_landmarks(R_pred, t_pred, cam,
                                                  st.lm_pos[li], has)
    octv = matching.predict_scale_level(dist, st.lm_dist_max[li])
    m = matching.search_by_projection(xy, vis, st.lm_desc[li], feat.xy,
                                      feat.valid, feat.desc,
                                      radius=radius * SCALE_FACTOR ** octv)
    bind = sless.id_max(m.idx, m.ok, lm_ids, feat.xy.shape[0], -1)
    return _optimize_with_bindings(st, cam, feat, bind, R_pred, t_pred,
                                   use_depth, rounds=rounds)


def track_reference_keyframe(st: mstate.MapState, cam, feat: FrameFeatures,
                             ref_kf, R0, t0, use_depth: bool = False,
                             matcher=None) -> TrackStepOut:
    """Match the frame against the reference keyframe's landmarks
    (reference: TrackReferenceKeyFrame): with a matcher
    (models.lightglue.MatcherState) LightGlue runs between the keyframe's
    keypoints and the frame's, otherwise descriptor mutual-NN."""
    obs = sless.row(st.obs_lm, ref_kf)
    has = (obs >= 0) & sless.row(st.kf_kp_mask, ref_kf)
    lm_ids = torch.where(has, obs, torch.zeros_like(obs))
    if matcher is not None:
        from dani_slam_tpu_torch.models import lightglue as lg
        idx, score, ok = lg.match_pair(
            matcher.model, sless.row(st.kf_kp, ref_kf),
            sless.row(st.kf_desc, ref_kf), has,
            feat.xy, feat.desc, feat.valid, cam.width, cam.height)
        m = matching.Matches(idx, 1.0 - score, ok)
    else:
        dmat = matching.desc_distance_matrix(st.lm_desc[lm_ids.long()],
                                             feat.desc)
        m = matching.masked_match(dmat, has[:, None] & feat.valid[None, :],
                                  th=matching.TH_HIGH, ratio=0.9,
                                  mutual=True)
        m = matching.resolve_duplicate_targets(m, feat.xy.shape[0])
    bind = sless.id_max(m.idx, m.ok, lm_ids, feat.xy.shape[0], -1)
    return _optimize_with_bindings(st, cam, feat, bind, R0, t0, use_depth)


def track_last_frame_vo(cam, last_xy, last_desc, last_depth, last_valid,
                        R_last, t_last, feat: FrameFeatures, R_pred, t_pred,
                        radius: float = 15.0, use_depth: bool = True):
    """Pure visual odometry against TEMPORAL points from the last frame's
    depth — localization mode's lifeline outside the mapped region
    (reference: UpdateLastFrame + TrackWithMotionModel in mbVO mode).
    Returns (R, t, n_inliers)."""
    good = last_valid & torch.isfinite(last_depth) & (last_depth > 0)
    Xc = _cam.unproject(cam, last_xy) * last_depth[:, None]
    Xw = lie.se3_apply(*lie.se3_inv(R_last, t_last), Xc)
    xy, vis, _, _ = matching.project_landmarks(R_pred, t_pred, cam, Xw, good)
    m = matching.search_by_projection(xy, vis, last_desc, feat.xy,
                                      feat.valid, feat.desc, radius=radius)
    res = solvers.pose_optimize(
        R_pred, t_pred, cam, Xw, feat.xy[m.idx], m.ok,
        obs_depth=feat.depth[m.idx] if use_depth else None,
        use_depth=use_depth)
    return res.R, res.t, res.n_inliers


def _ref_pose(st: mstate.MapState, k):
    """Reference keyframe pose gather."""
    return sless.row(st.kf_R, k), sless.row(st.kf_t, k)


def apply_chain_correction(R, t, corr_R, corr_t):
    """Right-compose a map-frame correction onto a stored pose: keeps the
    pipelined mode's rollback snapshots and deferred keyframe poses
    consistent with a re-anchored pose chain (a rollback restoring
    pre-correction poses would undo the re-anchoring). The rotation is
    projected back onto SO(3): a corrected pose becomes a keyframe's, whose
    next correction would otherwise compound its error."""
    R2, t2 = lie.se3_mul(R, t, corr_R, corr_t)
    return lie.orthonormalize(R2), t2


def _observer_keyframes(st: mstate.MapState, bind, has) -> torch.Tensor:
    """bool [K]: keyframes observing any bound landmark, from the observer
    words — OR over rows done as unpack-to-bits + any."""
    K = st.caps.K
    nw = st.lm_obs_bits.shape[1]
    obits = st.lm_obs_bits[torch.clamp(bind, min=0).long()]       # [N,nw]
    obits = torch.where(has[:, None], obits, torch.zeros_like(obits))
    shifts = torch.arange(32, dtype=torch.int32, device=bind.device)
    bits = (obits[:, :, None] >> shifts) & 1                        # [N,nw,32]
    return torch.any(bits != 0, dim=0).reshape(nw * 32)[:K]


def _compact(sel: torch.Tensor, size: int):
    """Fixed-size compaction: the first `size` indices where sel is True
    (ascending), zero-filled, and their validity."""
    dev = sel.device
    n = sel.shape[0]
    rank = torch.cumsum(sel.to(torch.int64), 0) - 1
    dst = torch.where(sel & (rank < size), rank, torch.full_like(rank, size))
    buf = torch.zeros(size + 1, dtype=torch.int64, device=dev)
    buf[dst] = torch.arange(n, device=dev)
    ok = torch.arange(size, device=dev) < torch.sum(sel.to(torch.int64))
    return buf[:size], ok


def track_local_map(st: mstate.MapState, cam, feat: FrameFeatures, bind,
                    R0, t0, radius: float = 4.0,
                    use_depth: bool = False) -> TrackStepOut:
    """Expand matches to the local covisible map and re-optimize
    (reference: TrackLocalMap + SearchLocalPoints)."""
    L = st.caps.L
    has = (bind >= 0) & st.lm_mask[torch.clamp(bind, min=0).long()]
    seen = sless.id_mask(bind, has, L)
    kf_sel = st.kf_mask & _observer_keyframes(st, bind, has)
    neigh = torch.any((st.covis > 10) & kf_sel[None, :], dim=1)
    kf_sel = kf_sel | (st.kf_mask & neigh)
    lm_sel = mstate.local_map_landmark_mask(st, kf_sel) & ~seen

    loc_ids, loc_ok = _compact(lm_sel, LQ)
    xy, vis, _, dist = matching.project_landmarks(
        R0, t0, cam, st.lm_pos[loc_ids], loc_ok, st.lm_normal[loc_ids],
        st.lm_dist_min[loc_ids], st.lm_dist_max[loc_ids])
    octv = matching.predict_scale_level(dist, st.lm_dist_max[loc_ids])
    ci, _, cok = matching.search_by_projection_bind(
        xy.contiguous(), vis, st.lm_desc[loc_ids], feat.xy.contiguous(),
        feat.valid & (bind < 0), feat.desc.contiguous(),
        radius=radius * SCALE_FACTOR ** octv)
    bind2 = torch.where(bind >= 0, bind,
                        torch.where(cok, loc_ids[ci].to(bind.dtype),
                                    torch.full_like(bind, -1)))
    out = _optimize_with_bindings(st, cam, feat, bind2, R0, t0, use_depth)

    # visibility bookkeeping (IncreaseVisible / IncreaseFound)
    vis_full = sless.id_mask(loc_ids, vis, L)
    dvis = (vis_full | seen).to(torch.int32)
    dfound = sless.id_count(out.bindings, out.bindings >= 0, L)
    st2 = dataclasses.replace(st, lm_visible=st.lm_visible + dvis,
                              lm_found=st.lm_found + dfound)
    return TrackStepOut(out.R, out.t, out.bindings, out.n_inliers, st2)


def track_frame_step(st: mstate.MapState, cam, feat: FrameFeatures,
                     last_bind, R_cur, t_cur, Rv, tv, ref_kf,
                     min_inliers: int = 10, use_depth: bool = False,
                     has_vel: bool = True, seed_rounds: int = 2,
                     matcher=None, select_on_device: bool = False):
    """Motion-model track (widened on failure) -> reference-KF fallback ->
    local-map track. select_on_device=False takes the two fallbacks as host
    branches on the inlier count (one counted pull each);
    select_on_device=True computes all three candidates and selects with
    torch.where, with no host read. Returns (R, t, bind, counts [4], st)."""
    if has_vel:
        R_pred, t_pred = lie.se3_mul(Rv, tv, R_cur, t_cur)
    else:
        R_pred, t_pred = R_cur, t_cur

    def motion(radius):
        return track_motion_model(st, cam, feat, last_bind, R_pred, t_pred,
                                  radius=radius, use_depth=use_depth,
                                  rounds=seed_rounds)

    def refkf():
        return track_reference_keyframe(st, cam, feat, ref_kf, R_cur, t_cur,
                                        use_depth=use_depth, matcher=matcher)

    out = motion(15.0)
    if select_on_device:
        def pick(take_b, a, b):
            return tuple(torch.where(take_b, y, x) for x, y in zip(a, b))

        def parts(o):
            return o.R, o.t, o.bindings, o.n_inliers

        first = parts(out)
        sel1 = pick(first[3] < min_inliers, first, parts(motion(30.0)))
        R2, t2, b2, n2 = pick(sel1[3] < min_inliers, sel1, parts(refkf()))
    else:
        if int(pull(out.n_inliers)) < min_inliers:
            out = motion(30.0)
            if int(pull(out.n_inliers)) < min_inliers:
                out = refkf()
        R2, t2, b2, n2 = out.R, out.t, out.bindings, out.n_inliers
    out3 = track_local_map(st, cam, feat, b2, R2, t2, use_depth=use_depth)
    R3 = lie.orthonormalize(out3.R)
    close = feat.valid & torch.isfinite(feat.depth) & (feat.depth > 0)
    bound = out3.bindings >= 0
    counts = torch.stack([n2, out3.n_inliers, torch.sum(bound & close),
                          torch.sum(~bound & close)]).to(torch.int32)
    return R3, out3.t, out3.bindings, counts, out3.st


def rgbd_frame_fused(sp_model, img, depth_img, cam, time, depth_factor,
                     threshold, st: mstate.MapState, last_bind, R_cur, t_cur,
                     Rv, tv, ref_kf, n_max: int = 1024, min_inliers: int = 10,
                     has_vel: bool = True, matcher=None, detector=None,
                     seed_rounds: int = 2):
    """The whole per-frame pipeline as one function with no host read
    inside: (YOLO dynamic masking ->) SuperPoint frontend -> track step with
    the fallbacks selected on the device -> next velocity -> reference-KF
    pose gather. The keyframe-decision scalars ride along with the counts:
    counts6 = the four counts, int(dyn_ratio * 1000) and the live keyframe
    count.

    Returns (feat, R, t, bind, counts6, st2, (Rv', tv'), (R_ref, t_ref),
    dyn_ratio)."""
    from dani_slam_tpu_torch.slam import frame as frame_mod

    boxes = box_mask = None
    if detector is not None:
        boxes, box_mask, dyn_ratio = detector.dynamic_mask_inputs(img)
    else:
        dyn_ratio = torch.zeros((), dtype=torch.float32, device=img.device)
    feat = frame_mod._frame_rgbd_program(
        sp_model, img, depth_img, cam, time, depth_factor, threshold, boxes,
        box_mask, n_max=n_max)
    R3, t3, bind, counts, st2 = track_frame_step(
        st, cam, feat, last_bind, R_cur, t_cur, Rv, tv, ref_kf,
        min_inliers=min_inliers, use_depth=True, has_vel=has_vel,
        seed_rounds=seed_rounds, matcher=matcher, select_on_device=True)
    # velocity for the next frame: T_new o T_cur^-1
    vel2 = lie.se3_mul(R3, t3, *lie.se3_inv(R_cur, t_cur))
    counts6 = torch.cat([counts, torch.stack([
        (dyn_ratio * 1000.0).to(torch.int32),
        torch.sum(st2.kf_mask.to(torch.int32))]).to(torch.int32)])
    return (feat, R3, t3, bind, counts6, st2, vel2,
            _ref_pose(st2, ref_kf), dyn_ratio)


def vi_refine_step_marg(st: mstate.MapState, cam, feat: FrameFeatures,
                        bind, R, t, v, bg, ba, R_prev, t_prev, v_prev,
                        prior_info, preint, calib, use_depth: bool = False):
    """Visual-inertial refinement of a tracked frame with the marginalized
    prior: the previous frame's state optimized jointly (30 DoF) under the
    carried 15x15 prior information, then Schur-marginalized out
    (reference src/Optimizer.cc:4875, :2960). Returns (R, t, v, bg, ba,
    n_inliers, prior_info_next)."""
    has = (bind >= 0) & st.lm_mask[torch.clamp(bind, min=0).long()]
    pts = st.lm_pos[torch.where(has, bind, torch.zeros_like(bind)).long()]
    (R2, t2, v2, bg2, ba2, _, n,
     info_next) = solvers.pose_inertial_optimize_marginalized(
        R, t, v, bg, ba, R_prev, t_prev, v_prev, bg, ba, prior_info, preint,
        calib, cam, pts, feat.xy, has,
        obs_depth=feat.depth if use_depth else None, use_depth=use_depth,
        iters=8)
    return R2, t2, v2, bg2, ba2, n, info_next


def bootstrap_prior_info(preint, calib, info_cap: float = 1e3):
    """The first 15x15 prior information of the marginalized chain after
    the IMU initialization: the capped diagonal of the inverse
    preintegration covariance and the bias random walk."""
    covs = torch.diagonal(preint.cov[:9, :9])
    info9 = torch.clamp(1.0 / torch.clamp(covs, min=1e-8), 0.0, info_cap)
    dtp = torch.clamp(preint.dt, min=1e-3)
    walk = torch.cat([
        (1.0 / torch.clamp(calib.walk_gyro ** 2 * dtp, min=1e-12))
        .expand(3),
        (1.0 / torch.clamp(calib.walk_acc ** 2 * dtp, min=1e-12))
        .expand(3)])
    return torch.diag(torch.cat([info9, torch.clamp(walk, 0.0, info_cap)]))


# ---------------------------------------------------------------------------
# Host-side tracker
# ---------------------------------------------------------------------------

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
RECENTLY_LOST = "RECENTLY_LOST"
LOST = "LOST"


class Tracker:
    """Host state machine driving the device steps for one sensor mode:
    "mono" (no depth; two-view initialization; keyframe ratio 0.9),
    "stereo" or "rgbd" (depth; initialization from depth; ratio 0.75). The
    System runs the mapping step after a keyframe is created.

    pipelined=False: each frame's lost/keyframe decision is taken right
    after a blocking pull of its counts. pipelined=True: decisions are
    deferred by pipeline_depth frames (see the module docstring); on the
    image path a tracked frame with a velocity is one captured graph replay
    on a CUDA device (frame_graph; set it False to run the same function
    eagerly), and the eager fused function otherwise; on the feature path
    (monocular, stereo, inertial frames) the track step is a graph replay
    on the card (utils/graphs) under the same flag."""

    def __init__(self, cam: _cam.Camera, caps: mstate.MapCaps = None,
                 sensor: str = "rgbd", seed: int = 0,
                 min_inliers_track: int = 10, min_inliers_map: int = 20,
                 kf_tracked_ratio: float | None = None,
                 max_frames_between_kf: int = 15,
                 min_frames_between_kf: int = 0, pipelined: bool = False):
        if sensor not in ("mono", "stereo", "rgbd"):
            raise ValueError(f"sensor={sensor!r}: expected 'mono', "
                             "'stereo' or 'rgbd'")
        self.cam = cam
        self.device = cam.device
        self.caps = caps or mstate.MapCaps()
        self.sensor = sensor
        self.use_depth = sensor in ("rgbd", "stereo")
        self.min_inliers_track = min_inliers_track
        self.min_inliers_map = min_inliers_map
        # keyframe-policy ratio by sensor (reference: thRefRatio 0.9 mono,
        # 0.75 stereo / RGB-D)
        if kf_tracked_ratio is None:
            kf_tracked_ratio = 0.9 if sensor == "mono" else 0.75
        self.kf_tracked_ratio = kf_tracked_ratio
        self.max_frames_between_kf = max_frames_between_kf
        self.min_frames_between_kf = min_frames_between_kf
        self.pipelined = pipelined
        self.seed_rounds = 2
        # optional models.lightglue.MatcherState: the matcher of the
        # reference-keyframe fallback
        self.matcher = None
        self.sp_params = None
        # localization-mode visual odometry against last-frame depth points,
        # set by System.activate_localization_mode
        self.localization_vo = False
        # host hook invoked before each keyframe decision (the System wires
        # its deferred keyframe-pull resolver here)
        self.pre_kf_decision = None
        # relocalization hook, reloc_fn(tracker, feat) -> (R, t, bind,
        # keyframe slot) or None (System._relocalize); survives reset()
        self.reloc_fn = None
        self.pipeline_depth = 4    # frames in flight before resolving
        self.frame_graph = self.device.type == "cuda"
        self.graph_replays = 0
        self.eager_frames = 0      # image-path frames run without a graph
        self.vo_frames = 0         # frames the localization VO lifeline
                                   # tracked
        self.rollbacks = 0         # deferred decisions that found a loss
        self.relocalizations = 0   # successful relocalizations
        # the two-view RANSAC's draws (monocular initialization); survives
        # reset(). init_sampler(pair_mask) -> (idx_e, idx_h), when set,
        # supplies the hypotheses' index sets instead (a test replays the
        # reference package's draws through it)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.init_sampler = None
        # inertial bookkeeping (slam/inertial.InertialState), installed by
        # the System for IMU sensors; reset() hands a fresh one (same
        # calibration) to each new map
        self.inertial = None
        self.reset()

    def reset(self):
        """A fresh map and per-map state; configuration and hooks survive
        (the System keeps one Tracker across maps)."""
        dev = self.device
        self.st = mstate.empty_map(self.caps, device=dev)
        self.state = NOT_INITIALIZED
        self.frame_id = 0
        self.init_feat = None      # monocular init's reference frame
        self._init_feat_fid = 0
        self.last_feat = None
        self.last_bind = None
        self.R = torch.eye(3, device=dev)
        self.t = torch.zeros(3, device=dev)
        self.R_last = torch.eye(3, device=dev)
        self.t_last = torch.zeros(3, device=dev)
        self.vel = None
        self.ref_kf = 0
        self.ref_kf_fid = -1
        self.ref_kf_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self.ref_kf_tracked = 0
        self.pending_kf = None
        # set when this frame made a keyframe: the initialization's slot,
        # True for one the mapping step inserts (utils/stage_profile reads
        # it)
        self.new_kf = None
        # a map correction that landed DURING a keyframe decision, to be
        # applied to the already-popped frame pose before _create_kf
        self.pending_chain_corr = None
        self.last_kf_frame = -999
        self.frames_lost = 0
        self._traj_dev = []
        self._traj_host = []
        self._pending = []         # deferred decisions (pipelined mode)
        self.dynamic_ratio = None
        self._host_dyn_ratio = None   # host copies that rode along with the
        self._host_n_kf = None        # counts of the fused image path
        # (slot, frame id) of the keyframes made by the initialization, for
        # the System's inertial chain marks
        self.init_kfs = None
        if self.inertial is not None:
            from dani_slam_tpu_torch.slam.inertial import InertialState
            self.inertial = InertialState(self.inertial.calib, device=dev)
        self.last_time = None
        self._vi_refined = False

    def flush(self):
        """Resolve all deferred decisions (call before reading results)."""
        self._resolve_pending(force=True)

    # -- public API -------------------------------------------------------

    def track(self, feat: FrameFeatures):
        """Process one frame; returns (state, R_cw, t_cw)."""
        self.new_kf = None
        self._resolve_pending()
        if self.state == NOT_INITIALIZED:
            self._initialize(feat)
        else:
            self._track_frame(feat)
        self.frame_id += 1
        if self.state == OK:
            R_ref, t_ref = _ref_pose(self.st, self.ref_kf_dev)
            self._traj_dev.append((feat.time, self.R, self.t, R_ref, t_ref,
                                   self.ref_kf_dev, self.ref_kf_fid))
        return self.state, self.R, self.t

    def track_image_rgbd(self, img, depth_img, time, depth_factor, threshold,
                         detector=None, n_max: int = 1024):
        """Image-in RGB-D frame. Steady state in pipelined mode: the fused
        frame function (a graph replay on the card). Otherwise — not
        pipelined, initialization, lost — the staged path: (YOLO dynamic
        masking ->) SuperPoint frontend -> track(). Returns (state, R, t)."""
        from dani_slam_tpu_torch.slam import frame as frame_mod
        imu_on = self.inertial is not None and self.inertial.initialized
        if not (self.state == OK and self.pipelined and not imu_on):
            boxes = bmask = None
            if detector is not None:
                boxes, bmask, self.dynamic_ratio = \
                    detector.dynamic_mask_inputs(img)
            feat = frame_mod._frame_rgbd_program(
                self.sp_params, img, depth_img, self.cam, time, depth_factor,
                threshold, boxes, bmask, n_max=n_max)
            if self.pipelined:
                self.eager_frames += 1
            return self.track(feat)

        # (a resolve that rolls back leaves RECENTLY_LOST behind; this frame
        # then tracks optimistically from the restored state, as in the
        # reference package)
        self.new_kf = None
        self._resolve_pending()
        has_vel = self.vel is not None
        if self.frame_graph and has_vel:
            from dani_slam_tpu_torch.slam import framegraph
            out = framegraph.frame_graph(
                self, img, depth_img, depth_factor, threshold, detector,
                n_max).replay(self, img, depth_img, time)
            self.graph_replays += 1
        else:
            dev = self.device
            Rv, tv = self.vel if has_vel else (torch.eye(3, device=dev),
                                               torch.zeros(3, device=dev))
            out = rgbd_frame_fused(
                self.sp_params, img, depth_img, self.cam, time, depth_factor,
                threshold, self.st, self.last_bind, self.R, self.t, Rv, tv,
                self.ref_kf_dev, n_max=n_max,
                min_inliers=self.min_inliers_track, has_vel=has_vel,
                matcher=self.matcher, detector=detector,
                seed_rounds=self.seed_rounds)
            self.eager_frames += 1
        feat, R_new, t_new, bind, counts, st, vel2, ref_pose, dyn_ratio = out
        if detector is not None:
            self.dynamic_ratio = dyn_ratio
        self._defer(feat, R_new, t_new, bind, counts, st, vel=vel2)
        self.frame_id += 1
        self._traj_dev.append((feat.time, self.R, self.t, ref_pose[0],
                               ref_pose[1], self.ref_kf_dev,
                               self.ref_kf_fid))
        return self.state, self.R, self.t

    @property
    def trajectory(self):
        """[(time, R_cw, t_cw)] numpy triples, re-anchored to the CURRENT
        (refined) reference-keyframe poses."""
        if self._traj_dev:
            cols = list(zip(*self._traj_dev))
            tm, R, t, R_ref, t_ref, slot = (pull(torch.stack(c))
                                            for c in cols[:6])
            kf_R, kf_t = pull(self.st.kf_R), pull(self.st.kf_t)
            kf_fid, kf_mask = pull(self.st.kf_frame_id), pull(self.st.kf_mask)
            for i, fid in enumerate(cols[6]):
                Ri, ti, k = R[i], t[i], int(slot[i])
                if kf_mask[k] and kf_fid[k] == fid:
                    # T_cr = T_cw_track o inv(T_rw_track); T_cw = T_cr o T_rw
                    R_cr = Ri @ R_ref[i].T
                    t_cr = ti - R_cr @ t_ref[i]
                    Ri = R_cr @ kf_R[k]
                    ti = R_cr @ kf_t[k] + t_cr
                self._traj_host.append((float(tm[i]), Ri, ti))
            self._traj_dev = []
        return self._traj_host

    # -- init -------------------------------------------------------------

    def _initialize(self, feat: FrameFeatures):
        if self.use_depth:
            self._initialize_depth(feat)
        else:
            self._initialize_mono(feat)

    def _initialize_depth(self, feat: FrameFeatures):
        st2, k0, bind, stats_ = build_initial_map_rgbd(
            self.st, self.cam, feat, self.frame_id)
        n_depth, k0_host, n_bound = (int(x) for x in pull(stats_))
        if n_depth < 50:
            return
        self.st = st2
        dev = self.device
        self._post_init(feat, bind, torch.eye(3, device=dev),
                        torch.zeros(3, device=dev), k0_host, k0, n_bound)
        self.new_kf = k0_host
        self.init_kfs = [(k0_host, self.frame_id)]

    def _initialize_mono(self, feat: FrameFeatures):
        """Keep a reference frame (> 100 keypoints) and try a two-view
        reconstruction against each new frame: >= 100 init matches, else
        the frame becomes the new reference; an accepted reconstruction
        makes the two-keyframe map. Each decision is one counted blocking
        read, as in the reference package (which reads the same four
        values); on the card an attempt's SVDs wait as well, counted in
        ops/linalg."""
        n_kp = int(pull(torch.sum(feat.valid)))
        if self.init_feat is None:
            if n_kp > 100:
                self.init_feat = feat
                self._init_feat_fid = self.frame_id
            return
        if n_kp <= 100:
            self.init_feat = None
            return
        m = match_for_init(self.init_feat, feat)
        if int(pull(torch.sum(m.ok))) < 100:
            self.init_feat = feat
            self._init_feat_fid = self.frame_id
            return
        key = (self.gen if self.init_sampler is None
               else self.init_sampler(m.ok))
        tv = two_view_from_matches(key, self.cam, self.init_feat, feat, m)
        if not bool(pull(tv.ok)):
            return
        st, k0, k1, bind1, R, t = build_initial_map(
            self.st, self.cam, self.init_feat, feat, m, tv,
            self._init_feat_fid, self.frame_id)
        k0_host, k1_host, n_bound = (int(x) for x in pull(torch.stack([
            k0.to(torch.int64), k1.to(torch.int64),
            torch.sum(bind1 >= 0).to(torch.int64)])))
        self.st = st
        self._post_init(feat, bind1, R, t, k1_host, k1, n_bound)
        self.new_kf = k1_host
        self.init_kfs = [(k0_host, self._init_feat_fid),
                         (k1_host, self.frame_id)]
        self.init_feat = None

    def _post_init(self, feat, bind, R, t, ref_kf, ref_kf_dev, n_bound):
        self.state = OK
        self.R, self.t = R, t
        self.R_last, self.t_last = R, t
        self.last_feat = feat
        self.last_bind = bind
        self.ref_kf = ref_kf
        self.ref_kf_fid = self.frame_id
        self.ref_kf_dev = ref_kf_dev
        self.ref_kf_tracked = n_bound
        self.last_kf_frame = self.frame_id
        self.vel = None

    # -- per-frame tracking ----------------------------------------------

    def _imu_ready(self) -> bool:
        ins = self.inertial
        return (ins is not None and ins.initialized and
                ins.last_preint is not None)

    def _predict_imu(self):
        ins = self.inertial
        from dani_slam_tpu_torch.slam import inertial as inert
        return inert.predict_state_imu(
            self.R, self.t, ins.v_w, ins.last_preint, ins.bias_g, ins.bias_a,
            ins.calib.R_bc, ins.calib.t_bc)

    def _track_frame(self, feat: FrameFeatures):
        R_cur, t_cur = self.R, self.t
        has_vel = self.vel is not None
        dev = self.device
        imu = self._imu_ready()
        if imu:
            # the IMU prediction replaces the constant-velocity model
            # (reference PredictStateIMU, src/Tracking.cc:1962-1977)
            R_cur, t_cur, _ = self._predict_imu()
            has_vel = False
        Rv, tv = self.vel if has_vel else (torch.eye(3, device=dev),
                                           torch.zeros(3, device=dev))
        R_new, t_new, bind, counts, st = self._track_step(
            feat, R_cur, t_cur, Rv, tv, has_vel)
        if imu:
            ins = self.inertial
            if ins.prior_info is None:
                ins.prior_info = bootstrap_prior_info(ins.last_preint,
                                                      ins.calib)
            (R_new, t_new, ins.v_w, ins.bias_g, ins.bias_a, _,
             ins.prior_info) = vi_refine_step_marg(
                st, self.cam, feat, bind, R_new, t_new, ins.v_w, ins.bias_g,
                ins.bias_a, self.R, self.t, ins.v_w, ins.prior_info,
                ins.last_preint, ins.calib, use_depth=self.use_depth)
            self._vi_refined = True
        if self.pipelined:
            self._defer(feat, R_new, t_new, bind, counts, st)
            return
        n_track, n, n_ct, n_cf = (int(x) for x in pull(counts))
        if n_track < self.min_inliers_track or n < self.min_inliers_map:
            # localization mode outside the mapped region: frame-to-frame
            # VO on the last frame's depth points
            if self.localization_vo and self.use_depth and \
                    self.last_feat is not None:
                R_pred, t_pred = lie.se3_mul(Rv, tv, R_cur, t_cur) \
                    if has_vel else (R_cur, t_cur)
                lf = self.last_feat
                R_vo, t_vo, n_vo = track_last_frame_vo(
                    self.cam, lf.xy, lf.desc, lf.depth, lf.valid, self.R,
                    self.t, feat, R_pred, t_pred, use_depth=self.use_depth)
                if int(pull(n_vo)) >= self.min_inliers_track:
                    self._apply_track(feat, R_vo, t_vo,
                                      torch.full_like(bind, -1), self.st)
                    self.vo_frames += 1
                    return
            self._on_lost(feat)
            return
        self._apply_track(feat, R_new, t_new, bind, st)
        if self._need_new_kf(n, n_ct, n_cf):
            self._create_kf(feat, bind, n_tracked_hint=n)

    def _track_step(self, feat, R_cur, t_cur, Rv, tv, has_vel):
        """track_frame_step of a feature frame. Pipelined on the card
        (frame_graph) it is a CUDA graph replay per static variant
        (utils/graphs): the three candidates are selected on the device, so
        the step holds no host read; the map, the frame and the poses are
        its inputs, the two map fields a tracked frame changes its
        outputs."""
        kw = dict(min_inliers=self.min_inliers_track,
                  use_depth=self.use_depth, has_vel=has_vel,
                  seed_rounds=self.seed_rounds, matcher=self.matcher,
                  select_on_device=self.pipelined)
        if not (self.pipelined and self.frame_graph):
            return track_frame_step(self.st, self.cam, feat, self.last_bind,
                                    R_cur, t_cur, Rv, tv, self.ref_kf_dev,
                                    **kw)
        from dani_slam_tpu_torch.utils import graphs
        fields, cam, caps = mstate.TENSOR_FIELDS, self.cam, self.caps
        nf = len(fields)

        def step(*a):
            st = mstate.MapState(**dict(zip(fields, a[:nf])), caps=caps)
            f = FrameFeatures(*a[nf:nf + 6])
            c = dataclasses.replace(cam, params=a[nf + 6], dist=a[nf + 7])
            R, t, bind, counts, st2 = track_frame_step(
                st, c, f, *a[nf + 8:], **kw)
            return R, t, bind, counts, st2.lm_visible, st2.lm_found

        args = (tuple(getattr(self.st, k) for k in fields) +
                (feat.xy, feat.desc, feat.depth, feat.valid, feat.time,
                 feat.octave_or_zeros(), cam.params, cam.dist,
                 self.last_bind, R_cur, t_cur, Rv, tv, self.ref_kf_dev))
        m = self.matcher
        key = ("track_frame_step", tuple(caps), cam.kind, cam.width,
               cam.height, None if m is None else id(m.model),
               self.min_inliers_track, self.use_depth, has_vel,
               self.seed_rounds)
        R, t, bind, counts, vis, found = graphs.call(key, step, args)
        return R, t, bind, counts, dataclasses.replace(
            self.st, lm_visible=vis, lm_found=found)

    def _defer(self, feat, R_new, t_new, bind, counts, st, vel=None):
        """Pipelined mode: update the state optimistically from device
        references, start the asynchronous copy of the counts, and queue the
        lost/keyframe decision with a rollback snapshot."""
        inert_snap = None
        if self.inertial is not None:
            # the inertial state moves optimistically too (the refinement,
            # the frame's window): a rollback restores it with the pose
            ins = self.inertial
            inert_snap = (ins.v_w, ins.bias_g, ins.bias_a, ins.last_preint,
                          len(ins.frame_windows), ins.prior_info)
        snapshot = (self.R, self.t, self.R_last, self.t_last, self.vel,
                    self.st, self.last_bind, self.last_feat, self.last_time,
                    inert_snap)
        read = AsyncRead(counts)
        self._apply_track(feat, R_new, t_new, bind, st, vel=vel)
        self._pending.append((read, feat, bind, (R_new, t_new), snapshot))

    def _apply_track(self, feat, R_new, t_new, bind, st, vel=None):
        self.st = st
        self.state = OK
        self.frames_lost = 0
        # velocity T_new * T_last^-1 (reference mVelocity); R_new was
        # re-orthonormalized on device so the feedback chain stays on SO(3).
        # The fused frame function computes it itself and passes it in.
        if vel is not None:
            self.vel = vel
        else:
            self.vel = lie.se3_mul(R_new, t_new, *lie.se3_inv(self.R_last,
                                                              self.t_last))
        # world-frame velocity for the inertial chain by finite differences,
        # unless the visual-inertial refinement produced one this frame
        if self.inertial is not None and self.last_time is not None and \
                not self._vi_refined:
            dt = torch.clamp(feat.time - self.last_time, min=1e-3)
            p_new = -torch.einsum('ji,j->i', R_new, t_new)
            p_old = -torch.einsum('ji,j->i', self.R_last, self.t_last)
            self.inertial.v_w = (p_new - p_old) / dt
        self._vi_refined = False
        self.last_time = feat.time
        self.R_last, self.t_last = R_new, t_new
        self.R, self.t = R_new, t_new
        self.last_feat = feat
        self.last_bind = bind

    def _resolve_pending(self, force: bool = False):
        """Take deferred lost/keyframe decisions once their counts have had
        pipeline_depth frames to reach the host (all of them when forced)."""
        while self._pending and (force or
                                 len(self._pending) > self.pipeline_depth):
            read, feat, bind, frame_pose, snapshot = self._pending.pop(0)
            vals = read.get()
            n_track, n, n_ct, n_cf = (int(x) for x in vals[:4])
            if len(vals) > 4:
                # the fused image path: the keyframe-decision scalars rode
                # along, so _need_new_kf reads host copies
                self._host_dyn_ratio = float(vals[4]) / 1000.0
                self._host_n_kf = int(vals[5])
            else:
                # feature path / recovery: cached fused-path values are
                # stale (a lingering high ratio would veto every recovery
                # keyframe, a stale count defeats the capacity veto)
                self._host_dyn_ratio = None
                self._host_n_kf = None
            if n_track < self.min_inliers_track or n < self.min_inliers_map:
                # roll back to before the failed frame, discarding the
                # optimistic updates of the frames after it
                (self.R, self.t, self.R_last, self.t_last, self.vel,
                 self.st, self.last_bind, self.last_feat, self.last_time,
                 inert_snap) = snapshot
                if inert_snap is not None and self.inertial is not None:
                    ins = self.inertial
                    (ins.v_w, ins.bias_g, ins.bias_a, ins.last_preint,
                     n_wins, ins.prior_info) = inert_snap
                    del ins.frame_windows[n_wins:]
                for _ in range(len(self._pending) + 1):
                    if self._traj_dev:
                        self._traj_dev.pop()
                self._pending.clear()
                self.rollbacks += 1
                self._on_lost(feat)
            elif self._need_new_kf(n, n_ct, n_cf):
                if self.pending_chain_corr is not None:
                    cR, ct = self.pending_chain_corr
                    frame_pose = apply_chain_correction(
                        frame_pose[0], frame_pose[1], cR, ct)
                self._create_kf(feat, bind, pose=frame_pose,
                                n_tracked_hint=n)
            self.pending_chain_corr = None

    def _on_lost(self, feat: FrameFeatures | None = None):
        """Count the loss (RECENTLY_LOST, then LOST after 20 frames) and try
        to relocalize the lost frame `feat` (reference: the RECENTLY_LOST
        branch runs Relocalization every frame). On success the tracker
        restarts from the relocalized pose with no velocity, so the next
        frame runs the eager path, and re-anchors on the keyframe that
        relocalized it (one blocking read of its frame id). With an
        initialized IMU a RECENTLY_LOST tracker first coasts: the pose chain
        advances on the IMU prediction (reference src/Tracking.cc:2001-2033),
        and a relocalization drops the marginalized prior."""
        self.frames_lost += 1
        if self.state == OK:
            self.state = RECENTLY_LOST
        elif self.frames_lost > 20:
            self.state = LOST
        if self.state == RECENTLY_LOST and self._imu_ready():
            R_p, t_p, v_p = self._predict_imu()
            self.R, self.t = R_p, t_p
            self.R_last, self.t_last = R_p, t_p
            self.inertial.v_w = v_p
            self.vel = None
        if feat is None or self.reloc_fn is None:
            return
        out = self.reloc_fn(self, feat)
        if out is None:
            return
        R, t, bind, reloc_kf = out
        self.state = OK
        self.frames_lost = 0
        self.relocalizations += 1
        self.R, self.t = R, t
        self.R_last, self.t_last = R, t
        self.vel = None
        self.last_feat = feat
        self.last_bind = bind
        if reloc_kf is not None:
            self.ref_kf = int(reloc_kf)
            self.ref_kf_dev = torch.full((), self.ref_kf, dtype=torch.int64,
                                         device=self.device)
            self.ref_kf_fid = int(pull(self.st.kf_frame_id[self.ref_kf]))
        if self.inertial is not None:
            self.inertial.prior_info = None

    def _need_new_kf(self, n_tracked: int, n_close_tracked: int = 10 ** 9,
                     n_close_free: int = 0) -> bool:
        """Reference: NeedNewKeyFrame c1/c2 + close-point rule, dynamic
        veto (ratio > 0.8) and keyframe-capacity veto. The two vetoes read
        the host copies of the fused image path where there are any, and
        pull the device scalars otherwise."""
        if self.pre_kf_decision is not None:
            self.pre_kf_decision()
        since = self.frame_id - self.last_kf_frame
        if since < self.min_frames_between_kf or n_tracked < 15:
            return False
        th_ct = max(int(0.10 * self.caps.N), 20)
        th_cf = max(int(0.07 * self.caps.N), 14)
        need_close = (self.use_depth and n_close_tracked < th_ct and
                      n_close_free > th_cf)
        c1 = since >= self.max_frames_between_kf
        c2 = (n_tracked < self.kf_tracked_ratio *
              max(self.ref_kf_tracked, 1)) or need_close
        if not (c1 or c2):
            return False
        dyn = self._host_dyn_ratio
        if dyn is None and self.dynamic_ratio is not None:
            dyn = float(pull(self.dynamic_ratio))
        if dyn is not None and dyn > 0.8:
            return False
        n_kf = self._host_n_kf
        if n_kf is None:
            n_kf = int(pull(mstate.num_keyframes(self.st)))
        if n_kf >= self.caps.K:
            return False
        return True

    def _create_kf(self, feat: FrameFeatures, bind, pose=None,
                   n_tracked_hint=None):
        """Record the pending keyframe; the System runs the mapping step.
        `pose` is the tracked pose OF THAT FRAME: in pipelined mode the
        tracker state has advanced past it by the pipeline depth."""
        R_kf, t_kf = pose if pose is not None else (self.R, self.t)
        if n_tracked_hint is not None:
            self.ref_kf_tracked = int(n_tracked_hint)
        self.pending_kf = (feat, bind, R_kf, t_kf)
        self.new_kf = True
        self.last_kf_frame = self.frame_id
