"""System facade (counterpart of dani_slam_tpu/slam/system.py): construct,
call track_monocular / track_stereo / track_rgbd per frame, save the
trajectory, shutdown.

The port covers the three visual sensors: monocular (two-view
initialization, the multi-level pyramid, Sim3 loop correction with scale),
rectified stereo (depth from stereo matching, LightGlue when the matcher is
loaded) and RGB-D, and the three inertial sensors IMU_MONOCULAR,
IMU_STEREO and IMU_RGBD (preintegration between frames, IMU prediction and
the visual-inertial refinement with the marginalized prior, the IMU coast
while recently lost, IMU initialization with the staged full inertial BA,
local inertial BA in place of the visual one once initialized, the
inertial keyframe-culling policy and merge gates; on a monocular map the
initialization also estimates the scale, which a periodic refinement and
full inertial BA keep metric); plain or pipelined
tracking, the LightGlue matcher
(matcher="auto") or descriptor mutual-NN (matcher=None), dynamic-object
masking on the RGB-D path, loop closing with its time-sliced correction and
global BA, relocalization of a lost frame, and an Atlas that stashes the
map on an unrecoverable loss or a timestamp jump, starts a new one, and
welds the new map back into a stored one when place recognition finds the
overlap. Each frame runs the frontend and the tracker (on the RGB-D path in
pipelined mode one captured device program per tracked frame on the card;
monocular, stereo and inertial frames run eagerly) and, on a keyframe, the
mapping step inline; the loop closer and the merge run when the keyframe's
slot is read back. Everything runs on `device` ("cuda" by default; asking
for CUDA without it raises).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.core import lie
from dani_slam_tpu_torch.core import state as mstate
from dani_slam_tpu_torch.models import vocab
from dani_slam_tpu_torch.slam import loopclosing as lc
from dani_slam_tpu_torch.slam import mapping, tracking
from dani_slam_tpu_torch.slam.atlas import Atlas
from dani_slam_tpu_torch.slam import frame as frame_mod
from dani_slam_tpu_torch.slam.frame import FrameFeatures
from dani_slam_tpu_torch.utils import verbose
from dani_slam_tpu_torch.utils.device import (no_tf32, pull, resolve_device,
                                          upload)


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4
    IMU_RGBD = 5


class System:
    """Facade. `sp_params` is a models.superpoint.SuperPoint (the shipped
    weights when None); `detector` a models.yolo.Detector or None; `matcher`
    a models.lightglue.MatcherState, None (descriptor mutual-NN) or "auto"
    (the shipped LightGlue when the descriptor dim is 256, else None);
    `pipelined` defers each frame's lost/keyframe decision by
    tracker.pipeline_depth frames; `enable_loop_closing` and
    `enable_relocalization` are on by default, as in the reference package
    (either one keeps the BoW database; `seed` seeds the loop closer's and
    the relocalization's random draws, and the monocular initialization's);
    `n_levels` and `scale_factor` set the monocular pyramid (the
    reference's mono configurations run 8 levels, RGB-D and stereo 1);
    `close_depth` (metres), when given, makes keyframe culling count only
    close points, the reference's stereo / RGB-D policy. `imu_calib` (IMU
    sensors): an ops.imu.ImuCalib, or any object with its fields
    (core/config's Settings.imu_calib()); the default calibration when
    None."""

    def __init__(self, cam: _cam.Camera, sensor: Sensor = Sensor.RGBD,
                 caps: Optional[mstate.MapCaps] = None, sp_params=None,
                 n_features: int = 1024, seed: int = 0,
                 enable_loop_closing: bool = True,
                 enable_relocalization: bool = True,
                 pipelined: bool = False, detector=None, matcher="auto",
                 n_levels: int = 1, scale_factor: float = 1.2,
                 close_depth: Optional[float] = None, imu_calib=None,
                 device="cuda"):
        mode = {Sensor.MONOCULAR: "mono", Sensor.IMU_MONOCULAR: "mono",
                Sensor.STEREO: "stereo", Sensor.IMU_STEREO: "stereo",
                Sensor.RGBD: "rgbd", Sensor.IMU_RGBD: "rgbd"}[sensor]
        self.device = resolve_device(device)
        no_tf32()
        if cam.device.type != self.device.type:
            raise ValueError(f"camera on {cam.device}, System on "
                             f"{self.device}")
        self.cam = cam
        self.sensor = sensor
        self.caps = caps or mstate.MapCaps()
        self.tracker = tracking.Tracker(cam, self.caps, sensor=mode,
                                        seed=seed, pipelined=pipelined)
        self.sp_params = sp_params
        self.n_features = n_features
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.close_depth = close_depth
        # the monocular map's scale is its own: loops and merges are
        # corrected by a Sim3 with scale there, by a rigid motion otherwise
        self.fix_scale = mode != "mono"
        # cleared by activate_localization_mode: keyframes are then dropped
        self.enable_mapping = True
        self.aux_every = 2
        # keyframe-culling policy by sensor (reference KeyFrameCulling,
        # src/LocalMapping.cc:914-920): redundancy 0.5 for stereo / RGB-D
        # with an IMU, else 0.9; the temporal guards for any inertial map
        self.use_imu = sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO,
                                  Sensor.IMU_RGBD)
        self.cull_redundancy = 0.5 if self.use_imu and mode != "mono" \
            else 0.9
        self.cull_max_kills = 4
        self.fuse_two_hop = 4
        self.ba_iters = 5
        self.ba_iters_pressure = 3
        self._kf_count = 0
        self.merges = 0
        # keyframe (slot, n_tracked) pulls are deferred by kf_pull_depth
        # frames, as in the reference package: the keyframe decision reads
        # ref_kf_tracked, so the deferral is part of the tracking behavior
        self._kf_pulls = []
        self._last_kf_fid = -10 ** 9
        self.kf_pull_depth = 4
        self.deferred_kf = True
        self._last_ts = None
        self.max_time_jump = 1.0
        self.sp_threshold = 0.007
        self.detector = detector
        if isinstance(matcher, str):
            if matcher != "auto":
                raise ValueError(f"matcher={matcher!r}: expected 'auto', "
                                 "None or a MatcherState")
            matcher = None
            if self.caps.D == 256:
                from dani_slam_tpu_torch.models import lightglue as lg
                matcher = lg.load_default_matcher(cam.width, cam.height,
                                                  device=self.device)
        self.matcher = matcher
        self.tracker.matcher = matcher
        self.tracker.pre_kf_decision = (
            lambda: self._resolve_kf_pull(force=False))
        # multi-map Atlas: a new map on unrecoverable loss or a cut stream
        self.atlas = Atlas(self.caps)
        self.lost_frames_before_new_map = 30
        self.min_kfs_to_stash = 5
        # the loop closer owns the BoW database, which relocalization needs
        # too: it exists for either feature, loop detection is gated apart
        self.loop_closer = None
        if enable_loop_closing or enable_relocalization:
            self.loop_closer = lc.LoopCloser(cam, self.caps, seed=seed,
                                             fix_scale=self.fix_scale)
            self.loop_closer.detect_loops = enable_loop_closing
        if enable_relocalization:
            self.tracker.reloc_fn = self._relocalize
        self._reloc_gen = torch.Generator(
            device=self.device).manual_seed(seed + 1)
        # the inertial pipeline (reference: preintegration between frames,
        # src/Tracking.cc:1643; InitializeIMU and its staging,
        # src/LocalMapping.cc:1175, :204-233)
        self.local_inertial_bas = 0     # calls, for the run's report
        self.full_inertial_bas = 0
        self.scale_refinements = 0      # accepted monocular refinements
        if self.use_imu:
            from dani_slam_tpu_torch.ops import imu as imu_ops
            from dani_slam_tpu_torch.slam.inertial import InertialState
            if imu_calib is not None and \
                    not isinstance(imu_calib, imu_ops.ImuCalib):
                imu_calib = imu_ops.calib_from_numpy(imu_calib, self.device)
            self.tracker.inertial = InertialState(imu_calib,
                                                  device=self.device)
            self._kf_window_marks = []   # (slot, frame id, window count)
            self._recent_kfs = []        # temporal keyframe chain
            self._recent_preints = []    # keyframe-to-keyframe preints
            self.vi_window = 10          # Nd (reference Nd = 10)
            # bLarge: strong tracking widens the window and shortens the LM
            # budget (reference: 25 keyframes x 4 iterations when more than
            # 75 matches, src/Optimizer.cc:2387-2392)
            self.vi_window_large = 25
            self.vi_large_tracked = 75
            self._viba_stage = -1        # -1 before init; 0/1/2 done
            self._t_imu_init = None
            self._frame_marks = {}       # frame id -> window count

    # -- frame entry points -----------------------------------------------

    def track_monocular(self, img, timestamp: float):
        """Monocular image in (H,W,3) or (H,W) uint8, T_cw out: frontend
        (the n_levels pyramid) -> tracker -> mapping on a keyframe. Returns
        (state, R, t)."""
        img = torch.as_tensor(img, device=self.device)
        feat = frame_mod.build_frame_mono(
            self._sp(), img, self.cam, timestamp, n_max=self.n_features,
            threshold=self.sp_threshold, n_levels=self.n_levels,
            scale_factor=self.scale_factor)
        return self.track_features(feat, timestamp=timestamp)

    def track_stereo(self, img_left, img_right, timestamp: float,
                     baseline: float, imu_window=None):
        """Rectified stereo pair in, T_cw out: SuperPoint on both images as
        one batch, stereo depth (LightGlue when the matcher is loaded,
        descriptor mutual-NN otherwise) -> tracker -> mapping on a keyframe.
        Unrectified input is remapped first with ops/rectify. imu_window
        (IMU_STEREO): slam/inertial.ImuWindow of the samples since the
        previous frame. Returns (state, R, t)."""
        feat = frame_mod.build_frame_stereo(
            self._sp(), torch.as_tensor(img_left, device=self.device),
            torch.as_tensor(img_right, device=self.device), self.cam,
            baseline, timestamp, n_max=self.n_features, matcher=self.matcher)
        return self.track_features(feat, imu_window=imu_window,
                                   timestamp=timestamp)

    def track_rgbd(self, img, depth, timestamp: float,
                   depth_factor: float = 5000.0, imu_window=None):
        """RGB-D image pair in (img (H,W,3) uint8, depth (H,W) encoded),
        T_cw out: detector -> frontend -> tracker -> mapping on a keyframe;
        in pipelined steady state the whole frame is one device program.
        IMU_RGBD frames take the feature path (the fused frame function
        carries no IMU), with imu_window (slam/inertial.ImuWindow) the
        samples since the previous frame; the JAX package's track_rgbd has
        no such argument, and its IMU_RGBD image path integrates nothing.
        Returns (state, R, t)."""
        tr = self.tracker
        tr.sp_params = self._sp()
        self._time_jump_guard(timestamp)
        if self.use_imu:
            boxes = box_mask = dyn_ratio = None
            img = torch.as_tensor(img, device=self.device)
            if self.detector is not None:
                boxes, box_mask, dyn_ratio = \
                    self.detector.dynamic_mask_inputs(img)
            feat = frame_mod.build_frame_rgbd(
                self._sp(), img, torch.as_tensor(depth, device=self.device),
                self.cam, timestamp, depth_factor=depth_factor,
                n_max=self.n_features, boxes=boxes, box_mask=box_mask)
            return self.track_features(feat, dyn_ratio=dyn_ratio,
                                       imu_window=imu_window)
        img = torch.as_tensor(img, device=self.device)
        depth = torch.as_tensor(depth, device=self.device)
        # a fill on the device: no per-frame copy from pageable host memory
        time = torch.full((), timestamp, dtype=torch.float32,
                          device=self.device)
        state, R, t = tr.track_image_rgbd(
            img, depth, time, depth_factor, self.sp_threshold,
            detector=self.detector, n_max=self.n_features)
        return self._after_track(state, R, t)

    def track_features(self, feat: FrameFeatures, dyn_ratio=None,
                       imu_window=None, timestamp: Optional[float] = None):
        """Pre-extracted features in (custom frontends, tests).
        dyn_ratio: device scalar in [0,1], the fraction of the image covered
        by dynamic objects (keyframe veto above 0.8). imu_window: the IMU
        samples since the previous frame (IMU sensors). timestamp: host-side
        frame time for the timestamp-jump guard; no device pull is ever made
        for it."""
        if timestamp is not None:
            self._time_jump_guard(timestamp)
        tr = self.tracker
        if self.use_imu and imu_window is not None:
            tr.inertial.integrate_frame(imu_window)
        if self.use_imu:
            # each frame's window count, so the keyframes made by the
            # initialization (inside the tracker) get their chain marks
            self._frame_marks[tr.frame_id] = len(tr.inertial.frame_windows)
            while len(self._frame_marks) > 30:
                self._frame_marks.pop(next(iter(self._frame_marks)))
        tr.dynamic_ratio = dyn_ratio
        state, R, t = tr.track(feat)
        if self.use_imu and tr.init_kfs:
            for (slot, fid) in tr.init_kfs:
                self._kf_window_marks.append(
                    (slot, fid, self._frame_marks.get(fid, 0)))
            tr.init_kfs = None
        return self._after_track(state, R, t)

    def _time_jump_guard(self, timestamp: float):
        """A gap of more than max_time_jump seconds or a backwards step
        means the stream was cut: stash the map and start a fresh one."""
        if self._last_ts is not None and (
                timestamp > self._last_ts + self.max_time_jump or
                timestamp < self._last_ts):
            if self.tracker.state != tracking.NOT_INITIALIZED:
                self._resolve_kf_pull()
                self._new_map_in_atlas()
        self._last_ts = timestamp

    def _after_track(self, state, R, t):
        tr = self.tracker
        if tr.pending_kf is not None and self.enable_mapping:
            self._resolve_kf_pull(force=False)
            self._keyframe_step()
        if state == tracking.LOST and \
                tr.frames_lost > self.lost_frames_before_new_map:
            self._new_map_in_atlas()
        return state, R, t

    def _new_map_in_atlas(self):
        """Unrecoverable loss: stash the current map (with its BoW rows) if
        it is substantial (>= min_kfs_to_stash keyframes) and start a fresh
        one; the loop closer forgets everything of the old map."""
        self._resolve_kf_pull()   # stale pulls reference the OLD map
        tr = self.tracker
        lcl = self.loop_closer
        n_kf = self.n_keyframes()
        verbose.print_mess(
            f"Atlas: unrecoverable loss at frame {tr.frame_id} — starting a "
            f"new map ({n_kf} KFs in the old one)")
        if n_kf >= self.min_kfs_to_stash:
            self.atlas.stash(tr.st, bow=lcl.bow if lcl is not None else None)
        frame_id = tr.frame_id
        tr.reset()
        tr.frame_id = frame_id
        self._last_ts = None
        if lcl is not None:
            lcl.drop_pending()
            lcl.bow = torch.zeros_like(lcl.bow)
            lcl.last_loop_kf = -10 ** 9
        self._kf_count = 0
        if self.use_imu:
            self._kf_window_marks = []
            self._recent_kfs = []
            self._recent_preints = []
            self._viba_stage = -1
            self._t_imu_init = None
            self._frame_marks = {}

    # -- mapping (keyframe-rate) -----------------------------------------

    def _keyframe_step(self):
        """Insert + mapping for the pending keyframe; re-anchors the
        tracker's pose chain onto the BA-refined keyframe pose."""
        tr = self.tracker
        feat, bind, R_kf, t_kf = tr.pending_kf
        tr.pending_kf = None
        self._kf_count += 1
        fid = tr.frame_id - 1
        # once the IMU is initialized the local inertial BA replaces the
        # visual one (reference src/LocalMapping.cc:150-151)
        imu_ready = self.use_imu and tr.inertial.initialized
        do_ba = self._kf_count > 1 and not imu_ready
        do_aux = self._kf_count % self.aux_every == 0 or self._kf_count <= 2
        two_hop = (self.fuse_two_hop
                   if (self._kf_count % (2 * self.aux_every) == 0
                       or self._kf_count <= 2) else 0)
        ba_iters = (self.ba_iters_pressure
                    if (fid - self._last_kf_fid) <= 4 else self.ba_iters)
        self._last_kf_fid = fid
        st, k, n_tracked, chain = mapping.keyframe_step(
            tr.st, self.cam, feat.xy, feat.valid, feat.desc, feat.depth,
            bind, R_kf, t_kf, feat.time, fid, use_depth=tr.use_depth,
            do_ba=do_ba, do_aux=do_aux, max_depth=40.0,
            feat_octave=feat.octave_or_zeros(), matcher=self.matcher,
            chain=(tr.R, tr.t, tr.R_last, tr.t_last), ba_iters=ba_iters,
            cull_redundancy=self.cull_redundancy,
            cull_inertial=self.use_imu,
            cull_max_kills=self.cull_max_kills,
            cull_close_only=self.close_depth is not None,
            cull_close_depth=(self.close_depth
                              if self.close_depth is not None else 3.0),
            fuse_two_hop=two_hop)
        tr.st = st
        tr.ref_kf_dev = k
        tr.R, tr.t, tr.R_last, tr.t_last, cR, ct = chain
        self._correct_pending_chain(cR, ct)
        tr.ref_kf_fid = fid
        self._kf_pulls.append((k, n_tracked, self._kf_count, tr.frame_id))
        if self.use_imu or self.atlas.n_maps() > 0 or not self.deferred_kf:
            # the inertial chain and a map merge need host slots now
            self._resolve_kf_pull()
        if self.use_imu:
            # (slot, frame id, window count) at insertion: the frame id
            # tells a reused slot apart, the window count pairs the
            # preintegration spans with this keyframe chain
            self._kf_window_marks.append(
                (tr.ref_kf, fid, len(tr.inertial.frame_windows)))
            self._maybe_initialize_imu()
            self._record_kf_preint()
            if tr.inertial.initialized:
                self._run_local_inertial_ba()

    def _correct_pending_chain(self, cR, ct):
        """Apply a map-frame pose correction to the in-flight pipeline:
        pending rollback snapshots and deferred keyframe poses must receive
        the same correction as the tracker chain, or a rollback would undo
        the re-anchoring."""
        tr = self.tracker
        fix = tracking.apply_chain_correction
        fixed = []
        for (read, pfeat, pbind, fpose, snap) in tr._pending:
            sR, st_, sRl, stl = snap[:4]
            fixed.append((read, pfeat, pbind, fix(*fpose, cR, ct),
                          fix(sR, st_, cR, ct) + fix(sRl, stl, cR, ct) +
                          tuple(snap[4:])))
        tr._pending = fixed

    def _resolve_kf_pull(self, force: bool = True):
        """Pull deferred keyframe ids once they are kf_pull_depth frames
        old (all of them when forced); only the newest keyframe updates the
        tracker's reference bookkeeping. Each pulled keyframe then runs the
        keyframe-rate hooks that need its host slot: the loop closer (whose
        weld may move the map under the tracker: the correction goes onto
        the pose chain, the in-flight pipeline and a pending keyframe) and
        the map merge."""
        tr = self.tracker
        while self._kf_pulls:
            k, n_tracked, kf_count, disp_fid = self._kf_pulls[0]
            if not force and tr.frame_id - disp_fid <= self.kf_pull_depth:
                break
            self._kf_pulls.pop(0)
            k_host, n_host = pull(torch.stack([k.to(torch.int64),
                                               n_tracked.to(torch.int64)]))
            if kf_count == self._kf_count:
                tr.ref_kf = int(k_host)
                tr.ref_kf_tracked = int(n_host)
            lcl = self.loop_closer
            if lcl is not None:
                tr.st = lcl.on_keyframe(tr.st, int(k_host),
                                        kf_count=kf_count, kf_dev=k,
                                        chain_ref=tr.ref_kf_dev)
                if lcl.chain_corr is not None:
                    cR, ct = lcl.chain_corr
                    self._apply_chain_corr(cR, ct)
                    # a keyframe awaiting its mapping step goes in at the
                    # post-weld pose, and the frame pose popped by an
                    # in-flight keyframe decision receives it as well
                    if tr.pending_kf is not None:
                        pfeat, pbind, pR, pt = tr.pending_kf
                        tr.pending_kf = (pfeat, pbind) + \
                            tracking.apply_chain_correction(pR, pt, cR, ct)
                    tr.pending_chain_corr = (cR, ct)
                    lcl.chain_corr = None
            if self.atlas.n_maps() > 0:
                self._try_map_merge()

    def _apply_chain_corr(self, cR, ct):
        """A weld moved the map: right-compose its correction onto the
        tracker's pose chain and the in-flight pipeline."""
        tr = self.tracker
        tr.R, tr.t = tracking.apply_chain_correction(tr.R, tr.t, cR, ct)
        tr.R_last, tr.t_last = tracking.apply_chain_correction(
            tr.R_last, tr.t_last, cR, ct)
        self._correct_pending_chain(cR, ct)

    # -- the inertial chain (keyframe-rate) -------------------------------

    def _record_kf_preint(self):
        """Preintegrate the span since the previous keyframe and extend the
        temporal keyframe chain of the local inertial BA."""
        tr = self.tracker
        marks = self._kf_window_marks
        pre = None
        if len(marks) >= 2:
            pre = tr.inertial.kf_chain_preintegrations(
                [(marks[-2][2], marks[-1][2])])[0]
        self._recent_kfs.append((marks[-1][0], marks[-1][1]))
        self._recent_preints.append(pre)
        if len(self._recent_kfs) > max(self.vi_window, self.vi_window_large):
            self._recent_kfs.pop(0)
            self._recent_preints.pop(0)

    def _refine_imu_scale(self):
        """Re-estimate scale and gravity over the recent keyframe chain and
        apply them to the map and the tracker (the monocular scale-drift
        correction; reference ScaleRefinement). The chain is the recorded
        (slot, preintegration) one, cut to its contiguous trailing run of
        keyframes that are still alive (a slot holding the same frame id:
        slots are reused), so that no preintegration pairs with the wrong
        span; one counted read of the slots' masks and frame ids."""
        from dani_slam_tpu_torch.slam import inertial as inert
        tr = self.tracker
        st = tr.st
        kf_mask, kf_fid = pull(torch.stack([st.kf_mask.to(torch.int64),
                                            st.kf_frame_id.to(torch.int64)]))
        chain = []
        for (k, fid), p in zip(reversed(self._recent_kfs),
                               reversed(self._recent_preints)):
            if not (kf_mask[k] and kf_fid[k] == fid) or (chain and p is None):
                break
            chain.append((k, p))
            if len(chain) > self.vi_window:
                break
        chain.reverse()
        if len(chain) < 4:
            return
        preints = [p for _, p in chain][1:]
        if any(p is None for p in preints):
            return
        was_init = tr.inertial.initialized
        st2, ok = inert.initialize_imu(st, tr.inertial,
                                       [k for k, _ in chain], preints,
                                       mono_scale_free=True)
        if ok:
            tr.st = st2
            Rg, s_scl = tr.inertial.last_alignment
            tr.R, tr.t = tr.R @ Rg.T, s_scl * tr.t
            tr.R_last, tr.t_last = tr.R_last @ Rg.T, s_scl * tr.t_last
            if tr.vel is not None:
                tr.vel = (tr.vel[0], s_scl * tr.vel[1])
            self.scale_refinements += 1
        tr.inertial.initialized = was_init or ok

    def _padded_chain(self, slots, preints, P):
        """(slot_arr [P], valid [P], stacked Preintegrated [P-1],
        edge_ok [P-1]) of a chain padded in front to P slots; `preints`
        pairs with slots[1:] when one shorter, else with every slot (the
        first entry then belongs to the span before the window)."""
        from dani_slam_tpu_torch.ops import imu as imu_ops
        pad = P - len(slots)
        dev = self.device
        slot_arr = upload(np.asarray([slots[0]] * pad + slots, np.int64),
                          dev)
        valid = upload(np.asarray([False] * pad + [True] * len(slots)), dev)
        ident = imu_ops.identity_preintegration(dev)
        spans = [None] * pad + list(preints)
        spans = spans[len(spans) - (P - 1):]
        stacked = imu_ops.stack_preints([p if p is not None else ident
                                         for p in spans])
        edge_ok = upload(np.asarray([p is not None for p in spans]), dev)
        return slot_arr, valid, stacked, edge_ok

    def _run_local_inertial_ba(self):
        """Temporal-window VI BA (reference LocalInertialBA in place of the
        visual local BA once the IMU is initialized)."""
        from dani_slam_tpu_torch.slam import inertial_mapping
        tr = self.tracker
        # bLarge only once a full large window exists
        large = (tr.ref_kf_tracked > self.vi_large_tracked and
                 len(self._recent_kfs) >= self.vi_window_large)
        P = self.vi_window_large if large else self.vi_window
        slots = [k for k, _ in self._recent_kfs[-P:]]
        if len(slots) < 3:
            return
        slot_arr, valid, stacked, edge_ok = self._padded_chain(
            slots, self._recent_preints[-P:], P)
        tr.st = inertial_mapping.local_inertial_ba(
            tr.st, self.cam, slot_arr, valid, stacked, edge_ok,
            tr.inertial.calib, iters=4 if large else 6)
        self.local_inertial_bas += 1

    def _maybe_initialize_imu(self):
        """IMU initialization once enough keyframes exist (reference
        src/LocalMapping.cc:183-189), then the staged whole-map VI BA:
        VIBA1 more than 5 s after the initialization with priors (1, 1e5),
        VIBA2 after 15 s with none (src/LocalMapping.cc:204-233). The
        keyframe times are read back (counted), as the reference package
        reads them."""
        from dani_slam_tpu_torch.slam import inertial as inert
        tr = self.tracker
        if tr.inertial.initialized:
            now = float(pull(tr.st.kf_time[tr.ref_kf]))
            elapsed = now - (self._t_imu_init or now)
            one = torch.ones((), dtype=torch.bool, device=self.device)
            if self._viba_stage == 0 and elapsed > 5.0:
                self._run_full_inertial_ba(1.0, 1e5)
                tr.st = dataclasses.replace(tr.st, imu_ba1=one)
                self._viba_stage = 1
            elif self._viba_stage == 1 and elapsed > 15.0:
                self._run_full_inertial_ba(0.0, 0.0)
                tr.st = dataclasses.replace(tr.st, imu_ba2=one)
                self._viba_stage = 2
            if tr.sensor == "mono" and len(self._kf_window_marks) % 3 == 0:
                self._refine_imu_scale()
                # mono triangulation drifts the scale segment by segment: a
                # whole-chain VI BA on every ninth mark spreads the rescale
                if len(self._kf_window_marks) % 9 == 0:
                    self._run_full_inertial_ba(1.0, 1e5, iters=6)
            return
        if len(self._kf_window_marks) < 5:
            return
        # marks whose keyframes are still alive: the windows between
        # consecutive alive marks merge the spans of culled keyframes
        run = self._alive_chain()
        if len(run) < 5:
            return
        bounds = [(a[2], b[2]) for a, b in zip(run[:-1], run[1:])]
        preints = tr.inertial.kf_chain_preintegrations(bounds)
        kf_ids = [slot for slot, _, _ in run]
        st2, ok = inert.initialize_imu(tr.st, tr.inertial, kf_ids, preints,
                                       mono_scale_free=tr.sensor == "mono")
        if not ok:
            return
        tr.st = dataclasses.replace(
            st2, imu_initialized=torch.ones((), dtype=torch.bool,
                                            device=self.device))
        # the tracker's poses live in the old world frame: apply the
        # gravity rotation and scale the map received
        Rg, s_scl = tr.inertial.last_alignment
        tr.R, tr.t = tr.R @ Rg.T, s_scl * tr.t
        tr.R_last, tr.t_last = tr.R_last @ Rg.T, s_scl * tr.t_last
        if tr.vel is not None:
            tr.vel = (tr.vel[0], s_scl * tr.vel[1])
        # stage 0: FullInertialBA with the strong initialization priors
        self._t_imu_init = float(pull(tr.st.kf_time[kf_ids[-1]]))
        self._viba_stage = 0
        self._run_full_inertial_ba(1e2, 1e10)

    def _alive_chain(self):
        """The recorded keyframe marks whose slot still holds the same
        keyframe (frame-id match: slots are reused), in temporal order; one
        counted read of the slots' masks and frame ids."""
        st = self.tracker.st
        mask, fids = pull(torch.stack([st.kf_mask.to(torch.int64),
                                       st.kf_frame_id.to(torch.int64)]))
        return [(s_, f, m) for (s_, f, m) in self._kf_window_marks
                if mask[s_] and fids[s_] == f]

    def _run_full_inertial_ba(self, prior_g: float, prior_a: float,
                              iters: int = 8):
        """Whole-map VI BA over the alive keyframe chain (padded to a
        power of two, at least 8); the newest keyframe's correction is
        carried onto the tracker's poses and its velocity and biases become
        the tracker's."""
        from dani_slam_tpu_torch.slam import inertial_mapping
        tr = self.tracker
        chain = self._alive_chain()
        if len(chain) < 4:
            return
        bounds = [(a[2], b[2]) for a, b in zip(chain[:-1], chain[1:])]
        preints = tr.inertial.kf_chain_preintegrations(bounds)
        slots = [s_ for s_, _, _ in chain]
        P_pad = 8
        while P_pad < len(slots):
            P_pad *= 2
        P_pad = min(P_pad, self.caps.K)
        if len(slots) > P_pad:
            drop = len(slots) - P_pad
            slots, preints = slots[drop:], preints[drop:]
        slot_arr, valid, stacked, edge_ok = self._padded_chain(
            slots, [None] + list(preints), P_pad)
        k_new = slots[-1]
        R_old, t_old = tr.st.kf_R[k_new], tr.st.kf_t[k_new]
        tr.st = inertial_mapping.full_inertial_ba_map(
            tr.st, self.cam, slot_arr, valid, stacked, edge_ok,
            tr.inertial.calib, prior_g=prior_g, prior_a=prior_a, iters=iters)
        self.full_inertial_bas += 1
        R_new, t_new = tr.st.kf_R[k_new], tr.st.kf_t[k_new]
        inv_old = lie.se3_inv(R_old, t_old)
        tr.R, tr.t = lie.se3_mul(*lie.se3_mul(tr.R, tr.t, *inv_old), R_new,
                                 t_new)
        tr.R_last, tr.t_last = lie.se3_mul(
            *lie.se3_mul(tr.R_last, tr.t_last, *inv_old), R_new, t_new)
        tr.inertial.v_w = tr.st.kf_vel[k_new]
        tr.inertial.bias_g = tr.st.kf_bias_g[k_new]
        tr.inertial.bias_a = tr.st.kf_bias_a[k_new]

    def _try_map_merge(self):
        """Weld the active map into a stored one when place recognition
        finds the overlap (reference: the LoopClosing merge branch ->
        MergeLocal): the Atlas verifies with verify_cross_map_candidate and
        merges, then the weld fuses duplicate landmarks (search_and_fuse),
        refines the weld window with a local BA (the landmark-block kernel)
        and moves the BoW rows to the merged slots."""
        tr = self.tracker
        lcl = self.loop_closer
        qbow = lcl.bow[tr.ref_kf] if lcl is not None else None

        imu_on = imu_ba1 = False
        if self.use_imu:
            imu_on, imu_ba1 = (bool(x) for x in pull(torch.stack([
                tr.st.imu_initialized, tr.st.imu_ba1])))
            imu_ba1 = imu_on and imu_ba1

        def verify(st_a, st_b, kf_a, kf_b, gen):
            T12, n, ok = lc.verify_cross_map_candidate(
                st_a, st_b, self.cam, kf_a, kf_b, gen,
                fix_scale=self.fix_scale)
            # inertial merge gates (reference src/LoopClosing.cc:145-178):
            # a scale outside (0.9, 1.1) is refused; after VIBA1 the
            # relative rotation is clamped to its yaw (gravity is shared)
            if imu_on and bool(pull(ok)):
                R12, t12, s12 = T12
                if not 0.90 < float(pull(s12)) < 1.1:
                    return T12, n, False
                if imu_ba1:
                    yaw = float(pull(lie.so3_log(R12))[2])
                    zero = torch.zeros((), device=self.device)
                    R_yaw = lie.so3_exp(torch.stack([
                        zero, zero, torch.full((), yaw, device=self.device)]))
                    T12 = (R_yaw, t12, torch.ones((), device=self.device))
            return T12, n, ok

        out = self.atlas.try_merge(tr.st, self.cam, tr.ref_kf, qbow,
                                   self._reloc_gen, verify)
        if out is None:
            return
        new_ref, kf_map, lm_map = out["new_active_kf"], out["kf_map"], \
            out["lm_map"]
        if lcl is not None:
            lcl.drop_pending()
        verbose.print_mess("Atlas: merged active map into a stored map")
        self.merges += 1
        tr.st = out["st"]
        tr.ref_kf = new_ref
        tr.ref_kf_fid = int(pull(tr.st.kf_frame_id[new_ref]))
        tr.ref_kf_dev = torch.full((), new_ref, dtype=torch.int64,
                                   device=self.device)
        if tr.last_bind is not None:
            lb = tr.last_bind
            tr.last_bind = torch.where(
                lb >= 0, lm_map[torch.clamp(lb, min=0).long()].to(lb.dtype),
                torch.full_like(lb, -1))
        tr.st = lc.search_and_fuse(tr.st, self.cam, new_ref, out["cand_kf"])
        tr.st = mapping.local_bundle_adjustment(tr.st, self.cam,
                                                tr.ref_kf_dev)
        # an inertial map re-welds velocities and biases over the temporal
        # window (reference MergeInertialBA, src/Optimizer.cc:3948)
        if self.use_imu and tr.inertial.initialized:
            self._run_local_inertial_ba()
        if lcl is not None:
            # the stored map's rows stay at their slots, the moved rows go
            # to theirs (written from the destination side)
            K = self.caps.K
            base = out.get("stored_bow")
            if base is None:
                base = torch.zeros_like(lcl.bow)
            dst = torch.where(kf_map >= 0, kf_map.long(),
                              torch.full_like(kf_map, K, dtype=torch.long))
            src = torch.full((K + 1,), -1, dtype=torch.long,
                             device=self.device)
            src = src.scatter(0, dst, torch.arange(K, device=self.device))
            src = src[:K]
            lcl.bow = torch.where((src >= 0)[:, None],
                                  lcl.bow[torch.clamp(src, min=0)], base)
        if self.use_imu:
            # the inertial bookkeeping follows the moved keyframes
            kf_map_h = pull(kf_map)
            self._kf_window_marks = [
                (int(kf_map_h[s_]), f, m)
                for (s_, f, m) in self._kf_window_marks if kf_map_h[s_] >= 0]
            kept = [((int(kf_map_h[s_]), f), p)
                    for (s_, f), p in zip(self._recent_kfs,
                                          self._recent_preints)
                    if kf_map_h[s_] >= 0]
            self._recent_kfs = [k for k, _ in kept]
            self._recent_preints = [p for _, p in kept]

    def _relocalize(self, tracker, feat: FrameFeatures):
        """Relocalization of a lost frame (reference:
        Tracking::Relocalization): BoW candidates from the database, then
        per candidate in rank order matching (LightGlue or mutual NN), PnP
        RANSAC and the widening refinement; the first accepted candidate
        wins. Returns (R, t, bind, keyframe slot) or None."""
        lcl = self.loop_closer
        if lcl is None or self.n_keyframes() < 2:
            return None
        self._resolve_kf_pull()   # score against the full database
        cb = lcl.codebook
        qbow = vocab.bow_vector(vocab.quantize(feat.desc, feat.valid, cb),
                                cb.shape[0])
        idx, _, keep = vocab.detect_reloc_candidates(
            lcl.bow, tracker.st.kf_mask, qbow, covis=tracker.st.covis,
            n_best=3)
        idx_h, keep_h = pull(torch.stack([idx.long(), keep.long()]))
        for rank in range(3):
            if not keep_h[rank]:
                continue
            kf = int(idx_h[rank])
            if self.matcher is not None:
                R, t, bind, _, ok = lc.relocalize_against_kf_lightglue(
                    tracker.st, self.cam, kf, feat.xy, feat.desc,
                    feat.valid, self._reloc_gen, self.matcher)
            else:
                R, t, bind, _, ok = lc.relocalize_against_kf(
                    tracker.st, self.cam, kf, feat.xy, feat.desc,
                    feat.valid, self._reloc_gen)
            if bool(pull(ok)):
                return R, t, bind, kf
        return None

    # -- misc public API --------------------------------------------------

    @property
    def map_state(self) -> mstate.MapState:
        return self.tracker.st

    def n_keyframes(self) -> int:
        return int(pull(mstate.num_keyframes(self.tracker.st)))

    def n_landmarks(self) -> int:
        return int(pull(mstate.num_landmarks(self.tracker.st)))

    def shutdown(self):
        """Resolve everything in flight; a pending time-sliced loop
        correction or global BA is drained, so that the map carries the
        final correction and the tracker's pose chain every weld's
        correction (composed by the loop closer, in weld order)."""
        self._resolve_kf_pull()
        self.tracker.flush()
        if self.tracker.pending_kf is not None and self.enable_mapping:
            self._keyframe_step()
        self._resolve_kf_pull()
        lcl = self.loop_closer
        if lcl is not None:
            tr = self.tracker
            tr.st = lcl.finish_gba(tr.st, tr.ref_kf_dev)
            if lcl.chain_corr is not None:
                self._apply_chain_corr(*lcl.chain_corr)
                lcl.chain_corr = None

    def activate_localization_mode(self):
        """Track against the existing map without extending it (mapping
        steps are skipped; outside the mapped region the tracker falls back
        to visual odometry on the last frame's depth points)."""
        self.enable_mapping = False
        self.tracker.localization_vo = True

    def deactivate_localization_mode(self):
        """Resume full SLAM."""
        self.enable_mapping = True
        self.tracker.localization_vo = False
        self.tracker.pending_kf = None   # drop any stale pending keyframe

    def save_trajectory_tum(self, path: str):
        """TUM format: time tx ty tz qx qy qz qw of T_wc, every tracked
        frame."""
        from dani_slam_tpu_torch.utils import io as io_utils
        io_utils.save_trajectory_tum(path, self.tracker.trajectory)

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe poses only, in time order, TUM format (reference:
        SaveKeyFrameTrajectoryTUM src/System.cc:639)."""
        from dani_slam_tpu_torch.utils import io as io_utils
        st = self.tracker.st
        mask, times, R, t = (pull(x) for x in (st.kf_mask, st.kf_time,
                                               st.kf_R, st.kf_t))
        ids = np.nonzero(mask)[0]
        order = ids[np.argsort(times[ids], kind="stable")]
        io_utils.save_trajectory_tum(
            path, [(float(times[k]), R[k], t[k]) for k in order])

    def save_atlas(self, path: str):
        """Write the active map and the place-recognition database, with the
        codebook's checksum (reference: System::SaveAtlas
        src/System.cc:1413)."""
        from dani_slam_tpu_torch.utils import checkpoint
        lcl = self.loop_closer
        checkpoint.save_map(path, self.tracker.st,
                            codebook=lcl.codebook if lcl else None,
                            bow=lcl.bow if lcl else None)

    def load_atlas(self, path: str):
        """Load a map saved by save_atlas (or by the JAX package's), checking
        the codebook checksum (reference: LoadAtlas and its vocabulary
        gate, src/System.cc:1455-1516); tracking resumes through
        relocalization against it."""
        from dani_slam_tpu_torch.utils import checkpoint
        lcl = self.loop_closer
        st, extras = checkpoint.load_map(
            path, expect_codebook=lcl.codebook if lcl else None,
            device=self.device)
        if st.caps != self.caps:
            raise ValueError(f"map capacities {tuple(st.caps)} differ from "
                             f"this System's {tuple(self.caps)}")
        tr = self.tracker
        tr.st = st
        if lcl is not None and "bow" in extras:
            lcl.bow = extras["bow"]
        tr.state = tracking.RECENTLY_LOST
        tr.frames_lost = 1
        tr.last_bind = torch.full((self.caps.N,), -1, dtype=torch.int32,
                                  device=self.device)

    def _sp(self):
        if self.sp_params is None:
            from dani_slam_tpu_torch.models import superpoint
            self.sp_params = superpoint.load_default_params(self.device)
        return self.sp_params
