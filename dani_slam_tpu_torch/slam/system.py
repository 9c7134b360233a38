"""System facade (counterpart of dani_slam_tpu/slam/system.py): construct,
call track_monocular / track_stereo / track_rgbd per frame, save the
trajectory, shutdown.

The port covers the three visual sensors without IMU: monocular (two-view
initialization, the multi-level pyramid, Sim3 loop correction with scale),
rectified stereo (depth from stereo matching, LightGlue when the matcher is
loaded) and RGB-D; plain or pipelined tracking, the LightGlue matcher
(matcher="auto") or descriptor mutual-NN (matcher=None), dynamic-object
masking on the RGB-D path, loop closing with its time-sliced correction and
global BA, relocalization of a lost frame, and an Atlas that stashes the
map on an unrecoverable loss or a timestamp jump, starts a new one, and
welds the new map back into a stored one when place recognition finds the
overlap. Each frame runs the frontend and the tracker (on the RGB-D path in
pipelined mode one captured device program per tracked frame on the card;
monocular and stereo frames run eagerly) and, on a keyframe, the mapping
step inline; the loop closer and the merge run when the keyframe's slot is
read back. Everything runs on `device` ("cuda" by default; asking for CUDA
without it raises).
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.core import state as mstate
from dani_slam_tpu_torch.models import vocab
from dani_slam_tpu_torch.slam import loopclosing as lc
from dani_slam_tpu_torch.slam import mapping, tracking
from dani_slam_tpu_torch.slam.atlas import Atlas
from dani_slam_tpu_torch.slam import frame as frame_mod
from dani_slam_tpu_torch.slam.frame import FrameFeatures
from dani_slam_tpu_torch.utils.device import pull, resolve_device


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
    close points, the reference's stereo / RGB-D policy."""

    def __init__(self, cam: _cam.Camera, sensor: Sensor = Sensor.RGBD,
                 caps: Optional[mstate.MapCaps] = None, sp_params=None,
                 n_features: int = 1024, seed: int = 0,
                 enable_loop_closing: bool = True,
                 enable_relocalization: bool = True,
                 pipelined: bool = False, detector=None, matcher="auto",
                 n_levels: int = 1, scale_factor: float = 1.2,
                 close_depth: Optional[float] = None, device="cuda"):
        mode = {Sensor.MONOCULAR: "mono", Sensor.STEREO: "stereo",
                Sensor.RGBD: "rgbd"}.get(sensor)
        if mode is None:
            raise NotImplementedError(f"{sensor}: the port has no inertial "
                                      "path yet")
        self.device = resolve_device(device)
        # f32 SLAM geometry in full precision (the JAX package sets
        # jax_default_matmul_precision="highest"); bf16 stays only where
        # the learned modules and the window-match kernel cast explicitly
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
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
        self.cull_redundancy = 0.9
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
                     baseline: float):
        """Rectified stereo pair in, T_cw out: SuperPoint on both images as
        one batch, stereo depth (LightGlue when the matcher is loaded,
        descriptor mutual-NN otherwise) -> tracker -> mapping on a keyframe.
        Unrectified input is remapped first with ops/rectify. Returns
        (state, R, t)."""
        feat = frame_mod.build_frame_stereo(
            self._sp(), torch.as_tensor(img_left, device=self.device),
            torch.as_tensor(img_right, device=self.device), self.cam,
            baseline, timestamp, n_max=self.n_features, matcher=self.matcher)
        return self.track_features(feat, timestamp=timestamp)

    def track_rgbd(self, img, depth, timestamp: float,
                   depth_factor: float = 5000.0):
        """RGB-D image pair in (img (H,W,3) uint8, depth (H,W) encoded),
        T_cw out: detector -> frontend -> tracker -> mapping on a keyframe;
        in pipelined steady state the whole frame is one device program.
        Returns (state, R, t)."""
        tr = self.tracker
        tr.sp_params = self._sp()
        self._time_jump_guard(timestamp)
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
                       timestamp: Optional[float] = None):
        """Pre-extracted features in (custom frontends, tests).
        dyn_ratio: device scalar in [0,1], the fraction of the image covered
        by dynamic objects (keyframe veto above 0.8). timestamp: host-side
        frame time for the timestamp-jump guard; no device pull is ever made
        for it."""
        if timestamp is not None:
            self._time_jump_guard(timestamp)
        self.tracker.dynamic_ratio = dyn_ratio
        state, R, t = self.tracker.track(feat)
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
        if self.n_keyframes() >= self.min_kfs_to_stash:
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

    # -- mapping (keyframe-rate) -----------------------------------------

    def _keyframe_step(self):
        """Insert + mapping for the pending keyframe; re-anchors the
        tracker's pose chain onto the BA-refined keyframe pose."""
        tr = self.tracker
        feat, bind, R_kf, t_kf = tr.pending_kf
        tr.pending_kf = None
        self._kf_count += 1
        fid = tr.frame_id - 1
        do_ba = self._kf_count > 1
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
        if self.atlas.n_maps() > 0 or not self.deferred_kf:
            self._resolve_kf_pull()   # a map merge would need host ids now

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

        def verify(st_a, st_b, kf_a, kf_b, gen):
            return lc.verify_cross_map_candidate(st_a, st_b, self.cam, kf_a,
                                                 kf_b, gen,
                                                 fix_scale=self.fix_scale)

        out = self.atlas.try_merge(tr.st, self.cam, tr.ref_kf, qbow,
                                   self._reloc_gen, verify)
        if out is None:
            return
        new_ref, kf_map, lm_map = out["new_active_kf"], out["kf_map"], \
            out["lm_map"]
        if lcl is not None:
            lcl.drop_pending()
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
        correction or global BA is drained, so that the trajectory and the
        map carry the final correction."""
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
