"""One device program per tracked frame: tracking.rgbd_frame_fused captured
as a CUDA graph and replayed once per frame.

The JAX package jits the fused frame function into one program; the PyTorch
counterpart of "one dispatch" is a torch.cuda.CUDAGraph of the same function.
One graph serves one static variant (image shape and dtypes, thresholds,
feature budget, capacities, the models; has_vel=True) for the life of the
process, whichever Tracker asks — as one jitted program serves every System
of a process there.

  * Fixed addresses. MapState is functional, so the tracker holds new
    tensors after every keyframe step, rollback or tracked frame. The graph
    reads the map from buffers it owns; before a replay every field whose
    tensor is not the one last mirrored is copied in (a keyframe step
    changes most of the map, a tracked frame only lm_visible/lm_found).
  * Outputs outlive a replay. The pipeline keeps a frame's features,
    bindings, pose and counts for several frames, so everything returned is
    cloned out of the graph's memory.
  * Per-frame inputs (image, depth, time, last bindings, pose, velocity,
    reference keyframe) and the camera intrinsics are copied into static
    buffers before the replay; nothing inside the capture copies from host
    memory.
  * The window-match kernel is launched through its wrapper during capture,
    which records it (its wrapper's counter ticks once, at capture, when
    nothing ran on the card); each replay then adds the captured launches to
    the counters, so they state what the card ran.

There is no fallback: if capture or replay fails the error propagates.
"""
from __future__ import annotations

import dataclasses

import torch

from dani_slam_tpu_torch.core import state as mstate
from dani_slam_tpu_torch.utils import graphs

_GRAPHS: dict = {}         # static variant -> FrameGraph


def frame_graph(tracker, img, depth_img, depth_factor, threshold, detector,
                n_max: int) -> "FrameGraph":
    """The captured frame program of this static variant, captured on first
    use. The models are part of the key by identity; the graph keeps them
    alive, so an identity is never reused."""
    cam, m = tracker.cam, tracker.matcher
    key = (tracker.device, tuple(img.shape), img.dtype, depth_img.dtype,
           float(depth_factor), float(threshold), n_max, cam.width,
           cam.height, cam.kind, tuple(tracker.caps),
           tracker.min_inliers_track, tracker.seed_rounds,
           id(tracker.sp_params), None if m is None else id(m.model),
           id(detector))
    if key not in _GRAPHS:
        _GRAPHS[key] = FrameGraph(tracker, img, depth_img, depth_factor,
                                  threshold, detector, n_max)
    return _GRAPHS[key]


class FrameGraph:
    """rgbd_frame_fused for one static variant, captured on first use from
    the tracker's current state and the first frame's inputs."""

    def __init__(self, tracker, img, depth_img, depth_factor, threshold,
                 detector, n_max: int):
        from dani_slam_tpu_torch.slam import tracking
        dev = tracker.device
        if dev.type != "cuda":
            raise ValueError(f"a frame graph needs a CUDA device, not {dev}")
        self.img = torch.empty_like(img)
        self.depth = torch.empty_like(depth_img)
        self.time = torch.zeros((), dtype=torch.float32, device=dev)
        self.st = mstate.MapState(
            **{f: torch.empty_like(getattr(tracker.st, f))
               for f in mstate.TENSOR_FIELDS}, caps=tracker.st.caps)
        self._mirrored = dict.fromkeys(mstate.TENSOR_FIELDS)
        self.last_bind = torch.empty_like(tracker.last_bind)
        self.R = torch.empty(3, 3, device=dev)
        self.t = torch.empty(3, device=dev)
        self.Rv = torch.empty(3, 3, device=dev)
        self.tv = torch.empty(3, device=dev)
        self.ref_kf = torch.empty_like(tracker.ref_kf_dev)
        self.cam = dataclasses.replace(
            tracker.cam, params=torch.empty_like(tracker.cam.params),
            dist=torch.empty_like(tracker.cam.dist))
        self._stage(tracker, img, depth_img, self.time)

        cam, sp, matcher = self.cam, tracker.sp_params, tracker.matcher
        self.sp_model, self.matcher, self.detector = sp, matcher, detector
        min_inl, rounds = tracker.min_inliers_track, tracker.seed_rounds

        def program():
            return tracking.rgbd_frame_fused(
                sp, self.img, self.depth, cam, self.time, depth_factor,
                threshold, self.st, self.last_bind, self.R, self.t, self.Rv,
                self.tv, self.ref_kf, n_max=n_max, min_inliers=min_inl,
                has_vel=True, matcher=matcher, detector=detector,
                seed_rounds=rounds)

        # warm-up and capture as utils/graphs does for every graph of the
        # port (the counters as before the capture; each replay adds)
        self.graph, self._out, self._per_replay = graphs.capture(program,
                                                                 dev)

    def _stage(self, tracker, img, depth_img, time):
        self.img.copy_(img)
        self.depth.copy_(depth_img)
        if time is not self.time:
            self.time.copy_(time)
        st = tracker.st
        for f in mstate.TENSOR_FIELDS:
            src = getattr(st, f)
            if src is not self._mirrored[f]:
                getattr(self.st, f).copy_(src)
                self._mirrored[f] = src
        self.last_bind.copy_(tracker.last_bind)
        self.R.copy_(tracker.R)
        self.t.copy_(tracker.t)
        Rv, tv = tracker.vel
        self.Rv.copy_(Rv)
        self.tv.copy_(tv)
        self.ref_kf.copy_(tracker.ref_kf_dev)
        self.cam.params.copy_(tracker.cam.params)
        self.cam.dist.copy_(tracker.cam.dist)

    def replay(self, tracker, img, depth_img, time):
        """Stage the frame's inputs and the tracker's state, replay, and
        return rgbd_frame_fused's tuple as tensors of their own; st2 is the
        tracker's map with the two fields a tracked frame changes."""
        self._stage(tracker, img, depth_img, time)
        self.graph.replay()
        graphs.count_replay(self._per_replay)
        feat, R, t, bind, counts6, st2, vel2, ref_pose, dyn = self._out
        c = torch.clone
        feat = type(feat)(*(None if x is None else c(x) for x in feat))
        st_out = dataclasses.replace(tracker.st,
                                     lm_visible=c(st2.lm_visible),
                                     lm_found=c(st2.lm_found))
        return (feat, c(R), c(t), c(bind), c(counts6), st_out,
                (c(vel2[0]), c(vel2[1])), (c(ref_pose[0]), c(ref_pose[1])),
                c(dyn))
