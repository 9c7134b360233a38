"""The whole slice: a synthetic RGB-D image sequence (detector on, SuperPoint
frontend, tracking, mapping with local BA) through the JAX package's System
and the port's System(device="cpu"), in two configurations: non-pipelined
with the descriptor mutual-NN matcher, and bench.py's own — pipelined with
the LightGlue matcher (matcher="auto").

Sizes: `short` (4 frames at 320x240, small caps), `short-pipelined` (12
frames of the same motion, so that deferred decisions resolve and a keyframe
is made from a popped pose) and `bench` / `bench-pipelined` (bench.py's
60-frame 640x480 sequence at the default caps; marked slow), and
localization mode; the same with bench.py's official-scale nets in
tests/test_torch_official_slice.py. tests/test_torch_pipeline.py holds pipelined against
non-pipelined inside the port and the forced loss with its rollback and
Atlas stash.

The two frontends round their bf16 convolutions at different places, so a
few percent of the keypoints differ and the trajectories drift apart
slowly; the port on the CPU also takes the TPU kernels' arithmetic
(squared bf16 window distances), where the JAX package on the CPU takes its
f32 branch. Tolerances: equal tracked-frame counts, keyframe counts within
1, landmark counts within 10 % (13.2 % for `bench-pipelined`, the JAX
package's own spread, see CONFIGS), per-frame camera centres within 5 cm
(short; the camera moves 27 cm per frame) or 10 cm (bench, 3.5 m of path,
where both runs reach an ATE near 0.2 m), and the port's ATE no worse than
the JAX run's by more than that tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dani_slam_tpu.core import cameras as jcam
from dani_slam_tpu.core import state as jst
from dani_slam_tpu.models import superpoint as jsp
from dani_slam_tpu.models import yolo as jyolo
from dani_slam_tpu.slam.system import Sensor as JSensor
from dani_slam_tpu.slam.system import System as JSystem
from dani_slam_tpu_torch.core import cameras as tcam
from dani_slam_tpu_torch.core import state as tst
from dani_slam_tpu_torch.models import yolo as tyolo
from dani_slam_tpu_torch.slam.system import Sensor as TSensor
from dani_slam_tpu_torch.slam.system import System as TSystem
from dani_slam_tpu_torch.utils import eval as ev
from dani_slam_tpu_torch.utils import synthetic

# the tier-1 run has several workers on one machine: a few intra-op threads
# each keep them from oversubscribing it
torch.set_num_threads(2)

CONFIGS = {
    # about four times the bench's angular rate, so that four frames make
    # two mapped keyframes and the second one runs local BA; the scene is
    # that of an 8-frame sequence (its texture is sampled along the whole
    # trajectory), of which the first four frames are run
    "short": dict(W=320, H=240, F=300.0, n_scene=8, n_run=4,
                  span=0.0267 * 7, caps=dict(K=32, L=4096, N=256, D=256),
                  n_features=256, min_kf=3, centre_tol=0.05),
    "bench": dict(W=640, H=480, F=500.0, n_scene=60, n_run=60, span=0.35,
                  caps={}, n_features=1024, min_kf=5, centre_tol=0.1),
}
# bench.py's configuration: LightGlue matcher, pipelined tracking
PIPELINED = dict(matcher="auto", pipelined=True)
CONFIGS["short-pipelined"] = dict(CONFIGS["short"], n_scene=12, n_run=12,
                                  span=0.0267 * 11, min_kf=2, **PIPELINED)
# At bench size the pipelined configuration makes bursts of keyframes (the
# decisions of the frames in flight behind a new keyframe still see the map
# without it), and its landmark count is sensitive to rounding. Held to the
# JAX package's own spread: on its frames with every keypoint moved by
# N(0, 1e-3) px (`spread`, seeds 1-6) it makes 1640-2134 landmarks against
# its 1886, at most 248 = 13.1 % away; on the same frames every keyframe
# step of the port lands within 5 slots of the JAX package's (`steps`).
# The port reads 1724 (16 keyframes) here, the JAX package 1886 (15).
CONFIGS["bench-pipelined"] = dict(CONFIGS["bench"], lm_tol=0.132,
                                  **PIPELINED)
# bench.py's official pass: the reference-scale nets (LightGlue 256x9 as the
# matcher, yolov5s as the detector) in the pipelined configuration; held in
# tests/test_torch_official_slice.py
CONFIGS["short-official"] = dict(CONFIGS["short-pipelined"], official=True)
CONFIGS["bench-official"] = dict(CONFIGS["bench-pipelined"], official=True)


def _centres(traj):
    return np.stack([-R.T @ t for _, R, t in traj])


def _systems(c):
    """(JAX System, port System on the CPU) in configuration c."""
    W, H, F = c["W"], c["H"], c["F"]
    pipelined = c.get("pipelined", False)
    if c.get("official"):
        from dani_slam_tpu.models import lightglue_official as jlo
        from dani_slam_tpu.models import yolo_official as jyo
        from dani_slam_tpu_torch.models import lightglue_official as tlo
        from dani_slam_tpu_torch.models import yolo_official as tyo
        jdet, jmatch = jyo.load_official_detector(), \
            jlo.load_official_matcher(W, H)
        tdet, tmatch = tyo.load_official_detector("cpu"), \
            tlo.load_official_matcher(W, H, device="cpu")
    else:
        jdet, jmatch = jyolo.load_default_detector(), c.get("matcher")
        tdet, tmatch = tyolo.load_default_detector("cpu"), c.get("matcher")
    js = JSystem(jcam.Camera.pinhole(F, F, W / 2, H / 2, W, H),
                 JSensor.RGBD, caps=jst.MapCaps(**c["caps"]),
                 sp_params=jsp.load_default_params(),
                 n_features=c["n_features"], detector=jdet,
                 enable_loop_closing=False, enable_relocalization=False,
                 matcher=jmatch, pipelined=pipelined)
    ts = TSystem(tcam.Camera.pinhole(F, F, W / 2, H / 2, W, H, device="cpu"),
                 TSensor.RGBD, caps=tst.MapCaps(**c["caps"]),
                 n_features=c["n_features"], detector=tdet,
                 enable_loop_closing=False, enable_relocalization=False,
                 device="cpu", matcher=tmatch, pipelined=pipelined)
    js.sp_threshold = ts.sp_threshold = 0.012          # as bench.py
    return js, ts


@pytest.fixture(scope="module", params=[
    "short", "short-pipelined",
    pytest.param("bench", marks=pytest.mark.slow),
    pytest.param("bench-pipelined", marks=pytest.mark.slow)])
def runs(request):
    c = CONFIGS[request.param]
    W, H, F = c["W"], c["H"], c["F"]
    R_gt, t_gt = synthetic.orbit_trajectory(c["n_scene"], radius=10.0,
                                            angle_span=c["span"])
    imgs, deps, times = synthetic.make_rgbd_image_sequence(
        [F, F, W / 2, H / 2], W, H, R_gt, t_gt, seed=0)
    js, ts = _systems(c)
    states = {"jax": [], "torch": []}
    for i in range(c["n_run"]):
        states["jax"].append(js.track_rgbd(
            jnp.asarray(imgs[i]), jnp.asarray(deps[i]), times[i])[0])
        states["torch"].append(ts.track_rgbd(
            imgs[i], deps[i].astype(np.int32), times[i])[0])
    js.shutdown()
    ts.shutdown()
    return c, js, ts, states, (R_gt, t_gt)


def test_tracked_frames_equal(runs):
    c, _, _, states, _ = runs
    assert states["torch"] == states["jax"]
    assert states["torch"].count("OK") >= 0.85 * c["n_run"]


def test_map_sizes_close(runs):
    c, js, ts, _, _ = runs
    assert abs(ts.n_keyframes() - js.n_keyframes()) <= 1
    assert ts.n_keyframes() >= c["min_kf"]
    assert abs(ts.n_landmarks() - js.n_landmarks()) <= \
        c.get("lm_tol", 0.1) * js.n_landmarks()


def test_camera_centres_close(runs):
    c, js, ts, _, (R_gt, t_gt) = runs
    cj = _centres(js.tracker.trajectory)
    ct = _centres(ts.tracker.trajectory)
    assert ct.shape == cj.shape
    assert np.linalg.norm(ct - cj, axis=1).max() < c["centre_tol"]
    idx = np.round(np.asarray([tm for tm, _, _ in ts.tracker.trajectory]) *
                   30).astype(int)
    gt = ev.centers_from_tcw(R_gt[idx], t_gt[idx])
    ate_t, ate_j = ev.ate_rmse(ct, gt), ev.ate_rmse(cj, gt)
    print(f"frames {len(ct)}: kf {ts.n_keyframes()}/{js.n_keyframes()}, "
          f"lm {ts.n_landmarks()}/{js.n_landmarks()} (port/JAX); max "
          f"centre difference {np.linalg.norm(ct - cj, axis=1).max():.4f} m; "
          f"ATE port {ate_t:.4f} m, JAX {ate_j:.4f} m")
    assert ate_t < ate_j + c["centre_tol"]


def test_pipelined_resolves_and_makes_keyframe_from_popped_pose(runs):
    """In the pipelined cases every decision was deferred and resolved (no
    blocking wait on the CPU), and at least one keyframe beyond the first
    was made from a pose popped off the pipeline."""
    c, js, ts, _, _ = runs
    if not c.get("pipelined"):
        assert ts.tracker._pending == [] and not ts.tracker.pipelined
        return
    assert ts.tracker.pipelined and ts.tracker._pending == []
    assert ts.matcher is not None and js.matcher is not None
    assert ts.tracker.eager_frames == c["n_run"]     # no card: no graph
    assert ts.tracker.graph_replays == 0
    assert ts.n_keyframes() >= 2
    assert abs(ts._kf_count - js._kf_count) <= 1 and ts._kf_count >= 1


def test_localization_mode_stops_mapping():
    """activate_localization_mode: frames go on being tracked against the
    map, no keyframe is added; deactivating resumes mapping. Same states and
    keyframe counts as the JAX package."""
    c = CONFIGS["short"]
    W, H, F = c["W"], c["H"], c["F"]
    R_gt, t_gt = synthetic.orbit_trajectory(c["n_scene"], radius=10.0,
                                            angle_span=c["span"])
    imgs, deps, times = synthetic.make_rgbd_image_sequence(
        [F, F, W / 2, H / 2], W, H, R_gt, t_gt, seed=0)
    js, ts = _systems(c)
    seen = {"jax": [], "torch": []}

    def step(i):
        sj = js.track_rgbd(jnp.asarray(imgs[i]), jnp.asarray(deps[i]),
                           times[i])[0]
        st = ts.track_rgbd(imgs[i], deps[i].astype(np.int32), times[i])[0]
        seen["jax"].append((sj, js.n_keyframes()))
        seen["torch"].append((st, ts.n_keyframes()))

    for i in range(3):
        step(i)
    js.activate_localization_mode()
    ts.activate_localization_mode()
    assert ts.tracker.localization_vo and not ts.enable_mapping
    for i in range(3, 5):
        step(i)
    js.deactivate_localization_mode()
    ts.deactivate_localization_mode()
    assert ts.tracker.pending_kf is None and ts.enable_mapping
    for i in range(5, 7):
        step(i)
    print(seen["torch"])
    assert [s for s, _ in seen["torch"]] == [s for s, _ in seen["jax"]]
    assert all(abs(a[1] - b[1]) <= 1
               for a, b in zip(seen["torch"], seen["jax"]))
    assert seen["torch"][4][1] == seen["torch"][2][1]    # none meanwhile
    assert seen["torch"][6][1] >= seen["torch"][4][1]    # mapping allowed
    assert ts._kf_count == js._kf_count


# ---------------------------------------------------------------------------
# The landmark count at bench size, examined as tests/test_torch_mono_stereo_
# system.py examines mono and stereo (run from the repository root):
#   PYTHONPATH=. python tests/test_torch_slice.py spread bench-pipelined 0 1 2
#   PYTHONPATH=. python tests/test_torch_slice.py steps bench-pipelined
#   PYTHONPATH=. python tests/test_torch_slice.py cross bench-pipelined
# `spread`: the JAX System and the port's System on the JAX package's RGB-D
# frames (its detector and frontend; seed s > 0 moves every keypoint by
# N(0, 1e-3) px), one line a seed. `steps`: the JAX System on its frames,
# and at every tracked frame and keyframe step the port's function on the
# same inputs, one line a call. `cross`: both Systems on the port's own
# frames (its detector and frontend on the CPU).
# ---------------------------------------------------------------------------

def _bench_frames(js, c, seq_imgs):
    """The JAX package's RGB-D frames (detector masks, frontend) as the
    port's FrameFeatures on the CPU, each with its dynamic-area ratio."""
    import jax
    from dani_slam_tpu.slam import frame as jfr
    from dani_slam_tpu_torch.slam.frame import FrameFeatures
    imgs, deps, times = seq_imgs
    out = []
    for i in range(c["n_run"]):
        img = jnp.asarray(imgs[i])
        boxes, bmask, dyn = js.detector.dynamic_mask_inputs(img)
        f = jfr.build_frame_rgbd(js._sp(), img, jnp.asarray(deps[i]), js.cam,
                                 times[i], n_max=js.n_features,
                                 threshold=js.sp_threshold, boxes=boxes,
                                 box_mask=bmask)
        out.append((FrameFeatures(*[None if x is None else torch.as_tensor(
            np.asarray(x)) for x in jax.device_get(f)]), float(dyn)))
    return out


def _run_frames(system, frames, times, to_jax):
    from dani_slam_tpu.slam import frame as jfr
    states = []
    for (f, dyn), tm in zip(frames, times):
        if to_jax:
            f = jfr.FrameFeatures(*[None if x is None else
                                    jnp.asarray(x.numpy()) for x in f])
            dyn = jnp.asarray(dyn, jnp.float32)
        else:
            dyn = torch.tensor(dyn)
        states.append(system.track_features(f, dyn_ratio=dyn,
                                            timestamp=tm)[0])
    system.shutdown()
    return states


def _bench_case(name):
    c = CONFIGS[name]
    W, H, F = c["W"], c["H"], c["F"]
    R_gt, t_gt = synthetic.orbit_trajectory(c["n_scene"], radius=10.0,
                                            angle_span=c["span"])
    seq = synthetic.make_rgbd_image_sequence([F, F, W / 2, H / 2], W, H,
                                             R_gt, t_gt, seed=0)
    return c, (R_gt, t_gt), seq


def _row(system, states, gt):
    traj = system.tracker.trajectory
    C = _centres(traj)
    idx = np.round(np.asarray([tm for tm, _, _ in traj]) * 30).astype(int)
    return dict(tracked=states.count("OK"), kf=system.n_keyframes(),
                lm=system.n_landmarks(),
                ate=round(ev.ate_rmse(C, ev.centers_from_tcw(
                    gt[0][idx], gt[1][idx])), 4))


def _port_frames(ts, c, seq_imgs):
    """The port's RGB-D frames (its detector masks and frontend on the CPU),
    each with its dynamic-area ratio."""
    from dani_slam_tpu_torch.slam import frame as tfr
    imgs, deps, times = seq_imgs
    out = []
    for i in range(c["n_run"]):
        img = torch.as_tensor(imgs[i])
        boxes, bmask, dyn = ts.detector.dynamic_mask_inputs(img)
        f = tfr.build_frame_rgbd(ts._sp(), img,
                                 torch.as_tensor(deps[i].astype(np.int32)),
                                 ts.cam, times[i], n_max=ts.n_features,
                                 threshold=ts.sp_threshold, boxes=boxes,
                                 box_mask=bmask)
        out.append((f, float(dyn)))
    return out


def cross(name):
    c, gt, seq = _bench_case(name)
    _, ts = _systems(c)
    frames = _port_frames(ts, c, seq)
    js, ts = _systems(c)
    sj = _run_frames(js, frames, seq[2], True)
    st = _run_frames(ts, frames, seq[2], False)
    print(dict(frames="port, CPU", jax=_row(js, sj, gt),
               port=_row(ts, st, gt)), flush=True)


def spread(name, seeds):
    from test_torch_mono_stereo_system import perturbed
    c, gt, seq = _bench_case(name)
    js, _ = _systems(c)
    base = _bench_frames(js, c, seq)
    for seed in seeds:
        moved = perturbed([f for f, _ in base], seed)
        frames = [(f, d) for f, (_, d) in zip(moved, base)]
        js, ts = _systems(c)
        sj = _run_frames(js, frames, seq[2], True)
        st = _run_frames(ts, frames, seq[2], False)
        print(dict(seed=seed, jax=_row(js, sj, gt), port=_row(ts, st, gt)),
              flush=True)


def steps(name):
    import jax
    import dani_slam_tpu.slam.system as jsys
    import dani_slam_tpu.slam.tracking as jtr
    from dani_slam_tpu_torch.slam import mapping as tmap
    from dani_slam_tpu_torch.slam import tracking as ttr
    from dani_slam_tpu_torch.slam.frame import FrameFeatures
    c, gt, seq = _bench_case(name)
    js, ts = _systems(c)
    frames = _bench_frames(js, c, seq)

    def T(x):
        return torch.as_tensor(np.array(x))

    def port_state(st):
        return tst.map_state_from_numpy(jax.device_get(st), device="cpu")

    track_jax, kf_jax = jtr.track_frame_step, jsys.mapping.keyframe_step

    def track(st, cam, feat, last_bind, R, t, Rv, tv, ref_kf, **kw):
        out = track_jax(st, cam, feat, last_bind, R, t, Rv, tv, ref_kf, **kw)
        o = jax.device_get(out)
        f = FrameFeatures(*[None if x is None else T(x)
                            for x in jax.device_get(feat)])
        p = ttr.track_frame_step(
            port_state(st), ts.cam, f, T(last_bind), T(R), T(t), T(Rv),
            T(tv), T(ref_kf).long(), min_inliers=kw["min_inliers"],
            use_depth=kw["use_depth"], has_vel=kw["has_vel"],
            seed_rounds=kw["seed_rounds"], matcher=ts.matcher,
            select_on_device=True)
        print(f"track: inliers {np.asarray(o[3])[:2].tolist()} / "
              f"{p[3].numpy()[:2].tolist()} (JAX / port), t within "
              f"{np.abs(np.asarray(o[1]) - p[1].numpy()).max():.1e}, "
              f"bindings differ {int((np.asarray(o[2]) != p[2].numpy()).sum())}"
              f" of {int((np.asarray(o[2]) >= 0).sum())}", flush=True)
        return out

    def keyframe(st, cam, xy, valid, desc, depth, bind, R, t, time, fid,
                 **kw):
        out = kf_jax(st, cam, xy, valid, desc, depth, bind, R, t, time, fid,
                     **kw)
        sj = jax.device_get(out[0])
        p = tmap.keyframe_step(
            port_state(st), ts.cam, T(xy), T(valid), T(desc), T(depth),
            T(bind), T(R), T(t), T(time), int(fid),
            use_depth=kw["use_depth"], do_ba=kw["do_ba"],
            do_aux=kw["do_aux"], max_depth=float(kw["max_depth"]),
            feat_octave=T(kw["feat_octave"]), matcher=ts.matcher,
            chain=tuple(T(x) for x in kw["chain"]), ba_iters=kw["ba_iters"],
            cull_redundancy=kw["cull_redundancy"],
            cull_max_kills=kw["cull_max_kills"],
            cull_close_only=kw["cull_close_only"],
            cull_close_depth=kw["cull_close_depth"],
            fuse_two_hop=kw["fuse_two_hop"])[0]
        kb = np.asarray(sj.kf_mask) & p.kf_mask.numpy()
        print(f"keyframe step at frame {int(fid)}: landmarks before "
              f"{int(np.asarray(st.lm_mask).sum())}, after "
              f"{int(np.asarray(sj.lm_mask).sum())} / {int(p.lm_mask.sum())} "
              f"(JAX / port), slots differing "
              f"{int((np.asarray(sj.lm_mask) != p.lm_mask.numpy()).sum())}, "
              f"keyframe t within "
              f"{np.abs(np.asarray(sj.kf_t)[kb] - p.kf_t.numpy()[kb]).max():.1e}",
              flush=True)
        return out

    jtr.track_frame_step, jsys.mapping.keyframe_step = track, keyframe
    try:
        states = _run_frames(js, frames, seq[2], True)
    finally:
        jtr.track_frame_step, jsys.mapping.keyframe_step = track_jax, kf_jax
    print(_row(js, states, gt), flush=True)


if __name__ == "__main__":
    import sys
    torch.set_num_threads(2)
    which, name = sys.argv[1:3]
    if which == "spread":
        spread(name, [int(x) for x in sys.argv[3:]])
    elif which == "cross":
        cross(name)
    else:
        assert which == "steps", which
        steps(name)
