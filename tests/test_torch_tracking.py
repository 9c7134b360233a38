"""Matcher branches and the fused frame function of the port against the JAX
package, on a real map: the JAX System tracks a few frames of a synthetic
RGB-D sequence (SuperPoint features, detector on, LightGlue matcher), then
its map state, pose chain and the next frame are carried across as numpy.

Tolerances. LightGlue's bf16 layers round differently in the two libraries
(tests/test_torch_lightglue.py), so a few accepted matches differ: bindings
agree on at least 95 % of the keypoints, inlier and landmark counts within
5 % (at least 3), poses within 2 mm / 1e-3 rad where both sides start from
the same features. rgbd_frame_fused runs each side's own frontend, whose bf16
convolutions round differently as well: valid-keypoint counts within 5 %,
inlier counts within 10 %, camera centre within 2 cm. The device-selected
and host-branch forms of track_frame_step run the same operations on the
same inputs and must agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dani_slam_tpu.core import cameras as jcam
from dani_slam_tpu.core import state as jst
from dani_slam_tpu.models import superpoint as jsp
from dani_slam_tpu.models import yolo as jyolo
from dani_slam_tpu.slam import frame as jframe
from dani_slam_tpu.slam import mapping as jmapping
from dani_slam_tpu.slam import tracking as jtracking
from dani_slam_tpu.slam.system import Sensor as JSensor
from dani_slam_tpu.slam.system import System as JSystem
from dani_slam_tpu_torch.core import cameras as tcam
from dani_slam_tpu_torch.core import lie as tlie
from dani_slam_tpu_torch.core import state as tst
from dani_slam_tpu_torch.models import lightglue as tlg
from dani_slam_tpu_torch.models import superpoint as tsp
from dani_slam_tpu_torch.models import yolo as tyolo
from dani_slam_tpu_torch.slam import mapping as tmapping
from dani_slam_tpu_torch.slam import tracking as ttracking
from dani_slam_tpu_torch.slam.frame import FrameFeatures as TFeat
from dani_slam_tpu_torch.utils import device as devmod
from dani_slam_tpu_torch.utils import synthetic

torch.set_num_threads(2)       # several test workers share the machine

W, H, F = 320, 240, 300.0
CAPS = dict(K=32, L=4096, N=256, D=256)
N_FEAT = 256
TH = 0.012
T = torch.as_tensor


def tfeat(jf):
    return TFeat(xy=T(np.asarray(jf.xy)), desc=T(np.asarray(jf.desc)),
                 depth=T(np.asarray(jf.depth)), valid=T(np.asarray(jf.valid)),
                 time=T(np.asarray(jf.time)))


@pytest.fixture(scope="module")
def scene():
    """JAX System after 3 frames (tracking + mapping), then one more frame
    with mapping held back so its keyframe stays pending."""
    R_gt, t_gt = synthetic.orbit_trajectory(8, radius=10.0,
                                            angle_span=0.0267 * 7)
    imgs, deps, times = synthetic.make_rgbd_image_sequence(
        [F, F, W / 2, H / 2], W, H, R_gt, t_gt, seed=0)
    jc = jcam.Camera.pinhole(F, F, W / 2, H / 2, W, H)
    js = JSystem(jc, JSensor.RGBD, caps=jst.MapCaps(**CAPS),
                 sp_params=jsp.load_default_params(), n_features=N_FEAT,
                 detector=jyolo.load_default_detector(), matcher="auto",
                 pipelined=False, enable_loop_closing=False,
                 enable_relocalization=False)
    js.sp_threshold = TH
    for i in range(3):
        assert js.track_rgbd(jnp.asarray(imgs[i]), jnp.asarray(deps[i]),
                             times[i])[0] == "OK"
    js._resolve_kf_pull()
    tr = js.tracker
    snap = dict(st=tr.st, last_bind=tr.last_bind, R=tr.R, t=tr.t,
                vel=tr.vel, ref_kf=tr.ref_kf_dev)
    assert snap["vel"] is not None
    # frame 3: features for the function-level comparisons
    det = js.detector
    boxes, bmask, _ = det.dynamic_mask_inputs(jnp.asarray(imgs[3]))
    feat = jframe._frame_rgbd_program(
        js.sp_params, jnp.asarray(imgs[3]), jnp.asarray(deps[3]), jc,
        jnp.asarray(times[3], jnp.float32), jnp.asarray(5000.0, jnp.float32),
        jnp.asarray(TH, jnp.float32), boxes, bmask, n_max=N_FEAT,
        use_boxes=True)
    tc = tcam.Camera.pinhole(F, F, W / 2, H / 2, W, H, device="cpu")
    return dict(js=js, jc=jc, tc=tc, snap=snap, feat=feat,
                img=imgs[3], dep=deps[3], time=times[3],
                matcher=tlg.load_default_matcher(W, H, device="cpu"))


def torch_snap(snap):
    return dict(st=tst.map_state_from_numpy(snap["st"], device="cpu"),
                last_bind=T(np.asarray(snap["last_bind"])),
                R=T(np.asarray(snap["R"])), t=T(np.asarray(snap["t"])),
                vel=tuple(T(np.asarray(v)) for v in snap["vel"]),
                ref_kf=T(np.asarray(snap["ref_kf"])).long())


def bind_agreement(bt, bj):
    bt, bj = np.asarray(bt), np.asarray(bj)
    return float(np.mean(bt == bj))


def close_count(a, b, rel=0.05, least=3):
    return abs(int(a) - int(b)) <= max(least, rel * int(b))


def test_track_reference_keyframe_with_matcher(scene):
    s, ts = scene["snap"], torch_snap(scene["snap"])
    mm = scene["js"].matcher
    oj = jtracking.track_reference_keyframe(
        s["st"], scene["jc"], scene["feat"], s["ref_kf"], s["R"], s["t"],
        use_depth=True, matcher_model=mm.model, matcher_params=mm.params)
    before = tlg.FORWARDS.count
    ot = ttracking.track_reference_keyframe(
        ts["st"], scene["tc"], tfeat(scene["feat"]), ts["ref_kf"], ts["R"],
        ts["t"], use_depth=True, matcher=scene["matcher"])
    assert tlg.FORWARDS.count == before + 1
    print(f"ref-KF inliers: port {int(ot.n_inliers)}, JAX {int(oj.n_inliers)}")
    assert int(oj.n_inliers) >= 8
    assert close_count(ot.n_inliers, oj.n_inliers)
    assert bind_agreement(ot.bindings, oj.bindings) >= 0.95
    np.testing.assert_allclose(ot.R.numpy(), np.asarray(oj.R), atol=1e-3)
    np.testing.assert_allclose(ot.t.numpy(), np.asarray(oj.t), atol=2e-3)
    # and the descriptor branch still runs without a matcher
    od = ttracking.track_reference_keyframe(
        ts["st"], scene["tc"], tfeat(scene["feat"]), ts["ref_kf"], ts["R"],
        ts["t"], use_depth=True)
    assert int(od.n_inliers) >= 8


def test_create_new_landmarks_with_matcher(scene):
    """Insert the next keyframe and its depth landmarks with the JAX
    package, carry that state across, and triangulate on both sides with
    the batched LightGlue branch."""
    s = scene["snap"]
    mm = scene["js"].matcher
    jc, feat = scene["jc"], scene["feat"]
    out = jtracking.track_frame_step(
        s["st"], jc, feat, s["last_bind"], s["R"], s["t"], *s["vel"],
        s["ref_kf"], use_depth=True, matcher_model=mm.model,
        matcher_params=mm.params)
    R, t, bind, _, st = out
    st, k = jst.insert_keyframe(
        st, R, t, feat.time, jnp.asarray(3), feat.xy, feat.valid, feat.desc,
        feat.depth, feat.octave_or_zeros(), bind)
    st = jmapping.create_depth_landmarks(st, jc, k, max_depth=40.0)
    sj = jmapping.create_new_landmarks(st, jc, k, matcher_model=mm.model,
                                       matcher_params=mm.params)
    stt = tmapping.create_new_landmarks(
        tst.map_state_from_numpy(st, device="cpu"), scene["tc"],
        T(np.asarray(k)).long(), matcher=scene["matcher"])
    n0 = int(jst.num_landmarks(st))
    new_j = int(jst.num_landmarks(sj)) - n0
    new_t = int(tst.num_landmarks(stt)) - n0
    print(f"new landmarks: port {new_t}, JAX {new_j}")
    assert new_j >= 5
    assert close_count(new_t, new_j, rel=0.1)
    kk = int(k)
    rows_t = stt.obs_lm[kk].numpy() >= 0
    rows_j = np.asarray(sj.obs_lm[kk]) >= 0
    assert np.mean(rows_t == rows_j) >= 0.95
    # without a matcher the descriptor branch gives a map of its own
    std = tmapping.create_new_landmarks(
        tst.map_state_from_numpy(st, device="cpu"), scene["tc"],
        T(np.asarray(k)).long())
    assert int(tst.num_landmarks(std)) >= n0


def _yaw(angle):
    c, s = np.cos(angle), np.sin(angle)
    return T(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32))


@pytest.mark.parametrize("way,angle,pulls,forwards", [
    ("motion-model", 0.0, 1, 0),
    # ~22 px of image shift: outside the radius-15 window, inside radius 30
    ("widened", 0.075, 2, 0),
    # ~45 px: both windows miss, the reference keyframe is matched
    ("reference-keyframe", 0.15, 2, 1)])
def test_track_frame_step_device_selection_equals_host_branches(
        scene, way, angle, pulls, forwards):
    ts = torch_snap(scene["snap"])
    feat = tfeat(scene["feat"])
    R_pred, t_pred = tlie.se3_mul(*ts["vel"], ts["R"], ts["t"])
    R_cur = _yaw(angle) @ R_pred       # has_vel=False: tracked from R_cur
    args = (ts["st"], scene["tc"], feat, ts["last_bind"], R_cur, t_pred,
            torch.eye(3), torch.zeros(3), ts["ref_kf"])
    kw = dict(use_depth=True, has_vel=False, matcher=scene["matcher"])
    s0, f0 = devmod.SYNCS.count, tlg.FORWARDS.count
    host = ttracking.track_frame_step(*args, **kw, select_on_device=False)
    assert devmod.SYNCS.count - s0 == pulls, way
    assert tlg.FORWARDS.count - f0 == forwards, way
    s0 = devmod.SYNCS.count
    dev = ttracking.track_frame_step(*args, **kw, select_on_device=True)
    assert devmod.SYNCS.count == s0          # no host read at all
    for a, b in zip(host[:4], dev[:4]):
        assert torch.equal(a, b), way
    assert torch.equal(host[4].lm_found, dev[4].lm_found)
    assert torch.equal(host[4].lm_visible, dev[4].lm_visible)
    assert int(host[3][1]) >= 20, way        # the frame is tracked


def test_rgbd_frame_fused_matches_jax(scene):
    s, ts = scene["snap"], torch_snap(scene["snap"])
    js = scene["js"]
    det, mm = js.detector, js.matcher
    img, dep = scene["img"], scene["dep"]
    nobox = (jnp.zeros((1, 4), jnp.float32), jnp.zeros((1,), bool))
    oj = jtracking.rgbd_frame_fused(
        js.sp_params, jnp.asarray(img), jnp.asarray(dep), scene["jc"],
        jnp.asarray(scene["time"], jnp.float32),
        jnp.asarray(5000.0, jnp.float32), jnp.asarray(TH, jnp.float32),
        nobox[0], nobox[1], s["st"], s["last_bind"], s["R"], s["t"],
        *s["vel"], s["ref_kf"], n_max=N_FEAT, min_inliers=10, has_vel=True,
        matcher_model=mm.model, matcher_params=mm.params,
        det_model=det.model, det_params=det.params, dyn_ids=det.dyn_ids,
        det_hw=tuple(det.input_hw), det_score_th=det.score_th,
        det_anchors=det.anchors, seed_rounds=2)
    s0 = devmod.SYNCS.count
    ot = ttracking.rgbd_frame_fused(
        tsp.load_default_params("cpu"), T(img), T(dep.astype(np.int32)),
        scene["tc"], T(np.float32(scene["time"])), 5000.0, TH, ts["st"],
        ts["last_bind"], ts["R"], ts["t"], *ts["vel"], ts["ref_kf"],
        n_max=N_FEAT, min_inliers=10, has_vel=True,
        matcher=scene["matcher"], detector=tyolo.load_default_detector("cpu"),
        seed_rounds=2)
    assert devmod.SYNCS.count == s0
    fj, Rj, tj, bj, cj, stj, velj, refj, dynj = oj
    ft, Rt, tt, bt, ct, stt, velt, reft, dynt = ot
    cj, ct = np.asarray(cj), ct.numpy()
    assert ct.shape == (6,) and ct.dtype == np.int32
    assert close_count(ft.valid.sum(), np.asarray(fj.valid).sum())
    assert close_count(ct[0], cj[0], rel=0.1) and \
        close_count(ct[1], cj[1], rel=0.1)
    assert abs(int(ct[4]) - int(cj[4])) <= 2          # dyn_ratio * 1000
    assert ct[5] == cj[5] == int(np.asarray(s["st"].kf_mask).sum())
    assert abs(float(dynt) - float(dynj)) < 2e-3
    Cj = -np.asarray(Rj).T @ np.asarray(tj)
    Ct = -Rt.numpy().T @ tt.numpy()
    assert np.linalg.norm(Ct - Cj) < 0.02
    # the velocity is T_new o T_cur^-1 and the reference pose the gather
    Rv, tv = tlie.se3_mul(Rt, tt, *tlie.se3_inv(ts["R"], ts["t"]))
    assert torch.equal(velt[0], Rv) and torch.equal(velt[1], tv)
    k = int(ts["ref_kf"])
    assert torch.equal(reft[0], ts["st"].kf_R[k])
    np.testing.assert_allclose(reft[1].numpy(), np.asarray(refj[1]),
                               atol=1e-6)
    # a tracked frame changes only the visibility counters of the map
    for name in tst.TENSOR_FIELDS:
        same = getattr(stt, name) is getattr(ts["st"], name)
        assert same == (name not in ("lm_visible", "lm_found")), name


def test_track_last_frame_vo_matches_jax(scene):
    """Localization mode's visual odometry: the frame against itself as the
    'last frame', from a prediction a few pixels off; both sides recover
    the pose the depth points were lifted with."""
    s, ts = scene["snap"], torch_snap(scene["snap"])
    jf, tf = scene["feat"], tfeat(scene["feat"])
    R_pred = _yaw(0.02) @ ts["R"]
    oj = jtracking.track_last_frame_vo(
        scene["jc"], jf.xy, jf.desc, jf.depth, jf.valid, s["R"], s["t"], jf,
        jnp.asarray(R_pred.numpy()), s["t"], use_depth=True)
    ot = ttracking.track_last_frame_vo(
        scene["tc"], tf.xy, tf.desc, tf.depth, tf.valid, ts["R"], ts["t"],
        tf, R_pred, ts["t"], use_depth=True)
    assert int(oj[2]) >= 50 and close_count(ot[2], oj[2])
    np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), atol=1e-3)
    np.testing.assert_allclose(ot[1].numpy(), np.asarray(oj[1]), atol=2e-3)
    np.testing.assert_allclose(ot[0].numpy(), ts["R"].numpy(), atol=2e-3)
    # apply_chain_correction right-composes
    cR, ct = _yaw(0.1), torch.tensor([0.1, -0.2, 0.3])
    got = ttracking.apply_chain_correction(ts["R"], ts["t"], cR, ct)
    want = jtracking.apply_chain_correction(s["R"], s["t"],
                                            jnp.asarray(cR.numpy()),
                                            jnp.asarray(ct.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_device_helpers_keep_reads_off_the_host():
    """AsyncRead of a CPU tensor is its own host copy (counted as ready,
    never as a blocking sync); const() stages a tensor once per device;
    sless.row / state._set index with a 0-d tensor like plain indexing."""
    from dani_slam_tpu_torch.core import scatterless as sless
    s0, r0, w0 = (devmod.SYNCS.count, devmod.ASYNC.ready,
                  devmod.ASYNC.waited)
    read = devmod.AsyncRead(torch.arange(6, dtype=torch.int32))
    np.testing.assert_array_equal(read.get(), np.arange(6))
    assert (devmod.SYNCS.count, devmod.ASYNC.ready, devmod.ASYNC.waited) \
        == (s0, r0 + 1, w0)
    a = devmod.const((1.0, 2.0), torch.float32, "cpu")
    assert a is devmod.const((1.0, 2.0), torch.float32, torch.device("cpu"))
    t = torch.arange(12.0).reshape(4, 3)
    k = torch.tensor(2)
    assert torch.equal(sless.row(t, k), t[2])
    out = tst._set(t, k, torch.tensor([7.0, 8.0, 9.0]))
    assert torch.equal(out[2], torch.tensor([7.0, 8.0, 9.0]))
    assert torch.equal(out[[0, 1, 3]], t[[0, 1, 3]]) and out is not t
    assert torch.equal(tst._set(torch.zeros(4, dtype=torch.bool), k, True),
                       torch.tensor([False, False, True, False]))
