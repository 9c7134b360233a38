"""Loop closing, relocalization and map merging of the port against the JAX
package: every function of slam/loopclosing.py on the drifted loop map of
tests/test_loop_reloc.py (K 64 / L 8192 / N 512 / D 64; the JAX builder's
state carried across with map_state_from_numpy) and LoopCloser.on_keyframe
over the whole 16-keyframe loop in both packages. The System-level runs are
in test_torch_loop_system.py.

Randomness drawn in JAX is injected: the RANSACs get the JAX key's
minimal sets as sample indices, the live vocabulary gets the JAX codebook.
Where the two packages draw on their own (LoopCloser, System) the outcomes
are compared, not the streams.

Tolerances. Integer and boolean fields, slot ids, inlier sets and match
flags exactly equal; positions, poses and Sim3s within 1e-4 after RANSAC
and Gauss-Newton, within 1e-3 after a pose graph or a weld (f32 solves of a
1e-6-damped 448x448 system and their propagation); relocalization poses
within 1e-3 with the same inlier count up to 2 % (the port's window search
is the kernel's bf16 dot, the JAX package's on the CPU is f32). Global BA
on this map is compared by its outcome (test_gba_problem_and_global_ba
says why). End to end: the same detection keyframe, one loop each, the
corrected centres within 1 mm.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dani_slam_tpu.core import cameras as jcam
from dani_slam_tpu.core import lie as jlie
from dani_slam_tpu.core import state as jst
from dani_slam_tpu.ops import matching as jmatching
from dani_slam_tpu.slam import loopclosing as jlc
from dani_slam_tpu.utils import synthetic as jsyn
from dani_slam_tpu_torch.core import cameras as tcam
from dani_slam_tpu_torch.core import lie as tlie
from dani_slam_tpu_torch.core import state as tst
from dani_slam_tpu_torch.slam import loopclosing as tlc
from dani_slam_tpu_torch.slam.frame import FrameFeatures as TFeat
from dani_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)       # several test workers share the machine

JC = jcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)
TC = tcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480, device="cpu")
CAPS = jst.MapCaps(K=64, L=8192, N=512, D=64)
TCAPS = tst.MapCaps(*CAPS)


def T(x):
    return torch.as_tensor(np.array(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def to_torch(st):
    return tst.map_state_from_numpy(jax.device_get(st), device="cpu")


def assert_states_close(t_st, j_st, atol=1e-4, fields=None):
    """Slot by slot: integer and bool fields equal, float fields within
    atol (inf where inf)."""
    a, b = tst.map_state_to_numpy(t_st), tst.map_state_to_numpy(
        to_torch(j_st))
    for name in fields or tst.TENSOR_FIELDS:
        x, y = a[name], b[name]
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


def categorical(key, mask, n_hypo, k):
    p = jnp.asarray(mask).astype(jnp.float32) + 1e-6
    return T(np.asarray(jax.random.categorical(
        key, jnp.broadcast_to(jnp.log(p), (n_hypo, k, p.shape[0])),
        axis=-1)))


def centres(R, t, kf_ids):
    R, t = N(R), N(t)
    return np.stack([-R[k].T @ t[k] for k in kf_ids])


@pytest.fixture(scope="module")
def loop():
    """The drifted 16-keyframe loop (drift 0.35) and its zero-drift twin,
    built by the JAX package, and the verified loop Sim3 of each."""
    out = {}
    for name, drift in (("drift", 0.35), ("flat", 0.0)):
        st, kf_ids, gt, world = jsyn.make_drifted_loop_state(
            JC, CAPS, K=16, drift=drift)
        cur, cand = kf_ids[-1], kf_ids[0]
        T12, n, ok = jlc.verify_loop_candidate(
            st, JC, jnp.asarray(cur), jnp.asarray(cand),
            jax.random.PRNGKey(0), fix_scale=True, min_inliers=20)
        assert bool(ok)
        out[name] = dict(st=st, tst=to_torch(st), kf_ids=kf_ids, gt=gt,
                         world=world, cur=cur, cand=cand,
                         T12=tuple(np.asarray(x) for x in T12))
    return out


def test_drifted_loop_state_matches_reference(loop):
    d = loop["drift"]
    st, kf_ids, (R_gt, t_gt), _ = tsyn.make_drifted_loop_state(TC, TCAPS,
                                                               K=16)
    assert kf_ids == d["kf_ids"]
    np.testing.assert_allclose(R_gt, N(d["gt"][0]), atol=1e-6)
    np.testing.assert_allclose(t_gt, N(d["gt"][1]), atol=1e-5)
    assert_states_close(st, d["st"], atol=1e-4)


def test_match_and_verify_loop_candidate(loop):
    d = loop["drift"]
    cur, cand = d["cur"], d["cand"]
    mj = jlc.match_kf_landmarks(d["st"], jnp.asarray(cur), jnp.asarray(cand))
    mt = tlc.match_kf_landmarks(d["tst"], cur, cand)
    np.testing.assert_array_equal(N(mt[2]), N(mj[2]))        # ok
    ok = N(mj[2])
    for a, b in zip(mt[:2], mj[:2]):
        np.testing.assert_allclose(N(a)[ok], N(b)[ok], atol=1e-4)
    np.testing.assert_array_equal(N(mt[6])[ok], N(mj[6])[ok])
    key = jax.random.PRNGKey(0)
    Tj, nj, okj = jlc.verify_loop_candidate(
        d["st"], JC, jnp.asarray(cur), jnp.asarray(cand), key,
        fix_scale=True, min_inliers=20)
    Tt, nt, okt = tlc.verify_loop_candidate(
        d["tst"], TC, cur, cand, categorical(key, ok, 128, 3),
        fix_scale=True, min_inliers=20)
    assert int(nt) == int(nj) and bool(okt) and bool(okj)
    for a, b in zip(Tt, Tj):
        np.testing.assert_allclose(N(a), N(b), atol=1e-4)
    # its own draws find the loop as well
    _, n2, ok2 = tlc.verify_loop_candidate(
        d["tst"], TC, cur, cand, torch.Generator().manual_seed(0),
        fix_scale=True, min_inliers=20)
    assert bool(ok2) and abs(int(n2) - int(nj)) <= 0.05 * int(nj)


def test_window_landmarks_and_cross_map_verification(loop):
    d = loop["drift"]
    cur, cand = d["cur"], d["cand"]
    for kf in (cur, cand, d["kf_ids"][7]):
        wj = jlc._window_landmarks(d["st"], jnp.asarray(kf), JC, 4)
        wt = tlc._window_landmarks(d["tst"], kf, TC, 4)
        np.testing.assert_array_equal(N(wt[3]), N(wj[3]))
        np.testing.assert_array_equal(N(wt[0]), N(wj[0]))
        np.testing.assert_allclose(N(wt[1]), N(wj[1]), atol=1e-4)
        np.testing.assert_allclose(N(wt[2]), N(wj[2]), atol=1e-3)
    # the two ends of the loop as two maps (the map against itself)
    la, _, _, ha = jlc._window_landmarks(d["st"], jnp.asarray(cur), JC, 4)
    lb, _, _, hb = jlc._window_landmarks(d["st"], jnp.asarray(cand), JC, 4)
    m = jmatching.masked_match(
        jmatching.desc_distance_matrix(d["st"].lm_desc[la],
                                       d["st"].lm_desc[lb]),
        ha[:, None] & hb[None, :], th=0.7, mutual=True)
    key = jax.random.PRNGKey(4)
    Tj, nj, okj = jlc.verify_cross_map_candidate(
        d["st"], d["st"], JC, jnp.asarray(cur), jnp.asarray(cand), key,
        fix_scale=True)
    Tt, nt, okt = tlc.verify_cross_map_candidate(
        d["tst"], d["tst"], TC, cur, cand, categorical(key, m.ok, 128, 3),
        fix_scale=True)
    assert int(nt) == int(nj) and bool(okt) == bool(okj)
    for a, b in zip(Tt, Tj):
        np.testing.assert_allclose(N(a), N(b), atol=1e-4)


def test_propagate_and_refine_hypothesis(loop):
    d = loop["drift"]
    cand, prev, cur = d["cand"], d["kf_ids"][-2], d["cur"]
    key = jax.random.PRNGKey(0)
    ok = jlc.match_kf_landmarks(d["st"], jnp.asarray(prev),
                                jnp.asarray(cand))[2]
    T0j, _, _ = jlc.verify_loop_candidate(
        d["st"], JC, jnp.asarray(prev), jnp.asarray(cand), key,
        fix_scale=True, min_inliers=20)
    T0t, _, _ = tlc.verify_loop_candidate(
        d["tst"], TC, prev, cand, categorical(key, ok, 128, 3),
        fix_scale=True, min_inliers=20)
    Tpj = jlc.propagate_hypothesis(d["st"], jnp.asarray(cur),
                                   jnp.asarray(prev), T0j)
    Tpt = tlc.propagate_hypothesis(d["tst"], cur, prev, T0t)
    for a, b in zip(Tpt, Tpj):
        np.testing.assert_allclose(N(a), N(b), atol=1e-4)
    Trj, nj, okj = jlc.refine_loop_from_hypothesis(
        d["st"], JC, jnp.asarray(cur), jnp.asarray(cand), Tpj,
        fix_scale=True, min_inliers=20)
    Trt, nt, okt = tlc.refine_loop_from_hypothesis(
        d["tst"], TC, cur, cand, Tpt, fix_scale=True, min_inliers=20)
    assert int(nt) == int(nj) >= 20 and bool(okt) and bool(okj)
    for a, b in zip(Trt, Trj):
        np.testing.assert_allclose(N(a), N(b), atol=1e-4)


@pytest.mark.parametrize("four_dof", [False, True])
def test_correct_loop_and_its_chunks(loop, four_dof):
    """correct_loop against the JAX package; the time-sliced composition
    (three loop_pg_chunk calls of 3 iterations, loop_correction_apply,
    apply_loop_weld) against correct_loop(pg_iters=9) inside the port."""
    d = loop["drift"]
    cur, cand = d["cur"], d["cand"]
    T12j = tuple(jnp.asarray(x) for x in d["T12"])
    T12t = tuple(T(x) for x in d["T12"])
    sj = jlc.correct_loop(d["st"], JC, jnp.asarray(cur), jnp.asarray(cand),
                          T12j, fix_scale=True, four_dof=four_dof)
    stt = tlc.correct_loop(d["tst"], TC, cur, cand, T12t, fix_scale=True,
                           four_dof=four_dof)
    assert_states_close(stt, sj, atol=1e-3)
    R_gt, t_gt = (N(x) for x in d["gt"])
    kf_ids = d["kf_ids"]
    C_gt = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(kf_ids))])
    err = lambda st_: np.linalg.norm(                        # noqa: E731
        centres(st_.kf_R, st_.kf_t, kf_ids) - C_gt, axis=1)
    if not four_dof:
        assert err(stt)[-1] < 0.15 * err(d["tst"])[-1]
    # the sliced path
    K = CAPS.K
    sync = tlc.correct_loop(d["tst"], TC, cur, cand, T12t, pg_iters=9,
                            fix_scale=True, four_dof=four_dof)
    snap = d["tst"]
    carry = (snap.kf_R, snap.kf_t, torch.ones(K))
    for _ in range(3):
        carry = tlc.loop_pg_chunk(snap, cur, cand, T12t, carry, iters=3,
                                  fix_scale=True, four_dof=four_dof)
    R_out, t_out, lm_pos, dmin, dmax = tlc.loop_correction_apply(snap, carry)
    sliced, cR, ct = tlc.apply_loop_weld(
        snap, snap.kf_mask, snap.kf_frame_id, snap.lm_mask, snap.lm_first_kf,
        R_out, t_out, lm_pos, dmin, dmax, cur, cand,
        int(snap.kf_frame_id[cur]), int(snap.kf_frame_id[cand]),
        torch.tensor(cur))
    a, b = tst.map_state_to_numpy(sliced), tst.map_state_to_numpy(sync)
    for name in tst.TENSOR_FIELDS:
        if a[name].dtype.kind == "f":
            np.testing.assert_allclose(a[name], b[name], atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    Rc, tc = tlie.se3_mul(snap.kf_R[cur], snap.kf_t[cur], cR, ct)
    np.testing.assert_allclose(N(Rc), N(sliced.kf_R[cur]), atol=1e-4)
    np.testing.assert_allclose(N(tc), N(sliced.kf_t[cur]), atol=1e-3)


def test_search_and_fuse(loop):
    """On the zero-drift map the loop-gap duplicates project onto each
    other: the same merges, the same observations, slot by slot."""
    d = loop["flat"]
    cur, cand = d["cur"], d["cand"]
    sj = jlc.search_and_fuse(d["st"], JC, jnp.asarray(cur),
                             jnp.asarray(cand))
    stt = tlc.search_and_fuse(d["tst"], TC, cur, cand)
    assert int(stt.lm_mask.sum()) < int(d["tst"].lm_mask.sum())
    assert_states_close(stt, sj, atol=1e-6)


@pytest.fixture(scope="module")
def corrected(loop):
    d = loop["drift"]
    st = jlc.correct_loop(d["st"], JC, jnp.asarray(d["cur"]),
                          jnp.asarray(d["cand"]),
                          tuple(jnp.asarray(x) for x in d["T12"]),
                          fix_scale=True)
    return st, to_torch(st)


def test_gba_problem_and_global_ba(loop, corrected):
    """The observation problem (gauge anchors, observation list, weights)
    exactly equal; the solve itself is compared by its outcome. On this map
    most landmarks are seen from one or two keyframes, so their H_ll blocks
    are nearly singular, and the f32 cumulative-sum differences that form
    them in the JAX package decide their steps: relabelling the landmarks
    moves its mean keyframe-centre error by up to 0.148 m (relabellings
    1-8, `python tests/test_torch_loop.py`). The port's sums are
    fixed-order (kernels.segment_sum). Both must lower the keyframe-centre
    error against the ground truth in 10 iterations as time-sliced chunks,
    the port within the JAX package's own spread of it (0.15 m) and within
    1 cm of its own float64 solve."""
    sj, stt = corrected
    pj = jlc._gba_problem(sj)
    pt = tlc._gba_problem(stt)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(N(a), N(b))
    kf_ids = loop["drift"]["kf_ids"]
    R_gt, t_gt = (N(x) for x in loop["drift"]["gt"])
    C_gt = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(kf_ids))])
    cj = (sj.kf_R, sj.kf_t, sj.lm_pos, jnp.asarray(1e-4))
    ct = (stt.kf_R, stt.kf_t, stt.lm_pos, torch.tensor(1e-4))
    s64 = dataclasses.replace(stt, kf_R=stt.kf_R.double(),
                              kf_t=stt.kf_t.double(),
                              lm_pos=stt.lm_pos.double(),
                              kf_kp=stt.kf_kp.double())
    c64 = (s64.kf_R, s64.kf_t, s64.lm_pos, torch.tensor(1e-4))
    for _ in range(5):
        cj = jlc.gba_chunk(sj, JC, cj, iters=2)
        ct = tlc.gba_chunk(stt, TC, ct, iters=2)
        c64 = tlc.gba_chunk(s64, TC, c64, iters=2)
    e0, ej, et, e64 = (
        np.linalg.norm(centres(R, t, kf_ids) - C_gt, axis=1).mean()
        for R, t in ((stt.kf_R, stt.kf_t), cj[:2], ct[:2], c64[:2]))
    assert ej < e0 and et < e0 and abs(et - ej) <= 0.15
    assert abs(et - e64) < 0.01, (et, e64)
    assert np.all(np.isfinite(N(ct[2])))
    gt_ = tlc.global_bundle_adjustment(stt, TC, iters=10)
    for name in ("kf_R", "kf_t", "lm_pos"):
        np.testing.assert_array_equal(
            N(getattr(gt_, name)),
            N(torch.where(
                (stt.kf_mask if name != "lm_pos" else stt.lm_mask).reshape(
                    (-1,) + (1,) * (getattr(gt_, name).ndim - 1)),
                dict(kf_R=ct[0], kf_t=ct[1], lm_pos=ct[2])[name],
                getattr(stt, name))))


def test_apply_gba_and_weld_propagate_to_new_keyframe(loop, corrected):
    """A keyframe and a landmark made after the snapshot (the live map
    moved on): participants take the solved poses, the new keyframe
    follows its spanning parent, the new landmark its reference keyframe —
    slot by slot against the JAX package."""
    sj, stt = corrected
    last = loop["drift"]["kf_ids"][-1]
    dR, dt = jlie.se3_exp(jnp.asarray([0.0, 0.0, 0.0, 0.05, 0.0, 0.02]))
    R_new = dR @ sj.kf_R[last]
    t_new = dR @ sj.kf_t[last] + dt
    live, k_new = jst.insert_keyframe(
        sj, R_new, t_new, jnp.asarray(99.0), jnp.asarray(999),
        sj.kf_kp[last], sj.kf_kp_mask[last], sj.kf_desc[last],
        sj.kf_depth[last], jnp.zeros((CAPS.N,), jnp.int8), sj.obs_lm[last])
    X_new = jnp.asarray([[1.0, 2.0, 8.0]])
    live, _ = jst.insert_landmarks(
        live, X_new, live.kf_desc[k_new, :1], X_new, jnp.asarray([0.5]),
        jnp.asarray([50.0]), jnp.asarray([int(k_new)], jnp.int32),
        jnp.broadcast_to(live.next_kf_counter, (1,)), jnp.ones(1, bool))
    rng = np.random.RandomState(0)
    R_s = np.asarray(jlie.se3_exp(jnp.asarray(
        rng.randn(CAPS.K, 6).astype(np.float32) * 0.01))[0]) @ \
        np.asarray(sj.kf_R)
    t_s = np.asarray(sj.kf_t) + rng.randn(CAPS.K, 3).astype(np.float32) * 0.01
    lm_s = np.asarray(sj.lm_pos) + \
        rng.randn(CAPS.L, 3).astype(np.float32) * 0.01
    snap_args = (sj.kf_mask, sj.kf_frame_id, sj.lm_mask, sj.lm_first_kf)
    lt = to_torch(live)
    oj = jlc.apply_gba(live, *snap_args, jnp.asarray(R_s), jnp.asarray(t_s),
                       jnp.asarray(lm_s), k_new)
    ot = tlc.apply_gba(lt, *(T(np.asarray(x)) for x in snap_args), T(R_s),
                       T(t_s), T(lm_s), torch.tensor(int(k_new)))
    assert_states_close(ot[0], oj[0], atol=1e-4)
    for a, b in zip(ot[1:], oj[1:]):
        np.testing.assert_allclose(N(a), N(b), atol=1e-4)
    dmin = np.asarray(sj.lm_dist_min) * 0.9
    dmax = np.asarray(sj.lm_dist_max) * 1.1
    cur, cand = loop["drift"]["cur"], loop["drift"]["cand"]
    wj = jlc.apply_loop_weld(
        live, *snap_args, jnp.asarray(R_s), jnp.asarray(t_s),
        jnp.asarray(lm_s), jnp.asarray(dmin), jnp.asarray(dmax),
        jnp.asarray(cur), jnp.asarray(cand), sj.kf_frame_id[cur],
        sj.kf_frame_id[cand], jnp.asarray(cur))
    wt = tlc.apply_loop_weld(
        lt, *(T(np.asarray(x)) for x in snap_args), T(R_s), T(t_s), T(lm_s),
        T(dmin), T(dmax), cur, cand, int(sj.kf_frame_id[cur]),
        int(sj.kf_frame_id[cand]), cur)
    assert_states_close(wt[0], wj[0], atol=1e-4)
    assert bool(wt[0].loop_edges[cur, cand])


def _reloc_frame(d, k, seed):
    f, _ = jsyn.render_frame(d["world"], JC, d["gt"][0][k], d["gt"][1][k],
                             n_max=CAPS.N, noise_px=0.3, seed=seed,
                             with_depth=True)
    return f, TFeat(*(T(np.asarray(x)) for x in (f.xy, f.desc, f.depth,
                                                 f.valid, f.time)))


@pytest.mark.parametrize("k", [3, 9])
def test_relocalize_against_kf(loop, k):
    d = loop["flat"]
    kf = d["kf_ids"][k]
    fj, ft = _reloc_frame(d, k, 500 + k)
    # the JAX function's PnP mask, for the injected draws
    st = d["st"]
    obs = st.obs_lm[kf]
    has = (obs >= 0) & st.kf_kp_mask[kf]
    lm_ids = jnp.where(has, obs, 0)
    m = jmatching.masked_match(
        jmatching.desc_distance_matrix(st.lm_desc[lm_ids], fj.desc),
        has[:, None] & fj.valid[None, :], th=jmatching.TH_HIGH, ratio=0.9,
        mutual=True)
    m = jmatching.resolve_duplicate_targets(m, fj.xy.shape[0])
    key = jax.random.PRNGKey(k)
    oj = jlc.relocalize_against_kf(st, JC, jnp.asarray(kf), fj.xy, fj.desc,
                                   fj.valid, key)
    ot = tlc.relocalize_against_kf(d["tst"], TC, kf, ft.xy, ft.desc,
                                   ft.valid,
                                   categorical(key, m.ok & has, 256, 6))
    assert bool(ot[4]) and bool(oj[4])
    assert abs(int(ot[3]) - int(oj[3])) <= max(2, 0.02 * int(oj[3]))
    np.testing.assert_allclose(N(ot[0]), N(oj[0]), atol=1e-3)
    np.testing.assert_allclose(N(ot[1]), N(oj[1]), atol=1e-3)
    same = (N(ot[2]) == N(oj[2])).mean()
    assert same >= 0.98
    # the true pose (the zero-drift map's world is the ground truth's)
    np.testing.assert_allclose(N(ot[1]), N(d["gt"][1][k]), atol=0.02)


def test_relocalize_against_kf_lightglue(loop, monkeypatch):
    """The LightGlue branch with the shipped matcher at D 256 on the
    zero-drift map. LightGlue itself is held against the JAX package in
    test_torch_lightglue.py (its bf16 layers round differently); here the
    port's matcher call returns the JAX matcher's matches, and the PnP
    draws are injected, so everything after the matcher must agree: the
    same inlier count, poses within 1e-3, bindings on 98 % of the
    keypoints."""
    from dani_slam_tpu.models import lightglue as jlg
    from dani_slam_tpu_torch.models import lightglue as tlg
    caps = jst.MapCaps(K=16, L=8192, N=512, D=256)
    st, kf_ids, gt, world = jsyn.make_drifted_loop_state(JC, caps, K=6,
                                                         drift=0.0)
    k = 2
    kf = kf_ids[k]
    fj, ft = _reloc_frame(dict(world=world, gt=gt), k, 77)
    jm = jlg.load_default_matcher(640, 480)
    obs = st.obs_lm[kf]
    has = (obs >= 0) & st.kf_kp_mask[kf]
    lm_ids = jnp.where(has, obs, 0)
    idx, score, ok = jlg.match(jm, st.kf_kp[kf], st.lm_desc[lm_ids], has,
                               fj.xy, fj.desc, fj.valid)
    assert int(ok.sum()) > 30
    calls = []

    def jax_matches(ms, *args):
        calls.append(ms)
        return T(np.asarray(idx)), T(np.asarray(score)), T(np.asarray(ok))

    monkeypatch.setattr(tlg, "match", jax_matches)
    key = jax.random.PRNGKey(3)
    oj = jlc.relocalize_against_kf_lightglue(
        st, JC, jnp.asarray(kf), fj.xy, fj.desc, fj.valid, key, jm)
    tm = tlg.load_default_matcher(640, 480, device="cpu")
    ot = tlc.relocalize_against_kf_lightglue(
        to_torch(st), TC, kf, ft.xy, ft.desc, ft.valid,
        categorical(key, ok & has, 256, 6), tm)
    assert calls == [tm]
    assert int(ot[3]) == int(oj[3]) and bool(ot[4]) == bool(oj[4])
    np.testing.assert_allclose(N(ot[0]), N(oj[0]), atol=1e-3)
    np.testing.assert_allclose(N(ot[1]), N(oj[1]), atol=1e-3)
    assert (N(ot[2]) == N(oj[2])).mean() >= 0.98


def test_inertial_loop_gate(loop):
    d = loop["flat"]
    cur, cand = d["kf_ids"][5], d["kf_ids"][0]
    st = d["st"]
    one = jnp.ones(())
    for phi, ba2 in (([0.1, 0.0, 0.0], False), ([0.003, -0.002, 0.2], True),
                     ([0.001, 0.001, 0.1], False)):
        Rww = jlie.so3_exp(jnp.asarray(phi))
        Scw = jlie.sim3_mul(st.kf_R[cur], st.kf_t[cur], one, Rww,
                            jnp.asarray([0.1, 0.0, 0.05]), one)
        T12 = jlie.sim3_mul(*Scw, *jlie.sim3_inv(st.kf_R[cand],
                                                 st.kf_t[cand], one))
        Tj, fj, gj = jlc.inertial_loop_gate(st, cur, cand, T12, ba2=ba2)
        Tt, ft_, gt_ = tlc.inertial_loop_gate(
            d["tst"], cur, cand, tuple(T(np.asarray(x)) for x in T12),
            ba2=ba2)
        assert (ft_, gt_) == (fj, gj)
        for a, b in zip(Tt, Tj):
            np.testing.assert_allclose(N(a), N(b), atol=1e-5)


def test_loop_closer_end_to_end(loop):
    """bench.py's loop pass at the test capacities in both packages:
    on_keyframe over the 16 keyframes (live vocabulary, min_kf_gap 6,
    fixed scale), then finish_gba. The same keyframe at which the loop
    closes, one loop each, keyframe centres within 1 mm of each other after
    the time-sliced correction (pose graph, weld, fuse); after the global BA
    the port meets the gates of tests/test_loop_reloc.py (loop end below
    0.3 of its drift, mean error lower)."""
    d = loop["drift"]
    kf_ids = d["kf_ids"]
    jl = jlc.LoopCloser(JC, CAPS, codebook="live", seed=0, min_kf_gap=6,
                        fix_scale=True)
    tl = tlc.LoopCloser(TC, TCAPS, codebook="live", seed=0, min_kf_gap=6,
                        fix_scale=True)
    tl.codebook = T(np.asarray(jl.codebook))
    for lc_ in (jl, tl):
        lc_.train_codebook_after = 6
        lc_.gba_chunk_iters = 2
        lc_.gba_iters = 4
    # the JAX package's sliced correction runs whole chunks of 3: 12
    # pose-graph iterations for its pg_iters 10; the port runs pg_iters
    # exactly, so it is given the JAX count here
    tl.pg_iters = 12
    sj, stt = d["st"], d["tst"]
    at = {}
    for count, k in enumerate(kf_ids, start=1):
        sj = jl.on_keyframe(sj, k, kf_count=count)
        stt = tl.on_keyframe(stt, k, kf_count=count)
        # the keyframe that starts the correction (the JAX package counts
        # the loop there, the port when its weld lands)
        for name, lc_ in (("jax", jl), ("torch", tl)):
            if (lc_.n_loops or lc_._pgc is not None) and name not in at:
                at[name] = count
    assert at["jax"] == at["torch"]
    R_gt, t_gt = (N(x) for x in d["gt"])
    C_gt = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(kf_ids))])
    # the time-sliced correction: pose-graph chunks, weld, fuse
    while jl._pgc is not None:
        sj = jl._pgc_step(sj, jnp.asarray(kf_ids[-1]))
    while tl._pgc is not None:
        stt = tl._pgc_step(stt, kf_ids[-1])
    assert jl.n_loops == tl.n_loops == 1
    Cj, Ct = (centres(s_.kf_R, s_.kf_t, kf_ids) for s_ in (sj, stt))
    np.testing.assert_allclose(Ct, Cj, atol=1e-3)
    assert int(stt.lm_mask.sum()) == int(sj.lm_mask.sum())
    # then the time-sliced global BA: the port's result must meet the
    # gates of tests/test_loop_reloc.py; the two libraries' GBA results are
    # not compared (see test_gba_problem_and_global_ba)
    stt = tl.finish_gba(stt, kf_ids[-1])
    assert tl._hyp is None and tl._pgc is None and tl._gba is None
    C0 = centres(d["tst"].kf_R, d["tst"].kf_t, kf_ids)
    Ct = centres(stt.kf_R, stt.kf_t, kf_ids)
    e0, et = (np.linalg.norm(C - C_gt, axis=1) for C in (C0, Ct))
    assert et[-1] < 0.3 * e0[-1] and et.mean() < e0.mean()
    assert tl.stats["welds"] == 2 and tl.stats["verifications"] >= 1


# ---------------------------------------------------------------------------
# The sliced correction's three repairs (the port departs from the JAX
# package here on purpose: slam/loopclosing.py's module note)
# ---------------------------------------------------------------------------

def _sliced_loop(d, kf_count=16):
    """A port LoopCloser holding the time-sliced correction of the drifted
    map's verified loop, started as on_keyframe starts it: the third
    coincidence of a hypothesis resolved at keyframe `cur`."""
    st = d["tst"]
    tl = tlc.LoopCloser(TC, TCAPS, codebook="live", seed=0, fix_scale=True)
    tl.gba_iters = 4
    cur, cand = d["cur"], d["cand"]
    stats = torch.tensor([60, 1, int(st.kf_frame_id[cand]),
                          int(st.kf_frame_id[cur])])
    tl._pending_verify = (cand, tuple(T(x) for x in d["T12"]), cur,
                          types.SimpleNamespace(get=lambda: stats),
                          tl.consistency_needed - 1)
    st, corrected = tl._resolve_verify(st, cur, kf_count)
    assert corrected and tl._pgc is not None
    return tl, st


@pytest.fixture(scope="module")
def sliced(loop):
    """The sliced correction of the drifted loop drained by finish_gba (the
    pose-graph chunks' iteration counts recorded), and drained step by
    step with each weld's correction of the tracker's pose taken alone."""
    d = loop["drift"]
    cur = d["cur"]
    chunks = []
    chunk = tlc.loop_pg_chunk

    def counted(*a, **k):
        chunks.append(k["iters"])
        return chunk(*a, **k)
    tlc.loop_pg_chunk = counted
    try:
        tl, st = _sliced_loop(d)
        counted_at_start = (tl.n_loops, tl.last_loop_kf)
        T12c = tl._pgc["T12"]
        drained = tl.finish_gba(st, cur)
    finally:
        tlc.loop_pg_chunk = chunk
    ts, st_s = _sliced_loop(d)
    while ts._pgc is not None:
        st_s = ts._pgc_step(st_s, cur)
    after_pg, c_pg = st_s, ts.chain_corr
    ts.chain_corr = None
    while ts._gba is not None:
        st_s = ts._gba_step(st_s, cur)
    return dict(tl=tl, drained=drained, chunks=chunks, T12c=T12c,
                counted_at_start=counted_at_start, after_pg=after_pg,
                c_pg=c_pg, c_gba=ts.chain_corr, stepped=st_s)


def test_finish_gba_composes_both_welds_corrections(loop, sliced):
    """finish_gba welds twice (pose graph, then GBA): the tracker's pose
    chain receives the pose graph's correction composed with the GBA's, so
    the reference keyframe's old pose, so corrected, is its final pose (the
    second weld used to overwrite the first)."""
    cur = loop["drift"]["cur"]
    c_pg, c_gba = sliced["c_pg"], sliced["c_gba"]
    assert float(torch.linalg.norm(c_pg[1])) > 1e-2   # the loop moved it
    want = tlie.se3_mul(*c_pg, *c_gba)
    got = sliced["tl"].chain_corr
    for a, b in zip(got, want):
        np.testing.assert_allclose(N(a), N(b), atol=1e-6)
    st0, fin = loop["drift"]["tst"], sliced["drained"]
    assert torch.equal(fin.kf_t, sliced["stepped"].kf_t)
    R, t = tlie.se3_mul(st0.kf_R[cur], st0.kf_t[cur], *got)
    np.testing.assert_allclose(N(R), N(fin.kf_R[cur]), atol=1e-4)
    np.testing.assert_allclose(N(t), N(fin.kf_t[cur]), atol=1e-4)


def test_sliced_correction_runs_pg_iters(loop, sliced):
    """The last chunk is cut: chunks of 3, 3, 3 and 1 for pg_iters 10 (whole
    chunks ran 12), and the welded poses are the synchronous correction's
    with pg_iters 10."""
    d = loop["drift"]
    assert sliced["chunks"] == [3, 3, 3, 1]
    assert sum(sliced["chunks"]) == sliced["tl"].pg_iters == 10
    sync = tlc.correct_loop(d["tst"], TC, d["cur"], d["cand"],
                            sliced["T12c"], pg_iters=10, fix_scale=True)
    after = sliced["after_pg"]
    for name in ("kf_R", "kf_t"):
        np.testing.assert_allclose(N(getattr(after, name)),
                                   N(getattr(sync, name)), atol=1e-5,
                                   err_msg=name)


def test_sliced_loop_counted_when_its_weld_lands(loop, sliced):
    """A sliced loop is counted, and its cooldown starts, when its weld
    lands with both loop ends holding their keyframes; when a loop end's
    slot holds another keyframe by then, the loop is not counted, its
    cooldown does not start and no loop edge is added."""
    assert sliced["counted_at_start"] == (0, -10 ** 9)
    assert (sliced["tl"].n_loops, sliced["tl"].last_loop_kf) == (1, 16)
    d = loop["drift"]
    cur, cand = d["cur"], d["cand"]
    tl, st = _sliced_loop(d)
    tl.run_gba = False
    fid = st.kf_frame_id.clone()
    fid[cur] = 999                         # the slot was reused meanwhile
    live = tl.finish_gba(dataclasses.replace(st, kf_frame_id=fid), cur)
    assert (tl.n_loops, tl.last_loop_kf) == (0, -10 ** 9)
    assert tl.stats["welds"] == 1
    assert not bool(live.loop_edges[cur, cand])


def jax_gba_relabel_spread(seeds=range(1, 9)):
    """test_gba_problem_and_global_ba's time-sliced JAX GBA on the corrected
    drifted map with its landmark table in the order of random permutations
    (the same problem, its running sums in other orders): the mean
    keyframe-centre error against the ground truth, and its change from the
    table order's."""
    import dataclasses as dc
    st, kf_ids, gt, _ = jsyn.make_drifted_loop_state(JC, CAPS, K=16,
                                                     drift=0.35)
    cur, cand = kf_ids[-1], kf_ids[0]
    T12, _, _ = jlc.verify_loop_candidate(
        st, JC, jnp.asarray(cur), jnp.asarray(cand), jax.random.PRNGKey(0),
        fix_scale=True, min_inliers=20)
    sj = jlc.correct_loop(st, JC, jnp.asarray(cur), jnp.asarray(cand), T12,
                          fix_scale=True)
    R_gt, t_gt = (N(x) for x in gt)
    C_gt = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(kf_ids))])

    def run(s):
        c = (s.kf_R, s.kf_t, s.lm_pos, jnp.asarray(1e-4))
        for _ in range(5):
            c = jlc.gba_chunk(s, JC, c, iters=2)
        return np.linalg.norm(centres(*c[:2], kf_ids) - C_gt, axis=1).mean()
    base = run(sj)
    print("table order", base, flush=True)
    olm = np.asarray(sj.obs_lm)
    for seed in seeds:
        perm = np.random.RandomState(seed).permutation(CAPS.L)
        inv = np.argsort(perm)
        e = run(dc.replace(sj, lm_pos=sj.lm_pos[perm],
                           lm_mask=sj.lm_mask[perm],
                           obs_lm=jnp.asarray(np.where(
                               olm >= 0, inv[np.maximum(olm, 0)],
                               olm).astype(olm.dtype))))
        print("relabel", seed, e, "change", abs(e - base), flush=True)


if __name__ == "__main__":
    jax_gba_relabel_spread()
