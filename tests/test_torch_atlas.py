"""Atlas of the port against the JAX package's: the same small maps (built
with the JAX package's state functions, carried across as numpy) go through
transform_map, merge_into and Atlas.try_merge on both sides and are compared
slot by slot.

Tolerances: integer, bool and copied float fields exactly equal; fields that
went through the sim3 arithmetic (lm_pos, kf_R, kf_t, distance bands) within
atol 1e-5 (two f32 matmul orders).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dani_slam_tpu.core import cameras as jcam
from dani_slam_tpu.core import lie as jlie
from dani_slam_tpu.core import state as jst
from dani_slam_tpu.slam import atlas as jatlas
from dani_slam_tpu.utils import synthetic as jsyn
from dani_slam_tpu_torch.core import lie as tlie
from dani_slam_tpu_torch.core import state as tst
from dani_slam_tpu_torch.slam import atlas as tatlas

torch.set_num_threads(2)       # several test workers share the machine

CAM = jcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)
CAPS = jst.MapCaps(K=16, L=2048, N=128, D=64)
MOVED = ("lm_pos", "kf_R", "kf_t", "lm_dist_min", "lm_dist_max")
T = torch.as_tensor


def small_map(seed=0, n_kf=3, caps=CAPS):
    """n_kf keyframes of an orbit with landmarks from depth (the maps of
    tests/test_atlas.py, smaller)."""
    world = jsyn.make_world(400, desc_dim=caps.D, seed=seed)
    R_gt, t_gt = jsyn.orbit_trajectory(n_kf, radius=10.0, angle_span=0.2)
    st = jst.empty_map(caps)
    for k in range(n_kf):
        feat, _ = jsyn.render_frame(world, CAM, R_gt[k], t_gt[k],
                                    n_max=caps.N, seed=seed * 10 + k,
                                    with_depth=True)
        Xc = jcam.unproject(CAM, feat.xy) * feat.depth[:, None]
        Xw = jlie.se3_apply(*jlie.se3_inv(R_gt[k], t_gt[k]), Xc)
        good = feat.valid & jnp.isfinite(feat.depth)
        st, slots = jst.insert_landmarks(
            st, Xw, feat.desc, Xw, jnp.zeros(caps.N) + 0.5,
            jnp.zeros(caps.N) + 50.0, jnp.full((caps.N,), k, jnp.int32),
            jnp.full((caps.N,), k, jnp.int32), good)
        bind = jnp.where(good & (slots >= 0), slots, -1)
        st, _ = jst.insert_keyframe(
            st, R_gt[k], t_gt[k], k / 5.0, jnp.asarray(k), feat.xy,
            feat.valid, feat.desc, feat.depth,
            jnp.zeros((caps.N,), jnp.int8), bind)
    return st


def to_torch(st):
    return tst.map_state_from_numpy(st, device="cpu")


def assert_states_equal(t_state, j_state, moved=()):
    want = {f.name: np.asarray(getattr(j_state, f.name))
            for f in dataclasses.fields(j_state) if f.name != "caps"}
    got = tst.map_state_to_numpy(t_state)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        if name in moved:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)


@pytest.fixture(scope="module")
def maps():
    return small_map(seed=1, n_kf=3), small_map(seed=2, n_kf=2)


def test_sim3_ops_match():
    rng = np.random.RandomState(0)
    Ra, ta = (np.asarray(x) for x in jlie.se3_exp(
        jnp.asarray(rng.randn(6).astype(np.float32) * 0.3)))
    Rb, tb = (np.asarray(x) for x in jlie.se3_exp(
        jnp.asarray(rng.randn(6).astype(np.float32) * 0.3)))
    sa, sb = np.float32(1.3), np.float32(0.7)
    p = rng.randn(5, 3).astype(np.float32)
    for got, want in zip(
            tlie.sim3_mul(T(Ra), T(ta), T(sa), T(Rb), T(tb), T(sb)) +
            tlie.sim3_inv(T(Ra), T(ta), T(sa)) +
            (tlie.sim3_apply(T(Ra), T(ta), T(sa), T(p)),),
            jlie.sim3_mul(Ra, ta, jnp.asarray(sa), Rb, tb, jnp.asarray(sb)) +
            jlie.sim3_inv(Ra, ta, jnp.asarray(sa)) +
            (jlie.sim3_apply(Ra, ta, jnp.asarray(sa), p),)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_free_slots_and_rebuild_obs_bits(maps):
    a, _ = maps
    mask = np.asarray(a.lm_mask).copy()
    mask[5] = False
    mask[40] = False
    np.testing.assert_array_equal(
        tst.free_slots(T(mask), 64).numpy(),
        np.asarray(jst.free_slots(jnp.asarray(mask), 64)))
    # the maintained bits of a map without culls ARE the exact bits
    ta = to_torch(a)
    scrambled = dataclasses.replace(
        ta, lm_obs_bits=torch.full_like(ta.lm_obs_bits, 7))
    assert_states_equal(tst.rebuild_obs_bits(scrambled),
                        jst.rebuild_obs_bits(a))
    np.testing.assert_array_equal(
        tst.rebuild_obs_bits(scrambled).lm_obs_bits.numpy(),
        np.asarray(a.lm_obs_bits))


def test_transform_map_identity(maps):
    a, _ = maps
    got = tatlas.transform_map(to_torch(a), torch.eye(3), torch.zeros(3),
                               torch.ones(()))
    assert_states_equal(got, jatlas.transform_map(
        a, jnp.eye(3), jnp.zeros(3), jnp.ones(())), moved=MOVED)
    np.testing.assert_allclose(got.lm_pos.numpy(), np.asarray(a.lm_pos),
                               atol=1e-5)
    np.testing.assert_allclose(got.kf_t.numpy(), np.asarray(a.kf_t),
                               atol=1e-4)


def test_transform_map_sim3(maps):
    a, _ = maps
    R, t = (np.asarray(x) for x in jlie.se3_exp(
        jnp.asarray([0.5, -0.3, 0.2, 0.1, 0.2, -0.1])))
    s = np.float32(1.25)
    got = tatlas.transform_map(to_torch(a), T(R), T(t), T(s))
    assert_states_equal(got, jatlas.transform_map(a, R, t, jnp.asarray(s)),
                        moved=MOVED)
    # a landmark's reprojection into its keyframe is unchanged
    k = 0
    row = int(np.nonzero(np.asarray(a.obs_lm[k]) >= 0)[0][0])
    lm = int(a.obs_lm[k][row])
    p1 = jcam.project(CAM, jlie.se3_apply(a.kf_R[k], a.kf_t[k],
                                          a.lm_pos[lm]))
    pc = got.kf_R[k] @ got.lm_pos[lm] + got.kf_t[k]
    p2 = jcam.project(CAM, jnp.asarray(pc.numpy()))
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=0.05)


def test_merge_into_content(maps):
    a, b = maps
    mj, kmj, lmj, okj = jatlas.merge_into(a, b)
    mt, kmt, lmt, okt = tatlas.merge_into(to_torch(a), to_torch(b))
    assert bool(okt) and bool(okj)
    np.testing.assert_array_equal(kmt.numpy(), np.asarray(kmj))
    np.testing.assert_array_equal(lmt.numpy(), np.asarray(lmj))
    assert_states_equal(mt, mj)
    assert int(mt.kf_mask.sum()) == 5
    assert int(mt.lm_mask.sum()) == int(a.lm_mask.sum()) + \
        int(b.lm_mask.sum())


def test_merge_into_holes_and_last_slot():
    """Target with culled (free) slots in the middle, and a source that
    fills the target up to its LAST keyframe slot: the case in which the
    reference's scatter also writes unused rows to slot K-1."""
    caps = jst.MapCaps(K=4, L=1024, N=128, D=64)
    a = small_map(seed=3, n_kf=3, caps=caps)
    a = dataclasses.replace(a, kf_mask=a.kf_mask.at[1].set(False))
    b = small_map(seed=4, n_kf=2, caps=caps)
    mj, kmj, lmj, okj = jatlas.merge_into(a, b)
    mt, kmt, lmt, okt = tatlas.merge_into(to_torch(a), to_torch(b))
    assert bool(okt) and bool(okj)
    np.testing.assert_array_equal(kmt.numpy()[:2], [1, 3])
    np.testing.assert_array_equal(kmt.numpy(), np.asarray(kmj))
    np.testing.assert_array_equal(lmt.numpy(), np.asarray(lmj))
    # the source keyframe mapped to slot K-1 arrives intact
    np.testing.assert_array_equal(mt.kf_kp[3].numpy(), np.asarray(b.kf_kp[1]))
    np.testing.assert_array_equal(mt.kf_t[3].numpy(), np.asarray(b.kf_t[1]))
    assert int(mt.kf_mask.sum()) == 4


def test_merge_rejected_when_full():
    caps = jst.MapCaps(K=4, L=256, N=64, D=64)
    full = dataclasses.replace(jst.empty_map(caps),
                               kf_mask=jnp.ones(4, bool))
    _, _, _, okj = jatlas.merge_into(full, full)
    _, _, _, okt = tatlas.merge_into(to_torch(full), to_torch(full))
    assert not bool(okj) and not bool(okt)


@pytest.mark.parametrize("with_bow", [False, True])
def test_try_merge_with_stub_verifier(maps, with_bow):
    """The verifier is the caller's; a stub that accepts with a fixed
    relative sim3 drives both implementations down the merge branch."""
    stored, active = maps
    R12, t12 = (np.asarray(x) for x in jlie.se3_exp(
        jnp.asarray([0.1, 0.05, -0.2, 0.02, -0.03, 0.01])))
    s12 = np.float32(1.1)
    bow = qbow = None
    if with_bow:
        rng = np.random.RandomState(0)
        bow = rng.rand(CAPS.K, 32).astype(np.float32)
        bow /= bow.sum(1, keepdims=True)
        qbow = 0.9 * bow[1] + 0.1 * bow[0]      # keyframe 1 scores best
    calls = []

    def verify_j(st_a, st_b, kf_a, kf_b, key):
        calls.append(("j", int(kf_a), int(kf_b)))
        return (jnp.asarray(R12), jnp.asarray(t12), jnp.asarray(s12)), 40, \
            True

    def verify_t(st_a, st_b, kf_a, kf_b, key):
        calls.append(("t", int(kf_a), int(kf_b)))
        return (T(R12), T(t12), T(s12)), 40, True

    aj = jatlas.Atlas(CAPS)
    aj.stash(stored, bow=None if bow is None else jnp.asarray(bow))
    at = tatlas.Atlas(tst.MapCaps(*CAPS))
    at.stash(to_torch(stored), bow=None if bow is None else T(bow))
    assert at.n_maps() == 1
    rj = aj.try_merge(active, CAM, 1, None if qbow is None else
                      jnp.asarray(qbow), None, verify_j)
    rt = at.try_merge(to_torch(active), None, 1, None if qbow is None else
                      T(qbow), None, verify_t)
    assert rj is not None and rt is not None
    assert calls[0][1:] == calls[1][1:] == (1, 1 if with_bow else 2)
    assert at.n_maps() == aj.n_maps() == 0
    assert rt["new_active_kf"] == rj["new_active_kf"]
    assert rt["cand_kf"] == rj["cand_kf"]
    np.testing.assert_array_equal(rt["kf_map"].numpy(),
                                  np.asarray(rj["kf_map"]))
    np.testing.assert_array_equal(rt["lm_map"].numpy(),
                                  np.asarray(rj["lm_map"]))
    assert_states_equal(rt["st"], rj["st"], moved=MOVED)

    # a verifier that refuses leaves the atlas as it was
    at.stash(to_torch(stored))
    assert at.try_merge(to_torch(active), None, 1, None, None,
                        lambda *a: (None, 0, False)) is None
    assert at.n_maps() == 1
