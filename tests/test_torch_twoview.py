"""Monocular initialization pieces of the port against the JAX package on
seeded numpy inputs: the camera additions (KB8 projection, its Newton
unprojection and Jacobian, bearings, radtan distortion, epipolar error,
two-view DLT triangulation, disparity depth), the averaging medians,
search_for_initialization, the two-view reconstruction on the cases of
tests/test_twoview.py, and tracking.build_initial_map.

The RANSAC hypotheses are the JAX key's own draws (jax.random.categorical
as in twoview.two_view_init), handed to the port as index sets.

Tolerances: camera functions within 1e-5 relative (KB8's Newton steps and
arctan in f32; the epipolar error, a squared f32 difference that cancels,
within 1e-3 relative or 1e-9 absolute, 1e-4 of its gate); the chosen
motion's R within 1e-4 and unit t within 1e-3
(the SVDs of the two libraries may differ in sign and order: the chosen
motion is compared, never a candidate index); ok and the model choice
equal; census inlier sets equal up to pairs whose residual or parallax lies
within 1e-3 relative of its threshold; match sets exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dani_slam_tpu.core import cameras as jcam
from dani_slam_tpu.core import lie as jlie
from dani_slam_tpu.core import state as jst
from dani_slam_tpu.ops import matching as jmatch
from dani_slam_tpu.ops import twoview as jtv
from dani_slam_tpu.slam import frame as jfr
from dani_slam_tpu.slam import tracking as jtr
from dani_slam_tpu_torch.core import cameras as tcam
from dani_slam_tpu_torch.core import state as tst
from dani_slam_tpu_torch.ops import matching as tmatch
from dani_slam_tpu_torch.ops import stats as tstats
from dani_slam_tpu_torch.ops import twoview as ttv
from dani_slam_tpu_torch.slam import frame as tfr
from dani_slam_tpu_torch.slam import tracking as ttr

torch.set_num_threads(2)       # several test workers share the machine

FOCAL = 520.0
KB8 = (280.0, 282.0, 320.0, 240.0, -0.01, 0.02, -0.005, 0.001, 640, 480)


def T(x):
    return torch.as_tensor(np.array(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def draws(key, mask, n_hypo=256):
    """The (idx_e, idx_h) index sets two_view_init draws from `key`."""
    k1, k2 = jax.random.split(key)
    p = jnp.asarray(mask).astype(jnp.float32) + 1e-6

    def cat(k, m):
        return T(jax.random.categorical(
            k, jnp.broadcast_to(jnp.log(p), (n_hypo, m, p.shape[0])),
            axis=-1))
    return cat(k1, 8), cat(k2, 4)


# ---------------------------------------------------------------------------
# Cameras
# ---------------------------------------------------------------------------

def _points(n=256, seed=0):
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(0.5, 8, n)], 1).astype(np.float32)
    pts[:4, :2] = 0.0                  # on the axis: the r < 1e-9 branch
    return pts


def test_kb8_project_unproject_and_jacobian():
    jc = jcam.Camera.kb8(*KB8)
    tc = tcam.Camera.kb8(*KB8, device="cpu")
    pts = _points()
    px_j = jcam.project(jc, jnp.asarray(pts))
    px_t = tcam.project(tc, T(pts))
    np.testing.assert_allclose(N(px_t), N(px_j), rtol=1e-5, atol=1e-3)
    ray_j = jcam.unproject(jc, px_j)
    ray_t = tcam.unproject(tc, T(px_j))
    np.testing.assert_allclose(N(ray_t), N(ray_j), rtol=1e-5, atol=1e-5)
    # round trip: the ray points back at the scene point
    np.testing.assert_allclose(N(ray_t)[:, :2], pts[:, :2] / pts[:, 2:],
                               atol=1e-4)
    np.testing.assert_allclose(N(tcam.project_jac(tc, T(pts))),
                               N(jcam.project_jac(jc, jnp.asarray(pts))),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(N(tcam.unproject_bearing(tc, T(px_j))),
                               N(jcam.unproject_bearing(jc, px_j)),
                               atol=1e-6)


def test_radtan_and_disparity_depth():
    rng = np.random.RandomState(1)
    dist = np.float32([-0.28, 0.07, 2e-4, 1.8e-5, 0.0])
    xn = rng.uniform(-0.6, 0.6, (200, 2)).astype(np.float32)
    xd_j = jcam.radtan_distort(jnp.asarray(dist), jnp.asarray(xn))
    xd_t = tcam.radtan_distort(T(dist), T(xn))
    np.testing.assert_allclose(N(xd_t), N(xd_j), atol=1e-6)
    np.testing.assert_allclose(N(tcam.radtan_undistort(T(dist), xd_t)),
                               N(jcam.radtan_undistort(jnp.asarray(dist),
                                                       xd_j)), atol=1e-6)
    disp = np.float32([-1.0, 0.0, 0.5, 3.0, 40.0])
    np.testing.assert_array_equal(
        N(tcam.stereo_depth_from_disparity(500.0, 0.12, T(disp))),
        N(jcam.stereo_depth_from_disparity(jnp.float32(500.0),
                                           jnp.float32(0.12),
                                           jnp.asarray(disp))))


def _two_views(n=200, seed=5, noise_px=0.0):
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3).astype(np.float32)
    pts[:, 0] *= 2.0
    pts[:, 1] *= 1.5
    pts[:, 2] = rng.uniform(3, 10, n)
    R, t = jlie.se3_exp(jnp.asarray([0.4, 0.1, 0.05, 0.02, -0.06, 0.01]))
    t = t / jnp.linalg.norm(t)
    p2 = np.asarray(jlie.se3_apply(R, t, jnp.asarray(pts)))
    r1 = pts / pts[:, 2:3]
    r2 = p2 / p2[:, 2:3]
    if noise_px:
        r1[:, :2] += rng.randn(n, 2).astype(np.float32) * noise_px / FOCAL
        r2[:, :2] += rng.randn(n, 2).astype(np.float32) * noise_px / FOCAL
    return r1, r2, np.asarray(R), np.asarray(t), pts


def test_triangulate_two_view_and_epipolar_error():
    r1, r2, R, t, pts = _two_views(noise_px=0.5)
    X_j = jcam.triangulate_two_view(jnp.asarray(r1), jnp.asarray(r2),
                                    jnp.asarray(R), jnp.asarray(t))
    X_t = tcam.triangulate_two_view(T(r1), T(r2), T(R), T(t))
    np.testing.assert_allclose(N(X_t), N(X_j), rtol=1e-4, atol=1e-4)
    assert np.median(np.linalg.norm(N(X_t) - pts, axis=1)) < 0.05
    jc = jcam.Camera.pinhole(FOCAL, FOCAL, 320.0, 240.0, 640, 480)
    tc = tcam.Camera.pinhole(FOCAL, FOCAL, 320.0, 240.0, 640, 480,
                             device="cpu")
    kp1 = (r1[:, :2] * FOCAL + [320.0, 240.0]).astype(np.float32)
    kp2 = (r2[:, :2] * FOCAL + [320.0, 240.0]).astype(np.float32)
    # (R12, t12) maps view-2 coordinates to view 1
    R12 = R.T
    t12 = -R.T @ t
    e_j = jcam.epipolar_error(jc, jc, jnp.asarray(kp2), jnp.asarray(kp1),
                              jnp.asarray(R12), jnp.asarray(t12))
    e_t = tcam.epipolar_error(tc, tc, T(kp2), T(kp1), T(R12), T(t12))
    np.testing.assert_allclose(N(e_t), N(e_j), rtol=1e-3, atol=1e-9)
    assert np.median(N(e_t)) < (2.0 / FOCAL) ** 2


# ---------------------------------------------------------------------------
# Medians with numpy's semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["odd", "even", "nan", "all-nan",
                                  "single"])
def test_averaging_median(case):
    rng = np.random.RandomState(3)
    x = rng.uniform(0, 10, {"odd": 9, "single": 1}.get(case, 10)) \
        .astype(np.float32)
    if case in ("nan", "all-nan"):
        x[::3 if case == "nan" else 1] = np.nan
    np.testing.assert_array_equal(N(tstats.nanmedian(T(x))),
                                  N(jnp.nanmedian(jnp.asarray(x))))
    np.testing.assert_array_equal(N(tstats.median(T(x))),
                                  N(jnp.median(jnp.asarray(x))))
    if case == "even":          # torch's own median takes the lower one
        assert float(tstats.median(T(x))) != float(torch.median(T(x)))


# ---------------------------------------------------------------------------
# Init matching
# ---------------------------------------------------------------------------

def _init_frames(n=300, seed=7, shift=(14.0, -6.0), D=64):
    """Two keypoint sets of the same scene: the second shifted, jittered,
    reordered, with a fifth of its descriptors perturbed."""
    rng = np.random.RandomState(seed)
    xy0 = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
    desc0 = rng.randn(n, D).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=1, keepdims=True)
    perm = rng.permutation(n)
    xy1 = (xy0 + shift + rng.randn(n, 2) * 2.0).astype(np.float32)[perm]
    desc1 = desc0 + rng.randn(n, D).astype(np.float32) * 0.05
    desc1[: n // 5] += rng.randn(n // 5, D).astype(np.float32) * 0.5
    desc1 = (desc1 / np.linalg.norm(desc1, axis=1, keepdims=True))[perm]
    v0 = rng.rand(n) > 0.05
    v1 = rng.rand(n) > 0.05
    return (xy0, v0, desc0), (xy1, v1, desc1)


def test_search_for_initialization():
    a, b = _init_frames()
    mj = jmatch.search_for_initialization(*map(jnp.asarray, a + b))
    mt = tmatch.search_for_initialization(*map(T, a + b))
    ok = N(mj.ok)
    np.testing.assert_array_equal(N(mt.ok), ok)
    np.testing.assert_array_equal(N(mt.idx)[ok], N(mj.idx)[ok])
    np.testing.assert_allclose(N(mt.dist)[ok], N(mj.dist)[ok], atol=1e-5)
    assert 100 < ok.sum() < len(ok)


# ---------------------------------------------------------------------------
# Two-view reconstruction
# ---------------------------------------------------------------------------

def _case(name):
    """(rays1, rays2, mask, key seed) of tests/test_twoview.py's cases."""
    if name == "general":
        r1, r2, _, _, _ = _two_views(n=200)
        return r1, r2, np.ones(200, bool), 0
    if name == "noise-outliers":
        r1, r2, _, _, _ = _two_views(n=300, noise_px=0.5)
        r2[:60, :2] += np.random.RandomState(11).uniform(
            0.05, 0.2, (60, 2)).astype(np.float32)
        return r1, r2, np.ones(300, bool), 1
    if name == "too-few":
        r1, r2, _, _, _ = _two_views(n=200)
        mask = np.zeros(200, bool)
        mask[:30] = True
        return r1, r2, mask, 0
    if name == "pure-rotation":
        rng = np.random.RandomState(2)
        pts = rng.randn(150, 3).astype(np.float32) + [0, 0, 6]
        R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.1, 0.0])))
        p2 = pts @ R.T
        return (pts / pts[:, 2:3]).astype(np.float32), \
            (p2 / p2[:, 2:3]).astype(np.float32), np.ones(150, bool), 0
    # planar: the scene of tests/test_twoview.py on the plane z = 4
    rng = np.random.RandomState(5)
    pts = rng.randn(200, 3).astype(np.float32)
    pts[:, 0] *= 2.0
    pts[:, 1] *= 1.5
    pts[:, 2] = 4.0
    R, t = jlie.se3_exp(jnp.asarray([0.4, 0.1, 0.05, 0.02, -0.06, 0.01]))
    p2 = np.asarray(jlie.se3_apply(R, t / jnp.linalg.norm(t),
                                   jnp.asarray(pts)))
    return pts / pts[:, 2:3], (p2 / p2[:, 2:3]).astype(np.float32), \
        np.ones(200, bool), 3


def _near_threshold(rays1, rays2, R, t, focal, th_px=3.84 ** 0.5):
    """Pairs whose census residual or parallax lies within 1e-3 relative
    of its threshold under (R, t) (where two f32 SVDs may disagree)."""
    X = N(tcam.triangulate_two_view(T(rays1), T(rays2), T(R), T(t)))
    X2 = X @ R.T + t
    e1 = np.sum((X[:, :2] / X[:, 2:] - rays1[:, :2]) ** 2, 1)
    e2 = np.sum((X2[:, :2] / X2[:, 2:] - rays2[:, :2]) ** 2, 1)
    th = 4 * (th_px / focal) ** 2
    C2 = -R.T @ t
    d2 = X - C2
    cos = np.sum(X * d2, 1) / (np.linalg.norm(X, axis=1) *
                              np.linalg.norm(d2, axis=1))
    return ((np.abs(e1 / th - 1) < 1e-3) | (np.abs(e2 / th - 1) < 1e-3) |
            (np.abs(cos - 0.99998) < 1e-6))


@pytest.mark.parametrize("name", ["general", "noise-outliers", "too-few",
                                  "pure-rotation", "planar"])
def test_two_view_init(name):
    rays1, rays2, mask, seed = _case(name)
    key = jax.random.PRNGKey(seed)
    rj = jtv.two_view_init(key, jnp.asarray(rays1), jnp.asarray(rays2),
                           jnp.asarray(mask), jnp.float32(FOCAL))
    rt = ttv.two_view_init(draws(key, mask), T(rays1), T(rays2), T(mask),
                           FOCAL)
    assert bool(rt.ok) == bool(rj.ok)
    assert bool(rt.used_h) == bool(rj.used_h)
    expect_ok = name in ("general", "noise-outliers", "planar")
    assert bool(rt.ok) == expect_ok
    if not expect_ok:
        return
    np.testing.assert_allclose(N(rt.R21), N(rj.R21), atol=1e-4)
    np.testing.assert_allclose(N(rt.t21), N(rj.t21), atol=1e-3)
    inl_t, inl_j = N(rt.inliers), N(rj.inliers)
    differ = inl_t != inl_j
    near = _near_threshold(rays1, rays2, N(rj.R21), N(rj.t21), FOCAL)
    assert not (differ & ~near).any(), np.flatnonzero(differ & ~near)
    good = inl_t & inl_j
    np.testing.assert_allclose(N(rt.pts3d)[good], N(rj.pts3d)[good],
                               rtol=1e-3, atol=1e-3)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) == differ.sum()


def test_sampson_transfer_and_decompositions():
    """The batched solves and residuals on the same minimal sets; the four
    essential candidates compared as a set (their order follows the SVD's
    signs)."""
    r1, r2, R, t, _ = _two_views(n=120, noise_px=0.3)
    idx = np.arange(96).reshape(12, 8)
    E_j = jtv._eight_point(jnp.asarray(r1)[idx], jnp.asarray(r2)[idx])
    E_t = ttv._eight_point(T(r1)[T(idx)], T(r2)[T(idx)])
    sgn = np.sign(np.sum(N(E_j) * N(E_t), axis=(1, 2)))[:, None, None]
    np.testing.assert_allclose(N(E_t) * sgn, N(E_j), atol=1e-4)
    np.testing.assert_allclose(
        N(ttv._sampson_sq(E_t, T(r1), T(r2))),
        N(jtv._sampson_sq(E_j, jnp.asarray(r1), jnp.asarray(r2))),
        rtol=1e-2, atol=1e-9)
    H_j = jtv._four_point_h(jnp.asarray(r1)[idx[:, :4]],
                            jnp.asarray(r2)[idx[:, :4]])
    H_t = ttv._four_point_h(T(r1)[T(idx[:, :4])], T(r2)[T(idx[:, :4])])
    np.testing.assert_allclose(
        N(ttv._h_transfer_sq(H_t, T(r1), T(r2))),
        N(jtv._h_transfer_sq(H_j, jnp.asarray(r1), jnp.asarray(r2))),
        rtol=1e-2, atol=1e-9)
    Rs_j, ts_j = jtv.decompose_essential(E_j[0])
    Rs_t, ts_t = ttv.decompose_essential(E_t[0])
    for Rj, tj in zip(N(Rs_j), N(ts_j)):
        err = [np.abs(Rt - Rj).max() + np.abs(tt - tj).max()
               for Rt, tt in zip(N(Rs_t), N(ts_t))]
        assert min(err) < 1e-3
    Hn = H_j[0] / jnp.linalg.svd(H_j[0], compute_uv=False)[1]
    Rh_j, th_j = jtv._decompose_homography(Hn)
    Rh_t, th_t = ttv._decompose_homography(T(Hn))
    for Rj, tj in zip(N(Rh_j), N(th_j)):
        err = [np.abs(Rt - Rj).max() + np.abs(tt - tj).max()
               for Rt, tt in zip(N(Rh_t), N(th_t))]
        assert min(err) < 1e-3


# ---------------------------------------------------------------------------
# The initial monocular map
# ---------------------------------------------------------------------------

def test_build_initial_map():
    """match_for_init -> two_view_from_matches (JAX draws) ->
    build_initial_map on two frames of a seeded scene: the same matches,
    motion, landmark slots and bindings; positions within 1e-3 of the
    median-depth scale."""
    rng = np.random.RandomState(4)
    n, D = 256, 256
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(4, 9, n)], 1).astype(np.float32)
    desc = rng.randn(n, D).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    R1, t1 = jlie.se3_exp(jnp.asarray([0.3, 0.02, 0.01, 0.0, 0.03, 0.0]))
    frames = []
    for i, (R, t) in enumerate(((np.eye(3, dtype=np.float32),
                                 np.zeros(3, np.float32)),
                                (np.asarray(R1), np.asarray(t1)))):
        pc = pts @ R.T + t
        xy = (pc[:, :2] / pc[:, 2:] * 500.0 + [320.0, 240.0] +
              rng.randn(n, 2) * 0.3).astype(np.float32)
        frames.append(dict(xy=xy, desc=desc, depth=np.full(n, np.inf,
                                                           np.float32),
                           valid=np.ones(n, bool), time=np.float32(i / 30),
                           octave=np.zeros(n, np.int8)))
    jc = jcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)
    tc = tcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480,
                             device="cpu")
    jf = [jfr.FrameFeatures(**{k: jnp.asarray(v) for k, v in f.items()})
          for f in frames]
    tf = [tfr.FrameFeatures(**{k: T(v) for k, v in f.items()})
          for f in frames]
    mj = jtr.match_for_init(*jf)
    mt = ttr.match_for_init(*tf)
    np.testing.assert_array_equal(N(mt.ok), N(mj.ok))
    np.testing.assert_array_equal(N(mt.idx)[N(mj.ok)], N(mj.idx)[N(mj.ok)])
    key = jax.random.PRNGKey(9)
    tvj = jtr.two_view_from_matches(key, jc, *jf, mj)
    tvt = ttr.two_view_from_matches(draws(key, N(mj.ok)), tc, *tf, mt)
    assert bool(tvj.ok) and bool(tvt.ok)
    caps = dict(K=8, L=1024, N=n, D=D)
    out_j = jtr.build_initial_map(jst.empty_map(jst.MapCaps(**caps)), jc,
                                  *jf, mj, tvj, jnp.int32(0), jnp.int32(1))
    out_t = ttr.build_initial_map(tst.empty_map(tst.MapCaps(**caps),
                                                device="cpu"), tc, *tf, mt,
                                  tvt, 0, 1)
    st_j, st_t = out_j[0], out_t[0]
    differ = N(tvt.inliers) != N(tvj.inliers)
    assert differ.sum() <= 2
    assert (int(out_t[1]), int(out_t[2])) == (int(out_j[1]), int(out_j[2]))
    if not differ.any():
        np.testing.assert_array_equal(N(out_t[3]), N(out_j[3]))
        np.testing.assert_array_equal(N(st_t.lm_mask), N(st_j.lm_mask))
    live = N(st_t.lm_mask) & N(st_j.lm_mask)
    assert live.sum() > 100
    np.testing.assert_allclose(N(st_t.lm_pos)[live], N(st_j.lm_pos)[live],
                               atol=1e-3)
    np.testing.assert_allclose(N(st_t.kf_t), N(st_j.kf_t), atol=1e-4)
    np.testing.assert_allclose(N(st_t.kf_R), N(st_j.kf_R), atol=1e-4)
    # the median depth of the inlier points is 1 (the averaging median)
    z = N(st_t.lm_pos)[N(st_t.lm_mask), 2]
    assert abs(np.median(z) - 1.0) < 1e-5
