"""Stereo depth, rectification and the multi-level pyramid of the port
against the JAX package on seeded numpy inputs: stereo_match_depth on the
cases of tests/test_stereo.py, its LightGlue variant, stereo_fisheye_depth,
the rectifier on the cases of tests/test_rectify.py, gaussian_pyramid,
remap_bilinear, extract_multiscale with the shipped SuperPoint, and the
stereo frame constructors.

Tolerances: depth sets and values exactly where both sides see the same
float32 numbers (descriptor matching, fisheye triangulation within 1e-4
relative); the LightGlue variant, whose bf16 layers round differently in
the two frameworks, on >= 97 % of the rows; the rectifying rotations to
1e-12, the remap grids within 2e-3 px and a remapped image within 0.05 of
255; pyramid levels within 1e-4; pyramid keypoints (>= 95 % in common, per
level) as the RGB-D frame program's in tests/test_torch_frontend.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from dani_slam_tpu.core import cameras as jcam
from dani_slam_tpu.core import lie as jlie
from dani_slam_tpu.models import lightglue as jlg
from dani_slam_tpu.models import superpoint as jsp
from dani_slam_tpu.ops import frontend as jfe
from dani_slam_tpu.ops import image as jimg
from dani_slam_tpu.ops import rectify as jrect
from dani_slam_tpu.slam import frame as jfr
from dani_slam_tpu.utils import synthetic as jsyn
from dani_slam_tpu_torch.core import cameras as tcam
from dani_slam_tpu_torch.models import lightglue as tlg
from dani_slam_tpu_torch.models import superpoint as tsp
from dani_slam_tpu_torch.ops import frontend as tfe
from dani_slam_tpu_torch.ops import image as timg
from dani_slam_tpu_torch.ops import rectify as trect
from dani_slam_tpu_torch.slam import frame as tfr
from dani_slam_tpu_torch.utils import synthetic

torch.set_num_threads(2)       # several test workers share the machine

BASELINE = 0.12
JC = jcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def N(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# stereo_match_depth (tests/test_stereo.py's cases)
# ---------------------------------------------------------------------------

def _feature_pair():
    """tests/test_stereo.py's render_stereo: left features of a world seen
    from the orbit's first pose, the right ones the same points projected
    from the camera `BASELINE` to the right, 0.2 px noise."""
    world = jsyn.make_world(1200, desc_dim=64, seed=7)
    R, t = jsyn.orbit_trajectory(1, radius=10.0)
    featL, tid = jsyn.render_frame(world, JC, R[0], t[0], n_max=256,
                                   noise_px=0.2, seed=0, with_depth=True)
    pts = np.asarray(world.points)[np.maximum(np.asarray(tid), 0)]
    pc = np.asarray(jlie.se3_apply(R[0], t[0] + jnp.asarray(
        [-BASELINE, 0.0, 0.0]), jnp.asarray(pts)))
    xy_r = np.asarray(jcam.project(JC, jnp.asarray(pc)))
    xy_r = (xy_r + np.random.RandomState(1).randn(*xy_r.shape) * 0.2) \
        .astype(np.float32)
    valid_r = np.asarray(featL.valid) & (pc[:, 2] > 0.3)
    return (N(featL.xy), N(featL.desc), N(featL.valid), xy_r,
            N(featL.desc), valid_r), N(featL.depth)


def _one(xy_l, xy_r):
    d = np.ones((1, 8), np.float32) / 8 ** 0.5
    return (np.float32([xy_l]), d, np.ones(1, bool), np.float32([xy_r]), d,
            np.ones(1, bool))


@pytest.mark.parametrize("case", ["metric", "across-rows",
                                  "negative-disparity"])
def test_stereo_match_depth(case):
    if case == "metric":
        args, true_d = _feature_pair()
    elif case == "across-rows":
        args = _one([100.0, 100.0], [80.0, 150.0])
    else:
        args = _one([100.0, 100.0], [150.0, 100.0])
    dj = N(jfr.stereo_match_depth(*map(J, args), jnp.float32(500.0),
                                  jnp.float32(BASELINE)))
    dt = N(tfr.stereo_match_depth(*map(T, args), 500.0, BASELINE))
    np.testing.assert_array_equal(np.isfinite(dt), np.isfinite(dj))
    ok = np.isfinite(dj)
    np.testing.assert_allclose(dt[ok], dj[ok], rtol=1e-6)
    if case == "metric":
        assert ok.sum() > 100
        assert np.median(np.abs(dt[ok] - true_d[ok]) / true_d[ok]) < 0.05
    else:
        assert not ok.any()


def test_stereo_trim_takes_the_averaging_median():
    """Every row matched with an even count: the 1.5x-median trim sits on
    the average of the two middle distances (jnp.median), not the lower
    one (torch.median) — a row between the two is kept only so."""
    xy_l = np.float32([[100.0 + 10 * i, 50.0] for i in range(4)])
    xy_r = xy_l - [5.0, 0.0]
    d_l = np.eye(4, 8, dtype=np.float32)
    # descriptor distances 0.1, 0.3, 0.5, 0.62: median 0.4, lower 0.3
    ang = np.float32([0.1, 0.3, 0.5, 0.62])
    d_r = d_l.copy()
    for i, a in enumerate(ang):
        c = 1 - a ** 2 / 2                  # |u - v| = a for unit u, v
        d_r[i] = c * d_l[i] + np.sqrt(1 - c * c) * np.eye(8)[4 + i]
    args = (xy_l, d_l, np.ones(4, bool), xy_r.astype(np.float32), d_r,
            np.ones(4, bool))
    dj = N(jfr.stereo_match_depth(*map(J, args), jnp.float32(500.0),
                                  jnp.float32(BASELINE)))
    dt = N(tfr.stereo_match_depth(*map(T, args), 500.0, BASELINE))
    np.testing.assert_array_equal(np.isfinite(dt), np.isfinite(dj))
    # 0.5 <= 1.5 * 0.4 is kept, 0.62 is dropped (1.5 * 0.3 drops both)
    np.testing.assert_array_equal(np.isfinite(dt), [True, True, True, False])


# ---------------------------------------------------------------------------
# Real keypoints: the LightGlue variant and the frame constructors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stereo_images():
    """One rectified 320x240 pair of the bench world (f 250)."""
    W, H, f = 320, 240, 250.0
    R, t = synthetic.orbit_trajectory(2, radius=10.0, angle_span=0.01)
    left, right, _ = synthetic.make_stereo_image_sequence(
        [f, f, W / 2, H / 2], W, H, R[:1], t[:1], baseline=BASELINE)
    return left[0], right[0], (W, H, f)


def _keys(xy, valid):
    """{rounded keypoint: row} of the valid rows."""
    return {tuple(np.round(p, 2)): i
            for i, (p, v) in enumerate(zip(N(xy), N(valid))) if v}


def test_stereo_depth_lightglue(stereo_images):
    """Both packages' LightGlue variants on the JAX package's keypoints of
    one pair: depth finite on the same rows for >= 97 % of them and equal
    where both matched the same right keypoint."""
    left, right, (W, H, f) = stereo_images
    g = jnp.stack([jimg.to_gray01(J(left)), jimg.to_gray01(J(right))])
    heat, dm = jsp.SuperPoint().apply(jsp.load_default_params(), g[..., None])
    out = [jfe.extract(heat[i], dm[i], n_max=256) for i in range(2)]
    args = [N(out[i][k]) for i in range(2) for k in ("xy", "desc", "valid")]
    dj = N(jfr.stereo_match_depth_lightglue(
        jlg.load_default_matcher(W, H), *map(J, args), jnp.float32(f),
        jnp.float32(BASELINE)))
    dt = N(tfr.stereo_match_depth_lightglue(
        tlg.load_default_matcher(W, H, device="cpu"), *map(T, args), f,
        BASELINE))
    valid = args[2]
    same = np.isfinite(dt) == np.isfinite(dj)
    assert same[valid].mean() >= 0.97, same[valid].mean()
    both = np.isfinite(dt) & np.isfinite(dj)
    assert both.sum() > 50
    eq = np.isclose(dt[both], dj[both], rtol=1e-6)
    assert eq.mean() >= 0.97


@pytest.mark.parametrize("matcher", ["descriptor", "lightglue"])
def test_build_frame_stereo(stereo_images, matcher):
    """The stereo frame (SuperPoint on a batch of two, stereo depth): the
    port keeps >= 95 % of the JAX package's left keypoints and gives them
    the same depth (>= 90 % of them: a keypoint that moved its right
    partner moves its match)."""
    left, right, (W, H, f) = stereo_images
    jc = jcam.Camera.pinhole(f, f, W / 2, H / 2, W, H)
    tc = tcam.Camera.pinhole(f, f, W / 2, H / 2, W, H, device="cpu")
    mj = jlg.load_default_matcher(W, H) if matcher == "lightglue" else None
    mt = (tlg.load_default_matcher(W, H, device="cpu")
          if matcher == "lightglue" else None)
    fj = jfr.build_frame_stereo(jsp.load_default_params(), J(left),
                                J(right), jc, BASELINE, 0.0, n_max=256,
                                matcher=mj)
    ft = tfr.build_frame_stereo(tsp.load_default_params("cpu"), T(left),
                                T(right), tc, BASELINE, 0.0, n_max=256,
                                matcher=mt)
    kj, kt = _keys(fj.xy, fj.valid), _keys(ft.xy, ft.valid)
    common = set(kj) & set(kt)
    assert len(kj) > 100
    assert len(common) >= 0.95 * len(kj)
    dj, dt = N(fj.depth), N(ft.depth)
    same = [np.isclose(dj[kj[p]], dt[kt[p]], rtol=1e-5) or
            (np.isinf(dj[kj[p]]) and np.isinf(dt[kt[p]])) for p in common]
    assert np.mean(same) >= 0.9
    assert np.isfinite(dt).sum() > 50


# ---------------------------------------------------------------------------
# Fisheye stereo (tests/test_stereo.py's TestFisheyeStereo case)
# ---------------------------------------------------------------------------

KB8_L = (280.0, 280.0, 320.0, 240.0, -0.01, 0.02, -0.005, 0.001, 640, 480)
KB8_R = (282.0, 282.0, 318.0, 242.0, -0.012, 0.021, -0.004, 0.0012, 640,
         480)


def _fisheye_case():
    ang = 0.02
    R_rl = np.float32([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]])
    t_rl = np.float32([-0.11, 0.0, 0.0])
    rng = np.random.RandomState(3)
    n = 128
    pc_l = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                     rng.uniform(1.5, 4.5, n)], 1).astype(np.float32)
    cl, cr = jcam.Camera.kb8(*KB8_L), jcam.Camera.kb8(*KB8_R)
    xy_l = N(jcam.project(cl, J(pc_l)))
    pc_r = pc_l @ R_rl.T + t_rl
    xy_r = N(jcam.project(cr, J(pc_r)))

    def inb(xy):
        return ((xy[:, 0] > 2) & (xy[:, 0] < 638) & (xy[:, 1] > 2) &
                (xy[:, 1] < 478))
    ok = inb(xy_l) & inb(xy_r) & (pc_r[:, 2] > 0.1)
    desc = rng.randn(n, 64).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    perm = rng.permutation(n)
    return (xy_l, desc, ok, xy_r[perm], desc[perm], ok[perm]), R_rl, t_rl, \
        pc_l


@pytest.mark.parametrize("lapping", [None, (100.0, 540.0)])
def test_stereo_fisheye_depth(lapping):
    args, R_rl, t_rl, pc_l = _fisheye_case()
    kw = {} if lapping is None else dict(lapping_l=lapping,
                                         lapping_r=lapping)
    dj = N(jfr.stereo_fisheye_depth(jcam.Camera.kb8(*KB8_L),
                                    jcam.Camera.kb8(*KB8_R), *map(J, args),
                                    J(R_rl), J(t_rl), **kw))
    dt = N(tfr.stereo_fisheye_depth(
        tcam.Camera.kb8(*KB8_L, device="cpu"),
        tcam.Camera.kb8(*KB8_R, device="cpu"), *map(T, args), T(R_rl),
        T(t_rl), **kw))
    np.testing.assert_array_equal(np.isfinite(dt), np.isfinite(dj))
    got = np.isfinite(dt)
    np.testing.assert_allclose(dt[got], dj[got], rtol=1e-4)
    if lapping is None:
        assert got.sum() >= 0.8 * args[2].sum()
        assert np.median(np.abs(dt[got] - pc_l[got, 2])) < 0.05
    else:
        assert (N(args[0])[got, 0] >= 100).all()


def test_build_frame_stereo_fisheye(stereo_images):
    """The fisheye frame on one image pair (treated as KB8 images): the
    same keypoints (>= 95 %) and the same depth set as the JAX package."""
    left, right, _ = stereo_images
    cam = KB8_L[:8] + (320, 240)
    camr = KB8_R[:8] + (320, 240)
    R_rl = np.eye(3, dtype=np.float32)
    t_rl = np.float32([-BASELINE, 0.0, 0.0])
    fj = jfr.build_frame_stereo_fisheye(
        jsp.load_default_params(), J(left), J(right), jcam.Camera.kb8(*cam),
        jcam.Camera.kb8(*camr), J(R_rl), J(t_rl), 0.0, n_max=256)
    ft = tfr.build_frame_stereo_fisheye(
        tsp.load_default_params("cpu"), T(left), T(right),
        tcam.Camera.kb8(*cam, device="cpu"),
        tcam.Camera.kb8(*camr, device="cpu"), T(R_rl), T(t_rl), 0.0,
        n_max=256)
    kj, kt = _keys(fj.xy, fj.valid), _keys(ft.xy, ft.valid)
    common = set(kj) & set(kt)
    assert len(kj) > 100 and len(common) >= 0.95 * len(kj)
    dj, dt = N(fj.depth), N(ft.depth)
    same = [np.isfinite(dj[kj[p]]) == np.isfinite(dt[kt[p]]) for p in common]
    assert np.mean(same) >= 0.9


# ---------------------------------------------------------------------------
# Rectification (tests/test_rectify.py's cases)
# ---------------------------------------------------------------------------

def _rect_pair(mod, cam_mod, **dev):
    cam_l = cam_mod.Camera.pinhole(450.0, 452.0, 320.0, 240.0, 640, 480,
                                   dist=(-0.28, 0.07, 1e-4, -2e-5, 0.0),
                                   **dev)
    cam_r = cam_mod.Camera.pinhole(455.0, 457.0, 318.0, 242.0, 640, 480,
                                   dist=(-0.28, 0.07, 1e-5, 2e-5, 0.0),
                                   **dev)
    R = Rotation.from_rotvec([0.01, -0.02, 0.005]).as_matrix()
    Tv = np.array([-0.11, 0.001, -0.002])
    return cam_l, cam_r, R, Tv


def test_stereo_rectify_rotations():
    _, _, R, Tv = _rect_pair(jrect, jcam)
    out_j = jrect.stereo_rectify(np.eye(3), None, np.eye(3), None, R, Tv,
                                 (640, 480))
    out_t = trect.stereo_rectify(np.eye(3), None, np.eye(3), None, R, Tv,
                                 (640, 480))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, atol=1e-12)
    R1, R2, K_new, b = out_t
    np.testing.assert_allclose(R2 @ R @ R1.T, np.eye(3), atol=1e-10)
    t_rect = R2 @ Tv
    assert abs(abs(t_rect[0]) - b) < 1e-10
    assert abs(t_rect[1]) < 1e-10 and abs(t_rect[2]) < 1e-10


@pytest.mark.parametrize("model", ["pinhole", "kb8"])
def test_rectifier_maps_and_remap(model):
    """The two source grids of the rectifier within 2e-3 px of the JAX
    package's, the rectified camera and baseline equal, and one remapped
    pair within 0.05 gray levels."""
    if model == "pinhole":
        jl, jr, R, Tv = _rect_pair(jrect, jcam)
        tl, tr, _, _ = _rect_pair(trect, tcam, device="cpu")
    else:
        jl, jr = jcam.Camera.kb8(*KB8_L), jcam.Camera.kb8(*KB8_R)
        tl = tcam.Camera.kb8(*KB8_L, device="cpu")
        tr = tcam.Camera.kb8(*KB8_R, device="cpu")
        R = Rotation.from_rotvec([0.0, 0.02, 0.0]).as_matrix()
        Tv = np.array([-0.11, 0.0, 0.0])
    rj = jrect.build_rectifier(jl, jr, R, Tv, (640, 480))
    rt = trect.build_rectifier(tl, tr, R, Tv, (640, 480))
    np.testing.assert_allclose(N(rt.map_l), N(rj.map_l), atol=2e-3)
    np.testing.assert_allclose(N(rt.map_r), N(rj.map_r), atol=2e-3)
    np.testing.assert_array_equal(N(rt.cam.params), N(rj.cam.params))
    assert rt.baseline == rj.baseline
    rng = np.random.RandomState(0)
    img_l = rng.randint(0, 256, (480, 640), dtype=np.uint8)
    img_r = rng.randint(0, 256, (480, 640, 3), dtype=np.uint8)
    out_j = rj(J(img_l), J(img_r))
    out_t = rt(T(img_l), T(img_r))
    for a, b in zip(out_t, out_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(N(a), N(b), atol=0.05)


def test_remap_bilinear():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (40, 50), dtype=np.uint8)
    img3 = rng.rand(40, 50, 3).astype(np.float32)
    mx = rng.uniform(-3, 53, (30, 20)).astype(np.float32)
    my = rng.uniform(-3, 43, (30, 20)).astype(np.float32)
    mx[0, :4] = [0.0, 49.0, 49.5, -0.5]       # on and just past the edges
    my[0, :4] = [0.0, 39.0, 20.0, 20.0]
    for im in (img, img3):
        a = N(timg.remap_bilinear(T(im), T(mx), T(my)))
        b = N(jimg.remap_bilinear(J(im), J(mx), J(my)))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-4)
    assert (N(timg.remap_bilinear(T(img), T(mx), T(my)))[mx < 0] == 0).all()


# ---------------------------------------------------------------------------
# The scale pyramid
# ---------------------------------------------------------------------------

def test_gaussian_pyramid():
    rng = np.random.RandomState(4)
    g = rng.rand(480, 640).astype(np.float32)
    lj = jimg.gaussian_pyramid(J(g), 8, 1.2)
    lt = timg.gaussian_pyramid(T(g), 8, 1.2)
    assert [tuple(x.shape) for x in lt] == [tuple(x.shape) for x in lj]
    assert tuple(lt[-1].shape) == (134, 179)   # not a multiple of 8
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(N(a), N(b), atol=1e-4)


def test_extract_multiscale():
    """Eight levels of a 640x480 bench frame through the shipped
    SuperPoint: the same per-level budgets and octaves, keypoints in
    level-0 pixels, >= 95 % of each level's keypoints in common (the
    deepest level, 134x179, is not a multiple of SuperPoint's 8-px cell)."""
    R, t = synthetic.orbit_trajectory(2, radius=10.0, angle_span=0.01)
    imgs, _, _ = synthetic.make_rgbd_image_sequence(
        [500.0, 500.0, 320.0, 240.0], 640, 480, R[:1], t[:1], seed=0)
    g = N(jimg.to_gray01(J(imgs[0])))
    oj = jfe.extract_multiscale(jsp.load_default_params(), J(g),
                                n_max=1024, n_levels=8)
    ot = tfe.extract_multiscale(tsp.load_default_params("cpu"), T(g),
                                n_max=1024, n_levels=8)
    np.testing.assert_array_equal(N(ot["octave"]), N(oj["octave"]))
    assert sorted(ot) == sorted(oj)
    oct_ = N(oj["octave"])
    for lv in range(8):
        sel = oct_ == lv
        kj = _keys(N(oj["xy"])[sel], N(oj["valid"])[sel])
        kt = _keys(N(ot["xy"])[sel], N(ot["valid"])[sel])
        if len(kj) < 10:
            continue
        assert len(set(kj) & set(kt)) >= 0.95 * len(kj), lv
    assert N(ot["valid"])[oct_ == 7].sum() > 0
    # the deepest level's heatmap covers the same cells in both packages
    lvl = timg.gaussian_pyramid(T(g), 8, 1.2)[7]
    heat_t, _ = tsp.apply(tsp.load_default_params("cpu"), lvl)
    heat_j, _ = jsp.apply(jsp.load_default_params(), J(N(lvl)))
    assert tuple(heat_t.shape) == tuple(heat_j.shape) == (128, 176)
