"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips on a host without one (the
last four hold the monocular initialization, the stereo depth and a
pipelined IMU_RGBD run on the card against the CPU, and a second matcher's
track-step graph against the eager step). The file imports
neither JAX nor the JAX package, so that it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the window-match kernel rounds its operands to bf16 and adds
the exact f32 products on the tensor cores, in another order than the plain
version's ascending-k sum: kernels.window_match_agreement holds distances
within atol 1e-4 and lets an index differ only on a near-tie; two launches
are bitwise equal. The landmark-block kernel sums in another order than the
plain version's one-hot contraction: rtol/atol 1e-5, and bitwise equal from
one launch to the next (no float atomics). The reduction plan built on the
device equals the plain version's sort exactly (integers).
"""
import numpy as np
import pytest
import torch

from dani_slam_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only on the card)")
    return torch.device("cuda")


def match_problem(M, N, D, n_live, seed, dev):
    """Unit descriptors with planted near matches for the first rows, a
    valid prefix of n_live query rows, per-query radii 4 * 1.2^level."""
    rng = np.random.RandomState(seed)
    q = rng.randn(M, D).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.randn(N, D).astype(np.float32)
    k = min(M, N) // 2
    t[:k] = q[:k] + 0.05 * rng.randn(k, D)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    qxy = rng.uniform(0, 640, (M, 2)).astype(np.float32)
    txy = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    txy[:k] = qxy[:k] + rng.randn(k, 2) * 2
    if M > 3 and N > 3:
        q[3], qxy[3] = q[2], qxy[2]          # an exact tie between two rows
    qv = np.arange(M) < n_live
    tv = rng.rand(N) > 0.1
    r = (4.0 * 1.2 ** rng.randint(0, 4, M)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (q, qxy, qv, t, txy, tv, r))


@pytest.mark.parametrize("M,N,D,live", [
    (4096, 1024, 256, 3000),      # the main path: LQ x N x D
    (300, 700, 256, 300),         # ragged tiles
    (33, 5, 40, 33),              # D not a multiple of the staged chunk
    (64, 100, 256, 0),            # every query dead
    (1, 1, 8, 1)])
def test_window_match_kernel_equals_plain(dev, M, N, D, live):
    args = match_problem(M, N, D, live, M + N, dev)
    before = kernels.window_match_topk2.launches
    out_k = kernels.window_match_topk2(*args)
    assert kernels.window_match_topk2.launches == before + 1
    ref_dist = kernels.window_match_dist_ref(*args)
    out_r = kernels.window_match_reduce_ref(ref_dist)
    torch.cuda.synchronize()
    res = kernels.window_match_agreement(out_k, out_r, ref_dist, atol=1e-4)
    assert res["ok"], res
    again = kernels.window_match_topk2(*args)
    for name, a, b in zip(("best", "second", "idx", "col_best", "col_idx"),
                          out_k, again):
        assert torch.equal(a, b), name       # order-independent reductions
    if live and M > 8:
        assert bool((out_k[0] < 1e8).any())


def test_window_match_scalar_radius(dev):
    q, qxy, qv, t, txy, tv, _ = match_problem(500, 300, 256, 500, 1, dev)
    out_k = kernels.window_match_topk2(q, qxy, qv, t, txy, tv, 12.5)
    ref_dist = kernels.window_match_dist_ref(q, qxy, qv, t, txy, tv, 12.5)
    out_r = kernels.window_match_reduce_ref(ref_dist)
    res = kernels.window_match_agreement(out_k, out_r, ref_dist, atol=1e-4)
    assert res["ok"], res
    per_query = kernels.window_match_topk2(
        q, qxy, qv, t, txy, tv, torch.full((500,), 12.5, device=dev))
    for a, b in zip(out_k, per_query):
        assert torch.equal(a, b)


@pytest.mark.parametrize("radius", [10.0, 3.0])
def test_window_match_relocalization_shape(dev, radius):
    """Relocalization's shape: one keyframe's 1024 landmarks against the
    lost frame's 1024 keypoints, every row live, a scalar radius (the 10 px
    and 3 px passes of slam/loopclosing._reloc_refine)."""
    q, qxy, qv, t, txy, tv, _ = match_problem(1024, 1024, 256, 1024, 7, dev)
    before = kernels.window_match_topk2.launches
    out_k = kernels.window_match_topk2(q, qxy, qv, t, txy, tv, radius)
    assert kernels.window_match_topk2.launches == before + 1
    ref_dist = kernels.window_match_dist_ref(q, qxy, qv, t, txy, tv, radius)
    out_r = kernels.window_match_reduce_ref(ref_dist)
    torch.cuda.synchronize()
    res = kernels.window_match_agreement(out_k, out_r, ref_dist, atol=1e-4)
    assert res["ok"], res
    assert bool((out_k[0] < 1e8).any())
    again = kernels.window_match_topk2(q, qxy, qv, t, txy, tv, radius)
    for a, b in zip(out_k, again):
        assert torch.equal(a, b)


def lba_problem(P, N, L, seed, dev, invalid=0.3):
    rng = np.random.default_rng(seed)
    row_lm = rng.integers(0, L, size=(P, N)).astype(np.int32)
    row_lm[rng.random((P, N)) < invalid] = -1
    vals = rng.standard_normal((P, N, 30)).astype(np.float32)
    return (torch.as_tensor(row_lm, device=dev),
            torch.as_tensor(vals, device=dev))


@pytest.mark.parametrize("P,N,L,invalid", [
    (16, 1024, 2048, 0.3),        # the main path: 8 + 8 keyframes, L_loc
    (16, 1000, 1000, 0.3),        # ragged
    (3, 7, 5, 0.2),               # many duplicate ids within a row
    (40, 1100, 9000, 0.5),        # plan too large for shared memory
    (4, 64, 32, 1.0)])            # no valid observation at all
def test_lba_kernel_matches_plain(dev, P, N, L, invalid):
    row_lm, vals = lba_problem(P, N, L, P * N + L, dev, invalid)
    before = kernels.lba_plan.launches
    plan = kernels.lba_plan(row_lm, L)
    assert kernels.lba_plan.launches == before + 1
    for name, a, b in zip(("perm", "lm_off"), plan,
                          kernels.lba_plan_ref(row_lm, L)):
        assert torch.equal(a, b), name       # integers: exactly equal
    for a, b in zip(plan, kernels.lba_plan(row_lm, L)):
        assert torch.equal(a, b)
    before = kernels.lba_landmark_blocks.launches
    out_k = kernels.lba_landmark_blocks(row_lm, vals, L, plan)
    assert kernels.lba_landmark_blocks.launches == before + 1
    out_r = kernels.lba_landmark_blocks_ref(row_lm, vals, L)
    for a, b in zip(out_k, out_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    again = kernels.lba_landmark_blocks(row_lm, vals, L, plan)
    for a, b in zip(out_k, again):
        assert torch.equal(a, b)         # fixed summation order


def test_wrappers_check_their_inputs(dev):
    q, qxy, qv, t, txy, tv, r = match_problem(16, 16, 32, 16, 0, dev)
    with pytest.raises(ValueError, match="dtype"):
        kernels.window_match_topk2(q.double(), qxy, qv, t, txy, tv, r)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.window_match_topk2(q, qxy, qv, t.T.contiguous().T, txy, tv,
                                   r)
    wide = torch.zeros((16, 320), device=dev)
    with pytest.raises(ValueError, match="D = 320"):
        kernels.window_match_topk2(wide, qxy, qv, wide, txy, tv, r)
    row_lm, vals = lba_problem(2, 8, 4, 0, dev)
    with pytest.raises(ValueError, match="shape"):
        kernels.lba_landmark_blocks(row_lm, vals[..., :29].contiguous(), 4,
                                    kernels.lba_plan(row_lm, 4))


def test_frame_graph_replay_equals_eager_fused_function(dev):
    """Pipelined tracking on the card: a tracked frame replayed from its
    captured CUDA graph gives the poses and bindings of the same function
    run eagerly (same operations on the same inputs: poses within 1e-5),
    the window-match counter ticks once per replay, and no asynchronous
    read is lost."""
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.core import state as mstate
    from dani_slam_tpu_torch.models import yolo
    from dani_slam_tpu_torch.slam.system import Sensor, System
    from dani_slam_tpu_torch.utils import synthetic
    W, H, F, n = 320, 240, 300.0, 8
    R_gt, t_gt = synthetic.orbit_trajectory(n, radius=10.0,
                                            angle_span=0.35 * n / 60)
    imgs, deps, times = synthetic.make_rgbd_image_sequence(
        [F, F, W / 2, H / 2], W, H, R_gt, t_gt, seed=0)
    out = {}
    for graph in (True, False):
        cam = cameras.Camera.pinhole(F, F, W / 2, H / 2, W, H, device=dev)
        s = System(cam, Sensor.RGBD,
                   caps=mstate.MapCaps(K=32, L=4096, N=256, D=256),
                   n_features=256, detector=yolo.load_default_detector(dev),
                   matcher="auto", pipelined=True, device=dev)
        s.sp_threshold = 0.012
        s.tracker.frame_graph = graph
        kernels.reset_launch_counts()
        for i in range(n):
            s.track_rgbd(torch.as_tensor(imgs[i], device=dev),
                         torch.as_tensor(deps[i].astype(np.int32),
                                         device=dev), times[i])
        s.shutdown()
        out[graph] = (s.tracker.trajectory, s.tracker.last_bind,
                      s.tracker.graph_replays, s.tracker.eager_frames,
                      kernels.launch_counts()["window_match_topk2"])
    (tg, bg, rg, eg, wg), (te, be, re_, ee, we) = out[True], out[False]
    assert (rg, eg) == (n - 2, 2) and (re_, ee) == (0, n)
    assert wg >= n - 1 and we == n - 1
    assert len(tg) == len(te) == n
    for a, b in zip(tg, te):
        np.testing.assert_allclose(a[1], b[1], atol=1e-5)
        np.testing.assert_allclose(a[2], b[2], atol=1e-5)
    assert torch.equal(bg, be)


def test_two_view_init_card_equals_cpu(dev):
    """Monocular initialization on the card (batched SVDs through
    cuSOLVER) against the CPU on the same rays and the same injected draws:
    the same decision, R within 1e-4, unit t within 1e-3 (the limits of
    utils/agreement.two_view_init)."""
    from dani_slam_tpu_torch.utils import agreement
    r = agreement.two_view_init(dev)
    assert r["ok"], r


def test_stereo_depth_card_equals_cpu(dev):
    """stereo_match_depth and its LightGlue variant on the card against the
    CPU on one rendered 640x480 pair's SuperPoint keypoints: the same depth
    set (LightGlue: >= 97 % of the rows, its bf16 layers round on other
    units) and the same values where both matched (the limits of
    utils/agreement.stereo_depth)."""
    from dani_slam_tpu_torch.utils import agreement
    r = agreement.stereo_depth(dev)
    assert r["ok"], r


def test_imu_rgbd_pipelined_card_equals_cpu(dev):
    """System(IMU_RGBD, pipelined=True) on the card against the same run on
    the CPU: pre-extracted features of a 1500-point world seen by a camera
    accelerating at 1.2 m/s^2 (tests/test_inertial.py's scene), 10 Hz, 200
    Hz IMU windows, 24 frames (the IMU initializes at frame 13): the same
    states and initialization frame, keyframes within 1, camera centres
    within 0.097 m and bias_g within 9.4e-3 — the JAX package's own spread
    on this run (the `e2e-pipelined` configuration of
    tests/test_torch_inertial_system.py) with the features moved by
    N(0, 1e-3) px, seeds 1-12: the card's window-match kernel rounds its
    descriptor dots to bf16, the CPU's plain version does not, and the
    pipelined inertial run amplifies such differences. The card's run is
    also held against itself with the track step's graph off
    (frame_graph=False, the same function eagerly): the same states,
    centres within 1e-4 m up to the IMU initialization."""
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.core import state as mstate
    from dani_slam_tpu_torch.slam.inertial import make_window
    from dani_slam_tpu_torch.slam.system import Sensor, System
    from dani_slam_tpu_torch.utils import synthetic

    accel = np.array([1.2, 0.0, 0.0])
    spec = (accel - np.array([0.0, 0.0, -9.81])).astype(np.float32)

    def run(device, frame_graph=True):
        cam = cameras.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480,
                                     device=device)
        sys_ = System(cam, Sensor.IMU_RGBD,
                      caps=mstate.MapCaps(K=64, L=4096, N=256, D=64),
                      n_features=256, enable_loop_closing=False,
                      pipelined=True, device=device)
        sys_.tracker.max_frames_between_kf = 4
        sys_.tracker.frame_graph = frame_graph
        world = synthetic.make_world(1500, desc_dim=64, seed=6)
        states, centres, init = [], [], None
        for i in range(24):
            t = i / 10.0
            C = np.array([0.0, 0.0, -10.0]) + 0.5 * accel * t * t
            feat, _ = synthetic.render_frame(
                world, cam, np.eye(3), -C, n_max=256, noise_px=0.3, seed=i,
                with_depth=True, time=t)
            win = None
            if i:
                n = 20
                win = make_window(np.zeros((n, 3), np.float32),
                                  np.tile(spec, (n, 1)),
                                  np.full(n, 0.1 / n, np.float32),
                                  device=device)
            s, R, tt = sys_.track_features(feat, imu_window=win)
            states.append(s)
            centres.append((-R.T @ tt).cpu().numpy())
            if init is None and sys_.tracker.inertial.initialized:
                init = i
        sys_.shutdown()
        return states, np.stack(centres), init, \
            sys_.tracker.inertial.bias_g.cpu().numpy(), sys_.n_keyframes()

    sc, cc, ic, bc, kc = run(torch.device("cpu"))
    sg, cg, ig, bg, kg = run(dev)
    se, ce, ie, _, _ = run(dev, frame_graph=False)
    assert se == sg and ie == ig
    assert np.abs(ce[:ig] - cg[:ig]).max() <= 1e-4
    assert sg == sc and ig == ic and ic is not None
    assert abs(kg - kc) <= 1
    d = np.linalg.norm(cg - cc, axis=1)
    assert d.max() <= 0.097, d.round(4)
    np.testing.assert_allclose(bg, bc, atol=9.4e-3)


def test_track_step_graph_keeps_its_matcher(dev):
    """The track step's CUDA graph is keyed on its matcher's identity and
    reads the matcher's weights by address, so it keeps the matcher alive:
    after a pipelined STEREO System and its matcher are dropped, the
    matcher is still held, and a second System with another matcher (the
    shipped weights, each moved by 1 % at random) captures its own graph.
    That System's run equals the same run with the track step eager
    (frame_graph=False, the same function): poses within 1e-5, the same
    bindings, as the frame graph's test holds them."""
    import copy
    import gc
    import weakref
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.core import state as mstate
    from dani_slam_tpu_torch.models import lightglue
    from dani_slam_tpu_torch.slam.system import Sensor, System
    from dani_slam_tpu_torch.utils import synthetic
    W, H, F, n, b = 320, 240, 300.0, 6, 0.12
    R_gt, t_gt = synthetic.orbit_trajectory(n, radius=10.0,
                                            angle_span=0.35 * n / 60)
    left, right, times = synthetic.make_stereo_image_sequence(
        [F, F, W / 2, H / 2], W, H, R_gt, t_gt, baseline=b, seed=0)
    shipped = lightglue.load_default_matcher(W, H, device=dev).model

    def matcher(seed):
        model = copy.deepcopy(shipped)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + 0.01 * torch.randn(p.shape, generator=gen)
                       .to(dev))
        return lightglue.MatcherState(model, W, H)

    def run(m, graph):
        cam = cameras.Camera.pinhole(F, F, W / 2, H / 2, W, H, device=dev)
        s = System(cam, Sensor.STEREO,
                   caps=mstate.MapCaps(K=32, L=4096, N=256, D=256),
                   n_features=256, matcher=m, pipelined=True, device=dev)
        s.tracker.frame_graph = graph
        for i in range(n):
            s.track_stereo(torch.as_tensor(left[i], device=dev),
                           torch.as_tensor(right[i], device=dev), times[i],
                           b)
        s.shutdown()
        return s.tracker.trajectory, s.tracker.last_bind

    first = matcher(1)
    held = weakref.ref(first.model)
    run(first, True)
    del first
    gc.collect()
    torch.cuda.empty_cache()
    assert held() is not None
    second = matcher(2)
    (tg, bg), (te, be) = run(second, True), run(second, False)
    assert len(tg) == len(te) == n
    for a, c in zip(tg, te):
        np.testing.assert_allclose(a[1], c[1], atol=1e-5)
        np.testing.assert_allclose(a[2], c[2], atol=1e-5)
    assert torch.equal(bg, be)
