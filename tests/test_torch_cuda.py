"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips on a host without one (the
last two hold the monocular initialization and the stereo depth on the card
against the CPU). The file imports neither JAX nor the JAX package, so
that it also runs where only PyTorch is installed:

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
