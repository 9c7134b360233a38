"""The port's multi-device side (dani_slam_tpu_torch/parallel) against the
JAX package's, on 2 and 4 gloo ranks on the CPU (spawned processes, a
file store in a temporary directory, 2 torch threads each):

  * the dp x tp SuperPoint step (make_mesh_2d, shard_params,
    make_train_step) against the JAX package's make_train_step unsharded:
    the first step's gradients within 1e-4 of their norm, the 3 losses
    within rtol 1e-3, every rank holding the same parameters after them;
  * sharded_ba_solve against the JAX package's ba_solve on
    tests/test_ba.py's problem at tests/test_parallel.py's tolerances
    (poses 1e-3, landmarks 1e-2);
  * the float32 global BA of the drifted loop map (dryrun.GBA_MAP) in
    table order and with its landmarks relabelled twice, and sharded_gba
    in float32 on 2 and 4 ranks, against the one-process float64 solve:
    cost within 1 %, keyframes and landmarks within dryrun.GBA_TOL (the
    per-landmark sums are kernels.segment_sum's fixed-order sums; as
    differences of a running sum, the JAX package's arithmetic, a
    relabelling moved the cost by 10 %);
  * ba_solve and ba_solve_pcg with the `reduce` hook left at None give
    bitwise the results of the code before the hook (digests taken at
    the parent commit), and an identity hook changes nothing;
  * the dry run's command line.
"""
import hashlib
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dani_slam_tpu.models import superpoint as jsp
from dani_slam_tpu.ops import ba as jba
from dani_slam_tpu.parallel import train as jptrain
from dani_slam_tpu_torch.core import cameras
from dani_slam_tpu_torch.models import convert
from dani_slam_tpu_torch.models import superpoint as tsp
from dani_slam_tpu_torch.ops import ba, ba_large
from dani_slam_tpu_torch.parallel import dryrun, launch
from dani_slam_tpu_torch.slam import loopclosing

torch.set_num_threads(2)       # several test workers share the machine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
LR, STEPS = 1e-3, 3


# ---------------------------------------------------------------------------
# The dp x tp training step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's SuperPoint step (float32 SuperPoint, Adam) from
    its initial params on its batch of 4 32x32 images: the first step's
    gradients and the 3 losses."""
    model = jsp.SuperPoint(compute_dtype=jnp.float32)
    x = jax.random.uniform(jax.random.PRNGKey(0), (4, 32, 32, 1))
    params = jax.jit(model.init)(jax.random.PRNGKey(1), x)
    grads = jax.jit(jax.grad(lambda p: jptrain.warp_loss(model, p, x)))(
        params)
    opt = optax.adam(LR)
    step = jptrain.make_train_step(model, opt)
    p, ost, losses = params, opt.init(params), []
    for _ in range(STEPS):
        p, ost, loss = step(p, ost, x)
        losses.append(float(loss))
    return params, np.asarray(x), grads, losses


@pytest.fixture(scope="module", params=[2, 4])
def sharded_step(request, jax_step):
    params, x, _, _ = jax_step
    n = request.param
    init = convert.from_flax(tsp.SuperPoint(compute_dtype=torch.float32),
                             params).state_dict()
    return n, launch.launch(dryrun.sharded_train_rank, n, n, STEPS, init,
                            torch.as_tensor(x).permute(0, 3, 1, 2), LR,
                            device="cpu")


def test_mesh_shape_and_split(sharded_step):
    n, ranks = sharded_step
    shape = (2, 2) if n == 4 else (2, 1)
    coords = sorted((r["coords"]["data"], r["coords"]["model"])
                    for r in ranks)
    assert coords == [(d, m) for d in range(shape[0])
                      for m in range(shape[1])]
    want = [] if shape[1] == 1 else [
        "conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
        "conv4a", "conv4b", "convDa", "convDb", "convPa"]
    for r in ranks:
        assert r["split"] == want            # convPb (65 channels) stays
        assert r["foreign_modules"] == []


def test_sharded_step_gradients_match_jax(sharded_step, jax_step):
    _, ranks = sharded_step
    _, _, grads, _ = jax_step
    want = convert.from_flax(tsp.SuperPoint(compute_dtype=torch.float32),
                             jax.device_get(grads)).state_dict()
    for r in ranks:
        num = sum(float(torch.sum((r["grads"][k] - want[k]) ** 2))
                  for k in want)
        den = sum(float(torch.sum(want[k] ** 2)) for k in want)
        assert (num / den) ** 0.5 <= 1e-4


def test_sharded_step_losses_and_replicas(sharded_step, jax_step):
    _, ranks = sharded_step
    for r in ranks:
        np.testing.assert_allclose(r["losses"].numpy(), jax_step[3],
                                   rtol=1e-3)
        assert r["same"]
        for k, v in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], v), k


# ---------------------------------------------------------------------------
# Landmark-sharded BA and GBA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ba_problem():
    """tests/test_ba.py's problem (4 poses, 120 landmarks padded to 128),
    as tests/test_parallel.py builds it, and the JAX package's solve."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_ba import CAM, make_problem
    (R0, t0, fixed, lm0, lmv, okf, olm, oxy, ov, _) = make_problem(
        pose_err=0.02, pt_err=0.05, L=120)
    lm0p = jnp.pad(lm0, ((0, 8), (0, 0)))
    lmvp = jnp.pad(lmv, (0, 8))
    ref = jba.ba_solve(R0, t0, fixed, lm0p, lmvp, CAM, okf, olm, oxy, ov,
                       iters=10)
    problem = dict(cam=(500.0, 500.0, 320.0, 240.0, 640, 480),
                   R0=np.asarray(R0), t0=np.asarray(t0),
                   fixed=np.asarray(fixed), lm0=np.asarray(lm0p),
                   lm_valid=np.asarray(lmvp), obs_kf=np.asarray(okf),
                   obs_lm=np.asarray(olm), obs_xy=np.asarray(oxy),
                   obs_valid=np.asarray(ov))
    return problem, ref


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_ba_matches_jax(ba_problem, n):
    problem, ref = ba_problem
    ranks = launch.launch(dryrun.sharded_ba_rank, n, problem, 10,
                          device="cpu")
    L = problem["lm0"].shape[0]
    assert [r["landmarks"] for r in ranks] == [
        (i * L // n, (i + 1) * L // n) for i in range(n)]
    for r in ranks:
        np.testing.assert_allclose(r["t"].numpy(), np.asarray(ref.t),
                                   atol=1e-3)
        np.testing.assert_allclose(r["lm_pos"].numpy(),
                                   np.asarray(ref.lm_pos), atol=1e-2)
        np.testing.assert_array_equal(r["obs_inlier"].numpy(),
                                      np.asarray(ref.obs_inlier))
        # noise-free observations: both costs are rounding, ~4e-7 px^2
        assert abs(float(r["cost"]) - float(ref.cost)) <= 1e-5
        assert r["foreign_modules"] == []


GBA_ITERS = dryrun.GBA_ITERS


@pytest.fixture(scope="module")
def gba_single():
    """dryrun.GBA_MAP's drifted loop map (16 keyframes, 7303 landmarks)
    and its one-process float32 and float64 solves."""
    st, cam = dryrun.gba_map(CPU, *dryrun.GBA_MAP)
    return st, cam, dryrun.single_gba(st, cam, GBA_ITERS), \
        dryrun.single_gba(st, cam, GBA_ITERS, torch.float64)


def test_single_gba_is_global_bundle_adjustment(gba_single):
    st, cam, single, single64 = gba_single
    full = loopclosing.global_bundle_adjustment(st, cam, iters=GBA_ITERS)
    assert torch.equal(full.kf_t[st.kf_mask], single.t[st.kf_mask])
    assert torch.equal(full.lm_pos[st.lm_mask], single.lm_pos[st.lm_mask])
    # relabelling the landmarks moves the rows of the landmark table, not
    # the order of any landmark's sum: the same bits
    relabelled = dryrun.single_gba(st, cam, GBA_ITERS, relabel=1)
    assert torch.equal(relabelled.t, single.t)
    assert torch.equal(relabelled.lm_pos, single.lm_pos)


@pytest.mark.parametrize("relabel", [None, 1, 2])
def test_float32_gba_against_float64(gba_single, relabel):
    """The float32 solve in table order and with the landmarks relabelled
    (two random orders of the table) lands within 1 % of the float64 cost
    and within dryrun.GBA_TOL of its keyframes and landmarks (as
    differences of one running sum, the costs were 708.88 / 779.12 /
    709.40 against 708.43)."""
    st, cam, single, single64 = gba_single
    res = single if relabel is None else dryrun.single_gba(
        st, cam, GBA_ITERS, relabel=relabel)
    assert res.t.dtype == torch.float32
    assert abs(float(res.cost) - float(single64.cost)) <= \
        1e-2 * float(single64.cost), (float(res.cost), float(single64.cost))
    err = dryrun.gba_errors(res, single64, st)
    assert err[0] <= dryrun.GBA_TOL[0] and err[1] <= dryrun.GBA_TOL[1], err


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_gba_matches_one_process(gba_single, n):
    """In float32 against the one-process float64 solve (the sharding
    changes the order of the pose-indexed sums): cost within 1 %,
    keyframes and landmarks within dryrun.GBA_TOL."""
    st, _, _, single64 = gba_single
    for r in launch.launch(dryrun.sharded_gba_rank, n, *dryrun.GBA_MAP,
                           GBA_ITERS, device="cpu"):
        assert r["t"].dtype == torch.float32
        res = ba.BAResult(r["R"], r["t"], r["lm_pos"], r["obs_inlier"],
                          r["cost"])
        err = dryrun.gba_errors(res, single64, st)
        assert err[0] <= dryrun.GBA_TOL[0] and \
            err[1] <= dryrun.GBA_TOL[1], err
        np.testing.assert_allclose(float(r["cost"]), float(single64.cost),
                                   rtol=1e-2)
        assert r["foreign_modules"] == []


def test_launch_runs_on_the_card_by_default():
    """launch's ranks compute on the card unless asked for the CPU, as
    every other entry point of the port: on a host without one, a launch
    that names no device fails in its rank."""
    assert inspect.signature(launch.launch).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="rank 0"):
        launch.launch(dryrun.sharded_ba_rank, 1, None, 1, timeout=120)


# ---------------------------------------------------------------------------
# The hook: bitwise unchanged at None
# ---------------------------------------------------------------------------

def _hook_problem(seed):
    """A small BA problem (4 keyframes x 16 observations, 64 landmarks,
    10 % of the observations and one landmark masked)."""
    cam = cameras.Camera.pinhole(100.0, 100.0, 32.0, 32.0, 64, 64,
                                 device="cpu")
    rng = np.random.default_rng(seed)
    P, N, L = 4, 16, 64
    pts = torch.as_tensor(rng.uniform(-1, 1, (L, 3)) + np.array([0, 0, 4.0]),
                          dtype=torch.float32)
    R0 = torch.eye(3).expand(P, 3, 3).contiguous()
    t0 = torch.as_tensor(rng.normal(0, 0.05, (P, 3)), dtype=torch.float32)
    okf = torch.arange(P).repeat_interleave(N)
    olm = torch.as_tensor(rng.integers(0, L, P * N))
    xy = cameras.project(cam, pts[olm]) + torch.as_tensor(
        rng.normal(0, 0.5, (P * N, 2)), dtype=torch.float32)
    fixed = torch.zeros(P, dtype=torch.bool)
    fixed[0] = True
    lm0 = pts + torch.as_tensor(rng.normal(0, 0.05, (L, 3)),
                                dtype=torch.float32)
    ov = torch.as_tensor(rng.random(P * N) > 0.1)
    lv = torch.ones(L, dtype=torch.bool)
    lv[3] = False
    return R0, t0, fixed, lm0, lv, cam, okf, olm, xy, ov


def _digest(res):
    h = hashlib.sha256()
    for x in res:
        h.update(x.detach().numpy().tobytes())
    return h.hexdigest()[:16]


# sha256 of (R, t, lm_pos, obs_inlier, cost) of the code before the hook
# existed, on _hook_problem(seed): ba_solve 5 iterations, ba_solve_pcg 4
# (ba_solve_pcg's retaken when its per-landmark sums became
# kernels.segment_sum, which adds in another order than the running-sum
# differences before it; with the hook at None, as before)
BEFORE = {0: ("891cb3fec2597d7e", "bdda9a5e55808fbf"),
          1: ("1d37d39d8ea932c8", "918e76af60994d07")}


@pytest.mark.parametrize("seed", sorted(BEFORE))
def test_hook_none_is_bitwise_unchanged(seed):
    args = _hook_problem(seed)
    res = ba.ba_solve(*args, iters=5)
    pcg = ba_large.ba_solve_pcg(*args, iters=4)
    assert (_digest(res), _digest(pcg)) == BEFORE[seed]
    same = lambda t: t                                     # noqa: E731
    assert _digest(ba.ba_solve(*args, iters=5, reduce=same)) == \
        BEFORE[seed][0]
    assert _digest(ba_large.ba_solve_pcg(*args, iters=4, reduce=same)) == \
        BEFORE[seed][1]


# ---------------------------------------------------------------------------
# The dry run's command line
# ---------------------------------------------------------------------------

def test_dryrun_cli_four_ranks():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "dani_slam_tpu_torch.parallel.dryrun", "4",
         "--backend", "gloo", "--device", "cpu"], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "entry ok: heat (1, 480, 640), desc (1, 60, 80, 256)" in \
        proc.stdout
    assert "dryrun_multichip ok: 4 ranks, backend gloo" in proc.stdout
    assert proc.stdout.count("same params True") == 4


def test_dryrun_refuses_a_guessed_backend():
    proc = subprocess.run(
        [sys.executable, "-m", "dani_slam_tpu_torch.parallel.dryrun", "2"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 2 and "--backend" in proc.stderr
