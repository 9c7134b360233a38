"""IMU preintegration, prediction and initialization of the port against
the JAX package (ops/imu.py, slam/inertial.py, the inertial helpers of
core/lie.py and ops/linalg.py, tracking.bootstrap_prior_info, and the
two-frame solvers of ops/solvers.py on the chain of
tests/test_inertial.py::TestMarginalizedPrior).

Every case feeds one set of numpy inputs made from a seed to both packages
(the cases of tests/test_imu.py and tests/test_inertial.py::TestPrediction /
TestMarginalizedPrior) and, besides the parity, keeps that test's own
assertion on the port.

Tolerances (f32 on the CPU in both packages):
  * preintegration: deltas, covariance and bias Jacobians within 1e-5
    relative to each field's largest entry (the same operations in the same
    order; the covariance's f32 rounding accumulates over the window:
    observed up to 1.4e-6 over 400 samples);
  * edge information: within 1e-5 relative (a 9x9 Cholesky inverse of a
    covariance of entries down to 1e-12: LAPACK against the JAX package's
    unrolled factorization);
  * inertial_init: scale within 1e-4, gravity within 1e-4 m/s^2, biases
    within 1e-6, velocities within 1e-4 m/s (30 Gauss-Newton steps, each a
    Cholesky solve of a 27x27 system: observed 6e-6 / 1.1e-6 / 3e-10 /
    3e-6);
  * the solvers' chain (nine frames, each state fed back, weak vision:
    ten points at 1.5 px noise): poses and centre errors within 5e-4 m for
    the marginalized chain and 1e-4 m for the anchored one — the JAX
    package's own spread on observations moved by N(0, 1e-3) px is
    2.4e-4..4.1e-4 m and 2.1e-5..7.4e-5 m over seeds 1-5 (`python
    tests/test_torch_imu.py`; observed port - JAX 2.7e-4 / 2.6e-5 m) —
    and the carried 15x15 prior within 1e-3 relative (a Schur complement
    and an eigendecomposition every frame).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from dani_slam_tpu.core import cameras as jcam
from dani_slam_tpu.core import lie as jlie
from dani_slam_tpu.ops import imu as jimu
from dani_slam_tpu.ops import linalg as jla
from dani_slam_tpu.ops import solvers as jslv
from dani_slam_tpu.slam import inertial as jin
from dani_slam_tpu.slam import tracking as jtrk
from dani_slam_tpu_torch.core import cameras as tcam
from dani_slam_tpu_torch.core import lie as tlie
from dani_slam_tpu_torch.ops import imu as timu
from dani_slam_tpu_torch.ops import linalg as tla
from dani_slam_tpu_torch.ops import solvers as tslv
from dani_slam_tpu_torch.slam import inertial as tin
from dani_slam_tpu_torch.slam import tracking as ttrk

torch.set_num_threads(2)       # several test workers share the machine

JCAL = jimu.ImuCalib.default()
TCAL = timu.ImuCalib.default("cpu")
JC = jcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)
TC = tcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480, device="cpu")


def T(x):
    return torch.as_tensor(np.array(x, np.float32))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def simulate(traj_fn, t0, t1, n, bias_g=None, bias_a=None, seed=None):
    """Perfect (or seeded noisy) IMU samples of traj_fn(t) -> (R_wb, p, v,
    a, w_b) as numpy (gyro, acc, dts, valid), tests/test_imu.py's rule."""
    ts = np.linspace(t0, t1, n + 1)
    gyro, acc, dts = [], [], []
    for i in range(n):
        R, p, v, a, w = traj_fn(ts[i])
        gyro.append(w)
        acc.append(R.T @ (a - np.asarray(jimu.G_VEC)))
        dts.append(ts[i + 1] - ts[i])
    g = np.asarray(gyro, np.float32)
    a_ = np.asarray(acc, np.float32)
    if bias_g is not None:
        g = g + bias_g
    if bias_a is not None:
        a_ = a_ + bias_a
    if seed is not None:
        rng = np.random.RandomState(seed)
        g = g + rng.randn(*g.shape).astype(np.float32) * 1e-4
        a_ = a_ + rng.randn(*a_.shape).astype(np.float32) * 1e-3
    return g, a_, np.asarray(dts, np.float32), np.ones(n, bool)


def const_acc_traj(a_w=np.array([0.5, 0.0, 0.0])):
    def f(t):
        return np.eye(3), 0.5 * a_w * t * t, a_w * t, a_w, np.zeros(3)
    return f


def rotating_traj(w_z=0.7):
    def f(t):
        R = Rotation.from_rotvec([0, 0, w_z * t]).as_matrix()
        return R, np.zeros(3), np.zeros(3), np.zeros(3), np.array([0, 0, w_z])
    return f


def tumbling_traj(t):
    R = Rotation.from_rotvec([0.3 * t, 0.2 * t, 0]).as_matrix()
    a = np.array([0.4, 0.0, 0.2])
    return R, 0.5 * a * t * t, a * t, a, np.array([0.3, 0.2, 0])


def both_preint(samples, bg=np.zeros(3, np.float32),
                ba=np.zeros(3, np.float32)):
    g, a, d, v = samples
    pj = jimu.preintegrate(jnp.asarray(g), jnp.asarray(a), jnp.asarray(d),
                           jnp.asarray(v), jnp.asarray(bg), jnp.asarray(ba),
                           JCAL)
    pt = timu.preintegrate(T(g), T(a), T(d), torch.as_tensor(v), T(bg),
                           T(ba), TCAL)
    return pj, pt


def assert_preint_close(pj, pt, rel=1e-5):
    for f in jimu.Preintegrated._fields:
        x, y = N(getattr(pj, f)), N(getattr(pt, f))
        scale = max(float(np.abs(x).max()), 1e-30)
        assert np.abs(x - y).max() <= rel * scale, (f, np.abs(x - y).max())


# ---------------------------------------------------------------------------
# helpers of core/lie.py and ops/linalg.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["so3_right_jacobian", "so3_left_jacobian_inv",
                                "so3_right_jacobian_inv"])
def test_lie_jacobians_match(fn):
    rng = np.random.RandomState(0)
    phi = rng.randn(64, 3).astype(np.float32)
    phi[:8] *= 1e-5                       # the small-angle branch
    phi[8:16] *= 2.0
    want = N(getattr(jlie, fn)(jnp.asarray(phi)))
    got = N(getattr(tlie, fn)(T(phi)))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    if fn == "so3_left_jacobian_inv":    # an inverse indeed
        prod = got @ N(tlie.so3_left_jacobian(T(phi)))
        np.testing.assert_allclose(prod, np.broadcast_to(np.eye(3),
                                                         prod.shape),
                                   atol=1e-4)


def test_se3_log_matches_and_inverts_exp():
    rng = np.random.RandomState(1)
    xi = (rng.randn(32, 6) * [1, 1, 1, 0.8, 0.8, 0.8]).astype(np.float32)
    R, t = tlie.se3_exp(T(xi))
    got = N(tlie.se3_log(R, t))
    want = N(jlie.se3_log(*jlie.se3_exp(jnp.asarray(xi))))
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, xi, atol=1e-4)


def test_chol_inv_and_tri_lower_inv_match():
    rng = np.random.RandomState(2)
    A = rng.randn(6, 9, 9).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(9, dtype=np.float32)
    got = N(tla.chol_inv(T(A)))
    want = N(jla.chol_inv(jnp.asarray(A)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got @ A, np.broadcast_to(np.eye(9), A.shape),
                               atol=2e-3)
    L = np.tril(rng.randn(4, 7, 7)).astype(np.float32) + \
        3 * np.eye(7, dtype=np.float32)
    np.testing.assert_allclose(N(tla.tri_lower_inv(T(L))),
                               N(jla.tri_lower_inv(jnp.asarray(L))),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# preintegration (tests/test_imu.py)
# ---------------------------------------------------------------------------

def test_static_zero_motion():
    static = lambda t: (np.eye(3), np.zeros(3), np.zeros(3),  # noqa: E731
                        np.zeros(3), np.zeros(3))
    pj, pt = both_preint(simulate(static, 0, 1, 100))
    assert_preint_close(pj, pt)
    np.testing.assert_allclose(N(pt.dR), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(N(pt.dV), [0, 0, 9.81], atol=1e-3)
    assert abs(float(pt.dt) - 1.0) < 1e-6


def test_constant_acceleration():
    pj, pt = both_preint(simulate(const_acc_traj(), 0, 2, 400))
    assert_preint_close(pj, pt)
    np.testing.assert_allclose(N(pt.dV), [1.0, 0, 9.81 * 2], atol=2e-2)
    np.testing.assert_allclose(N(pt.dP), [1.0, 0, 0.5 * 9.81 * 4],
                               rtol=2e-2)


def test_pure_rotation():
    pj, pt = both_preint(simulate(rotating_traj(0.7), 0, 1, 500))
    assert_preint_close(pj, pt)
    R_expect = Rotation.from_rotvec([0, 0, 0.7]).as_matrix()
    np.testing.assert_allclose(N(pt.dR), R_expect, atol=2e-3)


def test_biased_noisy_tumbling_window():
    """Rotation about two axes, noisy samples, non-zero linearization
    biases: every field, the covariance and all five Jacobians."""
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.03, 0.01, -0.02], np.float32)
    pj, pt = both_preint(simulate(tumbling_traj, 0, 1, 200, seed=1), bg, ba)
    assert_preint_close(pj, pt)


def test_mask_ignores_padding():
    g, a, d, v = simulate(const_acc_traj(), 0, 1, 100)
    g2 = np.concatenate([g, np.full((50, 3), 999.0, np.float32)])
    a2 = np.concatenate([a, np.full((50, 3), 999.0, np.float32)])
    d2 = np.concatenate([d, np.full((50,), 0.01, np.float32)])
    v2 = np.concatenate([v, np.zeros(50, bool)])
    p1j, p1 = both_preint((g, a, d, v))
    p2j, p2 = both_preint((g2, a2, d2, v2))
    assert_preint_close(p2j, p2)
    np.testing.assert_allclose(N(p1.dP), N(p2.dP), atol=1e-5)
    assert abs(float(p1.dt) - float(p2.dt)) < 1e-6
    # skipping the masked tail is exact
    p3 = timu.preintegrate(T(g2), T(a2), T(d2), torch.as_tensor(v2),
                           torch.zeros(3), torch.zeros(3), TCAL, n_steps=100)
    for x, y in zip(p2, p3):
        assert torch.equal(x, y)


def test_window_and_chain_integration_match():
    """slam/inertial: make_window pads (and drops beyond max_s) as the JAX
    package does; InertialState.integrate_frame and the keyframe-chain
    re-integration over concatenated windows (the port visits only the
    valid prefixes) equal the JAX package's scan over the padded ones."""
    rng = np.random.RandomState(3)
    js, ts = jin.InertialState(), tin.InertialState(device="cpu")
    spans = []
    for k, n in enumerate((40, 64, 70, 23)):
        g, a, d, _ = simulate(tumbling_traj, 0.1 * k, 0.1 * (k + 1), n,
                              seed=k)
        wj = jin.make_window(g, a, d)
        wt = tin.make_window(g, a, d, device="cpu")
        for f in ("gyro", "acc", "dts", "valid"):
            np.testing.assert_array_equal(N(getattr(wt, f)),
                                          N(getattr(wj, f)))
        assert wt.n == min(n, 64)
        assert_preint_close(js.integrate_frame(wj), ts.integrate_frame(wt))
        spans.append(k)
    bg = rng.randn(3).astype(np.float32) * 0.01
    js.bias_g, ts.bias_g = jnp.asarray(bg), T(bg)
    bounds = [(0, 2), (1, 4), (3, 3)]
    for pj, pt in zip(js.kf_chain_preintegrations(bounds),
                      ts.kf_chain_preintegrations(bounds)):
        if pj is None:
            assert pt is None
            continue
        assert_preint_close(pj, pt)


def test_bias_jacobian_correction():
    bg = np.array([0.02, -0.01, 0.015], np.float32)
    ba = np.array([0.05, 0.03, -0.04], np.float32)
    s = simulate(const_acc_traj(), 0, 1, 200, bias_g=bg, bias_a=ba)
    p0j, p0 = both_preint(s)
    assert_preint_close(p0j, p0)
    cj = jimu.corrected_deltas(p0j, jnp.asarray(bg), jnp.asarray(ba))
    ct = timu.corrected_deltas(p0, T(bg), T(ba))
    for x, y in zip(cj, ct):
        np.testing.assert_allclose(N(y), N(x), atol=2e-6, rtol=1e-6)
    _, p1 = both_preint(s, bg, ba)
    np.testing.assert_allclose(N(ct[0]), N(p1.dR), atol=2e-4)
    np.testing.assert_allclose(N(ct[1]), N(p1.dV), atol=2e-2)
    np.testing.assert_allclose(N(ct[2]), N(p1.dP), atol=2e-2)


def test_residual_zero_for_true_states():
    pj, pt = both_preint(simulate(const_acc_traj(), 0, 1, 200))
    states = [np.eye(3), np.zeros(3), np.zeros(3), np.eye(3),
              np.array([0.25, 0, 0]), np.array([0.5, 0, 0]), np.zeros(3),
              np.zeros(3)]
    rj = jimu.inertial_residual(pj, *(jnp.asarray(x, jnp.float32)
                                      for x in states))
    rt = timu.inertial_residual(pt, *(T(x) for x in states))
    np.testing.assert_allclose(N(rt), N(rj), atol=1e-6)
    assert float(torch.abs(rt).max()) < 2e-2


@pytest.mark.parametrize("diag_only", [False, True])
def test_edge_information_matches(diag_only):
    pre = [both_preint(simulate(tumbling_traj, 0.3 * k, 0.3 * k + 0.2, 40,
                                seed=k)) for k in range(4)]
    sj = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                *[p[0] for p in pre])
    st = timu.stack_preints([p[1] for p in pre])
    for cap in (1e6, 1e12):
        Wj = N(jimu.edge_information(sj, JCAL, cap=cap, diag_only=diag_only))
        Wt = N(timu.edge_information(st, TCAL, cap=cap, diag_only=diag_only))
        assert np.abs(Wt - Wj).max() <= 1e-5 * np.abs(Wj).max()


@pytest.mark.parametrize("optimize_scale", [True, False])
def test_inertial_init_matches(optimize_scale):
    """tests/test_imu.py::TestInertialInit: a chain under acceleration and
    rotation with the map at half scale; the scale-free solve recovers
    s = 2 and gravity, the fixed-scale one (the stereo / RGB-D branch)
    keeps s = 1."""
    K = 6
    times = np.linspace(0, 2.5, K)
    Rs, ts, pre = [], [], []
    for i in range(K):
        R, p, _, _, _ = tumbling_traj(times[i])
        Rs.append(R)
        ts.append(p * 0.5)
        if i < K - 1:
            pre.append(both_preint(simulate(tumbling_traj, times[i],
                                            times[i + 1], 100)))
    sj = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                *[p[0] for p in pre])
    R_np = np.stack(Rs).astype(np.float32)
    t_np = np.stack(ts).astype(np.float32)
    oj = jimu.inertial_init(jnp.asarray(R_np), jnp.asarray(t_np), None, sj,
                            optimize_scale=optimize_scale)
    ot = timu.inertial_init(T(R_np), T(t_np), None,
                            timu.stack_preints([p[1] for p in pre]),
                            optimize_scale=optimize_scale)
    tol = dict(scale=1e-4, gravity=1e-4, bias_g=1e-6, bias_a=1e-6,
               velocities=1e-4)
    for k, a in tol.items():
        np.testing.assert_allclose(N(ot[k]), N(oj[k]), atol=a, err_msg=k)
    if optimize_scale:
        assert abs(float(ot["scale"]) - 2.0) < 0.1
        g_dir = N(ot["gravity"]) / np.linalg.norm(N(ot["gravity"]))
        np.testing.assert_allclose(g_dir, [0, 0, -1], atol=0.05)
        np.testing.assert_allclose(N(ot["velocities"][0]), [0, 0, 0],
                                   atol=0.1)
    else:
        assert float(ot["scale"]) == 1.0


# ---------------------------------------------------------------------------
# prediction and the marginalized chain (tests/test_inertial.py)
# ---------------------------------------------------------------------------

def accel_traj(a_w=np.array([0.6, 0.0, 0.3])):
    def f(t):
        return np.eye(3), 0.5 * a_w * t * t, a_w * t, a_w, np.zeros(3)
    return f


def test_predict_matches_truth():
    traj = accel_traj()
    t0, t1 = 1.0, 1.2
    s = simulate(traj, t0, t1, int((t1 - t0) * 200.0))
    pj, pt = both_preint(s)
    R0_wb, p0, v0, _, _ = traj(t0)
    _, p1, v1, _, _ = traj(t1)
    args = (R0_wb.T, -R0_wb.T @ p0, v0)
    Rj, tj, vj = jin.predict_state_imu(
        *(jnp.asarray(x, jnp.float32) for x in args), pj, jnp.zeros(3),
        jnp.zeros(3))
    Rt, tt, vt = tin.predict_state_imu(*(T(x) for x in args), pt,
                                       torch.zeros(3), torch.zeros(3))
    for x, y in ((Rj, Rt), (tj, tt), (vj, vt)):
        np.testing.assert_allclose(N(y), N(x), atol=1e-5)
    np.testing.assert_allclose(-N(Rt).T @ N(tt), p1, atol=2e-3)
    np.testing.assert_allclose(N(vt), v1, atol=2e-2)


def chain(marginalized, n_frames=10, n_pts=10, noise_px=1.5, seed=3,
          move_seed=0):
    """TestMarginalizedPrior's chain run in both packages side by side, each
    package fed its own previous estimate: (per-frame centre errors of the
    port, of the JAX package, the largest pose difference, the final prior
    of each). move_seed > 0 moves every observation by N(0, 1e-3) px more
    (the JAX package's own spread: `python tests/test_torch_imu.py`)."""
    rng = np.random.RandomState(seed)
    move = np.random.RandomState(move_seed)
    traj = accel_traj(np.array([0.8, 0.0, 0.2]))
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(14.0, 18.0, n_pts)], 1).astype(np.float32)
    mask = np.ones(n_pts, bool)

    def pose(t):
        R_wb, p, v, _, _ = traj(t)
        return R_wb.T, -R_wb.T @ p, v

    R, t, v = pose(0.0)
    J = dict(R=jnp.asarray(R, jnp.float32), t=jnp.asarray(t, jnp.float32),
             v=jnp.asarray(v, jnp.float32), bg=jnp.zeros(3),
             ba=jnp.zeros(3), prior=None)
    P = dict(R=T(R), t=T(t), v=T(v), bg=torch.zeros(3), ba=torch.zeros(3),
             prior=None)
    errs_t, errs_j, dpose = [], [], 0.0
    for i in range(1, n_frames):
        s = simulate(traj, (i - 1) / 10, i / 10, int(0.1 * 200.0))
        g, a, d, vv = s
        pj = jimu.preintegrate(*(jnp.asarray(x) for x in s), J["bg"],
                               J["ba"], JCAL)
        pt = timu.preintegrate(T(g), T(a), T(d), torch.as_tensor(vv),
                               P["bg"], P["ba"], TCAL)
        R_gt, t_gt, _ = pose(i / 10)
        obs = (N(jcam.project(JC, jnp.asarray(pts @ R_gt.T + t_gt,
                                              jnp.float32))) +
               rng.normal(0, noise_px, (n_pts, 2))).astype(np.float32)
        if move_seed:
            obs = obs + move.normal(0, 1e-3, obs.shape).astype(np.float32)
        for S, pre, pkg in ((J, pj, "jax"), (P, pt, "port")):
            if pkg == "jax":
                R0, t0, _ = jin.predict_state_imu(S["R"], S["t"], S["v"],
                                                  pre, S["bg"], S["ba"])
                if marginalized:
                    if S["prior"] is None:
                        S["prior"] = jtrk.bootstrap_prior_info(pre, JCAL)
                    out = jslv.pose_inertial_optimize_marginalized(
                        R0, t0, S["v"], S["bg"], S["ba"], S["R"], S["t"],
                        S["v"], S["bg"], S["ba"], S["prior"], pre, JCAL, JC,
                        jnp.asarray(pts), jnp.asarray(obs),
                        jnp.asarray(mask), iters=8)
                    S["prior"] = out[7]
                else:
                    out = jslv.pose_inertial_optimize(
                        R0, t0, S["v"], S["bg"], S["ba"], S["R"], S["t"],
                        S["v"], S["bg"], S["ba"], pre, JCAL, JC,
                        jnp.asarray(pts), jnp.asarray(obs),
                        jnp.asarray(mask), iters=8, info_cap=1e3)
            else:
                R0, t0, _ = tin.predict_state_imu(S["R"], S["t"], S["v"],
                                                  pre, S["bg"], S["ba"])
                if marginalized:
                    if S["prior"] is None:
                        S["prior"] = ttrk.bootstrap_prior_info(pre, TCAL)
                    out = tslv.pose_inertial_optimize_marginalized(
                        R0, t0, S["v"], S["bg"], S["ba"], S["R"], S["t"],
                        S["v"], S["bg"], S["ba"], S["prior"], pre, TCAL, TC,
                        T(pts), T(obs), torch.as_tensor(mask), iters=8)
                    S["prior"] = out[7]
                else:
                    out = tslv.pose_inertial_optimize(
                        R0, t0, S["v"], S["bg"], S["ba"], S["R"], S["t"],
                        S["v"], S["bg"], S["ba"], pre, TCAL, TC, T(pts),
                        T(obs), torch.as_tensor(mask), iters=8,
                        info_cap=1e3)
            S["R"], S["t"], S["v"], S["bg"], S["ba"] = out[:5]
        dpose = max(dpose, float(np.abs(N(J["R"]) - N(P["R"])).max()),
                    float(np.abs(N(J["t"]) - N(P["t"])).max()))
        C_gt = -R_gt.T @ t_gt
        errs_t.append(np.linalg.norm(-N(P["R"]).T @ N(P["t"]) - C_gt))
        errs_j.append(np.linalg.norm(-N(J["R"]).T @ N(J["t"]) - C_gt))
    return np.asarray(errs_t), np.asarray(errs_j), dpose, J["prior"], \
        P["prior"]


def test_bootstrap_prior_info_matches():
    pj, pt = both_preint(simulate(tumbling_traj, 0, 0.1, 20, seed=4))
    np.testing.assert_allclose(N(ttrk.bootstrap_prior_info(pt, TCAL)),
                               N(jtrk.bootstrap_prior_info(pj, JCAL)),
                               rtol=1e-6)


def test_marginalized_chain_matches_and_beats_anchored():
    e_marg, e_marg_j, d_marg, pri_j, pri_t = chain(True)
    e_anch, e_anch_j, d_anch, _, _ = chain(False)
    assert d_marg < 5e-4 and d_anch < 1e-4, (d_marg, d_anch)
    np.testing.assert_allclose(e_marg, e_marg_j, atol=5e-4)
    np.testing.assert_allclose(e_anch, e_anch_j, atol=1e-4)
    pj, pt = N(pri_j), N(pri_t)
    assert np.abs(pt - pj).max() <= 1e-3 * np.abs(pj).max()
    # tests/test_inertial.py's own assertions, on the port
    assert e_marg.mean() < 0.25, e_marg
    assert e_marg.mean() <= e_anch.mean() * 1.15, (e_marg.mean(),
                                                   e_anch.mean())


def test_information_propagates():
    _, _, _, _, prior3 = chain(True, n_frames=3)
    _, _, _, _, prior10 = chain(True, n_frames=10)
    tr3 = float(np.trace(N(prior3)[6:9, 6:9]))
    tr10 = float(np.trace(N(prior10)[6:9, 6:9]))
    assert tr10 > tr3 * 1.02, (tr3, tr10)


def jax_spread(seeds=(1, 2, 3, 4, 5)):
    """The JAX package's chain on observations moved by N(0, 1e-3) px
    against its chain on the unmoved ones: the largest camera-centre
    difference over the frames, per seed (the rounding-sized spread the
    chain's tolerance is held to)."""
    out = {}
    for marg in (True, False):
        base = chain(marg)[1]
        out[marg] = [float(np.abs(chain(marg, move_seed=k)[1] - base).max())
                     for k in seeds]
    return out


if __name__ == "__main__":
    print(jax_spread())
