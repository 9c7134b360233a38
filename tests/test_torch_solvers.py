"""The port's solvers and its mapping step against the JAX package on the
same problems: motion-only pose_optimize, the local-BA ba_solve, and a
keyframe_step run from one loaded MapState.

Tolerances: both sides solve in float32 with sums taken in another order
(the JAX package's one-hot einsum, the port's plain lba_landmark_blocks), so
the converged poses agree to 1e-4 in rotation and 1e-3 in translation,
landmarks to 2e-3, and the decisions taken on the solution (inlier flags,
observation rows, slot allocation) exactly. After a keyframe step with local
BA, map floats agree to 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dani_slam_tpu.core import cameras as jcam
from dani_slam_tpu.core import lie as jlie
from dani_slam_tpu.core import state as jst
from dani_slam_tpu.ops import ba as jba
from dani_slam_tpu.ops import solvers as jsol
from dani_slam_tpu.slam import frame as jfr
from dani_slam_tpu.slam import mapping as jmap
from dani_slam_tpu.slam import tracking as jtr
from dani_slam_tpu_torch.core import cameras as tcam
from dani_slam_tpu_torch.core import state as tst
from dani_slam_tpu_torch.ops import ba as tba
from dani_slam_tpu_torch.ops import solvers as tsol
from dani_slam_tpu_torch.slam import mapping as tmap

CAM = (300.0, 300.0, 160.0, 120.0, 320, 240)
CJ = jcam.Camera.pinhole(*CAM)
CT = tcam.Camera.pinhole(*CAM, device="cpu")


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def N(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _se3(xi):
    return tuple(np.asarray(x) for x in jlie.se3_exp(J(np.float32(xi))))


# ---------------------------------------------------------------------------
# pose_optimize
# ---------------------------------------------------------------------------

def _pose_problem(n=160, noise=0.5, outlier_frac=0.2, seed=0):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-3, 3, (n, 1)),
                          rng.uniform(-2, 2, (n, 1)),
                          rng.uniform(2, 8, (n, 1))], 1).astype(np.float32)
    R, t = _se3([0.04, -0.03, 0.02, 0.05, -0.02, 0.03])
    pc = pts @ R.T + t
    obs = pc[:, :2] / pc[:, 2:] * 300.0 + np.float32([160.0, 120.0])
    obs = (obs + noise * rng.randn(n, 2)).astype(np.float32)
    n_out = int(n * outlier_frac)
    obs[:n_out] += rng.uniform(20, 60, (n_out, 2)).astype(np.float32)
    depth = (pc[:, 2] + 0.01 * rng.randn(n)).astype(np.float32)
    depth[rng.rand(n) < 0.2] = np.inf                  # no depth reading
    mask = rng.rand(n) > 0.05
    inv_sigma2 = (1.2 ** (-2.0 * rng.randint(0, 3, n))).astype(np.float32)
    return pts, obs, depth, mask, inv_sigma2, (R, t), n_out


@pytest.mark.parametrize("use_depth", [False, True])
def test_pose_optimize_matches_jax(use_depth):
    pts, obs, depth, mask, isg, (R_t, t_t), n_out = _pose_problem()
    kw = dict(inv_sigma2=isg, obs_depth=depth if use_depth else None)
    rj = jsol.pose_optimize(jnp.eye(3), jnp.zeros(3), CJ, J(pts), J(obs),
                            J(mask), use_depth=use_depth,
                            **{k: (J(v) if v is not None else None)
                               for k, v in kw.items()})
    rt = tsol.pose_optimize(torch.eye(3), torch.zeros(3), CT, T(pts), T(obs),
                            T(mask), use_depth=use_depth,
                            **{k: (T(v) if v is not None else None)
                               for k, v in kw.items()})
    np.testing.assert_allclose(N(rt.R), N(rj.R), atol=1e-4)
    np.testing.assert_allclose(N(rt.t), N(rj.t), atol=1e-3)
    np.testing.assert_array_equal(N(rt.inliers), N(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-3,
                               atol=1e-3)
    # and the solution is the truth, outliers rejected
    np.testing.assert_allclose(N(rt.t), t_t, atol=0.02)
    assert not N(rt.inliers)[:n_out].any()


# ---------------------------------------------------------------------------
# ba_solve
# ---------------------------------------------------------------------------

def _ba_problem(P=4, L=120, seed=0):
    """Keyframe-major observations of L landmarks from P poses (two fixed),
    with pixel noise, gross outliers, invalid rows, an invalid landmark and
    per-observation information, from perturbed initial estimates."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.randn(L, 1) * 3.0, rng.randn(L, 1) * 2.0,
                          rng.uniform(4, 12, (L, 1))], 1).astype(np.float32)
    poses = [_se3([0.3 * p, 0.02 * p, 0.0, 0.0, 0.05 * p, 0.0])
             for p in range(P)]
    R_t = np.stack([p[0] for p in poses])
    t_t = np.stack([p[1] for p in poses])
    pc = np.einsum('pij,lj->pli', R_t, pts) + t_t[:, None]
    xy = (pc[..., :2] / pc[..., 2:] * 300.0 +
          np.float32([160.0, 120.0])).reshape(-1, 2)
    xy = (xy + 0.5 * rng.randn(P * L, 2)).astype(np.float32)
    xy[5:25] += 50.0                                       # gross outliers
    obs_kf = np.repeat(np.arange(P), L).astype(np.int32)
    obs_lm = np.tile(np.arange(L), P).astype(np.int32)
    obs_valid = rng.rand(P * L) > 0.15
    obs_info = (1.2 ** (-2.0 * rng.randint(0, 3, P * L))).astype(np.float32)
    dxi = (rng.randn(P, 6) * 0.02).astype(np.float32)
    dxi[:2] = 0.0
    dR, dt = jlie.se3_exp(J(dxi))
    R0 = np.asarray(dR @ J(R_t))
    t0 = np.asarray(jnp.einsum('pij,pj->pi', dR, J(t_t)) + dt)
    lm0 = (pts + 0.05 * rng.randn(L, 3)).astype(np.float32)
    lm_valid = np.ones(L, bool)
    lm_valid[7] = False
    fixed = np.zeros(P, bool)
    fixed[:2] = True
    return (R0, t0, fixed, lm0, lm_valid, obs_kf, obs_lm, xy, obs_valid,
            obs_info), (R_t, t_t, pts)


@pytest.mark.parametrize("iters", [3, 10])
def test_ba_solve_matches_jax(iters):
    (R0, t0, fixed, lm0, lmv, okf, olm, oxy, ov, info), (R_t, t_t, _) = \
        _ba_problem()
    a = (R0, t0, fixed, lm0, lmv)
    b = (okf, olm, oxy, ov)
    rj = jba.ba_solve(*map(J, a), CJ, *map(J, b), obs_info=J(info),
                      iters=iters)
    rt = tba.ba_solve(*map(T, a), CT, *map(T, b), obs_info=T(info),
                      iters=iters)
    np.testing.assert_allclose(N(rt.R), N(rj.R), atol=1e-4)
    np.testing.assert_allclose(N(rt.t), N(rj.t), atol=1e-3)
    # a landmark seen by fewer than two inlier rows is free along its ray
    # (H_ll rank 2 plus damping): its depth is float noise on either side
    n_inl = N(rj.obs_inlier).reshape(4, -1).sum(0)
    fixed_lm = lmv & (n_inl >= 2)
    assert fixed_lm.sum() > 100
    np.testing.assert_allclose(N(rt.lm_pos)[fixed_lm], N(rj.lm_pos)[fixed_lm],
                               atol=2e-3)
    np.testing.assert_array_equal(N(rt.lm_pos)[~lmv], lm0[~lmv])
    np.testing.assert_array_equal(N(rt.obs_inlier), N(rj.obs_inlier))
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    np.testing.assert_array_equal(N(rt.R)[:2], R0[:2])     # fixed poses
    if iters == 10:
        np.testing.assert_allclose(N(rt.t), t_t, atol=0.03)
        assert not N(rt.obs_inlier)[5:25].any()


# ---------------------------------------------------------------------------
# keyframe_step on a loaded MapState
# ---------------------------------------------------------------------------

KF_CAPS = dict(K=16, L=1024, N=128, D=32)


def _scene(n_pts=500, seed=0):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-7, 7, (n_pts, 1)),
                          rng.uniform(-5, 5, (n_pts, 1)),
                          rng.uniform(6, 14, (n_pts, 1))], 1)
    desc = rng.randn(n_pts, KF_CAPS["D"])
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return pts.astype(np.float32), desc.astype(np.float32), rng


def _frame(k, pts, desc, rng):
    """Features of frame k on an x-translating camera: the first N visible
    points (pixel noise 0.3 px, descriptor noise, 10 % without depth)."""
    Nf = KF_CAPS["N"]
    R, t = _se3([-0.25 * k, 0.0, 0.02 * k, 0.0, 0.01 * k, 0.0])
    pc = pts @ R.T + t
    uv = pc[:, :2] / pc[:, 2:] * 300.0 + np.float32([160.0, 120.0])
    vis = np.nonzero((pc[:, 2] > 0.5) & (uv[:, 0] > 2) & (uv[:, 0] < 318) &
                     (uv[:, 1] > 2) & (uv[:, 1] < 238))[0]
    ids = vis[rng.permutation(len(vis))[:Nf]]
    xy = (uv[ids] + 0.3 * rng.randn(len(ids), 2)).astype(np.float32)
    d = desc[ids] + 0.05 * rng.randn(len(ids), desc.shape[1])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    depth = pc[ids, 2].astype(np.float32)
    depth[rng.rand(len(ids)) < 0.1] = np.inf
    return dict(xy=xy, desc=d.astype(np.float32), depth=depth,
                valid=np.ones(len(ids), bool), time=np.float32(0.1 * k),
                octave=rng.randint(0, 3, len(ids)).astype(np.int8),
                ids=ids, R=R, t=t.astype(np.float32))


def assert_states_close(st_t, st_j, atol, rtol=1e-7):
    a = tst.map_state_to_numpy(st_t)
    b = jax.device_get(st_j)
    for name in tst.TENSOR_FIELDS:
        x, y = a[name], np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("policy,rtol", [
    (dict(use_depth=True), 1e-7),
    # monocular: no depth landmarks, only rays triangulated between
    # keyframes 0.5 m apart at 6-14 m, whose f32 positions after the local
    # BA differ by up to 2.7e-4 of their distance between the libraries
    (dict(use_depth=False), 1e-3),
    # the stereo / RGB-D culling that counts only close points
    (dict(use_depth=True, cull_close_only=True, cull_close_depth=9.0),
     1e-7)],
    ids=["rgbd", "mono", "close-points"])
def test_keyframe_step_matches_jax(policy, rtol):
    """An initial RGB-D map (frame 0) built by the JAX package and loaded
    into the port, then two keyframe steps on both sides: the first with
    fuse and culling, the second with local BA as well (the System's first
    two mapped keyframes), under each sensor's landmark and culling policy.
    The map states agree slot by slot."""
    pts, desc, rng = _scene()
    f0, f1, f2 = (_frame(k, pts, desc, rng) for k in (0, 2, 4))
    ff0 = jfr.FrameFeatures(J(f0["xy"]), J(f0["desc"]), J(f0["depth"]),
                            J(f0["valid"]), J(f0["time"]), J(f0["octave"]))
    st_j, _, bind0, _ = jtr.build_initial_map_rgbd(
        jst.empty_map(jst.MapCaps(**KF_CAPS)), CJ, ff0, jnp.int32(0))
    st_t = tst.map_state_from_numpy(jax.device_get(st_j), device="cpu")
    slot_of = {int(p): int(s) for p, s in zip(f0["ids"], np.asarray(bind0))
               if s >= 0}
    for fid, f, do_ba in ((2, f1, False), (4, f2, True)):
        # tracked bindings: 70 % of the frame's points with a frame-0 slot
        bind = np.int32([slot_of.get(int(p), -1) if rng.rand() < 0.7 else -1
                         for p in f["ids"]])
        kw = dict(do_ba=do_ba, do_aux=True, max_depth=40.0, ba_iters=5,
                  cull_redundancy=0.9, cull_max_kills=4, fuse_two_hop=4,
                  **policy)
        args = (f["xy"], f["valid"], f["desc"], f["depth"], bind, f["R"],
                f["t"], f["time"])
        out_j = jmap.keyframe_step(st_j, CJ, *map(J, args), jnp.int32(fid),
                                   feat_octave=J(f["octave"]), **kw)
        out_t = tmap.keyframe_step(st_t, CT, *map(T, args), fid,
                                   feat_octave=T(f["octave"]), **kw)
        st_j, st_t = out_j[0], out_t[0]
        assert int(out_t[1]) == int(out_j[1])
        assert int(out_t[2]) == int(out_j[2])
        assert_states_close(st_t, st_j, atol=1e-3, rtol=rtol)
    # the steps did real work: depth and triangulated landmarks, covisibility
    assert int(tst.num_keyframes(st_t)) == 3
    n_init = int(np.sum(np.isfinite(f0["depth"])))
    assert int(tst.num_landmarks(st_t)) > n_init + (
        0 if policy["use_depth"] else -n_init // 2)
    assert int(st_t.covis.max()) > 20


# ---------------------------------------------------------------------------
# the pose chain stays on SO(3) (the port's repair; the JAX package's
# keyframe_step and apply_chain_correction leave the products unprojected)
# ---------------------------------------------------------------------------

def _so3_off(R):
    """The largest |R R^T - I| (Frobenius, float64) over a stack."""
    R = np.asarray(N(R), np.float64).reshape(-1, 3, 3)
    return float(np.max(np.linalg.norm(
        R @ np.swapaxes(R, -1, -2) - np.eye(3), axis=(-2, -1))))


def _skewed(R, rng, by=1e-3):
    """R moved off SO(3) by a symmetric factor: |R R^T - I| ~ `by`."""
    S = rng.randn(3, 3)
    S = 0.5 * (S + S.T)
    S *= 0.5 * by / np.linalg.norm(S)
    return ((np.eye(3) + S) @ np.asarray(R, np.float64)).astype(np.float32)


def test_apply_chain_correction_stays_on_so3():
    """A pose and a correction each 1e-3 off SO(3): the corrected pose
    comes back within 1e-6 of it, next to the plain product."""
    from dani_slam_tpu_torch.slam import tracking as ttr
    rng = np.random.RandomState(3)
    R, t = _se3([0.1, -0.2, 0.3, 0.2, -0.1, 0.4])
    cR, ct = _se3([0.01, 0.02, -0.03, 0.03, 0.01, -0.02])
    Ro, cRo = _skewed(R, rng), _skewed(cR, rng)
    assert _so3_off(Ro) > 5e-4 and _so3_off(cRo) > 5e-4
    R2, t2 = ttr.apply_chain_correction(T(Ro), T(t), T(cRo), T(ct))
    assert _so3_off(R2) <= 1e-6, _so3_off(R2)
    np.testing.assert_allclose(N(R2), Ro @ cRo, atol=2e-3)
    np.testing.assert_allclose(N(t2), Ro @ ct + t, atol=1e-6)


def test_keyframe_chain_stays_on_so3():
    """Four keyframe steps as a pipelined System takes them: each keyframe
    at a pending frame's pose, which the previous keyframe's correction
    moved (tracking.apply_chain_correction), with the tracker's chain at
    that pose; the first correction and the first chain 1e-3 off SO(3).
    Every keyframe rotation the map holds, every correction and every
    re-anchored chain rotation lie within 1e-6 of SO(3). (The JAX package's
    arithmetic keeps the first 1e-3 and grows it about threefold a
    keyframe.)"""
    from dani_slam_tpu_torch.slam import frame as tfr
    from dani_slam_tpu_torch.slam import tracking as ttr
    pts, desc, rng = _scene()
    f0 = _frame(0, pts, desc, rng)
    st, _, bind0, _ = ttr.build_initial_map_rgbd(
        tst.empty_map(tst.MapCaps(**KF_CAPS), device="cpu"), CT,
        tfr.FrameFeatures(T(f0["xy"]), T(f0["desc"]), T(f0["depth"]),
                          T(f0["valid"]), T(f0["time"]), T(f0["octave"])), 0)
    slot_of = {int(p): int(s) for p, s in zip(f0["ids"], N(bind0))
               if s >= 0}
    corr = (T(_skewed(np.eye(3), rng)), torch.zeros(3))
    assert _so3_off(corr[0]) > 5e-4
    offs = []
    for fid in (1, 2, 3, 4):
        f = _frame(fid, pts, desc, rng)
        R, t = ttr.apply_chain_correction(T(f["R"]), T(f["t"]), *corr)
        R_chain = T(_skewed(N(R), rng)) if fid == 1 else R
        bind = np.int32([slot_of.get(int(p), -1) if rng.rand() < 0.7 else -1
                         for p in f["ids"]])
        st, k, _, chain = tmap.keyframe_step(
            st, CT, T(f["xy"]), T(f["valid"]), T(f["desc"]), T(f["depth"]),
            T(bind), R, t, T(f["time"]), fid, use_depth=True, do_ba=True,
            feat_octave=T(f["octave"]), chain=(R_chain, t, R_chain, t))
        corr = chain[4:]
        offs.append((fid, _so3_off(st.kf_R[int(k)]), _so3_off(chain[0]),
                     _so3_off(chain[2]), _so3_off(chain[4])))
    assert int(tst.num_keyframes(st)) == 5
    assert max(max(o[1:]) for o in offs) <= 1e-6, offs
