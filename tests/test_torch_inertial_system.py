"""The inertial sensors as a whole: the JAX package's System and the port's
System(device="cpu") on the same inputs, with IMU windows made from the
analytic trajectory the frames follow (numpy only; the JAX package ships
no sample generator, the rule is tests/test_mono_inertial.py's: the
gyroscope from finite rotation differences, the accelerometer the specific
force in the body frame, body == camera).

Configurations:
  * `rgbd` (tier 1): tests/test_inertial.py's TestInertialE2E /
    TestImuCoastWhenLost scene — pre-extracted features of a 1500-point
    world, caps K 64 / L 4096 / N 256 / D 64, a camera accelerating at
    1.2 m/s^2 along x, 10 Hz frames, 200 Hz IMU, a keyframe at least every
    4 frames — IMU_RGBD, 30 frames with the features blacked out at frames
    22-25 (the IMU coast), relocalization off, plain and pipelined
    (a lost frame of the pipelined run rolls the inertial state back with
    the pose).
  * `e2e-pipelined` (no test here): `e2e` with pipelined=True, the run
    tests/test_torch_cuda.py holds on the card against the CPU; the JAX
    package's spread on it (seeds 1-12: centres 0.097 m, bias_g 9.4e-3,
    keyframes 1, landmarks 25 %, states never) is that test's tolerance.
  * `stereo-stages` (tier 1): IMU_STEREO on the same world, the camera
    swinging +-1 m along x (a sinusoid, so the accelerometer sees a
    changing force) at 0.8 s between frames and a keyframe at least every
    second frame, 32 frames: the initialization, then VIBA1 (> 5 s after
    it) and VIBA2 (> 15 s) are reached.
  * `rgbd-full` / `stereo-full` (slow): chip_smoke.py's phases 14-15 at
    MapCaps() on 640x480 images of the bench's world at 10 Hz along the
    bench's orbit (orbit_trajectory(60, 10, 0.35)) with 400 Hz IMU windows:
    System(IMU_RGBD, detector=<compact YOLO>, matcher="auto",
    pipelined=True) and examples/stereo_inertial_euroc.py's
    System(IMU_STEREO, pipelined=True) on phase 10's rectified pair.
    `python tests/test_torch_inertial_system.py jax rgbd-full` prints the
    JAX package's numbers (chip_smoke's JAX_TARGETS); `... spread
    rgbd-full 1 2 3` its runs on its frames moved by N(0, 1e-3) px.

The JAX package's track_rgbd takes no IMU window (its IMU_RGBD image path
integrates nothing); its image runs here do what that path does for an
IMU sensor — detector masks, build_frame_rgbd, track_features — with the
window handed to track_features. The port's track_rgbd takes the window.

Tolerances (tier 1, on the same features): per-frame tracker states, the
IMU initialization frame and the VIBA stage equal, keyframes within 1;
bias_g within 1e-3; landmarks, camera centres and both biases within the
JAX package's own spread on the same features moved by N(0, 1e-3) px
(SPREAD below; PERF.md), e2e's accelerometer bias at every frame. The runs
part by rounding from the first local BA on (its reduced system is
ill-conditioned in f32), and the blackout of `coast` amplifies it: there
the JAX package alone lands up to 0.125 m apart.
"""
import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

torch.set_num_threads(2)       # several test workers share the machine

G = np.array([0.0, 0.0, -9.81])


# ---------------------------------------------------------------------------
# trajectories and their IMU samples (numpy)
# ---------------------------------------------------------------------------

def accel_pose(t, accel=np.array([1.2, 0.0, 0.0])):
    """(R_wb, C, a): tests/test_inertial.py's accelerating camera."""
    return np.eye(3), np.array([0.0, 0.0, -10.0]) + 0.5 * accel * t * t, \
        accel


def swing_pose(t, amp=1.0, omega=0.6):
    """(R_wb, C, a): the camera swinging along x, C = amp sin(omega t)."""
    C = np.array([amp * np.sin(omega * t), 0.0, -10.0])
    a = np.array([-amp * omega ** 2 * np.sin(omega * t), 0.0, 0.0])
    return np.eye(3), C, a


def orbit_pose(t, omega, radius=10.0):
    """(R_wb, C, a) of utils/synthetic.orbit_trajectory's camera at angle
    omega t (looking at the origin; body == camera)."""
    ang = omega * t
    C = np.array([radius * np.sin(ang), 0.0, -radius * np.cos(ang)])
    z = -C / np.linalg.norm(C)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], 1), C, -omega ** 2 * np.array(
        [C[0], 0.0, C[2]])


def imu_samples(pose_fn, t0, t1, rate):
    """(gyro [S,3], acc [S,3], dts [S]) f32 over [t0, t1]: gyro from the
    finite rotation between consecutive samples, acc = R_wb^T (a - g)."""
    n = max(int(round((t1 - t0) * rate)), 2)
    ts = np.linspace(t0, t1, n + 1)
    gyro, acc, dts = [], [], []
    for i in range(n):
        R0, _, a0 = pose_fn(ts[i])
        R1, _, _ = pose_fn(ts[i + 1])
        dt = ts[i + 1] - ts[i]
        gyro.append(Rotation.from_matrix(R0.T @ R1).as_rotvec() / dt)
        acc.append(R0.T @ (a0 - G))
        dts.append(dt)
    return (np.asarray(gyro, np.float32), np.asarray(acc, np.float32),
            np.asarray(dts, np.float32))


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

CONFIGS = {
    "e2e": dict(kind="rgbd", pose="accel", n=24, dt=0.1, rate=200.0,
                blackout=(), kf_every=4, reloc=True, pipelined=False),
    "e2e-pipelined": dict(kind="rgbd", pose="accel", n=24, dt=0.1,
                          rate=200.0, blackout=(), kf_every=4, reloc=True,
                          pipelined=True),
    "coast": dict(kind="rgbd", pose="accel", n=28, dt=0.1, rate=200.0,
                  blackout=range(22, 26), kf_every=4, reloc=False,
                  pipelined=False),
    "rollback": dict(kind="rgbd", pose="accel", n=26, dt=0.1, rate=200.0,
                     blackout=range(20, 22), kf_every=4, reloc=False,
                     pipelined=True),
    "stereo-stages": dict(kind="stereo", pose="swing", n=26, dt=1.0,
                          rate=64.0, blackout=(), kf_every=2, reloc=True,
                          pipelined=False),
    "rgbd-full": dict(kind="rgbd", full=True, n=60, fps=10.0, rate=400.0,
                      span=0.35),
    "stereo-full": dict(kind="stereo", full=True, n=60, fps=10.0,
                        rate=400.0, span=0.35),
}
FEAT_CAPS = dict(K=64, L=4096, N=256, D=64)
BASELINE = 0.12


def pose_fn(c):
    if c.get("full"):
        omega = c["span"] * c["fps"] / (c["n"] - 1)
        return lambda t: orbit_pose(t, omega)
    return accel_pose if c["pose"] == "accel" else swing_pose


def frame_times(c):
    dt = 1.0 / c["fps"] if c.get("full") else c["dt"]
    return [i * dt for i in range(c["n"])]


def windows(c):
    """Host IMU windows per frame (None for the first)."""
    ts = frame_times(c)
    fn = pose_fn(c)
    return [None] + [imu_samples(fn, ts[i - 1], ts[i], c["rate"])
                     for i in range(1, len(ts))]


def jax_system(c, pipelined):
    from dani_slam_tpu.core import cameras as jcam
    from dani_slam_tpu.core import state as jst
    from dani_slam_tpu.slam.system import Sensor, System
    sensor = Sensor.IMU_RGBD if c["kind"] == "rgbd" else Sensor.IMU_STEREO
    if c.get("full"):
        from dani_slam_tpu.models import superpoint as jsp
        from dani_slam_tpu.models import yolo as jyolo
        return System(jcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640,
                                          480),
                      sensor, caps=jst.MapCaps(), n_features=1024,
                      sp_params=jsp.load_default_params(),
                      detector=(jyolo.load_default_detector()
                                if c["kind"] == "rgbd" else None),
                      matcher="auto", pipelined=True)
    s = System(jcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480),
               sensor, caps=jst.MapCaps(**FEAT_CAPS), n_features=256,
               enable_loop_closing=False,
               enable_relocalization=c["reloc"], pipelined=pipelined)
    s.tracker.max_frames_between_kf = c["kf_every"]
    return s


def torch_system(c, pipelined, device="cpu"):
    from dani_slam_tpu_torch.core import cameras as tcam
    from dani_slam_tpu_torch.core import state as tst
    from dani_slam_tpu_torch.slam.system import Sensor, System
    sensor = Sensor.IMU_RGBD if c["kind"] == "rgbd" else Sensor.IMU_STEREO
    cam = tcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480,
                              device=device)
    if c.get("full"):
        from dani_slam_tpu_torch.models import yolo as tyolo
        return System(cam, sensor, caps=tst.MapCaps(), n_features=1024,
                      detector=(tyolo.load_default_detector(device)
                                if c["kind"] == "rgbd" else None),
                      matcher="auto", pipelined=True, device=device)
    s = System(cam, sensor, caps=tst.MapCaps(**FEAT_CAPS), n_features=256,
               enable_loop_closing=False, enable_relocalization=c["reloc"],
               pipelined=pipelined, device=device)
    s.tracker.max_frames_between_kf = c["kf_every"]
    return s


def feature_frames(c):
    """The JAX package's synthetic features of the feature configurations
    (render_frame of one world along the trajectory; blacked-out frames
    have no valid keypoint)."""
    import jax.numpy as jnp
    from dani_slam_tpu.core import cameras as jcam
    from dani_slam_tpu.utils import synthetic as jsyn
    cam = jcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)
    world = jsyn.make_world(1500, desc_dim=64, seed=6)
    fn = pose_fn(c)
    out = []
    for i, t in enumerate(frame_times(c)):
        R_wb, C, _ = fn(t)
        feat, _ = jsyn.render_frame(
            world, cam, jnp.asarray(R_wb.T, jnp.float32),
            jnp.asarray(-R_wb.T @ C, jnp.float32), n_max=256, noise_px=0.3,
            seed=i, with_depth=True, time=t)
        if i in c["blackout"]:
            feat = feat._replace(valid=jnp.zeros_like(feat.valid))
        out.append(feat)
    return out


def to_torch_frame(f):
    import jax
    from dani_slam_tpu_torch.slam.frame import FrameFeatures
    return FrameFeatures(*[None if x is None else torch.as_tensor(
        np.asarray(x)) for x in jax.device_get(f)])


def moved(frames, seed, px=1e-3):
    """The JAX frames with every keypoint moved by N(0, px) pixels."""
    import jax.numpy as jnp
    if not seed:
        return frames
    rng = np.random.RandomState(seed)
    return [f._replace(xy=f.xy + jnp.asarray(rng.normal(
        0.0, px, f.xy.shape).astype(np.float32))) for f in frames]


def run_features(system, frames, wins, pkg, device="cpu"):
    """Drive a System over features with the IMU windows; returns the
    per-frame (state, camera centre, init flag, bias_a)."""
    if pkg == "jax":
        from dani_slam_tpu.slam.inertial import make_window
        mk = make_window
    else:
        from dani_slam_tpu_torch.slam.inertial import make_window

        def mk(*w):
            return make_window(*w, device=device)
    out = []
    for i, f in enumerate(frames):
        w = None if wins[i] is None else mk(*wins[i])
        if pkg == "port":
            f = to_torch_frame(f) if not isinstance(f.xy, torch.Tensor) \
                else f
        s, R, t = system.track_features(f, imu_window=w)
        ins = system.tracker.inertial
        if pkg == "jax":
            C, ba = -np.asarray(R).T @ np.asarray(t), np.asarray(ins.bias_a)
        else:
            C, ba = (-R.T @ t).cpu().numpy(), ins.bias_a.cpu().numpy()
        out.append((s, C, bool(ins.initialized), ba))
    system.shutdown()
    return out


def summary(system, per_frame, pkg):
    ins = system.tracker.inertial
    if pkg == "jax":
        bg, ba = np.asarray(ins.bias_g), np.asarray(ins.bias_a)
    else:
        bg, ba = ins.bias_g.cpu().numpy(), ins.bias_a.cpu().numpy()
    states = [f[0] for f in per_frame]
    init = next((i for i, f in enumerate(per_frame) if f[2]), None)
    return dict(states=states, init=init, kf=system.n_keyframes(),
                lm=system.n_landmarks(), bias_g=bg, bias_a=ba,
                centres=np.stack([f[1] for f in per_frame]),
                bias_a_frames=np.stack([f[3] for f in per_frame]),
                stage=system._viba_stage,
                prior=(None if ins.prior_info is None else
                       np.asarray(ins.prior_info) if pkg == "jax" else
                       ins.prior_info.cpu().numpy()))


# ---------------------------------------------------------------------------
# tier-1 cases
# ---------------------------------------------------------------------------

RUNS = {}

# The JAX package's own spread on each feature configuration: its run on
# the same features moved by N(0, 1e-3) px against its run on the unmoved
# ones, seeds 1-12 (stereo-stages: 1-40, its accelerometer bias moving by
# 1.3e-3 on three of them; `python tests/test_torch_inertial_system.py
# spread <name> 1 2 ... 12`): the largest camera-centre distance over the
# frames, the largest change of bias_g and bias_a, and of the landmark
# count as a fraction, rounded up. States, the initialization frame,
# keyframes and the VIBA stage never moved. bias_g is held to 1e-3 where
# the JAX package's spread is larger (e2e: 5.9e-3 on seed 9). e2e's bias_a
# is held at every frame (`bias_a_frames`) to the JAX package's largest
# change at any frame over seeds 1-12, seed 9 left out as for bias_g (0.238
# there): 0.0465 (seed 7; at the last frame 0.0030-0.0254). A second
# witness, `python tests/test_torch_inertial_system.py order e2e`: the JAX
# package on the same features with XLA's CPU thread pool cut to one
# thread (another reduction order) moves it by up to 0.027 at a frame. The
# local inertial BA's reduced system is ill-conditioned in f32 (`...
# local-ba-rounding`), so the order of its sums sets the step. The port
# assembles and solves that system in float64 (ops/viba.py), off the JAX
# package's f32 arithmetic on purpose; its e2e run then keeps 613
# landmarks to the JAX package's 606 (1.16 %), where the JAX package's own
# runs on seeds 13-24 keep 605-613 (seed 17: 613): e2e's landmark spread
# is taken over seeds 1-24 (0.0116, rounded up; seeds 1-12 gave 0.01).
# coast's likewise over seeds 1-48: the port keeps 753 to the JAX
# package's 742, its own runs 740-754 on seeds 25-48 (seeds 34 and 45:
# 754, 0.0162; seeds 1-24 gave 0.014).
SPREAD = {"e2e": dict(centres=0.02, bias_g=1e-3, bias_a=0.047,
                      bias_a_frames=0.047, lm=0.012),
          "coast": dict(centres=0.09, bias_g=0.016, bias_a=0.35, lm=0.017),
          "rollback": dict(centres=0.09, bias_g=7e-4, bias_a=6e-3,
                           lm=0.004),
          "stereo-stages": dict(centres=0.0037, bias_g=2.5e-5,
                                bias_a=1.4e-3, lm=0.0021)}


# the arguments of the first VIBA_CALLS_KEPT local inertial BA solves
# (ops/viba._viba_solve) of each port run of feature_runs, by name
VIBA_CALLS = {}
VIBA_CALLS_KEPT = 3


def _kept(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return type(x)(*map(_kept, x)) if hasattr(x, "_fields") else \
            tuple(map(_kept, x))
    return x


def feature_runs(name):
    """(JAX summary, port summary, port System, JAX System) of a feature
    configuration, once per process; the port's first local inertial BA
    solves are kept in VIBA_CALLS[name]."""
    if name not in RUNS:
        from dani_slam_tpu_torch.ops import viba as tviba
        c = CONFIGS[name]
        frames = feature_frames(c)
        wins = windows(c)
        js = jax_system(c, c["pipelined"])
        j = summary(js, run_features(js, frames, wins, "jax"), "jax")
        ts = torch_system(c, c["pipelined"])
        calls = VIBA_CALLS.setdefault(name, [])
        solve = tviba._viba_solve

        def keep(*a):
            if len(calls) < VIBA_CALLS_KEPT:
                calls.append(_kept(a))
            return solve(*a)
        tviba._viba_solve = keep
        try:
            t = summary(ts, run_features(ts, frames, wins, "port"), "port")
        finally:
            tviba._viba_solve = solve
        RUNS[name] = (j, t, ts, js)
    return RUNS[name]


def assert_runs_close(j, t, name):
    assert t["states"] == j["states"]
    assert t["init"] == j["init"] and t["init"] is not None
    assert t["stage"] == j["stage"]
    assert abs(t["kf"] - j["kf"]) <= 1, (t["kf"], j["kf"])
    tol = SPREAD[name]
    assert abs(t["lm"] - j["lm"]) <= tol["lm"] * j["lm"], (t["lm"], j["lm"])
    np.testing.assert_allclose(t["bias_g"], j["bias_g"], atol=tol["bias_g"])
    np.testing.assert_allclose(t["bias_a"], j["bias_a"], atol=tol["bias_a"])
    if "bias_a_frames" in tol:
        np.testing.assert_allclose(t["bias_a_frames"], j["bias_a_frames"],
                                   atol=tol["bias_a_frames"])
    d = np.linalg.norm(t["centres"] - j["centres"], axis=1)
    assert d.max() <= tol["centres"], d.round(4)


def test_imu_rgbd_e2e_matches():
    """TestInertialE2E's IMU_RGBD run: the same states frame by frame, the
    same initialization frame, bias_g within 1e-3, keyframes, landmarks and
    trajectory; and the JAX tests' own assertions on the port (the IMU
    initialized, tracking OK, near-zero gyro bias, the marginalized prior
    carried: PSD, with pose-velocity cross-information)."""
    j, t, ts, _ = feature_runs("e2e")
    assert_runs_close(j, t, "e2e")
    assert ts.tracker.inertial.initialized
    assert float(np.abs(t["bias_g"]).max()) < 0.01
    assert t["states"].count("OK") / len(t["states"]) > 0.9
    info = t["prior"]
    assert info is not None and info.shape == (15, 15)
    evals = np.linalg.eigvalsh(0.5 * (info + info.T))
    assert evals.min() >= -1e-3 * max(evals.max(), 1.0)
    off = info - np.diag(np.diag(info))
    assert np.abs(off).max() > 1e-3


def _in_float64(x):
    """x with its floating-point tensors (also inside tuples, NamedTuples
    and the camera) in float64."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, params=x.params.double(),
                                   dist=x.dist.double())
    if isinstance(x, tuple):
        return type(x)(*map(_in_float64, x)) if hasattr(x, "_fields") else \
            tuple(map(_in_float64, x))
    return x


@pytest.mark.parametrize("call", range(VIBA_CALLS_KEPT))
def test_local_inertial_ba_step_against_float64(call):
    """The local inertial BA's normal equations and solve are float64 (the
    residuals, Jacobians and costs float32): on each of the first three
    local inertial BAs of the `e2e` run, one LM iteration's translation,
    velocity and biases lie within 1e-5 of the same iteration done
    entirely in float64. (Assembled and solved in float32, as in the JAX
    package, the third lay 6.0e-3 / 3.0e-3 apart in translation / bias_a;
    the float32-assembled system solved in float64 no closer.)"""
    from dani_slam_tpu_torch.ops import viba as tviba
    feature_runs("e2e")
    a = VIBA_CALLS["e2e"][call]
    one = tviba._viba_solve(*a[:15], 1, *a[16:])
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        ref = tviba._viba_solve(*_in_float64(a[:15]), 1, *a[16:])
    finally:
        torch.set_default_dtype(default)
    assert one.t.dtype == torch.float32 and ref.t.dtype == torch.float64
    for f in ("t", "v", "bg", "ba"):
        d = float(torch.max(torch.abs(getattr(one, f).double() -
                                      getattr(ref, f))))
        assert d <= 1e-5, (f, d)


def test_imu_coast_through_blackout_matches():
    """TestImuCoastWhenLost: through the four blacked-out frames the
    tracker is RECENTLY_LOST and coasts on the IMU prediction, then returns
    to OK without relocalization — frame by frame as in the JAX package —
    and the coast kept the pose moving with the truth."""
    j, t, ts, _ = feature_runs("coast")
    assert_runs_close(j, t, "coast")
    states = t["states"]
    assert ts.tracker.inertial.initialized
    assert "RECENTLY_LOST" in states[22:26], states[20:]
    assert states[-1] == "OK" and "OK" in states[26:], states[20:]
    assert ts.tracker.relocalizations == 0
    c = CONFIGS["coast"]
    C0 = accel_pose(0.0)[1]
    err = [np.linalg.norm(t["centres"][i] -
                          (accel_pose(frame_times(c)[i])[1] - C0))
           for i in range(len(states))]
    assert err[26] - err[21] < 0.6, np.round(err[18:], 3)


def test_imu_pipelined_rollback_matches():
    """Pipelined: the blacked-out frames are found lost when their
    deferred decisions resolve, and the rollback restores the inertial
    state (velocity, biases, the last preintegration, the frame windows,
    the marginalized prior) together with the pose — the same states, the
    same windows kept and the same trajectory frames as the JAX package."""
    j, t, ts, js = feature_runs("rollback")
    assert_runs_close(j, t, "rollback")
    assert ts.tracker.rollbacks >= 1
    assert len(ts.tracker.inertial.frame_windows) == \
        len(js.tracker.inertial.frame_windows)
    assert [round(tm, 4) for tm, _, _ in ts.tracker.trajectory] == \
        [round(tm, 4) for tm, _, _ in js.tracker.trajectory]


def test_imu_stereo_stages_match():
    """IMU_STEREO through the initialization, VIBA1 and VIBA2 in both
    packages: the same stage flags on the map and the same run."""
    j, t, ts, js = feature_runs("stereo-stages")
    assert t["stage"] == 2, t["stage"]
    st = ts.map_state
    assert bool(st.imu_initialized) and bool(st.imu_ba1) and \
        bool(st.imu_ba2)
    assert ts.full_inertial_bas >= 3 and ts.local_inertial_bas > 0
    assert_runs_close(j, t, "stereo-stages")


MERGE_R12 = Rotation.from_rotvec([0.05, -0.03, 0.2]).as_matrix().astype(
    np.float32)
MERGE_T12 = np.array([0.02, -0.01, 0.03], np.float32)


def fixed_verifiers(scale):
    """Cross-map verifiers for both packages returning one fixed relative
    Sim3 (MERGE_R12, MERGE_T12, scale) as verified."""
    import jax.numpy as jnp

    def jverify(st_a, st_b, cam, kf_a, kf_b, key, fix_scale=True):
        return ((jnp.asarray(MERGE_R12), jnp.asarray(MERGE_T12),
                 jnp.asarray(scale, jnp.float32)), jnp.asarray(100),
                jnp.ones((), bool))

    def tverify(st_a, st_b, cam, kf_a, kf_b, gen, fix_scale=True):
        return ((torch.as_tensor(MERGE_R12), torch.as_tensor(MERGE_T12),
                 torch.tensor(scale)), torch.tensor(100),
                torch.ones((), dtype=torch.bool))
    return jverify, tverify


def merge_once(sysm, js, pkg, move_seed=0):
    """_try_map_merge of System `sysm` (the JAX package's js itself, or
    the port's handed js's state: map, slots, chain marks, inertial state)
    with the e2e run's map stashed in the Atlas and its copy active, IMU
    initialized with VIBA1 done (for the JAX package with the active map's
    keypoints moved by N(0, 1e-3) px for move_seed > 0). Returns (merged,
    map as numpy, chain marks, recent chain); the System is restored."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from dani_slam_tpu_torch.core import state as tst
    from dani_slam_tpu_torch.ops import imu as timu
    from dani_slam_tpu_torch.slam import inertial as tin
    tr = sysm.tracker
    snap = (tr.st, list(sysm._kf_window_marks), list(sysm._recent_kfs),
            list(sysm._recent_preints), tr.ref_kf, tr.ref_kf_fid,
            tr.last_bind, tr.inertial)
    st0 = jax.device_get(js.tracker.st)
    if pkg == "jax":
        st1 = dataclasses.replace(js.tracker.st,
                                  imu_initialized=jnp.ones((), bool),
                                  imu_ba1=jnp.ones((), bool))
        sysm.atlas.stored = [dict(st=st1, bow=None)]
        if move_seed:
            kp = np.asarray(st0.kf_kp)
            st1 = dataclasses.replace(st1, kf_kp=jnp.asarray(
                kp + np.random.RandomState(move_seed).normal(
                    0, 1e-3, kp.shape).astype(np.float32)))
        tr.st = st1
    else:
        st1 = dataclasses.replace(
            tst.map_state_from_numpy(st0, device="cpu"),
            imu_initialized=torch.ones((), dtype=torch.bool),
            imu_ba1=torch.ones((), dtype=torch.bool))
        sysm.atlas.stored = [dict(st=st1, bow=None)]
        tr.st = st1
        tr.ref_kf, tr.ref_kf_fid = js.tracker.ref_kf, js.tracker.ref_kf_fid
        tr.ref_kf_dev = torch.tensor(tr.ref_kf)
        tr.last_bind = torch.as_tensor(np.asarray(js.tracker.last_bind))
        sysm._kf_window_marks = list(js._kf_window_marks)
        sysm._recent_kfs = list(js._recent_kfs)
        ji = js.tracker.inertial
        tr.inertial = tin.inertial_state_from_numpy(dict(
            calib=ji.calib, initialized=True, v_w=ji.v_w, bias_g=ji.bias_g,
            bias_a=ji.bias_a, frame_windows=ji.frame_windows),
            device="cpu")
        sysm._recent_preints = [
            None if p is None else timu.preint_from_numpy(
                jax.device_get(p), "cpu") for p in js._recent_preints]
    sysm._try_map_merge()
    out = (len(sysm.atlas.stored) == 0,
           ({f: np.asarray(getattr(jax.device_get(tr.st), f))
             for f in ("kf_mask", "kf_R", "kf_t")} if pkg == "jax" else
            tst.map_state_to_numpy(tr.st)),
           list(sysm._kf_window_marks), list(sysm._recent_kfs))
    (tr.st, sysm._kf_window_marks, sysm._recent_kfs, sysm._recent_preints,
     tr.ref_kf, tr.ref_kf_fid, tr.last_bind, tr.inertial) = snap
    sysm.atlas.stored = []
    return out


# The JAX package's own spread on the accepted merge: its weld (fuse, local
# BA, local inertial BA) with the active map's keypoints moved by
# N(0, 1e-3) px, seeds 1-3 (`python tests/test_torch_inertial_system.py
# spread merge 1 2 3`): the largest change of a keyframe's R or t entry,
# rounded up.
MERGE_SPREAD = 5e-3


def test_vi_merge_gates_match(monkeypatch):
    """The inertial merge gates of _try_map_merge (reference
    src/LoopClosing.cc:145-178) on one state handed to both packages: the
    e2e run's map stashed in the Atlas and its copy active, IMU initialized
    with VIBA1 done, the cross-map verifier replaced by one returning a
    fixed relative Sim3. A scale of 1.2 is refused (no merge); a scale of
    1.0 merges with the relative rotation clamped to its yaw, and the
    merged maps and the inertial bookkeeping after the merge agree."""
    from dani_slam_tpu.slam import loopclosing as jlc
    from dani_slam_tpu_torch.slam import loopclosing as tlc
    _, _, ts, js = feature_runs("e2e")
    outcomes = []
    for scale in (1.2, 1.0):
        jverify, tverify = fixed_verifiers(scale)
        monkeypatch.setattr(jlc, "verify_cross_map_candidate", jverify)
        monkeypatch.setattr(tlc, "verify_cross_map_candidate", tverify)
        outcomes.append({pkg: merge_once(sysm, js, pkg)
                         for pkg, sysm in (("jax", js), ("port", ts))})
    refused, accepted = outcomes
    assert not refused["jax"][0] and not refused["port"][0]
    assert accepted["jax"][0] and accepted["port"][0]
    (_, st_j, marks_j, rec_j), (_, st_t, marks_t, rec_t) = \
        accepted["jax"], accepted["port"]
    assert marks_t == marks_j and rec_t == rec_j
    np.testing.assert_array_equal(st_t["kf_mask"], st_j["kf_mask"])
    live = st_j["kf_mask"]
    for f in ("kf_t", "kf_R"):
        np.testing.assert_allclose(st_t[f][live], st_j[f][live],
                                   atol=MERGE_SPREAD)


# ---------------------------------------------------------------------------
# full size (slow) and the command line
# ---------------------------------------------------------------------------

def image_sequence(c):
    """(R_gt, t_gt, left images, depths or right images, times) of a full
    configuration, 10 Hz along the bench's orbit."""
    from dani_slam_tpu_torch.utils import synthetic as tsyn
    R_gt, t_gt = tsyn.orbit_trajectory(c["n"], radius=10.0,
                                       angle_span=c["span"])
    params = [500.0, 500.0, 320.0, 240.0]
    if c["kind"] == "rgbd":
        imgs, deps, times = tsyn.make_rgbd_image_sequence(
            params, 640, 480, R_gt, t_gt, seed=0, fps=c["fps"])
        return R_gt, t_gt, imgs, deps, times
    left, right, times = tsyn.make_stereo_image_sequence(
        params, 640, 480, R_gt, t_gt, baseline=BASELINE, seed=0,
        fps=c["fps"])
    return R_gt, t_gt, left, right, times


def jax_image_frames(js, c, seq):
    """The JAX package's frames of a full configuration as its IMU path
    builds them (detector masks + build_frame_rgbd, or build_frame_stereo),
    with the dynamic ratios."""
    import jax.numpy as jnp
    from dani_slam_tpu.slam import frame as jfr
    _, _, a, b, times = seq
    frames, dyn = [], []
    for i in range(len(a)):
        if c["kind"] == "rgbd":
            img = jnp.asarray(a[i])
            boxes, bmask, d = js.detector.dynamic_mask_inputs(img)
            frames.append(jfr.build_frame_rgbd(
                js._sp(), img, jnp.asarray(b[i]), js.cam, times[i],
                depth_factor=5000.0, n_max=js.n_features, boxes=boxes,
                box_mask=bmask))
            dyn.append(d)
        else:
            frames.append(jfr.build_frame_stereo(
                js._sp(), jnp.asarray(a[i]), jnp.asarray(b[i]), js.cam,
                BASELINE, times[i], n_max=js.n_features,
                matcher=js.matcher))
            dyn.append(None)
    return frames, dyn


def full_summary(system, states, seq, pkg):
    """Init frame, tracked, keyframes, landmarks, rigid ATE (no scale: the
    initialization rotates the world to gravity), biases, stage."""
    from dani_slam_tpu_torch.utils import eval as ev
    traj = system.tracker.trajectory
    C = np.stack([-np.asarray(R).T @ np.asarray(t) for _, R, t in traj])
    idx = np.round(np.asarray([tm for tm, _, _ in traj]) * 10).astype(int)
    gt = ev.centers_from_tcw(np.asarray(seq[0])[idx],
                             np.asarray(seq[1])[idx])
    ins = system.tracker.inertial
    to_np = (np.asarray if pkg == "jax" else
             (lambda x: x.detach().cpu().numpy()))
    return dict(tracked=states.count("OK"), kf=system.n_keyframes(),
                lm=system.n_landmarks(),
                ate=ev.ate_rmse(C, gt, with_scale=False),
                bias_g=float(np.linalg.norm(to_np(ins.bias_g))),
                bias_a=float(np.linalg.norm(to_np(ins.bias_a))),
                stage=system._viba_stage)


def jax_full_run(name, move_seed=0):
    """The JAX package's run of a full configuration on its frames (moved
    by N(0, 1e-3) px for move_seed > 0); prints and returns its numbers."""
    from dani_slam_tpu.slam.inertial import make_window
    c = CONFIGS[name]
    seq = image_sequence(c)
    js = jax_system(c, True)
    frames, dyn = jax_image_frames(js, c, seq)
    frames = moved(frames, move_seed)
    wins = windows(c)
    states, init = [], None
    for i, f in enumerate(frames):
        w = None if wins[i] is None else make_window(*wins[i])
        s, _, _ = js.track_features(f, dyn_ratio=dyn[i], imu_window=w,
                                    timestamp=seq[4][i])
        states.append(s)
        if init is None and js.tracker.inertial.initialized:
            init = i
    js.shutdown()
    out = full_summary(js, states, seq, "jax")
    out["init"] = init
    print(name, move_seed, out, "".join(s[0] for s in states), flush=True)
    return out


@pytest.mark.slow
@pytest.mark.parametrize("name", ["rgbd-full", "stereo-full"])
def test_full_size_against_jax(name):
    """The port's image run of chip_smoke's phase 14 / 15 on the CPU
    against the JAX package's, with chip_smoke's margins."""
    from dani_slam_tpu_torch.slam.inertial import make_window
    c = CONFIGS[name]
    seq = image_sequence(c)
    j = jax_full_run(name)
    ts = torch_system(c, True)
    wins = windows(c)
    states, init = [], None
    for i in range(c["n"]):
        w = None if wins[i] is None else make_window(*wins[i],
                                                     device="cpu")
        if c["kind"] == "rgbd":
            s, _, _ = ts.track_rgbd(torch.as_tensor(seq[2][i]),
                                    torch.as_tensor(seq[3][i].astype(
                                        np.int32)),
                                    seq[4][i], imu_window=w)
        else:
            s, _, _ = ts.track_stereo(torch.as_tensor(seq[2][i]),
                                      torch.as_tensor(seq[3][i]), seq[4][i],
                                      BASELINE, imu_window=w)
        states.append(s)
        if init is None and ts.tracker.inertial.initialized:
            init = i
    ts.shutdown()
    t = full_summary(ts, states, seq, "port")
    t["init"] = init
    print(name, "port", t, "jax", j)
    assert t["init"] is not None and abs(t["init"] - j["init"]) <= 2
    assert t["tracked"] >= max(51, j["tracked"] - 3)
    assert j["kf"] / 2 <= t["kf"] <= 2 * j["kf"]
    assert abs(t["lm"] - j["lm"]) <= 0.4 * j["lm"]
    assert t["ate"] <= j["ate"] + 0.10


def jax_bias_a_frames(name):
    """The JAX package's bias_a after every frame of a feature
    configuration (unmoved features), and its landmark count."""
    c = CONFIGS[name]
    js = jax_system(c, c["pipelined"])
    s = summary(js, run_features(js, feature_frames(c), windows(c), "jax"),
                "jax")
    return s["bias_a_frames"], s["lm"]


def reduction_order_witness(name):
    """The JAX package against itself on the same features with only XLA's
    CPU thread pool changed (one thread: another reduction order), and the
    port against both: the largest change of bias_a at any frame and at the
    last, and the landmark counts."""
    import json
    import os
    import subprocess
    if os.environ.get("WITNESS_CHILD"):
        frames, lm = jax_bias_a_frames(name)
        print(json.dumps([frames.tolist(), lm]))
        return
    env = dict(os.environ, WITNESS_CHILD="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    child = subprocess.run([sys.executable, __file__, "order", name],
                           env=env, capture_output=True, text=True,
                           check=True)
    one, lm_one = json.loads(child.stdout.strip().splitlines()[-1])
    one = np.asarray(one)
    many, lm_many = jax_bias_a_frames(name)
    c = CONFIGS[name]
    ts = torch_system(c, c["pipelined"])
    s = summary(ts, run_features(ts, feature_frames(c), windows(c),
                                 "port"), "port")
    port = s["bias_a_frames"]
    for what, a, b in (("JAX one thread vs JAX", one, many),
                       ("port vs JAX", port, many),
                       ("port vs JAX one thread", port, one)):
        d = np.abs(a - b).max(axis=1)
        print(name, what, "bias_a apart at any frame", float(d.max()),
              "at the last", float(d[-1]), flush=True)
    print(name, "landmarks: JAX", lm_many, "JAX one thread", lm_one,
          "port", s["lm"], flush=True)


def local_ba_rounding():
    """At every local inertial BA of the JAX package's `e2e` run: the
    port's local_inertial_ba on the same inputs against the JAX package's
    result, and the JAX package's on the window's keypoints moved by
    N(0, 1e-3) px; then the first iteration's reduced system in both
    packages (the port's viba_solve inputs handed to both): its condition
    number and each package's f32 step against the f64 solution."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from dani_slam_tpu.core import cameras as jcam
    from dani_slam_tpu.ops import imu as jimu
    from dani_slam_tpu.ops import viba as jviba
    from dani_slam_tpu.slam import inertial_mapping as jim
    from dani_slam_tpu.slam.inertial import make_window
    from dani_slam_tpu_torch.core import cameras as tcam
    from dani_slam_tpu_torch.core import state as tst
    from dani_slam_tpu_torch.ops import imu as timu
    from dani_slam_tpu_torch.ops import viba as tviba
    from dani_slam_tpu_torch.slam import inertial_mapping as tim
    jc = jcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)
    tc = tcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480,
                             device="cpu")
    jlba, tsolve, jchol, tchol = (jim.local_inertial_ba, tviba.viba_solve,
                                  jviba.dla.chol_solve,
                                  tviba.dla.chol_solve)

    def fields(st):
        d = jax.device_get(st)
        return {f.name: np.asarray(getattr(d, f.name))
                for f in dataclasses.fields(d) if f.name != "caps"}

    def apart(a, b):
        m = a["kf_mask"]
        return {f: round(float(np.abs(a[f][m] - b[f][m]).max()), 6)
                for f in ("kf_t", "kf_bias_a")}

    def probe(st, cam, slots, valid, pre, edge, calib, **kw):
        res = jlba(st, cam, slots, valid, pre, edge, calib, **kw)
        out = fields(res)
        A = fields(st)
        t_args = (torch.as_tensor(np.asarray(slots).astype(np.int64)),
                  torch.as_tensor(np.asarray(valid)),
                  timu.preint_from_numpy(jax.device_get(pre), "cpu"),
                  torch.as_tensor(np.asarray(edge)),
                  timu.ImuCalib(*[torch.as_tensor(np.asarray(x))
                                  for x in calib]))
        cap = {}

        def hook(*a, **k):
            cap["a"], cap["k"] = a, k
            return tsolve(*a, **k)
        tviba.viba_solve = hook
        port = tst.map_state_to_numpy(tim.local_inertial_ba(
            tst.map_state_from_numpy(A, device="cpu"), tc, *t_args, **kw))
        tviba.viba_solve = tsolve
        kp = st.kf_kp + jnp.asarray(np.random.RandomState(1).normal(
            0.0, 1e-3, st.kf_kp.shape).astype(np.float32))
        moved_out = fields(jlba(dataclasses.replace(st, kf_kp=kp), cam,
                                slots, valid, pre, edge, calib, **kw))
        # the first iteration's reduced system, the port's inputs in both
        a, k = cap["a"], dict(cap["k"], iters=1)
        J = lambda x: jnp.asarray(x.numpy())                 # noqa: E731
        ja = ([J(x) for x in a[:8]] + [jc] + [J(x) for x in a[9:12]] +
              [jimu.Preintegrated(*[J(x) for x in a[12]]), J(a[13]),
               jimu.ImuCalib(*[J(x) for x in a[14]])])
        systems = []
        jviba.dla.chol_solve = lambda S, b: (
            systems.append((np.asarray(S), np.asarray(b))), jchol(S, b))[1]
        with jax.disable_jit():
            jviba.viba_solve(*ja, **k)
        jviba.dla.chol_solve = jchol
        S, b = systems[0]
        S64 = S.astype(np.float64)
        x64 = np.linalg.solve(S64, b.astype(np.float64))
        xj = np.asarray(jchol(jnp.asarray(S), jnp.asarray(b)))
        xt = tchol(torch.as_tensor(S), torch.as_tensor(b)).numpy()
        print("local inertial BA: port vs JAX", apart(out, port),
              "JAX moved vs JAX", apart(out, moved_out),
              "| first reduced system: condition %.3g, f32 step vs f64: "
              "JAX %.3g, port %.3g (|step| %.3g)" % (
                  np.linalg.cond(S64), np.abs(xj - x64).max(),
                  np.abs(xt - x64).max(), np.abs(x64).max()), flush=True)
        return res

    jim.local_inertial_ba = probe
    c = CONFIGS["e2e"]
    js = jax_system(c, c["pipelined"])
    wins = windows(c)
    for i, f in enumerate(feature_frames(c)):
        js.track_features(f, imu_window=None if wins[i] is None
                          else make_window(*wins[i]))
    jim.local_inertial_ba = jlba


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_full_run(sys.argv[2])
    elif sys.argv[1] == "order":
        reduction_order_witness(sys.argv[2])
    elif sys.argv[1] == "local-ba-rounding":
        local_ba_rounding()
    elif sys.argv[1] == "spread":
        name = sys.argv[2]
        if name == "merge":
            from dani_slam_tpu.slam import loopclosing as jlc
            js = feature_runs("e2e")[3]
            jlc.verify_cross_map_candidate = fixed_verifiers(1.0)[0]
            base = merge_once(js, js, "jax")[1]
            for seed in (int(x) for x in sys.argv[3:]):
                m = merge_once(js, js, "jax", seed)[1]
                live = base["kf_mask"]
                print("merge", seed, max(
                    float(np.abs(m[f][live] - base[f][live]).max())
                    for f in ("kf_t", "kf_R")), flush=True)
        for seed in (int(x) for x in sys.argv[3:]):
            if name == "merge":
                break
            if not CONFIGS[name].get("full"):
                c = CONFIGS[name]

                def jax_run(k):
                    js = jax_system(c, c["pipelined"])
                    return summary(js, run_features(
                        js, moved(feature_frames(c), k), windows(c), "jax"),
                        "jax")
                if seed == int(sys.argv[3]):
                    base = jax_run(0)
                m = jax_run(seed)
                d = np.linalg.norm(m["centres"] - base["centres"], axis=1)
                print(name, seed, "states equal",
                      m["states"] == base["states"], "init", m["init"],
                      base["init"], "kf", m["kf"], base["kf"], "lm",
                      m["lm"], base["lm"], "stage", m["stage"],
                      base["stage"], "centres apart max",
                      round(float(d.max()), 5), "bias_g apart",
                      float(np.abs(m["bias_g"] - base["bias_g"]).max()),
                      "bias_a apart",
                      float(np.abs(m["bias_a"] - base["bias_a"]).max()),
                      "at any frame", float(np.abs(
                          m["bias_a_frames"] - base["bias_a_frames"]).max()),
                      flush=True)
            else:
                jax_full_run(name, seed)
