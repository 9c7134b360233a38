"""The three stereo runners' sequences of chip_smoke.py's phase 19 on the
CPU: KITTI stereo at 1241x376 with 2000 features (`kitti_1241`), EuRoC
stereo-inertial with its unrectified radtan pair at 752x480 (`euroc_752`)
and TUM-VI stereo-inertial with two KB8 fisheye cameras at 512x512
(`tumvi_512`), each written by chip_smoke's writer.

* Round trip: each writer at full resolution and 3 frames, read back
  through the port's loaders (utils/io, examples/_common.load_mav0) and
  Settings.from_yaml: frame and IMU counts and stamps, the camera kind,
  the rectifier (EuRoC only), N = nFeatures, KITTI's baseline from bf.
* Parity on frame 0 of each, port against the JAX package, for the
  function that first meets the dataset's camera: build_frame_stereo at
  1241x376 (with LightGlue, as the runner's System stereo-matches), the
  EuRoC rectifier's grids and rectified
  pair, build_frame_stereo_fisheye at 512x512 KB8. Tolerances as
  tests/test_torch_stereo.py's: >= 95 % of the JAX package's valid left
  keypoints kept, the depth equal (rtol 1e-5; the fisheye depth finite on
  the same rows) on >= 90 % of them; the rectifier's grids within 2e-3 px,
  its camera and baseline equal, the rectified images within 0.05 grey
  levels.

The command line gives the JAX package's runs that chip_smoke holds the
card's to (STEREO_RUNNER_TARGETS), on the CPU at full size:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_stereo_runners.py \\
        targets kitti_1241 30 0 1 2 3

writes the sequence's first 30 frames, and for seed > 0 moves a quarter of
every image's pixels by one grey level (tests/test_torch_examples_cli.py's
perturb_images, the method of its RUNNER_TOL), runs the JAX runner on each
in this process and prints its numbers and their range. `targets` runs the
JAX runner with the port's SO(3) repair applied from outside the package
(repair_jax); `unrepaired` runs it as it is, and `port` runs the port's
runner the same way with --device cpu.
`... drift jax|jax-repaired|port tumvi_512 28` prints, frame by frame, how
far the tracker's and the keyframes' rotations are from SO(3).
"""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

torch.set_num_threads(2)       # several test workers share the machine

N_WRITTEN = 3


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{name: (directory, the writer's result)} at N_WRITTEN frames."""
    out = {}
    for name in cs.STEREO_SEQUENCES:
        d = tmp_path_factory.mktemp(name)
        out[name] = (str(d), cs.write_stereo_sequences(
            {name: (str(d), N_WRITTEN)}, procs=1)[name])
    return out


def _pair(d, spec, i):
    """Frame i's (left, right) images as the runner loads them."""
    from dani_slam_tpu_torch.examples._common import load_mav0
    from dani_slam_tpu_torch.utils import io as io_utils
    if spec["layout"] == "kitti":
        _, lp, rp = io_utils.load_kitti_stereo_list(d)[i]
    else:
        _, (left, right), _ = load_mav0(d, ("cam0", "cam1"), False)
        lp, rp = left[i][1], right[i][1]
    return io_utils.load_image(lp), io_utils.load_image(rp)


@pytest.mark.parametrize("name", sorted(cs.STEREO_SEQUENCES))
def test_writer_round_trip(written, name):
    """The written sequence read back as the runner reads it."""
    from dani_slam_tpu_torch.core import cameras, config
    from dani_slam_tpu_torch.examples._common import load_mav0
    from dani_slam_tpu_torch.utils import io as io_utils
    d, seq = written[name]
    spec = cs.STEREO_SEQUENCES[name]
    s = config.Settings.from_yaml(seq["settings"])
    size = {"kitti_1241": (1241, 376), "euroc_752": (752, 480),
            "tumvi_512": (512, 512)}[name]
    assert (s.width, s.height) == size
    assert s.n_features == {"kitti_1241": 2000, "euroc_752": 1200,
                            "tumvi_512": 1000}[name]
    assert s.fps == (10.0 if name == "kitti_1241" else 20.0)
    cam = s.camera("cpu")
    assert cam.kind == (cameras.KB8 if name == "tumvi_512"
                        else cameras.PINHOLE)
    # the KITTI pair comes rectified; the EuRoC runner rectifies (the
    # TUM-VI runner matches the fisheye pair unrectified)
    rect = s.stereo_rectifier("cpu")
    if name != "tumvi_512":
        assert (rect is not None) == (name == "euroc_752")
    np.testing.assert_allclose(seq["stamps"][1:] - seq["stamps"][:-1],
                               1.0 / s.fps, atol=1e-6)
    left, right = _pair(d, spec, N_WRITTEN - 1)
    assert left.shape == right.shape == size[::-1]
    assert left.dtype == np.uint8 and 40 < left.mean() < 150
    if spec["layout"] == "kitti":
        frames = io_utils.load_kitti_stereo_list(d)
        assert len(frames) == N_WRITTEN
        np.testing.assert_allclose([f[0] for f in frames], seq["stamps"],
                                   atol=1e-9)
        # KITTI00-02.yaml's bf over fx: the 0.537 m baseline
        assert abs(s.baseline - 386.1448 / 718.856) < 1e-12
        assert abs(s.baseline - 0.5372) < 1e-4
        return
    t0, (cam0, cam1), imu = load_mav0(d, ("cam0", "cam1"), True)
    assert len(cam0) == len(cam1) == N_WRITTEN
    assert abs(t0 - spec["t0_ns"] * 1e-9) < 1e-6      # epoch-scale
    np.testing.assert_allclose([t for t, _ in cam0],
                               seq["stamps"] - seq["stamps"][0], atol=1e-6)
    # IMU_RATE_MAV0 samples between consecutive frames, the last at the
    # frame's own stamp
    per = int(round(cs.IMU_RATE_MAV0 / s.fps))
    imu_t = imu[0]
    assert len(imu_t) == per * (N_WRITTEN - 1)
    np.testing.assert_allclose(imu_t[per - 1::per], [t for t, _ in cam0[1:]],
                               atol=1e-9)
    np.testing.assert_allclose(np.diff(imu_t), 1.0 / cs.IMU_RATE_MAV0,
                               atol=1e-6)
    T12 = np.asarray(s.stereo_t_c1_c2).reshape(4, 4)
    if name == "euroc_752":
        assert 0.10 < rect.baseline < 0.12
        assert rect.map_l.shape == (480, 752, 2)
        assert abs(T12[0, 3] - 0.110074137800478) < 1e-9
    else:
        np.testing.assert_array_equal(T12[:3, :3], np.eye(3))
        assert T12[0, 3] == 0.10
        assert s.lapping1 == s.lapping2 == (0.0, 511.0)
        assert s.camera2("cpu").kind == cameras.KB8
        np.testing.assert_allclose(cam.params[4:].numpy(), [
            0.00348, 0.000715, -0.00205, 0.000202], rtol=1e-6)


def _keys(xy, valid):
    """{rounded keypoint: row} of the valid rows."""
    return {tuple(np.round(p, 2)): i for i, (p, v) in
            enumerate(zip(np.asarray(xy), np.asarray(valid))) if v}


def _hold_frames(fj, ft, fisheye=False):
    """tests/test_torch_stereo.py's rule: >= 95 % of the JAX package's
    valid keypoints kept, the same depth (fisheye: finite on the same
    rows) on >= 90 % of them."""
    kj, kt = _keys(fj.xy, fj.valid), _keys(ft.xy, ft.valid)
    common = set(kj) & set(kt)
    assert len(kj) > 300, len(kj)
    assert len(common) >= 0.95 * len(kj), (len(common), len(kj))
    dj, dt = np.asarray(fj.depth), ft.depth.numpy()
    if fisheye:
        same = [np.isfinite(dj[kj[p]]) == np.isfinite(dt[kt[p]])
                for p in common]
    else:
        same = [np.isclose(dj[kj[p]], dt[kt[p]], rtol=1e-5) or
                (np.isinf(dj[kj[p]]) and np.isinf(dt[kt[p]]))
                for p in common]
    assert np.mean(same) >= 0.9, np.mean(same)
    assert np.isfinite(dt).sum() > 20


def test_build_frame_stereo_kitti_1241(written):
    """Frame 0 of kitti_1241 (1241 px: not a multiple of SuperPoint's 8-px
    cell) at N 2000 through both packages' build_frame_stereo with the
    shipped LightGlue, as the runner's System calls it."""
    import jax.numpy as jnp
    from dani_slam_tpu.core import cameras as jcam
    from dani_slam_tpu.models import lightglue as jlg
    from dani_slam_tpu.models import superpoint as jsp
    from dani_slam_tpu.slam import frame as jfr
    from dani_slam_tpu_torch.core import config
    from dani_slam_tpu_torch.models import lightglue as tlg
    from dani_slam_tpu_torch.models import superpoint as tsp
    from dani_slam_tpu_torch.slam import frame as tfr
    d, seq = written["kitti_1241"]
    s = config.Settings.from_yaml(seq["settings"])
    left, right = _pair(d, cs.STEREO_SEQUENCES["kitti_1241"], 0)
    W, H = s.width, s.height
    jc = jcam.Camera.pinhole(s.fx, s.fy, s.cx, s.cy, W, H)
    fj = jfr.build_frame_stereo(
        jsp.load_default_params(), jnp.asarray(left), jnp.asarray(right), jc,
        s.baseline, 0.0, n_max=s.n_features,
        matcher=jlg.load_default_matcher(W, H))
    ft = tfr.build_frame_stereo(
        tsp.load_default_params("cpu"), torch.as_tensor(left),
        torch.as_tensor(right), s.camera("cpu"), s.baseline, 0.0,
        n_max=s.n_features,
        matcher=tlg.load_default_matcher(W, H, device="cpu"))
    assert ft.xy.shape == (2000, 2)
    _hold_frames(fj, ft)


def test_euroc_rectifier(written):
    """The EuRoC settings' rectifier in both packages: grids, rectified
    camera and baseline, and frame 0's pair rectified (uint8 in)."""
    import jax.numpy as jnp
    from dani_slam_tpu.core import config as jconfig
    from dani_slam_tpu_torch.core import config
    d, seq = written["euroc_752"]
    rj = jconfig.Settings.from_yaml(seq["settings"]).stereo_rectifier()
    rt = config.Settings.from_yaml(seq["settings"]).stereo_rectifier("cpu")
    np.testing.assert_allclose(rt.map_l.numpy(), np.asarray(rj.map_l),
                               atol=2e-3)
    np.testing.assert_allclose(rt.map_r.numpy(), np.asarray(rj.map_r),
                               atol=2e-3)
    np.testing.assert_array_equal(rt.cam.params.numpy(),
                                  np.asarray(rj.cam.params))
    assert rt.baseline == rj.baseline
    left, right = _pair(d, cs.STEREO_SEQUENCES["euroc_752"], 0)
    out_j = rj(jnp.asarray(left), jnp.asarray(right))
    out_t = rt(torch.as_tensor(left), torch.as_tensor(right))
    for a, b in zip(out_t, out_j):
        assert a.shape == b.shape == (480, 752)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=0.05)


def test_build_frame_stereo_fisheye_tumvi_512(written):
    """Frame 0 of tumvi_512 through both packages' fisheye frame, with the
    runner's R_rl, t_rl and lapping areas."""
    import jax.numpy as jnp
    from dani_slam_tpu.core import config as jconfig
    from dani_slam_tpu.models import superpoint as jsp
    from dani_slam_tpu.slam import frame as jfr
    from dani_slam_tpu_torch.core import config
    from dani_slam_tpu_torch.models import superpoint as tsp
    from dani_slam_tpu_torch.slam import frame as tfr
    d, seq = written["tumvi_512"]
    js = jconfig.Settings.from_yaml(seq["settings"])
    s = config.Settings.from_yaml(seq["settings"])
    T12 = np.asarray(s.stereo_t_c1_c2, np.float64).reshape(4, 4)
    R_rl = T12[:3, :3].T.astype(np.float32)
    t_rl = (-T12[:3, :3].T @ T12[:3, 3]).astype(np.float32)
    left, right = _pair(d, cs.STEREO_SEQUENCES["tumvi_512"], 0)
    fj = jfr.build_frame_stereo_fisheye(
        jsp.load_default_params(), jnp.asarray(left), jnp.asarray(right),
        js.camera(), js.camera2(), jnp.asarray(R_rl), jnp.asarray(t_rl), 0.0,
        lapping_l=js.lapping1, lapping_r=js.lapping2, n_max=js.n_features)
    ft = tfr.build_frame_stereo_fisheye(
        tsp.load_default_params("cpu"), torch.as_tensor(left),
        torch.as_tensor(right), s.camera("cpu"), s.camera2("cpu"),
        torch.as_tensor(R_rl), torch.as_tensor(t_rl), 0.0,
        lapping_l=s.lapping1, lapping_r=s.lapping2, n_max=s.n_features)
    _hold_frames(fj, ft, fisheye=True)


# ---------------------------------------------------------------------------
# the command line: the JAX package's runs (STEREO_RUNNER_TARGETS)
# ---------------------------------------------------------------------------

def repair_jax():
    """The port's SO(3) repair (slam/mapping.keyframe_step,
    slam/tracking.apply_chain_correction) applied to the JAX package at run
    time, from outside it: the chain correction, the re-anchored tracker
    poses and every corrected pending pose projected onto SO(3) with the
    JAX package's own lie.orthonormalize. Without it a keyframe's pose,
    a pending frame's that earlier corrections moved, leaves SO(3) about
    threefold a keyframe (ROADMAP section 3). Returns a function that
    undoes the patch."""
    import jax
    from dani_slam_tpu.core import lie
    from dani_slam_tpu.slam import mapping, tracking
    kf_step, fix = mapping.keyframe_step, tracking.apply_chain_correction

    @jax.jit
    def apply_chain_correction(R, t, corr_R, corr_t):
        R2, t2 = lie.se3_mul(R, t, corr_R, corr_t)
        return lie.orthonormalize(R2), t2

    @jax.jit
    def rechain(R_cur, t_cur, R_last, t_last, cR, ct):
        cR = lie.orthonormalize(cR)
        R_c, t_c = lie.se3_mul(R_cur, t_cur, cR, ct)
        R_l, t_l = lie.se3_mul(R_last, t_last, cR, ct)
        return (lie.orthonormalize(R_c), t_c, lie.orthonormalize(R_l), t_l,
                cR, ct)

    def keyframe_step(*a, chain=None, **k):
        st, kf, n, out = kf_step(*a, chain=chain, **k)
        if chain is not None:
            out = rechain(*chain, *out[4:])
        return st, kf, n, out

    mapping.keyframe_step = keyframe_step
    tracking.apply_chain_correction = apply_chain_correction

    def undo():
        mapping.keyframe_step = kf_step
        tracking.apply_chain_correction = fix
    return undo


def run_runner(pkg, name, n, seed, root):
    """One run of `name`'s runner (the JAX package's script, or the port's
    with --device cpu) in this process on the first n frames, moved by
    `seed`; the spy's numbers. `pkg`: port, jax (the JAX package as it
    is) or jax-repaired (with repair_jax)."""
    import runpy
    from test_torch_examples_cli import perturb_images
    spec = cs.STEREO_SEQUENCES[name]
    d = os.path.join(root, f"{name}_{seed}")
    seq = cs.write_stereo_sequences({name: (d, n)}, procs=4)[name]
    if seed:
        perturb_images(d, seed)
    argv = [seq["settings"], d, "--out-prefix", os.path.join(d, "out_")]
    if pkg == "port":
        from dani_slam_tpu_torch.slam import frame, system
    else:
        from dani_slam_tpu.slam import frame, system
    undo = repair_jax() if pkg == "jax-repaired" else None
    try:
        with cs.RunnerSpy(system.System, frame) as spy:
            if pkg == "port":
                import importlib
                importlib.import_module(
                    f"dani_slam_tpu_torch.examples.{spec['runner']}").main(
                        argv + ["--device", "cpu"])
            else:
                sys.argv = [spec["runner"]] + argv
                runpy.run_path(f"{REPO}/examples/{spec['runner']}.py",
                               run_name="__main__")
    finally:
        if undo is not None:
            undo()
    return spy.summary(seq)


def runner_targets(pkg, name, n, seeds):
    import json
    import tempfile
    root = tempfile.mkdtemp()
    runs = []
    for seed in seeds:
        r = run_runner(pkg, name, n, seed, root)
        r["seed"] = seed
        runs.append(r)
        print(json.dumps(r), flush=True)
    keys = ("tracked", "poses", "kf", "lm", "ate", "init", "features")
    print(pkg, name, n, "ranges", {k: (min(r[k] for r in runs),
                                       max(r[k] for r in runs))
                                   for k in keys
                                   if all(r[k] is not None for r in runs)},
          flush=True)


def rotation_drift(pkg, name, n, root=None):
    """The runner of `pkg` (jax, jax-repaired or port) on the first n
    frames, printing after every frame how far the tracker's rotation and
    the keyframes' are from SO(3), |R R^T - I| (Frobenius). In the JAX
    package as it is, it grows about threefold a keyframe once keyframes
    come faster than the pipeline resolves them (ROADMAP section 3); with
    the repair it stays at float32 rounding. Returns ([(frame, IMU
    initialized, tracker's, keyframes' largest)], the run's numbers)."""
    import tempfile
    if pkg == "port":
        from dani_slam_tpu_torch.slam import system
    else:
        from dani_slam_tpu.slam import system
    orig = system.System.track_features
    rows = []

    def off(R):
        R = np.asarray(R, np.float64)
        return float(np.linalg.norm(R @ R.T - np.eye(3)))

    def track_features(self, *a, **k):
        out = orig(self, *a, **k)
        tr = self.tracker
        kf = np.asarray(tr.st.kf_mask)
        rows.append((len(rows), tr.inertial.initialized, off(tr.R),
                     max(off(R) for R in np.asarray(tr.st.kf_R)[kf])))
        print(f"frame {rows[-1][0]}: IMU initialized {rows[-1][1]}, "
              f"tracker R {rows[-1][2]:.2e}, keyframes' R at most "
              f"{rows[-1][3]:.2e}, {int(kf.sum())} keyframes", flush=True)
        return out

    system.System.track_features = track_features
    try:
        run = run_runner(pkg, name, n, 0, root or tempfile.mkdtemp())
    finally:
        system.System.track_features = orig
    print(run, flush=True)
    return rows, run


@pytest.mark.slow
def test_tumvi_rotations_stay_on_so3(tmp_path):
    """The port's TUM-VI stereo-inertial runner on 28 frames of tumvi_512
    (the IMU initialized at frame 11): on every frame from the
    initialization on, the tracker's rotation and every keyframe's within
    1e-4 of SO(3), and the run ends. (Before the keyframe chain was kept
    on SO(3) the drift reached 1.5 by frame 27, and on the card an eigh of
    the then non-finite marginalized prior raised 15 frames after the
    initialization.)"""
    rows, run = rotation_drift("port", "tumvi_512", 28, str(tmp_path))
    after = [r for r in rows if r[1]]
    assert run["init"] is not None and len(after) == 28 - run["init"]
    assert len(after) >= 15, run
    assert max(max(r[2], r[3]) for r in after) <= 1e-4, after
    assert run["tracked"] >= 25 and np.isfinite(run["ate"]), run


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    runs = {"targets": "jax-repaired", "unrepaired": "jax", "port": "port"}
    if sys.argv[1] in runs:                  # targets NAME FRAMES SEEDS
        runner_targets(runs[sys.argv[1]], sys.argv[2], int(sys.argv[3]),
                       [int(x) for x in sys.argv[4:]])
    elif sys.argv[1] == "drift":    # drift jax|jax-repaired|port NAME FRAMES
        rotation_drift(sys.argv[2], sys.argv[3], int(sys.argv[4]))
