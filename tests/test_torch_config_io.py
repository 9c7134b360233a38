"""Settings, dataset IO, map checkpoints and persistence in the port
(core/config.py, utils/io.py, utils/native.py, utils/checkpoint.py,
utils/eval.associate, System.save_* / load_atlas) against the JAX package,
on the cases of tests/test_config_io.py. Where the output is text, the port's
file is byte-compared with the JAX package's; settings, loaders and maps
must be equal, cameras and rectification maps within 1e-6 (2e-4 px for the
maps, two f32 roundings of ~600 px coordinates).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dani_slam_tpu.core import config as jcfg
from dani_slam_tpu.core import lie as jlie
from dani_slam_tpu.core import state as jst
from dani_slam_tpu.utils import checkpoint as jck
from dani_slam_tpu.utils import eval as jev
from dani_slam_tpu.utils import io as jio
from dani_slam_tpu_torch.core import config as tcfg
from dani_slam_tpu_torch.core import state as tst
from dani_slam_tpu_torch.utils import checkpoint as tck
from dani_slam_tpu_torch.utils import eval as tev
from dani_slam_tpu_torch.utils import io as tio
from dani_slam_tpu_torch.utils import native as tnative

torch.set_num_threads(2)       # several test workers share the machine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TUM3_YAML = """\
%YAML:1.0
# TUM3-style settings (structure of Examples/RGB-D/TUM3.yaml)
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 535.4
Camera1.fy: 539.2
Camera1.cx: 320.1
Camera1.cy: 247.6
Camera1.k1: 0.0
Camera1.k2: 0.0
Camera.width: 640
Camera.height: 480
Camera.fps: 30
RGBD.DepthMapFactor: 5000.0
ORBextractor.nFeatures: 2000
ORBextractor.iniThFAST: 0.015
ORBextractor.minThFAST: 0.007
ORBextractor.nLevels: 1
ORBextractor.scaleFactor: 1.2
System.SaveAtlasToFile: "atlas_out"
Models.LightGlue: "weights/lightglue.pt"
"""

# a calibrated pinhole stereo rig that is not rectified: the rectifier is
# built from Stereo.T_c1_c2 (the second camera 0.11 m to the right, turned
# by ~1 degree), with an IMU section and its Tbc matrix
STEREO_YAML = """\
%YAML:1.0
Camera.type: "PinHole"
Camera1.fx: 458.6
Camera1.fy: 457.3
Camera1.cx: 367.2
Camera1.cy: 248.4
Camera2.fx: 457.6
Camera2.fy: 456.1
Camera2.cx: 379.9
Camera2.cy: 255.2
Camera.width: 752
Camera.height: 480
Stereo.T_c1_c2: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.99985, -0.01745, 0.0, 0.11,
          0.01745, 0.99985, 0.0, 0.0,
          0.0, 0.0, 1.0, 0.0,
          0.0, 0.0, 0.0, 1.0]
Stereo.ThDepth: 60.0
Camera.bf: 47.90639384423901
IMU.NoiseGyro: 0.00016
IMU.NoiseAcc: 0.0028
IMU.GyroWalk: 0.000022
IMU.AccWalk: 0.00086
IMU.Frequency: 200.0
IMU.T_b_c1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
          0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
          -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
          0.0, 0.0, 0.0, 1.0]
"""

KB8_YAML = """\
%YAML:1.0
Camera1.type: "KannalaBrandt8"
Camera1.fx: 190.97
Camera1.fy: 190.97
Camera1.cx: 254.93
Camera1.cy: 256.90
Camera1.k0: 0.0034
Camera1.k1: 0.0008
Camera1.k2: -0.0012
Camera1.k3: 0.0002
Camera1.overlappingBegin: 0
Camera1.overlappingEnd: 511
Camera.width: 512
Camera.height: 512
"""


# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [TUM3_YAML, STEREO_YAML, KB8_YAML,
                                  "Camera1.fx: 500.0\nCamera.bf: 50.0\n", ""],
                         ids=["tum3", "stereo-imu", "kb8", "bf", "empty"])
def test_settings_equal_to_jax(text):
    """parse_opencv_yaml and every Settings field equal the JAX
    package's, its printout byte for byte, and the camera built from it."""
    assert tcfg.parse_opencv_yaml(text) == jcfg.parse_opencv_yaml(text)
    s, j = tcfg.Settings.from_yaml(text), jcfg.Settings.from_yaml(text)
    assert dataclasses.asdict(s) == dataclasses.asdict(j)
    assert str(s) == str(j)
    cam, jc = s.camera("cpu"), j.camera()
    assert (cam.width, cam.height, cam.kind) == (jc.width, jc.height,
                                                 int(jc.kind))
    np.testing.assert_allclose(cam.params.numpy(), np.asarray(jc.params),
                               rtol=1e-7)
    np.testing.assert_allclose(cam.dist.numpy(), np.asarray(jc.dist))


def test_parse_tum_style():
    s = tcfg.Settings.from_yaml(TUM3_YAML)
    assert s.fx == 535.4 and s.cy == 247.6 and s.n_features == 2000
    assert s.ini_th == 0.015 and s.min_th == 0.007
    assert s.depth_map_factor == 5000.0 and s.camera("cpu").width == 640
    assert s.save_atlas == "atlas_out"
    assert s.lightglue_weights == "weights/lightglue.pt"
    assert abs(tcfg.Settings.from_yaml("Camera1.fx: 500.0\nCamera.bf: "
                                       "50.0\n").baseline - 0.1) < 1e-9
    assert tcfg.Settings.from_yaml("").n_features == 1024


def test_settings_from_file(tmp_path):
    p = tmp_path / "settings.yaml"
    p.write_text(STEREO_YAML)
    s = tcfg.Settings.from_yaml(str(p))
    assert s.width == 752 and s.stereo_t_c1_c2[3] == 0.11
    assert dataclasses.asdict(s) == \
        dataclasses.asdict(jcfg.Settings.from_yaml(str(p)))


def test_stereo_rectifier_and_imu_calib_match_jax():
    """The rectifier built from Camera2 + Stereo.T_c1_c2, and the IMU
    calibration (plain data here, ops/imu.ImuCalib there)."""
    s, j = tcfg.Settings.from_yaml(STEREO_YAML), \
        jcfg.Settings.from_yaml(STEREO_YAML)
    rt, rj = s.stereo_rectifier("cpu"), j.stereo_rectifier()
    assert abs(rt.baseline - float(rj.baseline)) < 1e-6
    np.testing.assert_allclose(rt.cam.params.numpy(),
                               np.asarray(rj.cam.params), rtol=1e-6)
    np.testing.assert_allclose(rt.map_l.numpy(), np.asarray(rj.map_l),
                               atol=2e-4)
    np.testing.assert_allclose(rt.map_r.numpy(), np.asarray(rj.map_r),
                               atol=2e-4)
    assert tcfg.Settings.from_yaml(TUM3_YAML).stereo_rectifier("cpu") is None
    ic, jc = s.imu_calib(), j.imu_calib()
    for name, want in (("noise_gyro", jc.noise_gyro),
                       ("noise_acc", jc.noise_acc),
                       ("walk_gyro", jc.walk_gyro), ("walk_acc", jc.walk_acc),
                       ("R_bc", jc.R_bc), ("t_bc", jc.t_bc)):
        np.testing.assert_allclose(getattr(ic, name), np.asarray(want),
                                   rtol=1e-7)
    assert ic.frequency == 200.0
    np.testing.assert_array_equal(
        tcfg.Settings.from_yaml(TUM3_YAML).imu_calib().R_bc, np.eye(3))


# ---------------------------------------------------------------------------
# Trajectory writers and dataset loaders
# ---------------------------------------------------------------------------

def _traj(n=5):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        R, t = jlie.se3_exp(jnp.asarray(rng.randn(6) * 0.2, jnp.float32))
        out.append((float(np.float32(i / 30.0)), np.asarray(R),
                    np.asarray(t)))
    return out


@pytest.mark.parametrize("fmt", ["tum", "tum-epoch", "euroc", "kitti"])
def test_trajectory_writers_byte_equal(tmp_path, fmt):
    traj = _traj()
    t0 = 1305031102.175 if fmt == "tum-epoch" else 0.0
    pt, pj = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    if fmt.startswith("tum"):
        tio.save_trajectory_tum(pt, traj, time_offset=t0)
        jio.save_trajectory_tum(pj, traj, time_offset=t0)
    elif fmt == "euroc":
        tio.save_trajectory_euroc(pt, traj, time_offset=t0)
        jio.save_trajectory_euroc(pj, traj, time_offset=t0)
    else:
        tio.save_trajectory_kitti(pt, traj)
        jio.save_trajectory_kitti(pj, traj)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    rows = np.loadtxt(pt, delimiter="," if fmt == "euroc" else None)
    assert rows.shape == (5, {"kitti": 12}.get(fmt, 8))
    if fmt.startswith("tum"):
        C0 = -traj[0][1].T @ traj[0][2]
        np.testing.assert_allclose(rows[0, 1:4], C0, atol=1e-5)
        assert len(np.unique(rows[:, 0])) == 5, "timestamps collapsed"
        np.testing.assert_allclose(rows[:, 0], t0 + np.asarray(
            [tm for tm, _, _ in traj]), atol=1e-3)


def test_associate_timestamps_and_eval_associate():
    ta = np.asarray([0.0, 0.1, 0.2])
    tb = np.asarray([0.001, 0.105, 0.5])
    assert tio.associate_timestamps(ta, tb) == \
        jio.associate_timestamps(ta, tb) == [(0, 0), (1, 1)]
    rng = np.random.RandomState(1)
    t_est = np.sort(rng.uniform(0, 5, 80))
    t_gt = np.sort(rng.uniform(0, 5, 120))
    for a, b in zip(tev.associate(t_est, t_gt, 0.02),
                    jev.associate(t_est, t_gt, 0.02)):
        np.testing.assert_array_equal(a, b)


def _write_pnm(path, img):
    maxv = 65535 if img.dtype == np.uint16 else 255
    magic = b"P6" if img.ndim == 3 else b"P5"
    with open(path, "wb") as f:
        f.write(magic + f"\n{img.shape[1]} {img.shape[0]}\n{maxv}\n".encode())
        f.write(img.astype(">u2" if maxv > 255 else "u1").tobytes())


def test_dataset_loaders_equal_to_jax(tmp_path):
    """TUM lists and associations, KITTI stereo lists, EuRoC camera and IMU
    csv files, and load_image on PGM (8 and 16 bit) and PPM."""
    (tmp_path / "rgb.txt").write_text("# ts path\n0.0333 rgb/0.png\n"
                                      "0.0667 rgb/1.png\n")
    (tmp_path / "assoc.txt").write_text("0.0333 rgb/0.png 0.034 d/0.png\n"
                                        "# c\n0.0667 rgb/1.png 0.066 d/1.png\n")
    (tmp_path / "times.txt").write_text("0.0\n0.1\n\n0.2\n")
    for cam in ("cam0", "imu0"):
        os.makedirs(tmp_path / "mav0" / cam)
    (tmp_path / "mav0" / "cam0" / "data.csv").write_text(
        "#t,fn\n1403636579763555584,1403636579763555584.png\n"
        "1403636579813555456,1403636579813555456.png\n")
    (tmp_path / "mav0" / "imu0" / "data.csv").write_text(
        "#t,w,a\n1403636579758555392,-0.099,0.14,0.02,8.1,-0.3,-3.4\n"
        "1403636579763555584,-0.098,0.13,0.02,8.2,-0.4,-3.5\n")
    d = str(tmp_path)
    assert tio.load_tum_rgb_list(d) == jio.load_tum_rgb_list(d)
    assert tio.load_tum_associations(d + "/assoc.txt") == \
        jio.load_tum_associations(d + "/assoc.txt")
    assert tio.load_kitti_stereo_list(d) == jio.load_kitti_stereo_list(d)
    assert tio.load_euroc_cam_list(d) == jio.load_euroc_cam_list(d)
    for a, b in zip(tio.load_euroc_imu(d), jio.load_euroc_imu(d)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(3)
    for name, img in (("g8.pgm", rng.randint(0, 256, (20, 30), np.uint8)),
                      ("g16.pgm", rng.randint(0, 65536, (20, 30),
                                              np.uint16)),
                      ("c.ppm", rng.randint(0, 256, (20, 30, 3), np.uint8))):
        p = str(tmp_path / name)
        _write_pnm(p, img)
        out = tio.load_image(p)
        assert out.dtype == img.dtype
        np.testing.assert_array_equal(out, img)
        np.testing.assert_array_equal(out, jio.load_image(p))
        with open(p, "rb") as f:
            np.testing.assert_array_equal(tio._load_pnm(f), img)


# ---------------------------------------------------------------------------
# The native loader: its own build directory, safe for concurrent builds
# ---------------------------------------------------------------------------

CHILD = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, sys.argv[1])
    build_dir, go = sys.argv[2], sys.argv[3]
    while not os.path.exists(go):
        time.sleep(0.005)
    from dani_slam_tpu_torch.utils import native
    lib = native.get_lib(build_dir)
    print("lib" if lib is not None else "none")
""")


def test_native_build_six_processes_all_get_a_library(tmp_path):
    """Six processes ask for the library on an empty build directory at
    once: one builds it under the file lock, the others wait and load the
    finished file; all six get a library, and no temporary file is left."""
    build_dir, go = str(tmp_path / "native"), str(tmp_path / "go")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, ROOT, build_dir,
                               go], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    with open(go, "w"):
        pass
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["lib"] * 6
    assert sorted(os.listdir(build_dir)) == ["libdataset_loader.lock",
                                            tnative.LIB_NAME]


def test_native_decode_and_prefetch(tmp_path):
    """The port's binding decodes PNM exactly and its prefetcher returns
    the frames in order."""
    lib = tnative.get_lib(str(tmp_path / "native"))
    assert lib is not None and tnative.get_lib(str(tmp_path / "native")) \
        is lib
    rng = np.random.RandomState(4)
    paths = []
    for i in range(5):
        img = rng.randint(0, 65536, (12, 17), np.uint16) if i % 2 else \
            rng.randint(0, 256, (12, 17, 3), np.uint8)
        p = str(tmp_path / f"{i}.pnm")
        _write_pnm(p, img)
        paths.append((p, img))
        np.testing.assert_array_equal(tnative.load_image_native(p), img)
    with tnative.ImagePrefetcher([p for p, _ in paths]) as pf:
        for i, (_, img) in enumerate(paths):
            np.testing.assert_array_equal(pf.get(i), img)
    assert tnative.BUILD_DIR.endswith(os.path.join("build", "native"))


# ---------------------------------------------------------------------------
# Map checkpoints
# ---------------------------------------------------------------------------

def _small_maps():
    """The same one-keyframe map in both packages."""
    caps = (8, 64, 16, 8)
    args = (np.eye(3, dtype=np.float32), np.ones(3, np.float32), 1.5, 7,
            np.zeros((16, 2), np.float32), np.ones(16, bool),
            np.zeros((16, 8), np.float32), np.full(16, np.inf, np.float32),
            np.zeros(16, np.int8), np.full(16, -1, np.int32))
    js, _ = jst.insert_keyframe(jst.empty_map(jst.MapCaps(*caps)),
                                *(jnp.asarray(a) for a in args))
    ts, _ = tst.insert_keyframe(tst.empty_map(tst.MapCaps(*caps), "cpu"),
                                *(torch.as_tensor(a) for a in args))
    return js, ts


def test_checkpoint_roundtrip_and_cross_package(tmp_path):
    """save_map / load_map round trip, and a map written by either package
    read by the other, field for field."""
    js, ts = _small_maps()
    cb = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (32, 8)))
    bow = np.random.RandomState(0).rand(8, 32).astype(np.float32)
    pt, pj = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tck.save_map(pt, ts, codebook=torch.as_tensor(cb),
                 bow=torch.as_tensor(bow), extra={"frames": np.arange(3)})
    jck.save_map(pj, js, codebook=jnp.asarray(cb), bow=jnp.asarray(bow))
    st2, extras = tck.load_map(pt, expect_codebook=torch.as_tensor(cb),
                               device="cpu")
    assert st2.caps == ts.caps and bool(st2.kf_mask[0])
    np.testing.assert_allclose(st2.kf_t[0].numpy(), 1.0)
    np.testing.assert_array_equal(extras["codebook"].numpy(), cb)
    np.testing.assert_array_equal(extras["bow"].numpy(), bow)
    np.testing.assert_array_equal(extras["frames"], np.arange(3))
    assert tck.codebook_checksum(torch.as_tensor(cb)) == \
        jck.codebook_checksum(jnp.asarray(cb))
    from_jax, _ = tck.load_map(pj, expect_codebook=cb, device="cpu")
    to_jax, _ = jck.load_map(pt, expect_codebook=jnp.asarray(cb))
    for name in tst.TENSOR_FIELDS:
        want = np.asarray(getattr(js, name))
        np.testing.assert_array_equal(getattr(from_jax, name).numpy(), want)
        np.testing.assert_array_equal(np.asarray(getattr(to_jax, name)),
                                      want)


def test_checkpoint_checksum_mismatch_rejected(tmp_path):
    _, ts = _small_maps()
    cb = torch.randn(32, 8, generator=torch.Generator().manual_seed(0))
    p = str(tmp_path / "map.npz")
    tck.save_map(p, ts, codebook=cb)
    with pytest.raises(ValueError, match="checksum"):
        tck.load_map(p, expect_codebook=cb + 1.0, device="cpu")


def test_checkpoint_without_obs_bits_rebuilt(tmp_path):
    """A checkpoint written before the observation bitmask existed: the
    bits are rebuilt from the observation table."""
    _, ts = _small_maps()
    ts.obs_lm[0, :3] = torch.tensor([5, 9, 40], dtype=torch.int32)
    ts = tst.rebuild_obs_bits(ts)
    p = str(tmp_path / "old.npz")
    tck.save_map(p, ts)
    with np.load(p) as data:
        old = {k: data[k] for k in data.files if k != "lm_obs_bits"}
    np.savez_compressed(p, **old)
    st2, _ = tck.load_map(p, device="cpu")
    assert torch.equal(st2.lm_obs_bits, ts.lm_obs_bits)
    assert int((st2.lm_obs_bits != 0).sum()) == 3


# ---------------------------------------------------------------------------
# System persistence
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mapped_system():
    """A small RGB-D map built from 12 rendered feature frames (the world
    and orbit of tests/test_config_io.py's persistence case)."""
    from dani_slam_tpu_torch.core import cameras
    from dani_slam_tpu_torch.slam.system import Sensor, System
    from dani_slam_tpu_torch.utils import synthetic
    cam = cameras.Camera.pinhole(500., 500., 320., 240., 640, 480,
                                 device="cpu")
    caps = tst.MapCaps(K=32, L=4096, N=256, D=64)
    world = synthetic.make_world(1200, desc_dim=64, seed=11)
    R_gt, t_gt = synthetic.orbit_trajectory(12, radius=10., angle_span=0.25)

    def frame(i, seed, time):
        return synthetic.render_frame(world, cam, R_gt[i], t_gt[i],
                                      n_max=256, noise_px=0.3, seed=seed,
                                      with_depth=True, time=time)[0]

    def make():
        return System(cam, Sensor.RGBD, caps=caps, n_features=256, seed=3,
                      device="cpu")

    sys1 = make()
    for i in range(12):
        sys1.track_features(frame(i, i, i / 30.0), timestamp=i / 30.0)
    return sys1, make, frame, (R_gt, t_gt)


def test_save_load_atlas_and_relocalize(mapped_system, tmp_path):
    """Save the map, load it into a fresh System, and a frame from a mapped
    viewpoint relocalizes against it (reference: the localization-from-a-
    saved-Atlas workflow, System.cc:162)."""
    sys1, make, frame, (R_gt, t_gt) = mapped_system
    p = str(tmp_path / "atlas.npz")
    sys1.save_atlas(p)
    sys2 = make()
    sys2.load_atlas(p)
    assert sys2.n_keyframes() == sys1.n_keyframes() >= 2
    assert sys2.n_landmarks() == sys1.n_landmarks()
    assert torch.equal(sys2.loop_closer.bow, sys1.loop_closer.bow)
    assert sys2.tracker.state == "RECENTLY_LOST"
    s, R, t = sys2.track_features(frame(5, 99, 1.0), timestamp=1.0)
    assert s == "OK"
    # the map's frame is frame 0's camera
    C = -np.asarray(R).T @ np.asarray(t)
    C_gt = R_gt[0] @ (-R_gt[5].T @ t_gt[5]) + t_gt[0]
    assert np.linalg.norm(C - C_gt) < 0.05
    # a map of other capacities, or another codebook, is refused
    other = make()
    other.loop_closer.codebook = other.loop_closer.codebook + 1.0
    with pytest.raises(ValueError, match="checksum"):
        other.load_atlas(p)


def test_keyframe_trajectory_save(mapped_system, tmp_path):
    """Keyframe poses in time order, one TUM row per keyframe, byte-equal to
    the JAX package's writer on the same poses."""
    sys1 = mapped_system[0]
    p = str(tmp_path / "kf.txt")
    sys1.save_keyframe_trajectory_tum(p)
    rows = np.loadtxt(p)
    assert rows.shape == (sys1.n_keyframes(), 8)
    assert np.all(np.diff(rows[:, 0]) > 0)
    st = sys1.map_state
    ids = np.nonzero(st.kf_mask.numpy())[0]
    order = ids[np.argsort(st.kf_time.numpy()[ids])]
    pj = str(tmp_path / "kf_jax.txt")
    jio.save_trajectory_tum(pj, [(float(st.kf_time[k]), st.kf_R[k].numpy(),
                                  st.kf_t[k].numpy()) for k in order])
    with open(p, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    p2 = str(tmp_path / "traj.txt")
    sys1.save_trajectory_tum(p2)
    assert np.loadtxt(p2).shape == (len(sys1.tracker.trajectory), 8)
