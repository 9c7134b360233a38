"""The port stands alone: every module of dani_slam_tpu_torch (and
chip_smoke.py) imports with `jax` and `dani_slam_tpu` blocked, and its entry
points (System for the monocular, stereo and RGB-D sensors and for the
inertial IMU_STEREO and IMU_RGBD, with loop closing and relocalization on
by default, the vocabulary, the LoopCloser, the KB8 camera, the
official-scale nets and their checkpoint loaders, the settings' cameras,
map loading, and the dataset runners) default to CUDA and raise on a host
without it instead of running on the CPU; IMU_MONOCULAR raises
NotImplementedError naming ROADMAP's inertial part 2, while IMU_STEREO and
IMU_RGBD build on the CPU when asked to. The official nets and the runners
also run there with `jax` blocked: one forward of each net on the CPU, and
the runners' --help.

This runs in a subprocess because tests/conftest.py imports JAX into the
test process itself.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "dani_slam_tpu_torch"

CHILD = r"""
import importlib, json, sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["dani_slam_tpu"] = None
sys.path.insert(0, sys.argv[1])
mods = json.loads(sys.argv[2])
for m in mods:
    importlib.import_module(m)
import torch
from dani_slam_tpu_torch.core import cameras, state
from dani_slam_tpu_torch.models import lightglue, superpoint, vocab, yolo
from dani_slam_tpu_torch.models import lightglue_official, yolo_official
from dani_slam_tpu_torch.core import config
from dani_slam_tpu_torch.examples import (evaluate_ate, mono_tum, rgbd_tum,
                                          stereo_kitti)
from dani_slam_tpu_torch.slam import loopclosing
from dani_slam_tpu_torch.slam.system import Sensor, System
from dani_slam_tpu_torch.utils import checkpoint
cam = cameras.Camera.pinhole(300.0, 300.0, 160.0, 120.0, 320, 240,
                             device="cpu")
default_raises = {}
for name, fn in (("System", lambda: System(cam)),
                 ("System(MONOCULAR, n_levels=8)",
                  lambda: System(cam, Sensor.MONOCULAR, n_levels=8,
                                 pipelined=True)),
                 ("System(STEREO)",
                  lambda: System(cam, Sensor.STEREO, pipelined=True)),
                 ("System(IMU_RGBD)",
                  lambda: System(cam, Sensor.IMU_RGBD, pipelined=True)),
                 ("System(IMU_STEREO)",
                  lambda: System(cam, Sensor.IMU_STEREO, pipelined=True)),
                 ("Camera.pinhole",
                  lambda: cameras.Camera.pinhole(1, 1, 1, 1, 2, 2)),
                 ("Camera.kb8",
                  lambda: cameras.Camera.kb8(1, 1, 1, 1, 0, 0, 0, 0, 2, 2)),
                 ("empty_map", lambda: state.empty_map()),
                 ("superpoint.load_default_params",
                  lambda: superpoint.load_default_params()),
                 ("yolo.load_default_detector",
                  lambda: yolo.load_default_detector()),
                 ("lightglue.load_default_matcher",
                  lambda: lightglue.load_default_matcher()),
                 ("System(matcher='auto', pipelined=True)",
                  lambda: System(cam, matcher="auto", pipelined=True)),
                 ("vocab.load_default_codebook",
                  lambda: vocab.load_default_codebook()),
                 ("LoopCloser",
                  lambda: loopclosing.LoopCloser(
                      cameras.Camera.pinhole(1, 1, 1, 1, 2, 2),
                      state.MapCaps())),
                 ("lightglue_official.load_official_matcher",
                  lambda: lightglue_official.load_official_matcher()),
                 ("yolo_official.load_official_detector",
                  lambda: yolo_official.load_official_detector()),
                 ("lightglue_official.load_lightglue_pt",
                  lambda: lightglue_official.load_lightglue_pt("x.pt")),
                 ("yolo_official.load_yolov5_pt",
                  lambda: yolo_official.load_yolov5_pt("x.pt")),
                 ("superpoint.load_magicleap_pt",
                  lambda: superpoint.load_magicleap_pt("x.pth")),
                 ("Settings.camera",
                  lambda: config.Settings.from_yaml("").camera()),
                 ("checkpoint.load_map",
                  lambda: checkpoint.load_map("x.npz")),
                 ("rgbd_tum.main",
                  lambda: rgbd_tum.main(["s.yaml", "seq", "assoc.txt"])),
                 ("mono_tum.main", lambda: mono_tum.main(["s.yaml", "seq"])),
                 ("stereo_kitti.main",
                  lambda: stereo_kitti.main(["s.yaml", "seq"]))):
    try:
        fn()
        default_raises[name] = False
    except RuntimeError as e:
        default_raises[name] = "cuda" in str(e).lower()
imu_raises = {}
for sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO, Sensor.IMU_RGBD):
    try:
        System(cam, sensor, device="cpu")
        imu_raises[sensor.name] = False
    except NotImplementedError as e:
        imu_raises[sensor.name] = "part 2" in str(e)
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                       "dani_slam_tpu")
                and sys.modules[k] is not None)
# the official nets run with jax blocked (CPU, tiny inputs)
lg = lightglue_official.load_official_matcher(device="cpu")
xy = torch.zeros(1, 8, 2)
d = torch.nn.functional.normalize(torch.randn(1, 8, 256), dim=-1)
m = torch.ones(1, 8, dtype=torch.bool)
ran = {"lightglue_official": tuple(lightglue.match_pairs(
    lg.model, xy, d, m, xy, d, m, 640, 480)[0].shape) == (1, 8)}
det = yolo_official.load_official_detector(device="cpu")
ran["yolo_official"] = len(det.model(torch.zeros(64, 64, 3))) == 3
import contextlib, io
helps = {}
for mod in (rgbd_tum, mono_tum, stereo_kitti, evaluate_ate):
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main(["--help"])
    except SystemExit as e:
        helps[mod.__name__] = e.code == 0 and "usage" in buf.getvalue()
import inspect
sig = inspect.signature(System).parameters
defaults_on = (sig["enable_loop_closing"].default is True and
               sig["enable_relocalization"].default is True)
print(json.dumps({"n": len(mods), "loaded": loaded, "defaults_on": defaults_on,
                  "cuda": torch.cuda.is_available(),
                  "default_raises": default_raises,
                  "imu_raises": imu_raises, "ran": ran, "helps": helps}))
"""


def _port_modules():
    mods = ["chip_smoke"]
    for dirpath, _, files in os.walk(os.path.join(ROOT, PKG)):
        rel = os.path.relpath(dirpath, ROOT).replace(os.sep, ".")
        for f in sorted(files):
            if f.endswith(".py"):
                mods.append(rel if f == "__init__.py" else
                            f"{rel}.{f[:-3]}")
    return sorted(mods)


def test_port_imports_without_jax_and_defaults_to_cuda():
    mods = _port_modules()
    assert len(mods) >= 35           # every module of the port
    for new in ("models.lightglue", "models.vocab", "slam.atlas",
                "slam.framegraph", "slam.loopclosing", "ops.pnp",
                "ops.sim3", "ops.posegraph", "ops.ba_large",
                "utils.checkpoint", "ops.twoview", "ops.rectify",
                "ops.stats", "models.lightglue_official",
                "models.yolo_official", "core.config", "utils.io",
                "utils.native", "utils.timing", "examples.rgbd_tum",
                "examples.mono_tum", "examples.stereo_kitti",
                "examples.evaluate_ate", "ops.imu", "ops.viba",
                "slam.inertial", "slam.inertial_mapping"):
        assert f"{PKG}.{new}" in mods
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", CHILD, ROOT,
                           json.dumps(mods)], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["n"] == len(mods)
    assert out["loaded"] == []
    assert out["defaults_on"]
    assert out["imu_raises"] == {"IMU_MONOCULAR": True,
                                 "IMU_STEREO": False,
                                 "IMU_RGBD": False}, out["imu_raises"]
    assert out["ran"] == {"lightglue_official": True, "yolo_official": True}
    assert len(out["helps"]) == 4 and all(out["helps"].values()), \
        out["helps"]
    if not out["cuda"]:        # with a card the default device is usable
        assert all(out["default_raises"].values()), out["default_raises"]
