"""Settings: typed configuration from ORB-SLAM3-style settings YAML
(counterpart of dani_slam_tpu/core/config.py; reference: src/Settings.cc,
the new format "File.version: 1.0" with sections Camera1/Camera2/ImageInfo/
IMU/RGBD/ORB, and the legacy flat keys of Tracking::ParseCamParamFile).
Model paths are explicit settings, where the reference hard-codes them.

The parser reads OpenCV-FileStorage-style YAML ("%YAML:1.0" directive,
"key.subkey: value" flat entries, !!opencv-matrix blocks) without external
dependencies. The camera, second camera and stereo rectifier are built on a
device (CUDA unless the caller names another); the IMU calibration is plain
data: inertial tracking is not part of the port yet.
"""
from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple, Optional

import numpy as np

from dani_slam_tpu_torch.core import cameras as _cam


class ImuCalib(NamedTuple):
    """IMU noise densities, random walks, rate and the body-from-camera
    extrinsics (reference: IMU::Calib, include/ImuTypes.h:92-127)."""
    noise_gyro: float
    noise_acc: float
    walk_gyro: float
    walk_acc: float
    frequency: float
    R_bc: np.ndarray          # [3,3] float32
    t_bc: np.ndarray          # [3] float32


def parse_opencv_yaml(path_or_text: str) -> dict:
    """Parse flat OpenCV FileStorage YAML into {dotted.key: value}."""
    if "\n" in path_or_text or ":" in path_or_text.split("\n")[0][:1]:
        text = path_or_text
    else:
        try:
            with open(path_or_text) as f:
                text = f.read()
        except (OSError, ValueError):
            text = path_or_text
    out = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].split("#")[0].rstrip()
        i += 1
        if not line or line.startswith("%") or line.startswith("---"):
            continue
        m = re.match(r"^\s*([A-Za-z0-9_.]+)\s*:\s*(.+)$", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip().strip('"')
        if val.startswith("!!opencv-matrix"):
            # multi-line matrix block: rows/cols/dt/data (data may span
            # lines until the closing bracket) — the reference reads these
            # via cv::FileStorage (e.g. IMU.T_b_c1, src/Settings.cc)
            buf = []
            while i < len(lines):
                nxt = lines[i].split("#")[0].rstrip()
                buf.append(nxt)
                i += 1
                if "]" in nxt:
                    break
                if re.match(r"^\s*[A-Za-z0-9_.]+\s*:", nxt) and \
                        not re.match(r"^\s*(rows|cols|dt|data)\s*:", nxt):
                    i -= 1
                    buf.pop()
                    break
            block = " ".join(buf)
            dm = re.search(r"data\s*:\s*\[([^\]]*)\]", block)
            if dm:
                out[key] = tuple(
                    float(x) for x in dm.group(1).replace(",", " ").split())
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


@dataclasses.dataclass
class Settings:
    """Typed settings (reference: Settings.h:127-155 readParameter with
    required/optional semantics)."""
    # camera
    camera_type: str = "PinHole"
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    k_equi: tuple = (0.0, 0.0, 0.0, 0.0)     # KannalaBrandt8
    fps: float = 30.0
    baseline: float = 0.0                    # stereo
    # second stereo camera + extrinsics (new-format Camera2.* +
    # Stereo.T_c1_c2; reference: Settings::readCamera2, src/Settings.cc)
    fx2: float = 0.0
    fy2: float = 0.0
    cx2: float = 0.0
    cy2: float = 0.0
    dist2: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    k_equi2: tuple = (0.0, 0.0, 0.0, 0.0)
    stereo_t_c1_c2: Optional[tuple] = None   # 16 row-major (c1-from-c2)
    # fisheye stereo lapping areas in pixels (reference:
    # Camera1.overlappingBegin/End, Settings::readCamera1 src/Settings.cc;
    # used by the stereo-fisheye Frame ctor, src/Frame.cc:968)
    lapping1: tuple = (0.0, 1e9)
    lapping2: tuple = (0.0, 1e9)
    depth_map_factor: float = 5000.0         # RGB-D (TUM3.yaml:35)
    th_depth: float = 40.0                   # far-point threshold
    # features (reference ORB section drives SPextractor thresholds,
    # Examples/RGB-D/TUM3.yaml:41-54)
    n_features: int = 1024
    ini_th: float = 0.015
    min_th: float = 0.007
    n_levels: int = 1
    scale_factor: float = 1.2
    # IMU (reference IMU section: noise/walk + Tbc + frequency)
    imu_noise_gyro: float = 1.7e-4
    imu_noise_acc: float = 2e-3
    imu_walk_gyro: float = 1.9e-5
    imu_walk_acc: float = 3e-3
    imu_frequency: float = 200.0
    imu_tbc: Optional[tuple] = None          # 16 row-major values (4x4 Tbc)
    # system
    load_atlas: Optional[str] = None
    save_atlas: Optional[str] = None
    # model weights (explicit, not hard-coded)
    superpoint_weights: Optional[str] = None
    lightglue_weights: Optional[str] = None
    yolo_weights: Optional[str] = None

    def __str__(self):
        """Readable multi-line summary (reference: Settings::operator<<
        prints camera/image/feature/IMU sections at startup,
        src/Settings.cc end + System.cc:87)."""
        L = ["SLAM settings:"]
        L.append(f"\t-Camera 1: fx={self.fx} fy={self.fy} "
                 f"cx={self.cx} cy={self.cy} type={self.camera_type}")
        if any(self.dist):
            L.append(f"\t-Distortion: {tuple(self.dist)}")
        if any(self.k_equi):
            L.append(f"\t-KannalaBrandt8 k: {tuple(self.k_equi)}")
        L.append(f"\t-Image size: {self.width}x{self.height} "
                 f"fps={self.fps}")
        if self.baseline:
            L.append(f"\t-Stereo baseline: {self.baseline}")
        L.append(f"\t-RGB-D: depth factor={self.depth_map_factor} "
                 f"ThDepth={self.th_depth}")
        L.append(f"\t-Features: {self.n_features} "
                 f"(thresholds {self.ini_th}/{self.min_th}, "
                 f"{self.n_levels} levels x{self.scale_factor})")
        if self.imu_tbc is not None:
            L.append(f"\t-IMU: freq={self.imu_frequency} "
                     f"noise g/a={self.imu_noise_gyro}/{self.imu_noise_acc} "
                     f"walk g/a={self.imu_walk_gyro}/{self.imu_walk_acc}, "
                     f"Tbc set")
        for name in ("load_atlas", "save_atlas", "superpoint_weights",
                     "lightglue_weights", "yolo_weights"):
            v = getattr(self, name)
            if v:
                L.append(f"\t-{name}: {v}")
        return "\n".join(L)

    @staticmethod
    def from_yaml(path_or_text: str) -> "Settings":
        d = parse_opencv_yaml(path_or_text)
        s = Settings()

        def g(*keys, default=None):
            for k in keys:
                if k in d:
                    return d[k]
            return default

        # new format (Camera1.*) falls back to legacy (Camera.*)
        s.camera_type = str(g("Camera.type", "Camera1.type",
                              default=s.camera_type))
        s.fx = float(g("Camera1.fx", "Camera.fx", default=s.fx))
        s.fy = float(g("Camera1.fy", "Camera.fy", default=s.fy))
        s.cx = float(g("Camera1.cx", "Camera.cx", default=s.cx))
        s.cy = float(g("Camera1.cy", "Camera.cy", default=s.cy))
        s.width = int(g("Camera.width", "Camera1.width", default=s.width))
        s.height = int(g("Camera.height", "Camera1.height", default=s.height))
        s.dist = tuple(float(g(f"Camera1.{k}", f"Camera.{k}", default=0.0))
                       for k in ("k1", "k2", "p1", "p2", "k3"))
        s.k_equi = tuple(float(g(f"Camera1.k{i}", default=0.0))
                         for i in range(4))
        s.fps = float(g("Camera.fps", default=s.fps))
        s.fx2 = float(g("Camera2.fx", default=0.0))
        s.fy2 = float(g("Camera2.fy", default=0.0))
        s.cx2 = float(g("Camera2.cx", default=0.0))
        s.cy2 = float(g("Camera2.cy", default=0.0))
        s.dist2 = tuple(float(g(f"Camera2.{k}", default=0.0))
                        for k in ("k1", "k2", "p1", "p2", "k3"))
        s.k_equi2 = tuple(float(g(f"Camera2.k{i}", default=0.0))
                          for i in range(4))
        tc12 = g("Stereo.T_c1_c2")
        if tc12 is not None and len(tc12) == 16:
            s.stereo_t_c1_c2 = tuple(float(x) for x in tc12)
        s.lapping1 = (float(g("Camera1.overlappingBegin", default=0.0)),
                      float(g("Camera1.overlappingEnd", default=1e9)))
        s.lapping2 = (float(g("Camera2.overlappingBegin", default=0.0)),
                      float(g("Camera2.overlappingEnd", default=1e9)))
        s.baseline = float(g("Camera.bf", "Stereo.b", default=0.0))
        if g("Camera.bf") is not None:
            s.baseline = float(g("Camera.bf")) / s.fx
        s.depth_map_factor = float(g("RGBD.DepthMapFactor",
                                     "DepthMapFactor",
                                     default=s.depth_map_factor))
        s.th_depth = float(g("Stereo.ThDepth", "ThDepth", default=s.th_depth))
        s.n_features = int(g("ORBextractor.nFeatures",
                             default=s.n_features))
        s.ini_th = float(g("ORBextractor.iniThFAST", default=s.ini_th))
        s.min_th = float(g("ORBextractor.minThFAST", default=s.min_th))
        s.n_levels = int(g("ORBextractor.nLevels", default=s.n_levels))
        s.scale_factor = float(g("ORBextractor.scaleFactor",
                                 default=s.scale_factor))
        s.imu_noise_gyro = float(g("IMU.NoiseGyro", default=s.imu_noise_gyro))
        s.imu_noise_acc = float(g("IMU.NoiseAcc", default=s.imu_noise_acc))
        s.imu_walk_gyro = float(g("IMU.GyroWalk", default=s.imu_walk_gyro))
        s.imu_walk_acc = float(g("IMU.AccWalk", default=s.imu_walk_acc))
        s.imu_frequency = float(g("IMU.Frequency", default=s.imu_frequency))
        tbc = g("IMU.T_b_c1", "Tbc")         # new format / legacy key
        if tbc is not None and len(tbc) == 16:
            s.imu_tbc = tuple(float(x) for x in tbc)
        s.load_atlas = g("System.LoadAtlasFromFile")
        s.save_atlas = g("System.SaveAtlasToFile")
        s.superpoint_weights = g("Models.SuperPoint")
        s.lightglue_weights = g("Models.LightGlue")
        s.yolo_weights = g("Models.Yolo")
        return s

    def imu_calib(self) -> ImuCalib:
        """The IMU calibration as plain data (identity extrinsics when the
        settings carry no IMU.T_b_c1 / Tbc)."""
        T = np.eye(4, dtype=np.float32) if self.imu_tbc is None else \
            np.asarray(self.imu_tbc, np.float32).reshape(4, 4)
        return ImuCalib(self.imu_noise_gyro, self.imu_noise_acc,
                        self.imu_walk_gyro, self.imu_walk_acc,
                        self.imu_frequency, T[:3, :3].copy(),
                        T[:3, 3].copy())

    def camera(self, device="cuda") -> _cam.Camera:
        if self.camera_type.lower() in ("kannalabrandt8", "fisheye"):
            return _cam.Camera.kb8(self.fx, self.fy, self.cx, self.cy,
                                   *self.k_equi, self.width, self.height,
                                   device=device)
        return _cam.Camera.pinhole(self.fx, self.fy, self.cx, self.cy,
                                   self.width, self.height, dist=self.dist,
                                   device=device)

    def camera2(self, device="cuda") -> Optional[_cam.Camera]:
        if self.fx2 <= 0:
            return None
        if self.camera_type.lower() in ("kannalabrandt8", "fisheye"):
            return _cam.Camera.kb8(self.fx2, self.fy2, self.cx2, self.cy2,
                                   *self.k_equi2, self.width, self.height,
                                   device=device)
        return _cam.Camera.pinhole(self.fx2, self.fy2, self.cx2, self.cy2,
                                   self.width, self.height, dist=self.dist2,
                                   device=device)

    def stereo_rectifier(self, device="cuda"):
        """Rectification maps when the settings carry Camera2 and
        Stereo.T_c1_c2 (reference: Settings computes M1l/M2l/M1r/M2r,
        src/Settings.cc); None for pre-rectified datasets."""
        cam2 = self.camera2(device)
        if cam2 is None or self.stereo_t_c1_c2 is None:
            return None
        from dani_slam_tpu_torch.ops import rectify as rect_ops
        T12 = np.asarray(self.stereo_t_c1_c2, np.float64).reshape(4, 4)
        # T_c1_c2 maps cam2 coordinates into cam1; the rectifier takes
        # cam2-from-cam1: x2 = R x1 + T
        R = T12[:3, :3].T
        T = -T12[:3, :3].T @ T12[:3, 3]
        return rect_ops.build_rectifier(self.camera(device), cam2, R, T,
                                        (self.width, self.height))
