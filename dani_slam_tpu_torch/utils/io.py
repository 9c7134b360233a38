"""Dataset loaders and trajectory writers (counterpart of
dani_slam_tpu/utils/io.py): TUM RGB-D file lists and association files,
KITTI odometry stereo lists, EuRoC camera and IMU csv files, an image loader
with a PNM fallback, and the TUM / EuRoC / KITTI trajectory formats
(reference: the Examples mains and System::SaveTrajectoryTUM
src/System.cc:579, SaveTrajectoryEuRoC :672, SaveTrajectoryKITTI :1216).
Trajectories are [(time, R_cw, t_cw)] with numpy poses, as the Tracker
keeps them.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# TUM RGB-D
# ---------------------------------------------------------------------------

def load_tum_rgb_list(seq_dir: str, fname: str = "rgb.txt"):
    """Parse TUM-format file lists: lines 'timestamp path'."""
    out = []
    with open(os.path.join(seq_dir, fname)) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 2:
                out.append((float(parts[0]), parts[1]))
    return out


def load_tum_associations(path: str):
    """Association file (evaluation/associate.py output): lines
    't_rgb rgb_path t_depth depth_path'."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            p = line.split()
            if len(p) >= 4:
                out.append((float(p[0]), p[1], float(p[2]), p[3]))
    return out


def associate_timestamps(t_a: np.ndarray, t_b: np.ndarray,
                         max_dt: float = 0.02):
    """Greedy nearest association (reference: evaluation/associate.py)."""
    pairs = []
    used = set()
    for i, ta in enumerate(t_a):
        j = int(np.argmin(np.abs(t_b - ta)))
        if abs(t_b[j] - ta) <= max_dt and j not in used:
            pairs.append((i, j))
            used.add(j)
    return pairs


def load_image(path: str) -> np.ndarray:
    """Image loader: the native C++ decoder first (zlib-PNG/PNM; threaded
    read-ahead in utils/native.ImagePrefetcher), then PIL where installed,
    then pure-numpy PGM/PPM."""
    from dani_slam_tpu_torch.utils import native as _native
    img = _native.load_image_native(path)
    if img is not None:
        return img
    try:
        from PIL import Image
        return np.asarray(Image.open(path))
    except ImportError:
        pass
    with open(path, "rb") as f:
        magic = f.read(2)
        if magic in (b"P5", b"P6"):
            f.seek(0)
            return _load_pnm(f)
    raise RuntimeError(f"cannot load image {path} (no PIL, not PNM)")


def _load_pnm(f):
    magic = f.readline().split()[0]
    dims = []
    while len(dims) < 3:
        line = f.readline()
        if line.startswith(b"#"):
            continue
        dims += [int(x) for x in line.split()]
    w, h, maxv = dims
    ch = 3 if magic == b"P6" else 1
    dtype = np.uint16 if maxv > 255 else np.uint8
    data = np.frombuffer(f.read(), dtype=f">{'u2' if maxv > 255 else 'u1'}")
    img = data[:h * w * ch].reshape(h, w, ch).astype(dtype)
    return img[..., 0] if ch == 1 else img


# ---------------------------------------------------------------------------
# KITTI and EuRoC
# ---------------------------------------------------------------------------

def load_kitti_stereo_list(seq_dir: str):
    """KITTI odometry sequence dir (image_0/ image_1/ times.txt) ->
    [(t, left_path, right_path)] (reference: LoadImages in
    Examples/Stereo/stereo_kitti.cc)."""
    times_path = os.path.join(seq_dir, "times.txt")
    with open(times_path) as f:
        times = [float(line.strip()) for line in f if line.strip()]
    out = []
    for i, t in enumerate(times):
        name = f"{i:06d}.png"
        out.append((t, os.path.join(seq_dir, "image_0", name),
                    os.path.join(seq_dir, "image_1", name)))
    return out


def load_euroc_cam_list(seq_dir: str, cam: str = "cam0"):
    """mav0/cam0/data.csv: 'timestamp_ns,filename'."""
    out = []
    csv = os.path.join(seq_dir, "mav0", cam, "data.csv")
    with open(csv) as f:
        for line in f:
            if line.startswith("#"):
                continue
            p = line.strip().split(",")
            if len(p) >= 2:
                out.append((int(p[0]) * 1e-9,
                            os.path.join(seq_dir, "mav0", cam, "data", p[1])))
    return out


def load_euroc_imu(seq_dir: str):
    """mav0/imu0/data.csv: t_ns, wx, wy, wz, ax, ay, az."""
    csv = os.path.join(seq_dir, "mav0", "imu0", "data.csv")
    rows = []
    with open(csv) as f:
        for line in f:
            if line.startswith("#"):
                continue
            p = line.strip().split(",")
            if len(p) >= 7:
                rows.append([float(x) for x in p])
    arr = np.asarray(rows)
    return arr[:, 0] * 1e-9, arr[:, 1:4], arr[:, 4:7]


# ---------------------------------------------------------------------------
# Trajectory writers (TUM / EuRoC / KITTI formats)
# ---------------------------------------------------------------------------

def _centre_quat(R_cw, t_cw):
    """(camera centre C = -R_cw^T t_cw, quaternion wxyz of R_wc)."""
    from dani_slam_tpu_torch.core import lie
    R_wc = np.asarray(R_cw).T
    C = -R_wc @ np.asarray(t_cw)
    q = lie.mat_to_quat(torch.as_tensor(np.ascontiguousarray(R_wc),
                                        dtype=torch.float32)).numpy()
    return C, q


def save_trajectory_tum(path: str, traj: List[Tuple[float, np.ndarray,
                                                    np.ndarray]],
                        time_offset: float = 0.0):
    """'time tx ty tz qx qy qz qw' of T_wc. time_offset restores absolute
    (epoch) timestamps: the runners feed the device sequence-relative times,
    because epoch-scale values quantize in float32 (ulp ~128 s at 1.4e9 s)."""
    rows = []
    for (tm, R_cw, t_cw) in traj:
        C, q = _centre_quat(R_cw, t_cw)
        rows.append(f"{tm + time_offset:.6f} {C[0]:.7f} {C[1]:.7f} "
                    f"{C[2]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f} "
                    f"{q[0]:.7f}")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def save_trajectory_euroc(path: str, traj, time_offset: float = 0.0):
    """EuRoC format: 'time_ns,tx,ty,tz,qw,qx,qy,qz'. time_offset: see
    save_trajectory_tum."""
    rows = []
    for (tm, R_cw, t_cw) in traj:
        C, q = _centre_quat(R_cw, t_cw)
        rows.append(f"{int((tm + time_offset) * 1e9)},{C[0]:.6f},{C[1]:.6f},"
                    f"{C[2]:.6f},{q[0]:.6f},{q[1]:.6f},{q[2]:.6f},"
                    f"{q[3]:.6f}")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def save_trajectory_kitti(path: str, traj):
    """KITTI format: 12 numbers per row, the 3x4 [R_wc|C] matrix."""
    rows = []
    for (_, R_cw, t_cw) in traj:
        R_wc = np.asarray(R_cw).T
        C = -R_wc @ np.asarray(t_cw)
        P = np.hstack([R_wc, C.reshape(3, 1)])
        rows.append(" ".join(f"{x:.6e}" for x in P.reshape(-1)))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
