"""Visual-inertial tracking support (counterpart of
dani_slam_tpu/slam/inertial.py): per-frame preintegration, IMU pose
prediction, and the IMU initialization over the keyframe chain.

Reference behaviors: Tracking::PreintegrateIMU (src/Tracking.cc:1643),
Tracking::PredictStateIMU (:1757), LocalMapping::InitializeIMU
(src/LocalMapping.cc:1175) — gravity, velocities and biases (and, for a
monocular map, the scale) from the keyframe chain, then the whole map
rotated so gravity points along -z (ApplyScaledRotation). The staged full
inertial BA after it is the System's (slam/system.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dani_slam_tpu_torch.core import lie
from dani_slam_tpu_torch.core import state as mstate
from dani_slam_tpu_torch.ops import imu as imu_ops
from dani_slam_tpu_torch.utils import graphs
from dani_slam_tpu_torch.utils.device import const, pull, upload

MAX_SAMPLES_PER_FRAME = 64


class ImuWindow(NamedTuple):
    """Fixed-size padded IMU sample window between two frames. `n` (host
    int): the valid samples form a prefix of this length (make_window's
    windows), so preintegration visits only those; None visits all."""
    gyro: torch.Tensor    # [S,3]
    acc: torch.Tensor     # [S,3]
    dts: torch.Tensor     # [S]
    valid: torch.Tensor   # [S] bool
    n: Optional[int] = None


def make_window(gyro, acc, dts, max_s: int = MAX_SAMPLES_PER_FRAME,
                device="cuda") -> ImuWindow:
    """Pad host samples to max_s (samples beyond max_s are dropped, as in
    the reference package) and copy them to `device`."""
    g = np.zeros((max_s, 3), np.float32)
    a = np.zeros((max_s, 3), np.float32)
    d = np.zeros((max_s,), np.float32)
    v = np.zeros((max_s,), bool)
    n = min(len(dts), max_s)
    g[:n] = np.asarray(gyro)[:n]
    a[:n] = np.asarray(acc)[:n]
    d[:n] = np.asarray(dts)[:n]
    v[:n] = True
    return ImuWindow(*(upload(x, device) for x in (g, a, d, v)), n=n)


def window_from_numpy(src, device="cuda") -> ImuWindow:
    """ImuWindow from arrays (a dict, or the JAX package's ImuWindow); `n`
    is the length of the valid prefix when the mask is one."""
    get = (src.__getitem__ if isinstance(src, dict)
           else lambda k: getattr(src, k))
    valid = np.asarray(get("valid"), bool)
    n = int(valid.sum())
    n = n if valid[:n].all() else None
    return ImuWindow(*(upload(np.asarray(get(k), np.float32), device)
                       for k in ("gyro", "acc", "dts")),
                     upload(valid, device), n=n)


def predict_state_imu(R_cw, t_cw, v_w, preint: imu_ops.Preintegrated,
                      bias_g, bias_a, R_bc=None, t_bc=None):
    """IMU forward prediction of the next camera pose (reference
    PredictStateIMU, src/Tracking.cc:1757-1805); integration on the BODY
    state through T_bc (identity when omitted). Returns (R_cw', t_cw',
    v_w')."""
    dev = R_cw.device
    if R_bc is None:
        R_bc = torch.eye(3, device=dev)
    if t_bc is None:
        t_bc = torch.zeros(3, device=dev)
    g = imu_ops.g_vec(R_cw)
    dR, dV, dP = imu_ops.corrected_deltas(preint, bias_g, bias_a)
    dt = preint.dt
    R_wb, p_w = imu_ops.body_from_camera(R_bc, t_bc, R_cw, t_cw)
    R_wb2 = lie.orthonormalize(R_wb @ dR)
    p_w2 = p_w + v_w * dt + 0.5 * g * dt * dt + R_wb @ dP
    v_w2 = v_w + g * dt + R_wb @ dV
    R_cw2, t_cw2 = imu_ops.camera_from_body(R_bc, t_bc, R_wb2, p_w2)
    return lie.orthonormalize(R_cw2), t_cw2, v_w2


class InertialState:
    """Host-side inertial bookkeeping attached to the Tracker (device
    tensors for the state, host lists for the windows)."""

    def __init__(self, calib: Optional[imu_ops.ImuCalib] = None,
                 device="cuda"):
        self.device = torch.device(device)
        self.calib = (calib.to(self.device) if calib is not None
                      else imu_ops.ImuCalib.default(self.device))
        self.initialized = False
        z = torch.zeros(3, device=self.device)
        self.v_w = z
        self.bias_g = z
        self.bias_a = z
        self.last_preint: Optional[imu_ops.Preintegrated] = None
        # 15x15 marginalized prior information on the last tracked frame's
        # [pose, v, bg, ba] (tracking.vi_refine_step_marg); None until the
        # first frame after the initialization bootstraps it
        self.prior_info = None
        # the raw windows of every frame (keyframe-to-keyframe
        # re-integration at init time)
        self.frame_windows = []
        self.last_alignment = (torch.eye(3, device=self.device),
                               torch.ones((), device=self.device))

    def integrate_frame(self, win: ImuWindow):
        """Preintegrate the frame's window at the current biases (on the
        card one CUDA graph replay per window length, utils/graphs) and
        keep the window for the keyframe chain."""
        def fn(*a):
            return imu_ops.preintegrate(*a[:6], imu_ops.ImuCalib(*a[6:]),
                                        n_steps=win.n)
        self.last_preint = graphs.call(
            ("preintegrate", win.n), fn,
            (win.gyro, win.acc, win.dts, win.valid, self.bias_g,
             self.bias_a, *self.calib))
        self.frame_windows.append(win)
        return self.last_preint

    def kf_chain_preintegrations(self, kf_frame_bounds):
        """Re-integrate keyframe-to-keyframe windows from the stored
        per-frame samples at the current biases; kf_frame_bounds: list of
        (start, end) into frame_windows. A span is integrated over the
        concatenated windows' valid samples only: the masked padding between
        them would leave the carry exactly as it is."""
        outs = []
        for (a, b) in kf_frame_bounds:
            wins = self.frame_windows[a:b]
            if not wins:
                outs.append(None)
                continue
            cut = lambda w, x: x if w.n is None else x[:w.n]  # noqa: E731
            cat = [torch.cat([cut(w, getattr(w, f)) for w in wins])
                   for f in ("gyro", "acc", "dts", "valid")]
            outs.append(imu_ops.preintegrate(*cat, self.bias_g, self.bias_a,
                                             self.calib))
        return outs


def inertial_state_from_numpy(src: dict, device="cuda") -> InertialState:
    """InertialState from host values (tests hand both packages one
    state): keys calib (a dict or an ImuCalib-like object), and optionally
    initialized, v_w, bias_g, bias_a, last_preint, prior_info,
    frame_windows (a list of window dicts or ImuWindow-like objects)."""
    s = InertialState(imu_ops.calib_from_numpy(src["calib"], device),
                      device=device)
    s.initialized = bool(src.get("initialized", False))
    for k in ("v_w", "bias_g", "bias_a", "prior_info"):
        if src.get(k) is not None:
            setattr(s, k, torch.as_tensor(np.asarray(src[k], np.float32),
                                          device=device))
    if src.get("last_preint") is not None:
        s.last_preint = imu_ops.preint_from_numpy(src["last_preint"], device)
    s.frame_windows = [window_from_numpy(w, device)
                       for w in src.get("frame_windows", [])]
    return s


def initialize_imu(st: mstate.MapState, inertial: InertialState, kf_ids,
                   preints, mono_scale_free: bool):
    """Gravity / scale / bias initialization over the keyframe chain and
    the map's alignment (reference InitializeIMU: InertialOptimization +
    ApplyScaledRotation). kf_ids: keyframe slots in temporal order; preints:
    keyframe-to-keyframe Preintegrated (len(kf_ids) - 1). The scale is read
    back to gate the solve (one counted blocking read, a host read in the
    reference package too). Returns (st_aligned, ok)."""
    from dani_slam_tpu_torch.slam.atlas import transform_map

    if len(kf_ids) < 4 or any(p is None for p in preints):
        return st, False
    dev = st.kf_R.device
    R_bc, t_bc = inertial.calib.R_bc, inertial.calib.t_bc
    ks = upload(np.asarray(kf_ids, np.int64), dev)
    R_wb, _ = imu_ops.body_from_camera(R_bc, t_bc, st.kf_R[ks], st.kf_t[ks])
    C_cam = -torch.einsum('kji,kj->ki', st.kf_R[ks], st.kf_t[ks])
    t_off = -torch.einsum('kij,j->ki', R_wb, t_bc)
    out = imu_ops.inertial_init(R_wb, C_cam, None,
                                imu_ops.stack_preints(preints),
                                optimize_scale=mono_scale_free, t_off=t_off)
    s = float(pull(out["scale"]))
    if not (0.02 < s < 100.0) or not np.isfinite(s):
        return st, False
    # rotate the world so the estimated gravity aligns with (0, 0, -9.81)
    g = out["gravity"]
    g_norm = g / torch.clamp(torch.linalg.norm(g), min=1e-9)
    target = const((0.0, 0.0, -1.0), torch.float32, dev)
    axis = torch.linalg.cross(g_norm, target)
    sin_a = torch.linalg.norm(axis)
    cos_a = torch.dot(g_norm, target)
    angle = torch.atan2(sin_a, cos_a)
    Rg = lie.so3_exp(axis / torch.clamp(sin_a, min=1e-9) * angle)
    Rg = torch.where(sin_a < 1e-6, torch.eye(3, device=dev), Rg)
    s_t = out["scale"]
    st2 = transform_map(st, Rg, torch.zeros(3, device=dev), s_t)
    inertial.last_alignment = (Rg, s_t)
    inertial.initialized = True
    inertial.bias_g = out["bias_g"]
    inertial.bias_a = out["bias_a"]
    # the solve's velocities are already metric: only the rotation applies
    inertial.v_w = Rg @ out["velocities"][-1]
    return st2, True
