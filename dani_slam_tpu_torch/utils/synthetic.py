"""Synthetic RGB-D sequences and maps (counterpart of
dani_slam_tpu/utils/synthetic.py), built with numpy and the port itself so
that a run on the card needs no JAX: an orbit trajectory, rasterized
textured corner spots with depth, the moving warm textured board the shipped
detector was trained on, a rectified stereo pair of the same world, feature-level frames of a random landmark cloud
with unique descriptors and their true ids (make_world / render_frame),
which exercise the SLAM layers without the learned frontend, and the
drifted loop map of the loop-closing tests and bench
(make_drifted_loop_state), and the two-view rays of the initialization
checks (two_view_rays).
The arithmetic follows the reference package's float32 steps so that the
same seed renders the same frames (up to float rounding at the last bit).
"""
from __future__ import annotations

import numpy as np


def orbit_trajectory(n_frames: int, radius: float = 10.0,
                     angle_span: float = 2 * np.pi, height: float = 0.0,
                     look_at=(0.0, 0.0, 0.0)):
    """Camera orbiting the origin, looking at `look_at`. Returns
    (R_cw [F,3,3], t_cw [F,3]) float32 ground-truth poses (T_cw)."""
    Rs, ts = [], []
    for i in range(n_frames):
        a = angle_span * i / max(n_frames - 1, 1)
        C = np.array([radius * np.sin(a), height, -radius * np.cos(a)])
        z = np.asarray(look_at) - C
        z = z / np.linalg.norm(z)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_cw = np.stack([x, y, z], axis=1).T
        Rs.append(R_cw)
        ts.append(-R_cw @ C)
    return (np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32))


def _apply(R, t, p):
    """R p + t in float32, p [M,3]."""
    R = np.asarray(R, np.float32)
    t = np.asarray(t, np.float32)
    p = np.asarray(p, np.float32)
    return (p[:, 0:1] * R[:, 0] + p[:, 1:2] * R[:, 1] +
            p[:, 2:3] * R[:, 2] + t).astype(np.float32)


def _project(cam_params, pc):
    """Pinhole projection in float32 (|z| < 1e-9 guarded)."""
    fx, fy, cx, cy = (np.float32(v) for v in cam_params[:4])
    z = pc[:, 2]
    zs = np.where(np.abs(z) < 1e-9, np.float32(1e-9), z)
    return np.stack([fx * pc[:, 0] / zs + cx, fy * pc[:, 1] / zs + cy],
                    axis=-1).astype(np.float32)


def render_image_depth(world_pts, brightness, cam_params, width: int,
                       height: int, R_cw, t_cw, spot: float = 2.0,
                       patch: int = 13, bg: float = 40.0,
                       depth_factor: float = 5000.0, seed: int = 0,
                       noise: float = 2.0, n_satellites: int = 4,
                       texture_seed: int = 1234):
    """Rasterize world points as Gaussian corner spots, each with a
    persistent 3-D satellite constellation (texture) -> (gray uint8 [H,W],
    encoded uint16 depth [H,W]; beyond-range depth encodes as 0)."""
    H, W = height, width
    rng = np.random.RandomState(seed)
    world_pts = np.asarray(world_pts)
    brightness = np.asarray(brightness)
    if n_satellites > 0:
        trng = np.random.RandomState(texture_seed)
        offs = trng.uniform(-0.10, 0.10,
                            (world_pts.shape[0], n_satellites, 3))
        offs = offs.astype(np.float32)
        nrm = np.linalg.norm(offs, axis=-1, keepdims=True)
        offs = offs * (np.maximum(nrm, 0.04) / np.maximum(nrm, 1e-9))
        sat_amp = (brightness[:, None] *
                   trng.uniform(0.35, 0.7, (world_pts.shape[0],
                                            n_satellites))).reshape(-1)
        sat_pts = (world_pts[:, None, :] + offs).reshape(-1, 3)
        world_pts = np.concatenate([world_pts, sat_pts], 0)
        brightness = np.concatenate([brightness, sat_amp], 0)
    pc = _apply(R_cw, t_cw, world_pts)
    z = pc[:, 2]
    uv = _project(cam_params, pc)
    r = patch // 2
    vis = ((z > 0.3) & (uv[:, 0] > r + 1) & (uv[:, 0] < W - r - 2) &
           (uv[:, 1] > r + 1) & (uv[:, 1] < H - r - 2))
    u, v, zz = uv[vis, 0], uv[vis, 1], z[vis]
    b = brightness[vis]
    u0 = np.round(u).astype(np.int32)
    v0 = np.round(v).astype(np.int32)
    off = np.arange(-r, r + 1)
    dx = off[None, None, :] + (u0 - u)[:, None, None]
    dy = off[None, :, None] + (v0 - v)[:, None, None]
    g = b[:, None, None] * np.exp(-(dx ** 2 + dy ** 2) / (2 * spot ** 2))
    xs = (u0[:, None, None] + off[None, None, :] +
          np.zeros_like(off)[None, :, None]).ravel()
    ys = (v0[:, None, None] + off[None, :, None] +
          np.zeros_like(off)[None, None, :]).ravel()
    img = np.full((H, W), bg, np.float32)
    np.maximum.at(img, (ys, xs), (bg + g).ravel())
    if noise > 0:
        img = img + rng.randn(H, W).astype(np.float32) * noise
    depth = np.full((H, W), np.inf, np.float32)
    zpatch = np.broadcast_to(zz[:, None, None], g.shape).ravel()
    np.minimum.at(depth, (ys, xs), np.where(g.ravel() > 0.02 * 255, zpatch,
                                            np.inf))
    scaled = depth * depth_factor
    depth_enc = np.where(np.isfinite(depth) & (scaled <= 65535.0), scaled,
                         0).astype(np.uint16)
    return np.clip(img, 0, 255).astype(np.uint8), depth_enc


def stamp_dynamic_object(img, depth, cam_f, uv, z, wh_m, offsets, amps):
    """Stamp the warm textured movable object onto an RGB frame (blob
    windows sliced: |du|, |dv| < 5 confine each blob)."""
    H, W = img.shape[:2]
    bw = wh_m[0] * cam_f / z
    bh = wh_m[1] * cam_f / z
    x1, y1 = uv[0] - bw / 2, uv[1] - bh / 2
    x2, y2 = uv[0] + bw / 2, uv[1] + bh / 2
    xi1, yi1 = max(int(x1), 0), max(int(y1), 0)
    xi2, yi2 = min(int(x2), W), min(int(y2), H)
    if xi2 - xi1 < 8 or yi2 - yi1 < 8:
        return img, depth
    img[yi1:yi2, xi1:xi2] = np.asarray([1.0, 0.55, 0.45]) * 0.55 * 255
    sx = bw / 100.0
    for (ox, oy), a in zip(offsets, amps):
        u, v = uv[0] + ox * sx, uv[1] + oy * sx
        if not (3 < u < W - 4 and 3 < v < H - 4):
            continue
        ix1, ix2 = max(int(np.floor(u - 5)), 0), min(int(np.ceil(u + 5)) + 1, W)
        iy1, iy2 = max(int(np.floor(v - 5)), 0), min(int(np.ceil(v + 5)) + 1, H)
        yy, xx = np.mgrid[iy1:iy2, ix1:ix2]
        du, dv = xx - u, yy - v
        m = (np.abs(du) < 5) & (np.abs(dv) < 5)
        g = a * np.exp(-(du ** 2 + dv ** 2) / (2 * 1.5 ** 2))
        sub = img[iy1:iy2, ix1:ix2]
        sub[m] = np.maximum(sub[m], (40 + g[m])[:, None] * np.ones((1, 3)))
    depth[yi1:yi2, xi1:xi2] = z * 5000.0
    return img, depth


def sequence_world(rng, cam_params, width: int, height: int, R_gt, t_gt,
                   sample_every: int = 6, per_batch: int = 160):
    """The textured world of the image sequences: per_batch points on a
    jittered 16x10 grid of every sample_every-th frame's view (and the
    last frame's) at depths 4-11 m, and their brightness; draws from the
    numpy RandomState `rng`. Returns (points [M,3] f32, brightness [M])."""
    n_frames = len(R_gt)
    fx, fy, cx, cy = (float(x) for x in np.asarray(cam_params)[:4])
    pts_list = []
    for j in list(range(0, n_frames, sample_every)) + [n_frames - 1]:
        gx, gy = np.meshgrid(np.linspace(40, width - 40, 16),
                             np.linspace(40, height - 40, 10))
        u = (gx + rng.uniform(-12, 12, gx.shape)).ravel()[:per_batch]
        v = (gy + rng.uniform(-12, 12, gy.shape)).ravel()[:per_batch]
        z = rng.uniform(4.0, 11.0, per_batch)
        rays = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones(per_batch)], 1)
        pc = (rays * z[:, None]).astype(np.float32)
        Rj, tj = np.asarray(R_gt[j]), np.asarray(t_gt[j])
        pts_list.append((Rj.T @ (pc - tj).T).T.astype(np.float32))
    pts = np.concatenate(pts_list, 0)
    bright = rng.uniform(150, 230, len(pts)).astype(np.float32)
    return pts, bright


def make_rgbd_image_sequence(cam_params, width: int, height: int, R_gt, t_gt,
                             seed: int = 0, with_object: bool = True,
                             sample_every: int = 6, per_batch: int = 160,
                             fps: float = 30.0):
    """RGB-D sequence along (R_gt [F,3,3], t_gt [F,3]): frustum-sampled
    textured points on a jittered grid plus the moving board at ~4 m
    crossing laterally (-1.8 + 0.07 i m). cam_params = [fx, fy, cx, cy].
    Returns (imgs [F] uint8 HxWx3, depths [F] uint16, times [F])."""
    n_frames = len(R_gt)
    rng = np.random.RandomState(seed)
    fx = float(np.asarray(cam_params)[0])
    pts, bright = sequence_world(rng, cam_params, width, height, R_gt, t_gt,
                                 sample_every, per_batch)
    obj_off = [(rng.uniform(-48, 48), rng.uniform(-33, 33))
               for _ in range(40)]
    obj_amp = [rng.uniform(150, 215) for _ in range(40)]
    C0 = -np.asarray(R_gt[0]).T @ np.asarray(t_gt[0])
    fwd0 = np.asarray(R_gt[0]).T @ np.asarray([0.0, 0.0, 1.0])
    side0 = np.asarray(R_gt[0]).T @ np.asarray([1.0, 0.0, 0.0])
    params = np.asarray(cam_params, np.float32)
    imgs, deps, times = [], [], []
    for i in range(n_frames):
        gray, de = render_image_depth(pts, bright, params, width, height,
                                      R_gt[i], t_gt[i], seed=i)
        img = np.repeat(gray[..., None], 3, axis=-1).astype(np.float32)
        de = de.astype(np.float32)
        if with_object:
            obj_w = C0 + fwd0 * 4.0 + side0 * (-1.8 + 0.07 * i)
            pc = _apply(R_gt[i], t_gt[i], obj_w[None])
            if pc[0, 2] > 0.5:
                uv = _project(params, pc)[0]
                img, de = stamp_dynamic_object(img, de, fx, uv, pc[0, 2],
                                               (1.6, 1.2), obj_off, obj_amp)
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
        deps.append(de.astype(np.uint16))
        times.append(i / fps)
    return imgs, deps, times


def make_stereo_image_sequence(cam_params, width: int, height: int, R_gt,
                               t_gt, baseline: float = 0.12, seed: int = 0,
                               fps: float = 30.0):
    """Rectified stereo sequence of the same world as
    make_rgbd_image_sequence (same seed, same points) without the moving
    board: the left camera at T_cw = (R, t), the right one `baseline`
    metres along the left camera's +x, T_cw = (R, t + [-b, 0, 0]); each
    image has its own pixel noise. Returns (left [F] uint8 HxW, right [F]
    uint8 HxW, times [F])."""
    rng = np.random.RandomState(seed)
    pts, bright = sequence_world(rng, cam_params, width, height, R_gt, t_gt)
    params = np.asarray(cam_params, np.float32)
    off = np.asarray([-baseline, 0.0, 0.0], np.float32)
    lefts, rights, times = [], [], []
    for i in range(len(R_gt)):
        lefts.append(render_image_depth(pts, bright, params, width, height,
                                        R_gt[i], t_gt[i], seed=i)[0])
        rights.append(render_image_depth(pts, bright, params, width, height,
                                         R_gt[i], t_gt[i] + off,
                                         seed=10_000 + i)[0])
        times.append(i / fps)
    return lefts, rights, times


def two_view_rays(n: int = 300, seed: int = 5, noise_px: float = 0.5,
                  focal: float = 520.0):
    """Normalized rays of a seeded scene in two views (unit baseline),
    `noise_px` of pixel noise, a fifth of the second view's rays corrupted,
    and fixed hypothesis index sets for ops/twoview.two_view_init. Returns
    (r1 [n,3], r2 [n,3], R_21, unit t_21, (idx8 [256,8], idx4 [256,4]))."""
    import torch
    from dani_slam_tpu_torch.core import lie
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3).astype(np.float32) * [2.0, 1.5, 1.0]
    pts[:, 2] = rng.uniform(3, 10, n)
    R, t = lie.se3_exp(torch.tensor([0.4, 0.1, 0.05, 0.02, -0.06, 0.01]))
    R, t = R.numpy(), (t / torch.linalg.norm(t)).numpy()
    p2 = pts @ R.T + t
    r1, r2 = pts / pts[:, 2:], p2 / p2[:, 2:]
    r1[:, :2] += rng.randn(n, 2) * noise_px / focal
    r2[:, :2] += rng.randn(n, 2) * noise_px / focal
    r2[: n // 5, :2] += rng.uniform(0.05, 0.2, (n // 5, 2))
    idx = (rng.randint(0, n, (256, 8)), rng.randint(0, n, (256, 4)))
    return r1.astype(np.float32), r2.astype(np.float32), R, t, idx


def make_world(n_points: int = 2000, desc_dim: int = 64, seed: int = 0,
               box=((-6.0, 6.0), (-4.0, 4.0), (-6.0, 6.0))):
    """Random landmark cloud: (points [M,3] f32, unit descriptors [M,D]
    f32, unique per landmark)."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(lo, hi, n_points) for lo, hi in box],
                   axis=1).astype(np.float32)
    d = rng.randn(n_points, desc_dim).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return pts, d


def render_frame(world, cam, R_cw, t_cw, n_max: int = 512,
                 noise_px: float = 0.3, desc_noise: float = 0.05,
                 seed: int = 0, with_depth: bool = False,
                 depth_noise: float = 0.0, time: float = 0.0):
    """Observe the world (points [M,3], unit descriptors [M,D]) from pose
    T_cw through the port's camera `cam` as pre-extracted features: up to
    n_max visible landmarks in shuffled order with pixel and descriptor
    noise, depth when with_depth (inf elsewhere). Returns (FrameFeatures on
    cam's device, true_ids [n_max] int32 world index per row, -1 for
    padding); numpy RandomState(seed) draws every random number."""
    import torch
    from dani_slam_tpu_torch.slam.frame import FrameFeatures
    pts, desc = (np.asarray(a) for a in world)
    width, height = cam.width, cam.height
    rng = np.random.RandomState(seed)
    pc = _apply(R_cw, t_cw, pts)
    z = pc[:, 2]
    xy = _project(cam.params.cpu().numpy(), pc)
    vis = ((z > 0.3) & (xy[:, 0] >= 1) & (xy[:, 0] < width - 1) &
           (xy[:, 1] >= 1) & (xy[:, 1] < height - 1))
    ids = np.nonzero(vis)[0]
    rng.shuffle(ids)
    ids = ids[:n_max]
    n = len(ids)
    D = desc.shape[1]
    fxy = np.zeros((n_max, 2), np.float32)
    fdesc = np.zeros((n_max, D), np.float32)
    fdepth = np.full((n_max,), np.inf, np.float32)
    valid = np.zeros((n_max,), bool)
    true_ids = np.full((n_max,), -1, np.int32)
    fxy[:n] = xy[ids] + rng.randn(n, 2) * noise_px
    d = desc[ids] + rng.randn(n, D) * desc_noise
    fdesc[:n] = d / np.linalg.norm(d, axis=1, keepdims=True)
    if with_depth:
        fdepth[:n] = z[ids] * (1 + rng.randn(n) * depth_noise)
    valid[:n] = True
    true_ids[:n] = ids
    dev = cam.device
    T = lambda a: torch.as_tensor(a, device=dev)     # noqa: E731
    feat = FrameFeatures(xy=T(fxy), desc=T(fdesc), depth=T(fdepth),
                         valid=T(valid),
                         time=torch.full((), time, dtype=torch.float32,
                                         device=dev))
    return feat, T(true_ids)


def make_drifted_loop_state(cam, caps, K: int = 12, drift: float = 0.35,
                            scale_drift: float = 1.0, desc_dim=None,
                            seed: int = 2):
    """Deterministic drifted loop map (the reference package's builder of
    the same name, for the loop-closing tests and the loop bench): K
    keyframes on a full orbit whose estimated poses carry a drift ramping
    up along the loop (optionally a monocular-style scale drift instead),
    landmarks created from depth at the estimated poses, and a covisibility
    chain between consecutive keyframes but not across the loop gap
    (last -> first), which only a loop edge can close. Built on cam's
    device with the port's map functions. Returns (MapState, kf_ids,
    (R_gt, t_gt) numpy, world)."""
    import torch
    from dani_slam_tpu_torch.core import cameras as _cam
    from dani_slam_tpu_torch.core import lie
    from dani_slam_tpu_torch.core import state as mstate
    dev = cam.device
    world = make_world(2000, desc_dim=desc_dim or caps.D, seed=seed)
    R_gt, t_gt = orbit_trajectory(K, radius=10.0, angle_span=2 * np.pi)
    st = mstate.empty_map(caps, device=dev)
    N = caps.N
    T = lambda a: torch.as_tensor(a, device=dev)     # noqa: E731
    kf_ids = []
    world2lm = {}        # world point id -> landmark slot (chain memory)
    C_prev_est = None
    for k in range(K):
        a = drift * k / (K - 1)
        dR, dt = lie.se3_exp(T(np.asarray([a, 0.5 * a, 0.0, 0.0, 0.05 * a,
                                           0.0], np.float32)))
        s_k = 1.0 + (scale_drift - 1.0) * k / (K - 1)
        if scale_drift != 1.0:
            C_gt_k = -R_gt[k].T @ t_gt[k]
            if C_prev_est is None:
                C_est = C_gt_k
            else:
                C_est = C_prev_est + s_k * (C_gt_k - (-R_gt[k - 1].T @
                                                      t_gt[k - 1]))
            C_prev_est = C_est
            R_est = T(R_gt[k])
            t_est = T(np.asarray(-R_gt[k] @ C_est, np.float32))
        else:
            R_est = dR @ T(R_gt[k])
            t_est = dR @ T(t_gt[k]) + dt
        # descriptor noise scaled so that matching is as hard at any width
        dnoise = 0.05 * (64.0 / world[1].shape[1]) ** 0.5
        feat, tid = render_frame(world, cam, R_gt[k], t_gt[k], n_max=N,
                                 noise_px=0.2, desc_noise=dnoise,
                                 seed=100 + k, with_depth=True, time=k / 5.0)
        if scale_drift != 1.0:
            feat = feat._replace(depth=feat.depth * s_k)
        # landmarks from depth at the ESTIMATED pose; world points the
        # previous keyframe saw are rebound, which makes the covisibility
        # chain (never across the loop gap)
        Xc = _cam.unproject(cam, feat.xy) * feat.depth[:, None]
        Xw = lie.se3_apply(*lie.se3_inv(R_est, t_est), Xc)
        good = (feat.valid & torch.isfinite(feat.depth)).cpu().numpy()
        tid_np = tid.cpu().numpy()
        bind = np.full(N, -1, np.int32)
        create = good.copy()
        for row in range(N):
            if good[row] and tid_np[row] in world2lm:
                bind[row] = world2lm[tid_np[row]]
                create[row] = False
        kk = torch.full((N,), k, dtype=torch.int32, device=dev)
        st, slots = mstate.insert_landmarks(
            st, Xw, feat.desc, Xw, torch.zeros(N, device=dev) + 0.5,
            torch.zeros(N, device=dev) + 50.0, kk, kk, T(create))
        slots_np = slots.cpu().numpy()
        for row in range(N):
            if create[row] and slots_np[row] >= 0:
                bind[row] = slots_np[row]
                world2lm[tid_np[row]] = int(slots_np[row])
        st, kf = mstate.insert_keyframe(
            st, R_est, t_est, k / 5.0, k, feat.xy, feat.valid, feat.desc,
            feat.depth, torch.zeros((N,), dtype=torch.int8, device=dev),
            T(bind))
        kf_ids.append(int(kf))
        seen_now = set(tid_np[good].tolist())
        world2lm = {w: l for w, l in world2lm.items() if w in seen_now}
    return st, kf_ids, (R_gt, t_gt), world
