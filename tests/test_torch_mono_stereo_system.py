"""The monocular and stereo entry points as a whole: the JAX package's
System and the port's System(device="cpu") on the same numpy images.

Configurations:
  * `mono-small` / `stereo-small` (tier 1): the 320x240 scene of
    tests/test_image_pipeline.py (400 textured spots at 4-9 m, the camera
    sliding 12 cm a frame along x), caps K 32 / L 4096 / N 256 / D 256,
    256 features, keypoint threshold 0.003 as there, LightGlue
    (matcher="auto"), pipelined; mono with the 8-level pyramid, stereo on a
    rectified pair with a 0.12 m baseline. Loop closing and
    relocalization are off here (each would add its own JAX programs to
    compile; the full-size cases run them).
  * `mono-full` / `stereo-full` (slow): the slice's configurations at
    MapCaps() on 640x480 images of the bench's camera (f 500): mono is
    examples/mono_tum.py's System(MONOCULAR, pipelined=True, n_levels=8,
    scale_factor=1.2) on the bench's 60-frame sequence; stereo is
    examples/stereo_kitti.py's System(STEREO, pipelined=True) on the same
    world rendered as a rectified pair without the moving board
    (utils/synthetic.make_stereo_image_sequence). Loop closing and
    relocalization on, the defaults. `python tests/test_torch_mono_stereo_
    system.py jax mono-full` prints the JAX package's numbers alone (the
    parity targets of chip_smoke.py's mono and stereo passes, PERF.md).

Each configuration runs three times: the JAX System on its own frames,
the port's System on the images (its own frontend), and the port's System
on the JAX package's frames, the mono init replaying the JAX draws (the
SLAM layers alone). At full size the JAX System also runs on its frames
with every keypoint moved by N(0, 1e-3) px (three seeds): its spread on
rounding-sized changes, which at full size is tenths of a metre of ATE
(`python tests/test_torch_mono_stereo_system.py spread mono-full 0 1 2`
prints both packages side by side on the same moved frames).

Tolerances, on the images: the init frame and the per-frame tracker states
equal (full size: the init frame within 2, at most 3 fewer frames
tracked), keyframe counts within 2 and landmark counts within 15 %, the
camera centres (each run aligned onto the ground truth: mono by a Sim3,
its map's scale being its own; stereo rigidly) within twice the JAX run's
own largest centre error plus centre_tol, and the port's ATE at most
centre_tol above the JAX run's. The envelope is wide because the runs
diverge: the two frontends round their bf16 convolutions at different
places, near-tied keypoint scores come out in another order, and a
keyframe or triangulation decision near its threshold then lands
differently (on the small stereo scene the two runs end 0.19 m apart while
each stays within 0.2 m of the truth). At full size the JAX side of
those limits is its range over its run and its spread runs. On the JAX
package's frames, small scenes: states, init frame and keyframes equal,
landmarks within 1 %, centres within same_tol metres (stereo 1 mm,
observed 4e-6 m; mono 5 cm, observed 2.4 cm: the init's f32 SVDs differ in
the last bits, the 1-frame baseline amplifies it, and one triangulation
decision at frame 8 differs); full size: states and init frame equal,
the rest as on the images.
"""
import sys

import numpy as np
import pytest
import torch

from dani_slam_tpu_torch.utils import eval as ev
from dani_slam_tpu_torch.utils import synthetic

# the tier-1 run has several workers on one machine: a few intra-op threads
# each keep them from oversubscribing it
torch.set_num_threads(2)

BASELINE = 0.12
SMALL = dict(W=320, H=240, F=300.0, n=12, caps=dict(K=32, L=4096, N=256,
                                                    D=256),
             n_features=256, threshold=0.003, loop=False, kf_tol=2,
             lm_tol=0.15, centre_tol=0.05, same_tol=0.05, spread=())
FULL = dict(W=640, H=480, F=500.0, n=60, caps={}, n_features=1024,
            threshold=0.007, loop=True, kf_tol=2, lm_tol=0.15,
            centre_tol=0.05, spread=(1, 2, 3))
CONFIGS = {
    "mono-small": dict(SMALL, kind="mono", scene="spots"),
    "stereo-small": dict(SMALL, kind="stereo", scene="spots",
                         same_tol=1e-3),
    "mono-full": dict(FULL, kind="mono", scene="bench"),
    "stereo-full": dict(FULL, kind="stereo", scene="bench"),
}


def spot_scene():
    """tests/test_image_pipeline.py's scene: 400 points, x/y in [-4, 4],
    z in [4, 9], brightness 120-215."""
    rng = np.random.RandomState(2)
    pts = rng.uniform(-4, 4, (400, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(4, 9, 400)
    colors = rng.uniform(120, 215, 400).astype(np.float32)
    return pts, colors


def render_spots(pts, colors, t_cw, F, W, H, spot=2.0):
    """Gray image of the spot scene from T_cw = (I, t_cw) (the rasterizer
    of tests/test_image_pipeline.py, numpy only)."""
    pc = pts + np.asarray(t_cw, np.float32)
    z = pc[:, 2]
    u = F * pc[:, 0] / z + W / 2
    v = F * pc[:, 1] / z + H / 2
    vis = (z > 0.5) & (u > 4) & (u < W - 4) & (v > 4) & (v < H - 4)
    img = np.full((H, W), 40.0, np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for i in np.argsort(-z):
        if not vis[i]:
            continue
        du, dv = xx - u[i], yy - v[i]
        m = (np.abs(du) < 6) & (np.abs(dv) < 6)
        g = colors[i] * np.exp(-(du ** 2 + dv ** 2) / (2 * spot ** 2))
        img = np.where(m, np.maximum(img, 40 + g), img)
    return img.astype(np.uint8)


def sequence(c):
    """(R_gt, t_gt, left images, right images or None, times)."""
    W, H, F, n = c["W"], c["H"], c["F"], c["n"]
    if c["scene"] == "spots":
        pts, colors = spot_scene()
        R_gt = np.repeat(np.eye(3, dtype=np.float32)[None], n, 0)
        t_gt = np.stack([np.asarray([-0.12 * i, 0, 0], np.float32)
                         for i in range(n)])
        left = [render_spots(pts, colors, t_gt[i], F, W, H)
                for i in range(n)]
        right = [render_spots(pts, colors, t_gt[i] + [-BASELINE, 0, 0], F,
                              W, H) for i in range(n)]
        times = [i / 30.0 for i in range(n)]
        return R_gt, t_gt, left, right if c["kind"] == "stereo" else None, \
            times
    R_gt, t_gt = synthetic.orbit_trajectory(n, radius=10.0, angle_span=0.35)
    params = [F, F, W / 2, H / 2]
    if c["kind"] == "mono":
        imgs, _, times = synthetic.make_rgbd_image_sequence(
            params, W, H, R_gt, t_gt, seed=0)
        return R_gt, t_gt, imgs, None, times
    left, right, times = synthetic.make_stereo_image_sequence(
        params, W, H, R_gt, t_gt, baseline=BASELINE, seed=0)
    return R_gt, t_gt, left, right, times


def jax_system(c):
    from dani_slam_tpu.core import cameras as jcam
    from dani_slam_tpu.core import state as jst
    from dani_slam_tpu.models import superpoint as jsp
    from dani_slam_tpu.slam.system import Sensor, System
    W, H, F = c["W"], c["H"], c["F"]
    extra = dict(n_levels=8, scale_factor=1.2) if c["kind"] == "mono" else {}
    s = System(jcam.Camera.pinhole(F, F, W / 2, H / 2, W, H),
               Sensor.MONOCULAR if c["kind"] == "mono" else Sensor.STEREO,
               caps=jst.MapCaps(**c["caps"]),
               sp_params=jsp.load_default_params(),
               n_features=c["n_features"], pipelined=True, matcher="auto",
               enable_loop_closing=c["loop"],
               enable_relocalization=c["loop"], **extra)
    s.sp_threshold = c["threshold"]
    return s


def torch_system(c, device="cpu"):
    from dani_slam_tpu_torch.core import cameras as tcam
    from dani_slam_tpu_torch.core import state as tst
    from dani_slam_tpu_torch.slam.system import Sensor, System
    W, H, F = c["W"], c["H"], c["F"]
    extra = dict(n_levels=8, scale_factor=1.2) if c["kind"] == "mono" else {}
    s = System(tcam.Camera.pinhole(F, F, W / 2, H / 2, W, H, device=device),
               Sensor.MONOCULAR if c["kind"] == "mono" else Sensor.STEREO,
               caps=tst.MapCaps(**c["caps"]), n_features=c["n_features"],
               pipelined=True, matcher="auto",
               enable_loop_closing=c["loop"],
               enable_relocalization=c["loop"], device=device, **extra)
    s.sp_threshold = c["threshold"]
    return s


def jax_frames(js, c, seq):
    """The JAX package's frames of the sequence, built as its
    track_monocular / track_stereo build them (which then call
    track_features on them)."""
    import jax.numpy as jnp
    from dani_slam_tpu.slam import frame as jfr
    _, _, left, right, times = seq
    out = []
    for i in range(len(left)):
        if c["kind"] == "mono":
            out.append(jfr.build_frame_mono(
                js._sp(), jnp.asarray(left[i]), js.cam, times[i],
                n_max=js.n_features, threshold=js.sp_threshold,
                n_levels=js.n_levels, scale_factor=js.scale_factor))
        else:
            out.append(jfr.build_frame_stereo(
                js._sp(), jnp.asarray(left[i]), jnp.asarray(right[i]),
                js.cam, BASELINE, times[i], n_max=js.n_features,
                matcher=js.matcher))
    return out


def to_torch_frame(f):
    import jax
    from dani_slam_tpu_torch.slam.frame import FrameFeatures
    return FrameFeatures(*[None if x is None else torch.as_tensor(
        np.asarray(x)) for x in jax.device_get(f)])


def jax_init_sampler(seed=0):
    """The JAX Tracker's two-view draws (its key split once an attempt,
    then jax.random.categorical as in twoview.two_view_init), handed to
    the port's Tracker.init_sampler."""
    import jax
    import jax.numpy as jnp
    key = [jax.random.PRNGKey(seed)]

    def draws(k, mask, n):
        p = jnp.asarray(mask.numpy()).astype(jnp.float32) + 1e-6
        logits = jnp.broadcast_to(jnp.log(p), (256, n, p.shape[0]))
        return torch.as_tensor(np.asarray(jax.random.categorical(
            k, logits, axis=-1)))

    def sampler(pair_mask):
        key[0], sub = jax.random.split(key[0])
        k1, k2 = jax.random.split(sub)
        return draws(k1, pair_mask, 8), draws(k2, pair_mask, 4)
    return sampler


def run(system, seq, frames=None):
    """Drive a System over the sequence (its own entry point on the
    images, or track_features on prepared frames); returns the per-frame
    states."""
    _, _, left, right, times = seq
    states = []
    for i in range(len(left)):
        if frames is not None:
            out = system.track_features(frames[i], timestamp=times[i])
        elif right is None:
            out = system.track_monocular(torch.as_tensor(left[i]), times[i])
        else:
            out = system.track_stereo(torch.as_tensor(left[i]),
                                      torch.as_tensor(right[i]), times[i],
                                      BASELINE)
        states.append(out[0])
    system.shutdown()
    return states


def summary(system, states, seq, kind):
    """Init frame, tracked frames, keyframes, landmarks, centres, the
    centres aligned onto the ground truth (mono: Sim3; stereo: rigid,
    metric) and the ATE."""
    traj = system.tracker.trajectory
    C = np.stack([-np.asarray(R).T @ np.asarray(t) for _, R, t in traj])
    idx = np.round(np.asarray([tm for tm, _, _ in traj]) * 30).astype(int)
    gt = ev.centers_from_tcw(seq[0][idx], seq[1][idx])
    s, R, t = ev.align_horn(C, gt, with_scale=kind == "mono")
    aligned = (s * (R @ C.T)).T + t
    ate = ev.ate_rmse(C, gt, with_scale=kind == "mono")
    init = states.index("OK") if "OK" in states else None
    return dict(init=init, tracked=states.count("OK"),
                kf=system.n_keyframes(), lm=system.n_landmarks(),
                ate=ate, centres=C, aligned=aligned, frames=idx,
                err=np.linalg.norm(aligned - gt, axis=1))


def perturbed(frames, seed, px=1e-3):
    """The port's frames with N(0, px) pixels of noise added to every
    keypoint (seed 0: the frames themselves): a change far below anything
    the images or the frontends decide, which shows how far a run's result
    moves on rounding alone."""
    if not seed:
        return frames
    rng = np.random.RandomState(seed)
    return [f._replace(xy=f.xy + torch.as_tensor(
        rng.normal(0.0, px, tuple(f.xy.shape)).astype(np.float32)))
        for f in frames]


def to_jax_frame(f):
    import jax.numpy as jnp
    from dani_slam_tpu.slam import frame as jfr
    return jfr.FrameFeatures(*[None if x is None else jnp.asarray(x.numpy())
                               for x in f])


def jax_run_on(c, seq, frames):
    """The JAX System on the port's FrameFeatures: (summary, states)."""
    js = jax_system(c)
    states = run(js, seq, [to_jax_frame(f) for f in frames])
    return summary(js, states, seq, c["kind"]), states


def port_run_on(c, seq, frames):
    """The port's System on FrameFeatures, the mono init replaying the JAX
    draws: (summary, states)."""
    ts = torch_system(c)
    ts.tracker.init_sampler = jax_init_sampler()
    states = run(ts, seq, frames)
    return summary(ts, states, seq, c["kind"]), states


def spread(name, seeds):
    """The JAX System and the port's System on the same frames — the JAX
    package's, each keypoint moved by N(0, 1e-3) px for seed > 0, the mono
    init replaying the JAX draws — for each seed: the two packages' results
    side by side, and how far each moves on rounding-sized changes."""
    c = CONFIGS[name]
    seq = sequence(c)
    js = jax_system(c)
    base = [to_torch_frame(f) for f in jax_frames(js, c, seq)]
    out = []
    for seed in seeds:
        frames = perturbed(base, seed)
        j, _ = jax_run_on(c, seq, frames)
        t, _ = port_run_on(c, seq, frames)
        keys = ("init", "tracked", "kf", "lm", "ate")
        row = dict(seed=seed, jax={k: j[k] for k in keys},
                   port={k: t[k] for k in keys})
        print(row, flush=True)
        out.append(row)
    return out


def port_frames(c, seq, device):
    """The port's own frames of the sequence (its frontend on `device`, as
    track_monocular / track_stereo build them), on the CPU."""
    from dani_slam_tpu_torch.slam import frame as tfr
    ts = torch_system(c, device)
    _, _, left, right, times = seq
    out = []
    for i in range(len(left)):
        img = torch.as_tensor(left[i], device=device)
        if right is None:
            f = tfr.build_frame_mono(
                ts._sp(), img, ts.cam, times[i], n_max=ts.n_features,
                threshold=ts.sp_threshold, n_levels=ts.n_levels,
                scale_factor=ts.scale_factor)
        else:
            f = tfr.build_frame_stereo(
                ts._sp(), img, torch.as_tensor(right[i], device=device),
                ts.cam, BASELINE, times[i], n_max=ts.n_features,
                matcher=ts.matcher)
        out.append(tfr.FrameFeatures(*[None if x is None else x.cpu()
                                       for x in f]))
    return out


def cross(name, path=None):
    """The JAX System and the port's System (CPU) on the port's frames:
    its frontend's on the CPU, or those `dump` saved on the card."""
    from dani_slam_tpu_torch.slam.frame import FrameFeatures
    c = CONFIGS[name]
    seq = sequence(c)
    if path is None:
        frames = port_frames(c, seq, "cpu")
    else:
        frames = [FrameFeatures(*[None if x is None else torch.as_tensor(x)
                                  for x in row])
                  for row in np.load(path, allow_pickle=True)]
    keys = ("init", "tracked", "kf", "lm", "ate")
    j, _ = jax_run_on(c, seq, frames)
    t, _ = port_run_on(c, seq, frames)
    print(dict(frames=path or "port, CPU", jax={k: j[k] for k in keys},
               port={k: t[k] for k in keys}), flush=True)


def dump(name, path):
    """The port's frames of the sequence built on the card, saved to
    `path`, and the port's System run on the card on them (needs no
    JAX)."""
    c = CONFIGS[name]
    seq = sequence(c)
    frames = port_frames(c, seq, "cuda")
    rows = np.empty(len(frames), dtype=object)
    for i, f in enumerate(frames):
        rows[i] = tuple(None if x is None else x.numpy() for x in f)
    np.save(path, rows, allow_pickle=True)
    ts = torch_system(c, "cuda")
    states = run(ts, seq, [type(f)(*[None if x is None else x.cuda()
                                     for x in f]) for f in frames])
    out = summary(ts, states, seq, c["kind"])
    print({k: out[k] for k in ("init", "tracked", "kf", "lm", "ate")})


def steps(name):
    """The JAX System on its frames; at every tracked frame and at every
    keyframe step the port's function runs on the same inputs (the JAX
    run's state converted), and one line a call says how far its output
    lies from the JAX package's: pose, bindings and inlier counts of a
    tracked frame; landmarks, observations and keyframe poses of a
    keyframe step."""
    import jax
    import dani_slam_tpu.slam.system as jsys
    import dani_slam_tpu.slam.tracking as jtr
    from dani_slam_tpu_torch.core import state as tst
    from dani_slam_tpu_torch.slam import mapping as tmap
    from dani_slam_tpu_torch.slam import tracking as ttr
    from dani_slam_tpu_torch.slam.frame import FrameFeatures
    c = CONFIGS[name]
    seq = sequence(c)
    js = jax_system(c)
    ts = torch_system(c)
    frames = jax_frames(js, c, seq)

    def T(x):
        return torch.as_tensor(np.array(x))

    def port_state(st):
        return tst.map_state_from_numpy(jax.device_get(st), device="cpu")

    track_jax, kf_jax = jtr.track_frame_step, jsys.mapping.keyframe_step

    def track(st, cam, feat, last_bind, R, t, Rv, tv, ref_kf, **kw):
        out = track_jax(st, cam, feat, last_bind, R, t, Rv, tv, ref_kf, **kw)
        o = jax.device_get(out)
        f = FrameFeatures(*[None if x is None else T(x)
                            for x in jax.device_get(feat)])
        p = ttr.track_frame_step(
            port_state(st), ts.cam, f, T(last_bind), T(R), T(t), T(Rv),
            T(tv), T(ref_kf).long(), min_inliers=kw["min_inliers"],
            use_depth=kw["use_depth"], has_vel=kw["has_vel"],
            seed_rounds=kw["seed_rounds"], matcher=ts.matcher,
            select_on_device=True)
        print(f"track: inliers {np.asarray(o[3])[:2].tolist()} / "
              f"{p[3].numpy()[:2].tolist()} (JAX / port), R within "
              f"{np.abs(np.asarray(o[0]) - p[0].numpy()).max():.1e}, t "
              f"{np.abs(np.asarray(o[1]) - p[1].numpy()).max():.1e}, "
              f"bindings differ {int((np.asarray(o[2]) != p[2].numpy()).sum())}"
              f" of {int((np.asarray(o[2]) >= 0).sum())}", flush=True)
        return out

    def keyframe(st, cam, xy, valid, desc, depth, bind, R, t, time, fid,
                 **kw):
        out = kf_jax(st, cam, xy, valid, desc, depth, bind, R, t, time, fid,
                     **kw)
        sj = jax.device_get(out[0])
        p = tmap.keyframe_step(
            port_state(st), ts.cam, T(xy), T(valid), T(desc), T(depth),
            T(bind), T(R), T(t), T(time), int(fid),
            use_depth=kw["use_depth"], do_ba=kw["do_ba"],
            do_aux=kw["do_aux"], max_depth=float(kw["max_depth"]),
            feat_octave=T(kw["feat_octave"]), matcher=ts.matcher,
            chain=tuple(T(x) for x in kw["chain"]), ba_iters=kw["ba_iters"],
            cull_redundancy=kw["cull_redundancy"],
            cull_max_kills=kw["cull_max_kills"],
            cull_close_only=kw["cull_close_only"],
            cull_close_depth=kw["cull_close_depth"],
            fuse_two_hop=kw["fuse_two_hop"])[0]
        kb = np.asarray(sj.kf_mask) & p.kf_mask.numpy()
        print(f"keyframe step at frame {int(fid)}: landmarks "
              f"{int(np.asarray(sj.lm_mask).sum())} / "
              f"{int(p.lm_mask.sum())}, slots differing "
              f"{int((np.asarray(sj.lm_mask) != p.lm_mask.numpy()).sum())}, "
              f"observations differing "
              f"{int((np.asarray(sj.obs_lm) != p.obs_lm.numpy()).sum())}, "
              f"keyframe t within "
              f"{np.abs(np.asarray(sj.kf_t)[kb] - p.kf_t.numpy()[kb]).max():.1e}",
              flush=True)
        return out

    jtr.track_frame_step, jsys.mapping.keyframe_step = track, keyframe
    try:
        states = run(js, seq, frames)
    finally:
        jtr.track_frame_step, jsys.mapping.keyframe_step = track_jax, kf_jax
    print({k: v for k, v in summary(js, states, seq, c["kind"]).items()
           if k in ("init", "tracked", "kf", "lm", "ate")})


def jax_summary(name):
    c = CONFIGS[name]
    seq = sequence(c)
    js = jax_system(c)
    frames = jax_frames(js, c, seq)
    states = run(js, seq, frames)
    return summary(js, states, seq, c["kind"]), states, frames


@pytest.fixture(scope="module", params=[
    "mono-small", "stereo-small",
    pytest.param("mono-full", marks=pytest.mark.slow),
    pytest.param("stereo-full", marks=pytest.mark.slow)])
def runs(request):
    """The JAX System on its frames; the port's System on the images
    (its own frontend) and on the JAX package's frames (the SLAM layers
    alone, the mono init replaying the JAX draws)."""
    name = request.param
    c = CONFIGS[name]
    seq = sequence(c)
    j_sum, j_states, jframes = jax_summary(name)
    ts = torch_system(c)
    t_states = run(ts, seq)
    t_sum = summary(ts, t_states, seq, c["kind"])
    frames = [to_torch_frame(f) for f in jframes]
    f_sum, f_states = port_run_on(c, seq, frames)
    # the JAX package's own spread: its frames moved by rounding-sized
    # amounts (full-size configurations only)
    j_sum["spread"] = [jax_run_on(c, seq, perturbed(frames, s))[0]
                       for s in c["spread"]]
    print(f"{name}: init {t_sum['init']}/{j_sum['init']}, tracked "
          f"{t_sum['tracked']}/{j_sum['tracked']}, kf {t_sum['kf']}/"
          f"{j_sum['kf']}, lm {t_sum['lm']}/{j_sum['lm']}, ATE "
          f"{t_sum['ate']:.4f}/{j_sum['ate']:.4f} m (port/JAX); port on the "
          f"JAX frames {f_sum['ate']:.4f} m; JAX on its frames moved by 1e-3 "
          f"px {[round(r['ate'], 4) for r in j_sum['spread']]} m")
    return c, ts, (t_states, t_sum), (j_states, j_sum), (f_states, f_sum)


def reference_envelope(j_sum):
    """The JAX package's largest centre error and largest ATE over its run
    and its spread runs (the frames moved by 1e-3 px)."""
    refs = [j_sum] + j_sum["spread"]
    return max(r["err"].max() for r in refs), max(r["ate"] for r in refs)


def test_init_frame_and_states_equal(runs):
    """The port's run on the images: the init frame and every tracker state
    as the JAX run's; at full size, where the mono init draws from the
    port's own generator on the port's frames, the init frame within 2 and
    the tracked frames at most 3 below (the margins of chip_smoke.py)."""
    c, ts, (t_states, t_sum), (j_states, j_sum), _ = runs
    assert t_sum["tracked"] >= 0.6 * c["n"]
    assert j_sum["init"] is not None and t_sum["init"] is not None
    if not c["spread"]:
        assert t_sum["init"] == j_sum["init"]
        assert t_states == j_states
        return
    assert abs(t_sum["init"] - j_sum["init"]) <= 2
    assert t_sum["tracked"] >= j_sum["tracked"] - 3


def sizes_close(c, j_sum, kf, lm):
    """Keyframes within kf_tol and landmarks within lm_tol of the JAX
    package's counts (at full size: of the range over its run and its
    spread runs)."""
    refs = [j_sum] + j_sum["spread"]
    kfs, lms = [r["kf"] for r in refs], [r["lm"] for r in refs]
    return (min(kfs) - c["kf_tol"] <= kf <= max(kfs) + c["kf_tol"] and
            min(lms) * (1 - c["lm_tol"]) <= lm <= max(lms) * (1 + c["lm_tol"]))


def test_map_sizes_close(runs):
    c, ts, (_, t_sum), (_, j_sum), _ = runs
    assert t_sum["kf"] >= 2
    assert sizes_close(c, j_sum, t_sum["kf"], t_sum["lm"])


def test_camera_centres_close(runs):
    """Each run's centres aligned onto the ground truth (mono by a Sim3:
    the monocular map's scale is its own) agree within the envelope of the
    JAX package's own error (twice its largest centre error, plus
    centre_tol), and the port's ATE is no worse than the JAX package's by
    more than centre_tol. At full size the JAX package's error is the
    largest over its run and its spread runs: there a run's ATE moves by
    tenths of a metre on rounding-sized changes of its input (PERF.md)."""
    c, ts, (_, t_sum), (_, j_sum), _ = runs
    if not c["spread"]:
        assert np.array_equal(t_sum["frames"], j_sum["frames"])
    assert np.all(np.isfinite(t_sum["centres"]))
    j_err, j_ate = reference_envelope(j_sum)
    _, ti, ji = np.intersect1d(t_sum["frames"], j_sum["frames"],
                               return_indices=True)
    d = np.linalg.norm(t_sum["aligned"][ti] - j_sum["aligned"][ji],
                       axis=1).max()
    print(f"max centre difference {d:.4f} m (JAX's largest error "
          f"{j_err:.4f} m, largest ATE {j_ate:.4f} m)")
    assert d < 2 * j_err + c["centre_tol"]
    assert t_sum["ate"] < j_ate + c["centre_tol"]


def test_same_frames_same_trajectory(runs):
    """On the JAX package's own frames (the mono init replaying its draws)
    the port's System reproduces its run: the same states and init frame;
    on the small scenes the same keyframes, landmarks within 1 % and
    centres (aligned onto the ground truth) within same_tol metres. At full
    size a triangulation decision on its threshold (a parallax cosine on
    the 0.99995 gate) lands the other way within the first keyframe steps,
    and from there a run moves as far as the JAX package's own run does on
    frames moved by 1e-3 px: keyframes and landmarks as in
    test_map_sizes_close, the ATE within centre_tol of the JAX package's
    largest."""
    c, _, _, (j_states, j_sum), (f_states, f_sum) = runs
    assert f_states == j_states
    assert f_sum["init"] == j_sum["init"]
    if not c["spread"]:
        assert f_sum["kf"] == j_sum["kf"]
        assert abs(f_sum["lm"] - j_sum["lm"]) <= 0.01 * j_sum["lm"]
        d = np.linalg.norm(f_sum["aligned"] - j_sum["aligned"], axis=1).max()
        print(f"same frames: max centre difference {d:.2e} m")
        assert d < c["same_tol"]
        return
    _, j_ate = reference_envelope(j_sum)
    print(f"same frames: ATE {f_sum['ate']:.4f} m, the JAX package's "
          f"largest {j_ate:.4f} m")
    assert sizes_close(c, j_sum, f_sum["kf"], f_sum["lm"])
    assert f_sum["ate"] < j_ate + c["centre_tol"]


def test_port_system_uses_the_sensor_path(runs):
    """Mono keeps no depth; stereo frames carry stereo depth; octaves of
    the 8-level mono pyramid reach the map."""
    c, ts, _, _, _ = runs
    st = ts.map_state
    assert ts.tracker.use_depth == (c["kind"] == "stereo")
    assert ts.tracker.kf_tracked_ratio == (0.9 if c["kind"] == "mono"
                                           else 0.75)
    assert ts.fix_scale == (c["kind"] == "stereo")
    assert ts.loop_closer is None or \
        ts.loop_closer.fix_scale == (c["kind"] == "stereo")
    kp = (st.kf_kp_mask & st.kf_mask[:, None]).numpy()
    depth = st.kf_depth.numpy()[kp]
    octave = st.kf_octave.numpy()[kp]
    if c["kind"] == "mono":
        assert not np.isfinite(depth).any()
        assert (octave > 0).sum() > 0
    else:
        assert np.isfinite(depth).mean() > 0.2
        assert (octave == 0).all()


if __name__ == "__main__":
    # python tests/test_torch_mono_stereo_system.py jax <config> [out.npz]
    # python tests/test_torch_mono_stereo_system.py spread <config> <seed>...
    # python tests/test_torch_mono_stereo_system.py cross <config> [frames]
    # python tests/test_torch_mono_stereo_system.py dump <config> <frames>
    # python tests/test_torch_mono_stereo_system.py steps <config>
    which, name = sys.argv[1:3]
    torch.set_num_threads(2)
    if which in ("spread", "cross", "dump", "steps"):
        if which == "steps":
            steps(name)
        elif which == "spread":
            spread(name, [int(x) for x in sys.argv[3:]])
        elif which == "cross":
            cross(name, *sys.argv[3:4])
        else:
            dump(name, sys.argv[3])
        sys.exit(0)
    assert which == "jax"
    out, states, _ = jax_summary(name)
    if len(sys.argv) > 3:
        np.savez(sys.argv[3], centres=out["centres"], frames=out["frames"],
                 states=np.asarray(states))
    print("states", "".join(s[0] for s in states))
    print({k: v for k, v in out.items()
           if k not in ("centres", "aligned", "frames")})
