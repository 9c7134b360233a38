"""Loop closing, relocalization and map merging of the port against the JAX
package at the System level, on the same frames: the blackout
relocalization of tests/test_loop_reloc.py and the Atlas loss-then-merge of
tests/test_atlas.py, each run through both packages' System (the port's on
the CPU, with loop closing and relocalization on by default as in the
reference), and the tracker's relocalization hook on its two paths.
Tolerances: the same tracker state (or the same number of stored maps) on
every frame; the JAX tests' own pose and reprojection gates for the port.
"""
import jax.numpy as jnp
import numpy as np
import torch

from dani_slam_tpu.core import lie as jlie
from dani_slam_tpu.core import state as jst
from dani_slam_tpu.utils import synthetic as jsyn
from dani_slam_tpu_torch.core import cameras as tcam
from dani_slam_tpu_torch.core import state as tst
from test_torch_loop import CAPS, JC, TC, N, T, TFeat

torch.set_num_threads(2)       # several test workers share the machine



def _systems(caps=CAPS, **kw):
    from dani_slam_tpu.slam.system import Sensor as JSensor
    from dani_slam_tpu.slam.system import System as JSystem
    from dani_slam_tpu_torch.slam.system import Sensor as TSensor
    from dani_slam_tpu_torch.slam.system import System as TSystem
    return (JSystem(JC, JSensor.RGBD, caps=caps, **kw),
            TSystem(TC, TSensor.RGBD, caps=tst.MapCaps(*caps), device="cpu",
                    **kw))


def _tfeat(f):
    return TFeat(*(T(np.asarray(x)) for x in (f.xy, f.desc, f.depth,
                                                f.valid, f.time)))


def test_blackout_relocalization_system():
    """tests/test_loop_reloc.py::TestRelocalization::
    test_recovers_after_blackout in both packages on the same frames:
    six blank frames lose track, the system is OK again afterwards with a
    pose within 10 cm of the truth; the same state on every frame."""
    world = jsyn.make_world(1500, desc_dim=64, seed=0)
    R_gt, t_gt = jsyn.orbit_trajectory(40, radius=10.0, angle_span=0.6)
    js, ts = _systems(n_features=512)
    R0, t0 = np.asarray(R_gt[0]), np.asarray(t_gt[0])
    states = {"jax": [], "torch": []}
    errs = {"jax": [], "torch": []}
    for i in range(40):
        dark = 18 <= i < 24
        feat, _ = jsyn.render_frame(world, JC, R_gt[i], t_gt[i], n_max=512,
                                    noise_px=0.3, seed=9000 + i,
                                    with_depth=True, time=i / 30.0)
        if dark:
            feat = feat._replace(valid=jnp.zeros_like(feat.valid))
        for name, sys_, f in (("jax", js, feat), ("torch", ts, _tfeat(feat))):
            s, R, t = sys_.track_features(f)
            states[name].append(s)
            if i >= 24 and s == "OK":
                C_est = -N(R).T @ N(t)
                C_gt = R0 @ (-np.asarray(R_gt[i]).T @ np.asarray(t_gt[i])) \
                    + t0
                errs[name].append(np.linalg.norm(C_est - C_gt))
    for name in ("jax", "torch"):
        st_ = states[name]
        assert "RECENTLY_LOST" in st_[18:24] or "LOST" in st_[18:24]
        assert st_[-1] == "OK"
        assert errs[name] and min(errs[name]) < 0.1
    assert states["torch"] == states["jax"]


def test_atlas_loss_then_merge_system():
    """tests/test_atlas.py::TestAtlasE2E in both packages on the same
    frames: a teleport to a disjoint area starts a new map, the return
    starts a third, which place recognition welds into the stored first
    map (search_and_fuse and a welding local BA through the landmark-block
    kernel); relocalization against a first-map view still works after the
    weld, and the moved keyframe reprojects tightly. The same number of
    maps on every frame in both packages."""
    world_a = jsyn.make_world(1500, desc_dim=64, seed=4)
    wb = jsyn.make_world(1500, desc_dim=64, seed=14)
    world_b = wb._replace(points=wb.points + jnp.asarray([500.0, 0.0, 0.0]))
    R_a, t_a = jsyn.orbit_trajectory(30, radius=10.0, angle_span=0.4)
    t_b = jnp.stack([t_a[i] - R_a[i] @ jnp.asarray([500.0, 0.0, 0.0])
                     for i in range(30)])
    seeds = {"A": 111, "B": 555, "A2": 111}
    js, ts = _systems(caps=jst.MapCaps(K=64, L=4096, N=256, D=64),
                      n_features=256, enable_relocalization=False)
    for s_ in (js, ts):
        s_.lost_frames_before_new_map = 3
        s_.min_kfs_to_stash = 2
    phases = ([("A", world_a, R_a, t_a, i) for i in range(25)] +
              [("B", world_b, R_a, t_b, i) for i in range(25)] +
              [("A2", world_a, R_a, t_a, i) for i in range(25)])
    maps = {"jax": [], "torch": []}
    for fi, (tag, world, Rs, ts_, i) in enumerate(phases):
        feat, _ = jsyn.render_frame(world, JC, Rs[i], ts_[i], n_max=256,
                                    noise_px=0.3, seed=seeds[tag] + i,
                                    with_depth=True, time=fi / 30.0)
        js.track_features(feat)
        ts.track_features(_tfeat(feat))
        maps["jax"].append(js.atlas.n_maps())
        maps["torch"].append(ts.atlas.n_maps())
    assert maps["torch"] == maps["jax"]
    assert max(maps["torch"]) >= 2
    assert ts.atlas.n_maps() < max(maps["torch"]) and ts.merges >= 1
    assert ts.tracker.state == js.tracker.state == "OK"
    assert abs(ts.n_keyframes() - js.n_keyframes()) <= 1
    assert ts.n_keyframes() >= 4
    # the stored map's BoW rows survived the weld: relocalization against
    # an original first-map view succeeds, at the true relative pose
    feat, _ = jsyn.render_frame(world_a, JC, R_a[2], t_a[2], n_max=256,
                                noise_px=0.3, seed=seeds["A"] + 2,
                                with_depth=True, time=99.0)
    out = ts._relocalize(ts.tracker, _tfeat(feat))
    assert out is not None
    _, t_exp = jlie.se3_mul(R_a[2], t_a[2], *jlie.se3_inv(R_a[0], t_a[0]))
    np.testing.assert_allclose(N(out[1]), np.asarray(t_exp), atol=0.1)
    st = ts.tracker.st
    k = ts.tracker.ref_kf
    obs = N(st.obs_lm[k])
    sel = obs >= 0
    assert sel.sum() > 30
    pc = N(st.kf_R[k]) @ N(st.lm_pos)[obs[sel]].T + N(st.kf_t[k])[:, None]
    px = N(tcam.project(TC, T(pc.T.astype(np.float32))))
    assert np.median(np.linalg.norm(px - N(st.kf_kp[k])[sel], axis=1)) < 2.0


def test_reloc_hook_on_plain_and_pipelined_paths():
    """Tracker.reloc_fn (the port only): a lost frame reaches it with its own
    features on the plain path and on the pipelined resolve path; a
    successful relocalization restarts the tracker from the returned pose
    with no velocity, re-anchored on the returned keyframe; the hook
    survives reset()."""
    from dani_slam_tpu_torch.slam import tracking
    from dani_slam_tpu_torch.slam.system import Sensor as TSensor
    from dani_slam_tpu_torch.slam.system import System as TSystem
    world = jsyn.make_world(1500, desc_dim=64, seed=0)
    R_gt, t_gt = jsyn.orbit_trajectory(16, radius=10.0, angle_span=0.3)
    for pipelined in (False, True):
        ts = TSystem(TC, TSensor.RGBD, caps=tst.MapCaps(K=32, L=4096, N=256,
                                                        D=64),
                     n_features=256, pipelined=pipelined, device="cpu")
        tr = ts.tracker
        seen = []

        def hook(tracker, feat, _tr=tr):
            seen.append(int(feat.valid.sum()))
            # relocalize the first blank frame onto the newest keyframe
            if len(seen) == 1:
                k = _tr.ref_kf
                return _tr.st.kf_R[k], _tr.st.kf_t[k], \
                    torch.full_like(feat.valid, -1, dtype=torch.int32), k
            return None

        tr.reloc_fn = hook
        entries = []          # (relocalizations, no velocity) per track
        plain = tr._track_frame

        def track_frame(feat, _tr=tr, _plain=plain):
            entries.append((_tr.relocalizations, _tr.vel is None))
            return _plain(feat)

        tr._track_frame = track_frame
        for i in range(16):
            f, _ = jsyn.render_frame(world, JC, R_gt[i], t_gt[i], n_max=256,
                                     noise_px=0.3, seed=i, with_depth=True,
                                     time=i / 30.0)
            if i in (10, 11):
                f = f._replace(valid=jnp.zeros_like(f.valid))
            ts.track_features(_tfeat(f))
        ts.shutdown()
        assert seen and seen[0] == 0          # the blank frame's features
        assert tr.relocalizations == 1
        # the first frame tracked after the relocalization had no velocity
        assert next(v for r, v in entries if r == 1)
        assert tr.state == tracking.OK
        tr.reset()
        assert tr.reloc_fn is hook
