"""The last utilities of the port against the JAX package on the same
inputs: mapping.lba_window_stats, state.cull_keyframe,
synthetic.forward_trajectory and synthetic.make_world, utils/verbose,
utils/stage_profile (the per-stage timing of the RGB-D path and its four
stat files), and, port only, utils/viewer.draw_map and
utils/timing.device_trace on the CPU.

The stage profile runs in both packages on one short RGB-D sequence (the
port's numpy renderer: 12 frames of 320x240 images along the bench's orbit
with the moving board, so that the compact detector fires): System(RGBD,
detector=<compact YOLO>, matcher=None, pipelined=True) at K 32 / L 4096 /
N 256 / D 256, a keyframe at least every second frame, loop closing and
relocalization off. Times are not compared; the stage names, the samples
per stage and the files' columns are. The JAX run's final map is the map
state the window statistics and the keyframe cull are held on (integer
outputs and masks exactly, the rest to the last bit: neither function
does float arithmetic).
"""
import io
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)       # several test workers share the machine

W, H, F = 320, 240, 250.0
N_FRAMES = 12
CAPS = dict(K=32, L=4096, N=256, D=256)


def sequence():
    from dani_slam_tpu_torch.utils import synthetic as tsyn
    R, t = tsyn.orbit_trajectory(N_FRAMES, radius=10.0,
                                 angle_span=0.35 * N_FRAMES / 60)
    return tsyn.make_rgbd_image_sequence([F, F, W / 2, H / 2], W, H, R, t,
                                         seed=0)


@pytest.fixture(scope="module")
def profiles():
    """(JAX timers, port timers, JAX System, port System) of the stage
    profile on the same sequence."""
    import jax.numpy as jnp
    from dani_slam_tpu.core import cameras as jcam
    from dani_slam_tpu.core import state as jst
    from dani_slam_tpu.models import yolo as jyolo
    from dani_slam_tpu.slam.system import Sensor as JSensor
    from dani_slam_tpu.slam.system import System as JSystem
    from dani_slam_tpu.utils import stage_profile as jsp
    from dani_slam_tpu_torch.core import cameras as tcam
    from dani_slam_tpu_torch.core import state as tst
    from dani_slam_tpu_torch.models import yolo as tyolo
    from dani_slam_tpu_torch.slam.system import Sensor, System
    from dani_slam_tpu_torch.utils import stage_profile as tsp
    imgs, deps, times = sequence()
    off = dict(matcher=None, pipelined=True, enable_loop_closing=False,
               enable_relocalization=False, n_features=256)
    js = JSystem(jcam.Camera.pinhole(F, F, W / 2, H / 2, W, H),
                 JSensor.RGBD, caps=jst.MapCaps(**CAPS),
                 detector=jyolo.load_default_detector(), **off)
    js.tracker.max_frames_between_kf = 2
    j = jsp.profile_rgbd_stages(
        js, [jnp.asarray(x) for x in imgs], [jnp.asarray(x) for x in deps],
        [jnp.asarray(x, jnp.float32) for x in times])
    ts = System(tcam.Camera.pinhole(F, F, W / 2, H / 2, W, H, device="cpu"),
                Sensor.RGBD, caps=tst.MapCaps(**CAPS),
                detector=tyolo.load_default_detector("cpu"), device="cpu",
                **off)
    ts.tracker.max_frames_between_kf = 2
    t = tsp.profile_rgbd_stages(ts, imgs, [d.astype(np.int32) for d in deps],
                                times)
    return j, t, js, ts


def test_stage_profile_matches(profiles, tmp_path):
    """The same stages with the same sample counts (the first sample of
    each and the warm-up frames discarded), every stage name of
    TRACKING_STAGES and MAPPING_STAGES, positive times, the same number of
    local-BA statistics rows; save_stats writes the same four files with
    the same columns and rows."""
    from dani_slam_tpu.utils import stage_profile as jsp
    from dani_slam_tpu_torch.utils import stage_profile as tsp
    (jt, jm), (tt, tm), _, _ = profiles
    assert tsp.TRACKING_STAGES == jsp.TRACKING_STAGES
    assert tsp.MAPPING_STAGES == jsp.MAPPING_STAGES
    for a, b in ((jt, tt), (jm, tm)):
        assert {k: len(v) for k, v in b.samples.items()} == \
            {k: len(v) for k, v in a.samples.items()}
        assert all(x > 0 for v in b.samples.values() for x in v)
    assert set(tt.samples) == set(tsp.TRACKING_STAGES)
    assert set(tm.samples) == set(tsp.MAPPING_STAGES)
    assert len(tm.lba_stats) == len(jm.lba_stats) >= 1
    for row in tm.lba_stats:
        assert row[0] > 0 and row[2] <= row[1] and row[4] <= row[3]
    jsp.save_stats(jt, jm, prefix=str(tmp_path / "jax_"))
    tsp.save_stats(tt, tm, prefix=str(tmp_path / "port_"))
    names = ("TrackingTimeStats.txt", "LocalMapTimeStats.txt",
             "LBA_Stats.txt", "ExecMean.txt")
    for name in names:
        a = (tmp_path / f"jax_{name}").read_text().splitlines()
        b = (tmp_path / f"port_{name}").read_text().splitlines()
        assert len(b) == len(a), name
        if name == "ExecMean.txt":
            assert [(r.split()[0], r.split()[3]) for r in b] == \
                [(r.split()[0], r.split()[3]) for r in a]
        else:
            assert b[0] == a[0], name
            assert [len(r.split(",")) for r in b] == \
                [len(r.split(",")) for r in a], name


@pytest.mark.parametrize("L_loc,P_opt", [(128, 8), (2048, 8), (96, 4)])
def test_lba_window_stats_matches(profiles, L_loc, P_opt):
    """tests/test_lba_window.py's coverage case on the JAX run's map: the
    same four counts at overflowing caps and at the production one, and
    that file's ranking assertion on the port's counts (window observations
    of culled landmarks count in the window, never as kept, in both
    packages)."""
    import jax.numpy as jnp
    from dani_slam_tpu.slam import mapping as jmap
    from dani_slam_tpu_torch.core import state as tst
    from dani_slam_tpu_torch.slam import mapping as tmap
    _, _, js, _ = profiles
    center = int(js.tracker.ref_kf)
    want = np.asarray(jmap.lba_window_stats(
        js.map_state, jnp.asarray(center, jnp.int32), P_opt=P_opt, P_fix=8,
        L_loc=L_loc))
    st = tst.map_state_from_numpy(js.map_state, "cpu")
    got = tmap.lba_window_stats(st, torch.tensor(center), P_opt=P_opt,
                                P_fix=8, L_loc=L_loc).numpy()
    np.testing.assert_array_equal(got, want)
    n_lm, n_kept_lm, n_obs, n_obs_kept = (int(x) for x in got)
    assert n_kept_lm == min(n_lm, L_loc) and n_obs_kept <= n_obs
    if n_lm > L_loc:      # the ranking keeps the multi-view landmarks
        assert n_obs_kept / L_loc > n_obs / n_lm


def _fields(st):
    from dani_slam_tpu_torch.core import state as tst
    if isinstance(st.kf_mask, torch.Tensor):
        return tst.map_state_to_numpy(st)
    return {k: np.asarray(getattr(st, k)) for k in tst.TENSOR_FIELDS}


def test_cull_keyframe_matches(profiles):
    """tests/test_state.py's reparenting case (three keyframes in a chain,
    the middle one culled) built in the JAX package and handed to the
    port, and every live keyframe of the JAX run's map culled in turn:
    every field of the result equal."""
    import jax.numpy as jnp
    from dani_slam_tpu.core import state as jst
    from dani_slam_tpu_torch.core import state as tst
    from test_state import CAPS as SCAPS
    from test_state import kf_args
    st = jst.empty_map(SCAPS)
    st, _ = jst.insert_landmarks(
        st, jnp.zeros((16, 3)), jnp.zeros((16, SCAPS.D)), jnp.zeros((16, 3)),
        jnp.zeros(16), jnp.ones(16), jnp.zeros(16, jnp.int32),
        jnp.zeros(16, jnp.int32), jnp.zeros(16, bool).at[:4].set(True))
    bind = jnp.full((16,), -1, jnp.int32).at[0].set(0)
    ks = []
    for i in range(3):
        st, k = jst.insert_keyframe(st, jnp.eye(3), jnp.zeros(3), float(i),
                                    jnp.asarray(i), *kf_args(bind=bind))
        ks.append(int(k))
    cases = [(st, ks[1])]
    big = profiles[2].map_state
    cases += [(big, int(k)) for k in np.nonzero(np.asarray(big.kf_mask))[0]]
    for st_j, k in cases:
        want = _fields(jst.cull_keyframe(st_j, jnp.asarray(k)))
        got = _fields(tst.cull_keyframe(tst.map_state_from_numpy(st_j, "cpu"),
                                        torch.tensor(k)))
        for f in tst.TENSOR_FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    got = tst.cull_keyframe(tst.map_state_from_numpy(st, "cpu"),
                            torch.tensor(ks[1]))
    assert not bool(got.kf_mask[ks[1]])
    assert int(got.spanning_parent[ks[2]]) == ks[0]


@pytest.mark.parametrize("n,step,yaw", [(40, 0.25, 0.0), (12, 0.08, 0.05)])
def test_forward_trajectory_matches(n, step, yaw):
    from dani_slam_tpu.utils import synthetic as jsyn
    from dani_slam_tpu_torch.utils import synthetic as tsyn
    Rj, tj = jsyn.forward_trajectory(n, step=step, yaw_rate=yaw)
    Rt, tt = tsyn.forward_trajectory(n, step=step, yaw_rate=yaw)
    assert Rt.dtype == tt.dtype == np.float32
    np.testing.assert_array_equal(Rt, np.asarray(Rj))
    np.testing.assert_array_equal(tt, np.asarray(tj))


def test_make_world_is_a_synthetic_world():
    """make_world returns SyntheticWorld(points, desc) as the JAX package
    does, with the same fields and values, and still unpacks as a pair."""
    from dani_slam_tpu.utils import synthetic as jsyn
    from dani_slam_tpu_torch.utils import synthetic as tsyn
    w = tsyn.make_world(300, desc_dim=16, seed=5)
    j = jsyn.make_world(300, desc_dim=16, seed=5)
    assert isinstance(w, tsyn.SyntheticWorld)
    assert w._fields == j._fields == ("points", "desc")
    pts, desc = w
    assert pts is w.points and desc is w.desc
    np.testing.assert_array_equal(w.points, np.asarray(j.points))
    np.testing.assert_array_equal(w.desc, np.asarray(j.desc))


def test_verbose_matches():
    """The same levels, threshold and messages: each level's message
    printed exactly when the threshold admits it, QUIET by default."""
    from dani_slam_tpu.utils import verbose as jv
    from dani_slam_tpu_torch.utils import verbose as tv
    names = ("QUIET", "NORMAL", "VERBOSE", "VERY_VERBOSE", "DEBUG")
    assert [getattr(tv, n) for n in names] == [getattr(jv, n) for n in names]
    assert tv.get_verbosity() == tv.QUIET
    outs = []
    for mod in (jv, tv):
        buf = io.StringIO()
        for th in range(5):
            mod.set_verbosity(th)
            assert mod.get_verbosity() == th
            for lvl in range(5):
                mod.print_mess(f"{th}/{lvl}", lvl, file=buf)
            mod.print_mess(f"{th}/default", file=buf)
        mod.set_verbosity(mod.QUIET)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    assert outs[1].count("\n") == 15 + 4


def test_draw_map_writes_png(profiles, tmp_path):
    """The port's map and trajectory drawn to a PNG."""
    pytest.importorskip("matplotlib")
    from dani_slam_tpu_torch.utils import viewer
    ts = profiles[3]
    path = tmp_path / "map.png"
    fig = viewer.draw_map(ts.map_state, ts.tracker.trajectory,
                          path=str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    labels = fig.axes[0].get_legend_handles_labels()[1]
    assert f"{ts.n_keyframes()} keyframes" in labels
    assert f"{ts.n_landmarks()} landmarks" in labels


def test_device_trace_on_cpu(tmp_path):
    """utils/timing.device_trace writes a Chrome trace of the block's
    operators on the CPU (the card's kernels are recorded only there)."""
    from dani_slam_tpu_torch.utils import timing
    a = torch.randn(64, 64)
    with timing.device_trace(str(tmp_path / "trace")) as prof:
        (a @ a).sum()
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
