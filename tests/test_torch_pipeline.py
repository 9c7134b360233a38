"""Pipelined tracking of the port beyond the plain slice
(tests/test_torch_slice.py): deferred decisions against immediate ones inside
the port (the rule of tests/test_slam_e2e.py::TestPipelined: translations
within 5 cm), and a forced loss (blank frames) that rolls the pipeline back,
followed by a timestamp jump that stashes the map in the Atlas and starts a
new one — states, atlas and map sizes frame by frame against the JAX
package (same tolerances as tests/test_torch_slice.py).
"""
import jax.numpy as jnp
import numpy as np
import torch

from dani_slam_tpu.core import cameras as jcam
from dani_slam_tpu_torch.core import cameras as tcam
from dani_slam_tpu_torch.core import state as tst
from dani_slam_tpu_torch.slam.system import Sensor as TSensor
from dani_slam_tpu_torch.slam.system import System as TSystem
from dani_slam_tpu_torch.utils import synthetic
from test_torch_slice import CONFIGS, _centres, _systems

torch.set_num_threads(2)       # several test workers share the machine


def test_pipelined_matches_plain_in_port():
    """Deferred-decision mode gives an equivalent trajectory (the case of
    tests/test_slam_e2e.py::TestPipelined, on pre-extracted features):
    translations within 5 cm, camera centres within 5 cm."""
    from dani_slam_tpu.utils import synthetic as jsyn
    from dani_slam_tpu_torch.slam.frame import FrameFeatures
    jc = jcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)
    world = jsyn.make_world(1500, desc_dim=64, seed=0)
    R_gt, t_gt = jsyn.orbit_trajectory(25, radius=10.0, angle_span=0.5)
    feats = []
    for i in range(25):
        f, _ = jsyn.render_frame(world, jc, R_gt[i], t_gt[i], n_max=256,
                                 noise_px=0.3, seed=i, with_depth=True,
                                 time=i / 30.0)
        feats.append(FrameFeatures(
            *(torch.as_tensor(np.asarray(x)) for x in
              (f.xy, f.desc, f.depth, f.valid, f.time))))
    outs = {}
    for pipelined in (False, True):
        sys_ = TSystem(
            tcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480,
                                device="cpu"),
            TSensor.RGBD, caps=tst.MapCaps(K=64, L=8192, N=256, D=64),
            n_features=256, pipelined=pipelined, device="cpu")
        assert sys_.matcher is None          # "auto" with D != 256
        for i, f in enumerate(feats):
            sys_.track_features(f, timestamp=i / 30.0)
        sys_.shutdown()
        outs[pipelined] = sys_.tracker.trajectory
    assert len(outs[True]) >= 23
    n = min(len(outs[True]), len(outs[False]))
    t_p = np.stack([p[2] for p in outs[True]][:n])
    t_s = np.stack([p[2] for p in outs[False]][:n])
    assert np.abs(t_p - t_s).max() < 0.05
    assert np.linalg.norm(_centres(outs[True][:n]) -
                          _centres(outs[False][:n]), axis=1).max() < 0.05


def test_forced_loss_rolls_back_then_time_jump_stashes_map():
    """Eight good frames, six blank ones (no keypoints: the deferred
    decisions find the loss and roll back), then a jump of ten seconds in
    the timestamps: the map (>= min_kfs_to_stash keyframes) goes into the
    Atlas and a new one starts on the next good frames. Same states frame
    by frame, same atlas and same map sizes as the JAX package."""
    c = CONFIGS["short-pipelined"]
    W, H, F = c["W"], c["H"], c["F"]
    R_gt, t_gt = synthetic.orbit_trajectory(c["n_scene"], radius=10.0,
                                            angle_span=c["span"])
    imgs, deps, times = synthetic.make_rgbd_image_sequence(
        [F, F, W / 2, H / 2], W, H, R_gt, t_gt, seed=0)
    blank_i, blank_d = np.zeros_like(imgs[0]), np.zeros_like(deps[0])
    frames = [(imgs[i], deps[i], times[i]) for i in range(8)] + \
        [(blank_i, blank_d, times[7] + (j + 1) / 30.0) for j in range(6)] + \
        [(imgs[i], deps[i], 10.0 + times[i]) for i in range(6, 12)]
    js, ts = _systems(c)
    js.min_kfs_to_stash = ts.min_kfs_to_stash = 2
    states = {"jax": [], "torch": []}
    maps = {"jax": [], "torch": []}
    for img, dep, tm in frames:
        states["jax"].append(js.track_rgbd(jnp.asarray(img),
                                           jnp.asarray(dep), tm)[0])
        states["torch"].append(ts.track_rgbd(img, dep.astype(np.int32),
                                             tm)[0])
        maps["jax"].append(js.atlas.n_maps())
        maps["torch"].append(ts.atlas.n_maps())
    js.shutdown()
    ts.shutdown()
    print(states["torch"], maps["torch"])
    assert states["torch"] == states["jax"]
    assert maps["torch"] == maps["jax"]
    # every returned state is the optimistic "OK" of deferred decisions;
    # the loss shows as a rollback when the blank frames' counts resolve
    assert ts.tracker.rollbacks >= 1
    assert ts.atlas.n_maps() == js.atlas.n_maps() == 1
    assert maps["torch"][13] == 0 and maps["torch"][14] == 1
    assert ts.tracker.state == js.tracker.state == "OK"
    stashed_t = ts.atlas.stored[0]["st"]
    stashed_j = js.atlas.stored[0]["st"]
    assert int(stashed_t.kf_mask.sum()) == int(stashed_j.kf_mask.sum()) >= 2
    assert abs(int(stashed_t.lm_mask.sum()) - int(stashed_j.lm_mask.sum())) \
        <= 0.1 * int(stashed_j.lm_mask.sum())
    assert abs(ts.n_keyframes() - js.n_keyframes()) <= 1
    # the trajectory holds no pose of a rolled-back frame
    assert len(ts.tracker.trajectory) == len(js.tracker.trajectory)
