"""TUM monocular runner (counterpart of examples/mono_tum.py; reference:
Examples/Monocular/mono_tum.cc): rgb.txt of the sequence through
System.track_monocular with the settings' pyramid, CameraTrajectory.txt in
TUM format.

    python -m dani_slam_tpu_torch.examples.mono_tum SETTINGS.yaml SEQUENCE \
        [--out-prefix OUT] [--max-frames N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

from dani_slam_tpu_torch.examples._common import add_device_argument, \
    device_of


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--out-prefix", default="")
    ap.add_argument("--max-frames", type=int, default=0)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from dani_slam_tpu_torch.core import config as cfg
    from dani_slam_tpu_torch.core import state as mstate
    from dani_slam_tpu_torch.slam.system import Sensor, System
    from dani_slam_tpu_torch.utils import io as io_utils
    from dani_slam_tpu_torch.utils.native import ImagePrefetcher

    dev = device_of(args)
    settings = cfg.Settings.from_yaml(args.settings)
    print(settings, file=sys.stderr)
    system = System(settings.camera(dev), Sensor.MONOCULAR,
                    caps=mstate.MapCaps(N=settings.n_features),
                    n_features=settings.n_features, pipelined=True,
                    n_levels=settings.n_levels,
                    scale_factor=settings.scale_factor, device=dev)
    frames = io_utils.load_tum_rgb_list(args.sequence)
    if args.max_frames:
        frames = frames[:args.max_frames]
    t0 = frames[0][0] if frames else 0.0
    with ImagePrefetcher([f"{args.sequence}/{r}" for _, r in frames]) as pf:
        for i, (ts, _) in enumerate(frames):
            state, _, _ = system.track_monocular(pf.get(i), ts - t0)
            if i % 50 == 0:
                print(f"[{i}/{len(frames)}] {state} "
                      f"kf={system.n_keyframes()}", flush=True)
    system.shutdown()
    io_utils.save_trajectory_tum(args.out_prefix + "CameraTrajectory.txt",
                                 system.tracker.trajectory, time_offset=t0)
    print(f"done: {len(frames)} frames, {len(system.tracker.trajectory)} "
          f"poses on {dev}", flush=True)


if __name__ == "__main__":
    main()
