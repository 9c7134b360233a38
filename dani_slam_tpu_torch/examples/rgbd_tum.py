"""TUM RGB-D sequence runner (counterpart of examples/rgbd_tum.py;
reference: Examples/RGB-D/rgbd_tum.cc): reads the settings YAML and the
association file, feeds System.track_rgbd frame by frame, and writes
CameraTrajectory.txt (TUM format, absolute timestamps), ExecMean.txt and
TrackingTimeStats.txt.

    python -m dani_slam_tpu_torch.examples.rgbd_tum SETTINGS.yaml SEQUENCE \
        ASSOCIATIONS.txt [--out-prefix OUT] [--max-frames N] [--detector] \
        [--superpoint-pt F] [--lightglue-pt F] [--yolov5-pt F] \
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from dani_slam_tpu_torch.examples._common import add_device_argument, \
    device_of, refuse_unported


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("associations")
    ap.add_argument("--out-prefix", default="")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--viz", action="store_true")
    ap.add_argument("--detector", action="store_true",
                    help="enable YOLO dynamic masking (the shipped compact "
                    "detector)")
    ap.add_argument("--superpoint-pt", default="",
                    help="MagicLeap superpoint_v1.pth checkpoint "
                    "(models/superpoint.load_magicleap_pt)")
    ap.add_argument("--lightglue-pt", default="",
                    help="cvg/LightGlue checkpoint, TorchScript or state "
                    "dict (models/lightglue_official.load_lightglue_pt)")
    ap.add_argument("--yolov5-pt", default="",
                    help="yolov5s checkpoint (models/yolo_official."
                    "load_yolov5_pt); implies --detector")
    ap.add_argument("--time-stats", action="store_true")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    refuse_unported(ap, args, ("--time-stats", "--viz"))

    from dani_slam_tpu_torch.core import config as cfg
    from dani_slam_tpu_torch.core import state as mstate
    from dani_slam_tpu_torch.slam.system import Sensor, System
    from dani_slam_tpu_torch.utils import io as io_utils
    from dani_slam_tpu_torch.utils import timing
    from dani_slam_tpu_torch.utils.native import ImagePrefetcher

    dev = device_of(args)
    settings = cfg.Settings.from_yaml(args.settings)
    print(settings, file=sys.stderr)
    cam = settings.camera(dev)
    detector = None
    if args.yolov5_pt:
        from dani_slam_tpu_torch.models.yolo_official import load_yolov5_pt
        detector = load_yolov5_pt(args.yolov5_pt, device=dev)
    elif args.detector:
        from dani_slam_tpu_torch.models.yolo import load_default_detector
        detector = load_default_detector(dev)
    sp_params = None
    if args.superpoint_pt:
        from dani_slam_tpu_torch.models.superpoint import load_magicleap_pt
        sp_params = load_magicleap_pt(args.superpoint_pt, device=dev)
    matcher = "auto"
    if args.lightglue_pt:
        from dani_slam_tpu_torch.models.lightglue_official import \
            load_lightglue_pt
        matcher = load_lightglue_pt(args.lightglue_pt, cam.width, cam.height,
                                    device=dev)
    # the close/far threshold in metres (reference mThDepth = bf * ThDepth
    # / fx, src/Tracking.cc:1179) when the settings carry a baseline
    close_depth = (settings.baseline * settings.th_depth
                   if settings.baseline else None)
    system = System(cam, Sensor.RGBD,
                    caps=mstate.MapCaps(N=settings.n_features),
                    n_features=settings.n_features, detector=detector,
                    sp_params=sp_params, matcher=matcher,
                    close_depth=close_depth, pipelined=True, device=dev)

    assoc = io_utils.load_tum_associations(args.associations)
    if args.max_frames:
        assoc = assoc[:args.max_frames]
    # sequence-relative time on the device (epoch-scale stamps quantize in
    # float32); the saver restores t0
    t0 = assoc[0][0] if assoc else 0.0
    timer = timing.StageTimer()
    with ImagePrefetcher([f"{args.sequence}/{a[1]}" for a in assoc]) as rgbs, \
            ImagePrefetcher([f"{args.sequence}/{a[3]}" for a in assoc]) as deps:
        for i, (t_rgb, _, _, _) in enumerate(assoc):
            rgb = rgbs.get(i)
            depth = deps.get(i).astype(np.int32)
            with timer.stage("track"):
                state, _, _ = system.track_rgbd(rgb, depth, t_rgb - t0,
                                                settings.depth_map_factor)
            if i % 50 == 0:
                print(f"[{i}/{len(assoc)}] {state} "
                      f"kf={system.n_keyframes()} "
                      f"lm={system.n_landmarks()}", flush=True)
    system.shutdown()
    pre = args.out_prefix
    io_utils.save_trajectory_tum(pre + "CameraTrajectory.txt",
                                 system.tracker.trajectory, time_offset=t0)
    timer.save_means(pre + "ExecMean.txt")
    timer.save_csv(pre + "TrackingTimeStats.txt")
    s = timer.summary().get("track", {})
    print(f"done: {len(assoc)} frames, {len(system.tracker.trajectory)} "
          f"poses, {system.n_keyframes()} keyframes, "
          f"{system.n_landmarks()} landmarks, mean track "
          f"{s.get('mean_ms', 0):.1f} ms on {dev}", flush=True)


if __name__ == "__main__":
    main()
