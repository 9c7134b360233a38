"""What the dataset runners share: the --device argument, the arguments
that wait on unported modules, and the System's device line."""
from __future__ import annotations

import argparse

import torch

from dani_slam_tpu_torch.utils.device import resolve_device


def add_device_argument(ap: argparse.ArgumentParser):
    ap.add_argument("--device", default="cuda",
                    help="torch device of the whole run (default cuda; a "
                    "host without CUDA must pass --device cpu)")


def refuse_unported(ap: argparse.ArgumentParser, args, names):
    """--time-stats and --viz need utils/stage_profile and utils/viewer,
    which the port does not have yet: refuse them instead of ignoring
    them."""
    for name in names:
        if getattr(args, name.lstrip("-").replace("-", "_"), False):
            ap.error(f"{name} needs utils/stage_profile and utils/viewer, "
                     "which are not ported yet (ROADMAP.md, queue 1: "
                     "remaining utils)")


def device_of(args) -> torch.device:
    """The run's device (raises when CUDA is asked for and absent), printed
    with the card's name."""
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"device {dev} ({name})", flush=True)
    return dev
