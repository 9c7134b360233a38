"""dani_slam_tpu_torch — the PyTorch/CUDA port of dani_slam_tpu for an
NVIDIA H100.

The JAX package (dani_slam_tpu) stays the reference; this package mirrors its
layout (core/ ops/ models/ slam/ utils/) and its module and function names so
that each counterpart is easy to find. Plain tensor code is PyTorch; the two
Pallas TPU kernels of the RGB-D tracking + local-mapping path are hand-written
CUDA C++ kernels for sm_90a (csrc/), bound through ctypes (ops/kernels.py).

It covers the RGB-D path in the configuration bench.py runs: SuperPoint
frontend, YOLO dynamic masking, LightGlue matcher, pipelined tracking (one
captured CUDA graph per tracked frame, slam/framegraph.py), local mapping
with local BA, loop closing with time-sliced correction and global BA,
relocalization, and an Atlas of maps that merges a new map back into a
stored one; the inertial paths are not ported yet.

Entry points run on the card by default and raise when CUDA is missing; the
CPU is used only when a caller passes device="cpu" (the tests do), and there
every kernel wrapper takes its plain PyTorch version.

    from dani_slam_tpu_torch import System, Sensor
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name in ("System", "Sensor"):
        from dani_slam_tpu_torch.slam.system import Sensor, System
        return {"System": System, "Sensor": Sensor}[name]
    raise AttributeError(name)
