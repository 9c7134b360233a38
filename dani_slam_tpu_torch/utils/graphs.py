"""CUDA graphs of the port's eager functions.

`capture` is the one capture routine of the port: the frame program of
slam/framegraph and the functions `call` serves below go through it. It
runs the function WARMUP_ITERS times on a side stream (which settles
library handles, workspaces and staged constants), captures it, and
returns what one replay launches by the kernel wrappers' counters and the
LightGlue forward counter: those tick at capture, when nothing ran on the
card, so they are set back, and `count_replay` adds them at every replay.

`call` serves the eager functions of the feature path that run with the
same shapes every time: a tracked feature frame (track_frame_step with its
three candidates selected on the device, ~45,000 small launches), the
visual-inertial refinement of an inertial frame (a 30-DoF Gauss-Newton
with forward-mode Jacobians, ~70,000), the preintegration of its IMU window
(a loop over the samples) and the local inertial BA. Eagerly the host
launches each small kernel; captured, one replay launches them all. `call`
keys a graph on the function's static variant and its inputs' shapes and
dtypes, captures on first use, and on every call copies the inputs that
changed into the graph's own buffers (an input that is the same tensor
object as at the previous call is not copied again: the port never writes
a tensor it was handed), replays, and returns clones of the outputs (a
frame's results outlive the next replay). A graph holds the addresses of
every tensor its function closes over (a model's weights), so it keeps the
function, and with it those tensors, alive: an object named in a key by
its identity is never freed while the key is in the cache, and so its
identity is never reused.

Only functions without a host read inside can be captured. On the CPU the
function runs eagerly. There is no fallback: a failed capture raises.
"""
from __future__ import annotations

import torch

WARMUP_ITERS = 3

_GRAPHS: dict = {}


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return type(x)(*(_clone(v) for v in x)) if hasattr(x, "_fields") \
            else tuple(_clone(v) for v in x)
    return x


def _counters():
    from dani_slam_tpu_torch.models import lightglue
    from dani_slam_tpu_torch.ops import kernels
    return (kernels.window_match_topk2.launches,
            kernels.lba_landmark_blocks.launches, kernels.lba_plan.launches,
            lightglue.FORWARDS.count)


def _set_counters(vals):
    from dani_slam_tpu_torch.models import lightglue
    from dani_slam_tpu_torch.ops import kernels
    (kernels.window_match_topk2.launches, kernels.lba_landmark_blocks.launches,
     kernels.lba_plan.launches, lightglue.FORWARDS.count) = vals


def capture(program, dev):
    """(graph, outputs, per_replay) of program() captured on device `dev`
    after WARMUP_ITERS runs on a side stream; the counters are as before
    the capture, per_replay is what count_replay adds."""
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_ITERS):
            program()
    torch.cuda.current_stream(dev).wait_stream(side)
    before = _counters()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = program()
    per_replay = tuple(a - b for a, b in zip(_counters(), before))
    _set_counters(before)
    return graph, out, per_replay


def count_replay(per_replay):
    """Adds one replay's launches and forwards to the counters."""
    _set_counters(tuple(c + d for c, d in zip(_counters(), per_replay)))


class GraphedCall:
    """fn(*inputs) captured once for inputs shaped like `args`; keeps fn
    (and what it closes over) alive as long as the graph."""

    def __init__(self, fn, args):
        self.fn = fn
        self.inputs = [a.clone() for a in args]
        self.last = list(args)
        self.graph, self.out, self.per_replay = capture(
            lambda: fn(*self.inputs), args[0].device)

    def __call__(self, args):
        for i, a in enumerate(args):
            if a is not self.last[i]:
                self.inputs[i].copy_(a)
                self.last[i] = a
        self.graph.replay()
        count_replay(self.per_replay)
        return _clone(self.out)


def call(key, fn, args):
    """fn(*args) for a tuple of tensors: a graph replay on the card, eager
    on the CPU. `key` names fn's static variant (everything fn closes over
    that is not in args; an object by its identity only if fn closes over
    it)."""
    if not args[0].is_cuda:
        return fn(*args)
    k = (key,) + tuple((a.shape, a.dtype, a.device) for a in args)
    if k not in _GRAPHS:
        _GRAPHS[k] = GraphedCall(fn, args)
    return _GRAPHS[k](args)
