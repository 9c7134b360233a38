"""Per-stage wall-clock samples (counterpart of the StageTimer of
dani_slam_tpu/utils/timing.py; reference: the REGISTER_TIMES vectors dumped
to TrackingTimeStats.txt and ExecMean.txt, src/Tracking.cc:185-535). The
runners time each frame's call on the host's clock: on the card that is the
time to enqueue the frame's work plus any wait the call makes, as the JAX
package's runners time its asynchronous dispatch.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class StageTimer:
    """Accumulates per-stage wall-clock samples."""

    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.samples[name].append(seconds)

    def summary(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = dict(mean_ms=float(a.mean() * 1e3),
                             std_ms=float(a.std() * 1e3),
                             max_ms=float(a.max() * 1e3), count=len(xs))
        return out

    def save_csv(self, path: str):
        """Per-sample CSV, one column per stage, ms."""
        names = sorted(self.samples)
        n = max((len(v) for v in self.samples.values()), default=0)
        with open(path, "w") as f:
            f.write("#" + ",".join(names) + "\n")
            for i in range(n):
                row = [f"{self.samples[k][i] * 1e3:.4f}"
                       if i < len(self.samples[k]) else "" for k in names]
                f.write(",".join(row) + "\n")

    def save_means(self, path: str):
        """ExecMean.txt: 'stage mean_ms std_ms count' lines."""
        with open(path, "w") as f:
            for name, s in sorted(self.summary().items()):
                f.write(f"{name} {s['mean_ms']:.4f} {s['std_ms']:.4f} "
                        f"{s['count']}\n")
