"""Medians with the reference package's semantics.

jnp.median and jnp.nanmedian average the two middle values of an even
count; torch.median and torch.nanmedian return the lower one. The monocular
map's scale (tracking.build_initial_map) and the stereo trim
(frame.stereo_match_depth) depend on the difference, so the port computes
its medians here: one sort, the middle values gathered on the device (no
host read), NaN handling as in numpy.
"""
from __future__ import annotations

import torch


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a 1-D tensor, the two middle values
    averaged when their count is even; NaN when every entry is NaN."""
    s = torch.sort(x).values                 # NaN sorts last
    k = torch.sum(~torch.isnan(x)).reshape(1)
    lo = torch.gather(s, 0, torch.clamp((k - 1) // 2, min=0))
    hi = torch.gather(s, 0, torch.clamp(k // 2, max=x.shape[0] - 1))
    med = 0.5 * (lo + hi)
    return torch.where(k > 0, med, torch.full_like(med, float("nan")))[0]


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor, the two middle values averaged when the
    count is even; NaN when any entry is NaN (jnp.median propagates it)."""
    n = x.shape[0]
    s = torch.sort(x).values
    med = 0.5 * (s[(n - 1) // 2] + s[n // 2])
    return torch.where(torch.any(torch.isnan(x)),
                       torch.full_like(med, float("nan")), med)
