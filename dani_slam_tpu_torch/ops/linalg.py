"""Small dense SPD solves (counterpart of dani_slam_tpu/ops/linalg.py; the
port's solvers need only chol_solve) and forward-mode Jacobians.

The JAX package unrolls a Cholesky factorisation at trace time because the
LAPACK custom call is latency-bound on a TPU. PyTorch has batched Cholesky
routines that need no host synchronisation (`cholesky_ex` reports failure in
a tensor instead of raising), so these helpers are thin wrappers. The
callers damp their systems (lam*diag + eps*I, identity rows for gauge-fixed
poses), so the matrices are symmetric positive definite, as in the
reference package.
"""
from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD


def chol_factor(A: torch.Tensor) -> torch.Tensor:
    """Lower-triangular L with L L^T = A for SPD A [..., n, n]."""
    return torch.linalg.cholesky_ex(A).L


def chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b for SPD A [..., n, n], b [..., n]."""
    L = chol_factor(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def jacfwd(f, x: torch.Tensor):
    """(f(x), J) with J [..., m, n] = d f / d x for x [..., n], where f maps
    [..., n] -> [..., m] and broadcasts over leading dims. The counterpart of
    jax.jacfwd (vmapped over the leading dims): the n basis directions are
    stacked on a new leading dim and pushed through f in one forward-mode
    pass with dual tensors. (torch.func.jacfwd would do the same, but some
    releases hand 0-d operands a float64 tangent and then fail.)"""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device).reshape(
        (n,) + (1,) * (x.ndim - 1) + (n,)).expand((n,) + x.shape)
    with fwAD.dual_level():
        out = f(fwAD.make_dual(x.expand((n,) + x.shape).contiguous(),
                               basis.contiguous()))
        val, tan = fwAD.unpack_dual(out)
    return val[0], tan.movedim(0, -1)
