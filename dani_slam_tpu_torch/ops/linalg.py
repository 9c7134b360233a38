"""Small dense SPD solves and inverses (counterpart of
dani_slam_tpu/ops/linalg.py), forward-mode Jacobians, and the SVDs and
eigendecompositions that wait for the card, counted.

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

from dani_slam_tpu_torch.utils.device import SYNCS


def chol_factor(A: torch.Tensor) -> torch.Tensor:
    """Lower-triangular L with L L^T = A for SPD A [..., n, n]."""
    return torch.linalg.cholesky_ex(A).L


def chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b for SPD A [..., n, n], b [..., n]."""
    L = chol_factor(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def tri_lower_inv(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular L [..., n, n] (a triangular solve
    against the identity: no host read)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(
        L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def chol_inv(A: torch.Tensor) -> torch.Tensor:
    """A^-1 for SPD A [..., n, n] via Cholesky, Linv^T Linv (the 9x9
    preintegration covariances, the 15x15 marginalization block)."""
    Li = tri_lower_inv(chol_factor(A))
    return torch.einsum('...ki,...kj->...ij', Li, Li)


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


def svd(A: torch.Tensor, full_matrices: bool = True):
    """torch.linalg.svd, which makes the host wait on the card: for the
    small systems of the solves (two-view 8x9 and 3x3 batches and single
    3x3 matrices, the triangulation's 4x4 batches, the PnP and Sim3
    hypotheses) PyTorch reads cuSOLVER's status back before returning, and
    torch's sync debug mode flags it (twice a call, the second read finding
    the queue empty). Counted in utils/device.SYNCS as one blocking read."""
    if A.is_cuda:
        SYNCS.count += 1
        SYNCS.svd += 1
    return torch.linalg.svd(A, full_matrices=full_matrices)


def svdvals(A: torch.Tensor) -> torch.Tensor:
    """torch.linalg.svdvals, counted as svd is."""
    if A.is_cuda:
        SYNCS.count += 1
        SYNCS.svd += 1
    return torch.linalg.svdvals(A)


def eigh(A: torch.Tensor):
    """torch.linalg.eigh, which, like svd, reads cuSOLVER's status back to
    the host on the card; counted in utils/device.SYNCS as one blocking
    read (and in SYNCS.eigh)."""
    if A.is_cuda:
        SYNCS.count += 1
        SYNCS.eigh += 1
    return torch.linalg.eigh(A)
