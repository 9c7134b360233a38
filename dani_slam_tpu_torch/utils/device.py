"""Device selection, host-sync accounting and staged constants.

Entry points take an explicit `device`; "cuda" is the default everywhere and
is never silently replaced by the CPU. Every device->host read on the
tracking and mapping path goes through `pull` (blocking) or `AsyncRead`
(started now, read some frames later), which count it, so a run can report
how many synchronisations a frame costs.
"""
from __future__ import annotations

import functools

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU")
    return dev


def no_tf32():
    """f32 matmuls and convolutions in full precision on the card (the JAX
    package sets jax_default_matmul_precision="highest"): TF32 off for
    cuBLAS and cuDNN. bf16 stays only where a module casts explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class SyncCounter:
    """Counts device->host reads that made the host wait for the device.
    `svd` counts the card's SVDs among them (ops/linalg.svd): torch's sync
    debug mode flags each of those twice, every other counted wait once.
    `eigh` counts the card's symmetric eigendecompositions (ops/linalg.eigh)
    among them."""

    def __init__(self):
        self.count = 0
        self.svd = 0
        self.eigh = 0


class AsyncCounter:
    """Counts asynchronous reads by how they resolved: `ready` had their
    copy finished when the host asked, `waited` had to block (those are
    counted in SYNCS as well)."""

    def __init__(self):
        self.ready = 0
        self.waited = 0


SYNCS = SyncCounter()
ASYNC = AsyncCounter()


def pull(x: torch.Tensor):
    """Copy a device tensor to the host (numpy), counting the sync."""
    SYNCS.count += 1
    return x.detach().cpu().numpy()


class AsyncRead:
    """A device->host copy started now and read later (the counterpart of
    the reference package's copy_to_host_async): the tensor is copied into
    pinned host memory on the current stream and an event recorded behind
    the copy; `get` returns the numpy value, blocking only if the event has
    not fired yet. A CPU tensor is its own host copy."""

    def __init__(self, x: torch.Tensor):
        x = x.detach()
        self.event = None
        if x.is_cuda:
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = x

    def get(self):
        if self.event is not None and not self.event.query():
            ASYNC.waited += 1
            SYNCS.count += 1
            self.event.synchronize()
        else:
            ASYNC.ready += 1
        self.event = None
        return self.host.numpy()


def upload(x, device, dtype=None) -> torch.Tensor:
    """A host array (numpy or a list) on `device` without a host wait: on
    the card it goes through pinned memory as an asynchronous copy (the
    caching host allocator keeps the pinned buffer until the copy is done);
    torch.as_tensor(x, device="cuda") would copy from pageable memory and
    block."""
    t = torch.as_tensor(x, dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=256)
def _const(values, dtype, device):
    if device.type == "cuda":
        SYNCS.count += 1         # staged once: a blocking copy to the card
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, dtype, device) -> torch.Tensor:
    """A small read-only tensor of Python numbers (nested tuples), staged on
    `device` once and reused: building it at every call would copy pageable
    host memory to the card each time, which a captured frame program cannot
    contain."""
    return _const(values, dtype, torch.device(device))
