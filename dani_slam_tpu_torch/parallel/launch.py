"""Start a function on n ranks: n spawned processes in one
torch.distributed process group, each returning a result to the caller.

The process group meets through a file store in a fresh temporary
directory (no port to collide with other runs on the machine). The
backend is the caller's choice: "nccl" with one card per rank
(cuda:rank), "gloo" otherwise — on a machine with one card every rank then
computes on cuda:0 (NCCL refuses two ranks on one card) and gloo stages
the CUDA tensors of each collective through the host.

    results = launch(fn, 4, arg, backend="gloo", device="cuda")

fn is a module-level function (it is sent to the ranks by import path):
fn(device, *args) -> dict of tensors / numbers, moved to the CPU. Each
result also holds "foreign_modules": the modules of jax, flax or the JAX
package that the rank's interpreter had loaded (none, for the port).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import sys
import tempfile
import time
import traceback

import torch

FOREIGN = ("jax", "jaxlib", "flax", "dani_slam_tpu")


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _rank_main(fn, rank, n, store, backend, device, threads, args, out):
    import torch.distributed as dist
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method="file://" + store,
                                rank=rank, world_size=n)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank if backend == "nccl" else 0)
            torch.cuda.set_device(dev)
        res = dict(fn(dev, *args))
        res["foreign_modules"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in FOREIGN and sys.modules[m] is not None)
        torch.save(_to_cpu(res), out)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


def launch(fn, n: int, *args, backend: str = "gloo", device="cuda",
           threads: int = 2, timeout: float = 600.0) -> list:
    """fn(device, *args) on n ranks; returns the n results in rank order.
    The ranks compute on the card unless `device` is "cpu", as every entry
    point of the port does.
    Raises with a rank's traceback if one failed, or if a rank is still
    running after `timeout` seconds (all ranks are then terminated)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        outs = [os.path.join(d, f"rank{r}.pt") for r in range(n)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, n, os.path.join(d, "store"), backend, str(device),
            threads, args, outs[r])) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.terminate()
            for p in alive:
                p.join(10)
        results = [torch.load(o, weights_only=False) if os.path.exists(o)
                   else {"error": "no result"} for o in outs]
    errors = [f"rank {r}: {res['error']}" for r, res in enumerate(results)
              if "error" in res]
    if alive:
        errors.append(f"{len(alive)} ranks still running after {timeout} s")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if errors or bad:
        raise RuntimeError(f"launch({fn.__name__}, {n}) failed (exit codes "
                           f"{[p.exitcode for p in procs]}):\n" +
                           "\n".join(errors))
    return results
