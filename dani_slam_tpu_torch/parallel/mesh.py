"""Device meshes over torch.distributed and the landmark-sharded solvers
(counterpart of dani_slam_tpu/parallel/mesh.py).

The JAX package places arrays on a jax.sharding.Mesh and lets GSPMD insert
the collectives. Here every rank is a process that runs the same program
(launch.py starts them), and the collectives are written out:

  * A Mesh is a grid of the default process group's ranks with named axes;
    each axis has the process group of the ranks that differ only along
    it, and a sum over an axis is one all_reduce in that group.
  * Bundle adjustment shards the landmark dimension: each rank holds a
    contiguous range of landmarks and builds their blocks (kernel 2 on its
    shard in ba_solve), observations and keyframe state are replicated,
    and the sums over landmarks and observations go through one all-reduce
    each (ops/ba.py's `reduce` hook). The pose step is solved replicated,
    the landmark step locally; the landmarks are gathered at the end.

The collectives run on the tensors' own device: gloo stages CUDA tensors
through the host, NCCL needs one card per rank.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """The default process group's ranks laid out on a grid `shape` with
    axis names `axes` (row-major: rank = ravel(coords)). `device` is where
    this rank computes."""

    def __init__(self, shape, axes, device):
        self.shape = dict(zip(axes, shape))
        self.axes = tuple(axes)
        self.device = torch.device(device)
        n = int(np.prod(shape))
        if dist.get_world_size() != n:
            raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the "
                             f"process group has {dist.get_world_size()}")
        self.rank = dist.get_rank()
        coords = np.unravel_index(self.rank, shape)
        self.coords = {a: int(c) for a, c in zip(axes, coords)}
        # every rank creates every group, in the same order
        self.groups = {}
        grid = np.arange(n).reshape(shape)
        for ax, name in enumerate(axes):
            if shape[ax] == 1:
                self.groups[name] = None
                continue
            if shape[ax] == n:
                self.groups[name] = dist.group.WORLD
                continue
            others = [range(s) for i, s in enumerate(shape) if i != ax]
            for idx in itertools.product(*others):
                sel = list(idx)
                sel.insert(ax, slice(None))
                ranks = [int(r) for r in grid[tuple(sel)]]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self.groups[name] = group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of t over the ranks along `axis` (a new tensor)."""
        if self.shape[axis] == 1:
            return t
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, group=self.groups[axis])
        return out

    def all_gather(self, t: torch.Tensor, axis: str) -> list:
        """t of every rank along `axis`, in coordinate order."""
        if self.shape[axis] == 1:
            return [t]
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t.contiguous(), group=self.groups[axis])
        return parts

    def reducer(self, axis: str):
        """The `reduce` hook of ops/ba.ba_solve: a sum over `axis`."""
        return lambda t: self.all_reduce(t, axis)


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device=None) -> Mesh:
    """A 1-D mesh over the process group's ranks (all of them: n_devices,
    where given, must be the world size). device defaults to cuda:rank
    under NCCL, cuda when there is a card, else the CPU."""
    n = n_devices or dist.get_world_size()
    if device is None:
        device = default_device()
    return Mesh((n,), (axis,), device)


def default_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", dist.get_rank())
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def landmark_range(mesh: Mesh, L: int, axis: str = "data"):
    """This rank's contiguous landmark rows [l0, l1) of L (ceil(L / n) a
    rank, the last rank's range possibly shorter)."""
    n = mesh.size(axis)
    chunk = -(-L // n)
    l0 = min(mesh.coords[axis] * chunk, L)
    return l0, min(l0 + chunk, L), chunk


def shard_landmarks(mesh: Mesh, lm_pos, lm_valid, axis: str = "data"):
    """This rank's rows of the landmark tables."""
    l0, l1, _ = landmark_range(mesh, lm_pos.shape[0], axis)
    return lm_pos[l0:l1], lm_valid[l0:l1]


def gather_landmarks(mesh: Mesh, rows: torch.Tensor, L: int,
                     axis: str = "data") -> torch.Tensor:
    """Every rank's landmark rows -> the full [L, ...] table."""
    _, _, chunk = landmark_range(mesh, L, axis)
    pad = torch.zeros((chunk - rows.shape[0],) + rows.shape[1:],
                      dtype=rows.dtype, device=rows.device)
    parts = mesh.all_gather(torch.cat([rows, pad]), axis)
    return torch.cat(parts)[:L]


def _local_observations(mesh, obs_lm, obs_valid, L, axis):
    """Observations of this rank's landmarks, with local ids."""
    l0, l1, _ = landmark_range(mesh, L, axis)
    mine = obs_valid & (obs_lm >= l0) & (obs_lm < l1)
    return torch.where(mine, obs_lm - l0, torch.zeros_like(obs_lm)), mine


def _gathered(mesh, res, L, axis, tail=None):
    """A rank's BAResult with the full landmark table (the ranks' rows,
    then `tail`, the rows past the sharded range) and every rank's inlier
    flags."""
    from dani_slam_tpu_torch.ops.ba import BAResult
    inlier = mesh.all_reduce(res.obs_inlier.to(torch.float32), axis) > 0
    lm = gather_landmarks(mesh, res.lm_pos, L, axis)
    if tail is not None:
        lm = torch.cat([lm, tail])
    return BAResult(res.R, res.t, lm, inlier, res.cost)


def sharded_ba_solve(mesh: Mesh, R0, t0, pose_fixed, lm0, lm_valid, cam,
                     obs_kf, obs_lm, obs_xy, obs_valid, *rest,
                     axis: str = "data", **kwargs):
    """ops/ba.ba_solve with the landmark dimension sharded over the mesh;
    callers on every rank pass the same (replicated) arguments as to
    ba_solve. Each rank solves with its own landmarks and their
    observations (kernel 2 builds the blocks of its shard, local ids),
    the sums going through mesh.all_reduce. Returns ba_solve's BAResult
    with the full landmark table, on every rank."""
    from dani_slam_tpu_torch.ops import ba as ba_ops
    L = lm0.shape[0]
    lm_loc, lmv_loc = shard_landmarks(mesh, lm0, lm_valid, axis)
    olm, mine = _local_observations(mesh, obs_lm, obs_valid, L, axis)
    res = ba_ops.ba_solve(R0, t0, pose_fixed, lm_loc, lmv_loc, cam, obs_kf,
                          olm, obs_xy, mine, *rest,
                          reduce=mesh.reducer(axis), **kwargs)
    return _gathered(mesh, res, L, axis)


def sharded_gba(mesh: Mesh, st, cam, iters: int = 10, axis: str = "data"):
    """Whole-map global BA (the PCG solve of ops/ba_large, as
    loopclosing.global_bundle_adjustment runs it) with the landmark tables
    sharded over the mesh: the per-landmark H_ll / g_l segment sums and
    the landmark back-substitution run on each rank's landmarks, the [P,6]
    CG terms, the rhs and the cost are all-reduced. The map's table is
    allocated first-free, so the live landmarks sit below the highest live
    slot (read on the host once): that range is split over the ranks, and
    the dead rows past it, which the solve leaves as they are, stay out.
    Returns ba_solve_pcg's BAResult with the full landmark table, on every
    rank."""
    from dani_slam_tpu_torch.ops import ba_large
    from dani_slam_tpu_torch.slam.loopclosing import _gba_problem
    pose_fixed, okf, olm, oxy, ovalid, obs_info = _gba_problem(st)
    live = torch.nonzero(st.lm_mask)
    L = int(live.max()) + 1 if live.numel() else 1
    lm_loc, lmv_loc = shard_landmarks(mesh, st.lm_pos[:L], st.lm_mask[:L],
                                      axis)
    olm_loc, mine = _local_observations(mesh, olm, ovalid, L, axis)
    res = ba_large.ba_solve_pcg(st.kf_R, st.kf_t, pose_fixed, lm_loc,
                                lmv_loc, cam, okf, olm_loc, oxy, mine,
                                obs_info=obs_info, iters=iters,
                                reduce=mesh.reducer(axis))
    return _gathered(mesh, res, L, axis, tail=st.lm_pos[L:])
