"""Distributed training of the learned front-end (counterpart of
dani_slam_tpu/parallel/train.py): a SuperPoint self-supervision step
(shift-consistency of the heat map and descriptors plus an entropy prior),
data-parallel x tensor-parallel over a ("data", "model") Mesh.

  * "data": the batch is split over the axis and the gradients are
    averaged over its group.
  * "model": each conv whose output channels divide by the axis size is
    split on them with its bias (convPb's 65 channels stay replicated), as
    the JAX package's shard_params lays them out. A split conv runs
    Megatron-style between two autograd functions: before it, identity
    forward and an all-reduce of the input's gradient backward (every
    rank's slice contributes to it); after it, an all-gather of the
    channels forward and this rank's slice of the gradient backward.
    Everything else runs replicated on the model axis, so every rank of
    it computes the same activations and the same replicated gradients.
"""
from __future__ import annotations

import torch
from torch import nn

from dani_slam_tpu_torch.models import convert
from dani_slam_tpu_torch.models.optim import Adam
from dani_slam_tpu_torch.models.superpoint import SuperPoint
from dani_slam_tpu_torch.parallel.mesh import Mesh, default_device
from dani_slam_tpu_torch.utils.device import no_tf32


def make_mesh_2d(n_devices: int, device=None) -> Mesh:
    """("data", "model") mesh of (n/2, 2) ranks for n >= 4, (n, 1)
    below."""
    shape = (n_devices // 2, 2) if n_devices >= 4 else (n_devices, 1)
    return Mesh(shape, ("data", "model"),
                default_device() if device is None else device)


class _ToModelParallel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group
    backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, "model"), None


class _GatherChannels(torch.autograd.Function):
    """All-gather of the channel dimension (dim 1) over the model group
    forward; this rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh, ctx.c = mesh, y.shape[1]
        return torch.cat(mesh.all_gather(y, "model"), dim=1)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.coords["model"]
        return g[:, i * ctx.c:(i + 1) * ctx.c].contiguous(), None


class ShardedSuperPoint(SuperPoint):
    """A SuperPoint whose `split` convs hold this rank's share of the
    output channels; the forward is SuperPoint's."""

    def __init__(self, full: SuperPoint, mesh: Mesh):
        self.descriptor_dim = full.convDb.out_channels
        super().__init__(self.descriptor_dim, full.compute_dtype)
        self.mesh = mesh
        m, i = mesh.size("model"), mesh.coords["model"]
        self.split = set()
        for name, conv in full.named_children():
            cout = conv.out_channels
            if cout % m == 0 and m > 1:
                c = cout // m
                part = nn.Conv2d(conv.in_channels, c, conv.kernel_size,
                                 padding=conv.padding)
                with torch.no_grad():
                    part.weight.copy_(conv.weight[i * c:(i + 1) * c])
                    part.bias.copy_(conv.bias[i * c:(i + 1) * c])
                setattr(self, name, part)
                self.split.add(name)
            else:
                getattr(self, name).load_state_dict(conv.state_dict())
        self.to(full.conv1a.weight.device)

    def _conv(self, name, x):
        if name not in self.split:
            return super()._conv(name, x)
        return _GatherChannels.apply(
            super()._conv(name, _ToModelParallel.apply(x, self.mesh)),
            self.mesh)

    def gather(self, grad: bool = False) -> SuperPoint:
        """The full model (every rank's channels), on every rank; with
        grad=True its parameters are the gradients."""
        full = SuperPoint(self.descriptor_dim, self.compute_dtype)
        full.to(self.conv1a.weight.device)
        with torch.no_grad():
            for name, conv in full.named_children():
                part = getattr(self, name)
                for key in ("weight", "bias"):
                    t = getattr(part, key)
                    t = (t.grad if grad else t).detach()
                    if name in self.split:
                        t = torch.cat(self.mesh.all_gather(t, "model"))
                    getattr(conv, key).copy_(t)
        return full


def shard_params(model: SuperPoint, mesh: Mesh) -> ShardedSuperPoint:
    """Conv kernels (and biases) split on output channels over "model"
    where they divide by its size; everything else replicated."""
    return ShardedSuperPoint(model, mesh)


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of the batch (split over "data")."""
    b = batch.shape[0] // mesh.size("data")
    i = mesh.coords["data"]
    return batch[i * b:(i + 1) * b]


def warp_loss(model, batch: torch.Tensor, shift=(4, 0)) -> torch.Tensor:
    """Self-supervision on gray batch (B,1,H,W): the heat map and
    descriptors of the shifted image must match the shifted heat map and
    descriptors of the original (homographic-adaptation consistency, the
    pure-translation case), plus an entropy prior that keeps the detector
    from collapsing to uniform."""
    dy, dx = shift
    heat, desc = model(batch)
    heat_s, desc_s = model(torch.roll(batch, (dy, dx), dims=(2, 3)))
    det = torch.mean((torch.roll(heat, (dy, dx), dims=(1, 2)) - heat_s) ** 2)
    dsc = torch.mean((torch.roll(desc, (dy // 8, dx // 8), dims=(1, 2)) -
                      desc_s) ** 2)
    ent = -torch.mean(heat * torch.log(heat + 1e-9))
    return det + 0.1 * dsc + 1e-3 * ent


def make_train_step(model, opt: Adam, mesh: Mesh | None = None):
    """step(batch) -> loss: one step of warp_loss on this rank's share of
    the (replicated) global batch, gradients averaged over "data", the
    optimizer's update; the loss returned is the global batch's. With
    mesh None a single-process step."""
    def step(batch):
        local = batch if mesh is None else shard_batch(batch, mesh)
        loss = warp_loss(model, local)
        opt.zero_grad()
        loss.backward()
        if mesh is not None and mesh.size("data") > 1:
            n = mesh.size("data")
            for p in model.parameters():
                p.grad = mesh.all_reduce(p.grad, "data") / n
            loss = mesh.all_reduce(loss.detach(), "data") / n
        opt.step()
        return loss.detach()
    return step


def train_superpoint_sharded(n_devices: int, steps: int = 1,
                             batch: int | None = None, hw=(32, 32),
                             lr: float = 1e-4, device=None):
    """Run `steps` sharded training steps on this rank (every rank of an
    n_devices process group calls it): a float32 SuperPoint with Flax's
    initialization from seed 1, a batch of uniform noise from
    torch.Generator(0), Adam(lr). Returns (sharded model, losses per
    step)."""
    mesh = make_mesh_2d(n_devices, device)
    if mesh.device.type == "cuda":
        no_tf32()
    B = batch or mesh.size("data") * 2
    x = torch.rand((B, 1) + tuple(hw),
                   generator=torch.Generator().manual_seed(0))
    full = convert.flax_init(SuperPoint(compute_dtype=torch.float32), 1)
    model = shard_params(full.to(mesh.device), mesh)
    step = make_train_step(model, Adam(model.parameters(), lr), mesh)
    x = x.to(mesh.device)
    losses = [step(x) for _ in range(steps)]
    return model, torch.stack(losses)


def params_equal_across(mesh: Mesh, model: nn.Module) -> bool:
    """Whether this rank's parameters equal its peers' on the data axis,
    and its replicated layers its peers' on the model axis."""
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    rep = torch.cat([p.detach().reshape(-1)
                     for name, mod in model.named_children()
                     if name not in getattr(model, "split", ())
                     for p in mod.parameters()])
    return (all(torch.equal(flat, o) for o in mesh.all_gather(flat, "data"))
            and all(torch.equal(rep, o)
                    for o in mesh.all_gather(rep, "model")))
