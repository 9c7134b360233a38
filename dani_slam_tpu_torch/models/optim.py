"""The optimizers of the JAX package's trainers, written to optax's
formulas (the port's counterpart of `optax.adam`, `optax.adamw`,
`optax.clip_by_global_norm` and `optax.cosine_decay_schedule` as the
trainers chain them).

torch.optim differs from optax in three places that move a trained model:
AdamW's default weight decay (torch 1e-2, optax 1e-4), the global-norm clip
(torch divides by norm + 1e-6, optax by the norm) and the learning-rate
schedule's first step. Here every update is optax's, in float32:

    g     <- g * max_norm / |g|           where |g| >= max_norm  (clip)
    mu    <- b1 mu + (1 - b1) g
    nu    <- b2 nu + (1 - b2) g^2
    u     <- (mu / (1 - b1^k)) / (sqrt(nu / (1 - b2^k)) + eps)   k = step + 1
    u     <- u + weight_decay * p                                 (adamw)
    p     <- p - lr(step) u,   lr(step) = lr (1 + cos(pi min(step, n) / n)) / 2

with step counted from 0, so the first update uses the full rate.
"""
from __future__ import annotations

import math

import torch


def report_step(i: int, loss, log_every: int, on_step):
    """A trainer's per-step hooks: on_step(i, loss) with the step's loss
    tensor (on the device), and the JAX trainers' log line every
    log_every steps."""
    if on_step is not None:
        on_step(i, loss.detach())
    if log_every and i % log_every == 0:
        print(f"step {i}: loss {float(loss):.4f}", flush=True)


def cosine_decay(lr: float, decay_steps: int):
    """optax.cosine_decay_schedule(lr, decay_steps): step -> rate."""
    def rate(step: int) -> float:
        k = min(step, decay_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * k / decay_steps))
    return rate


class Adam:
    """optax.chain([clip_by_global_norm(clip),] adam(lr) | adamw(lr)) over a
    list of parameters, stepped from their .grad (or from `grads`).

    lr is a float or a schedule step -> float; weight_decay > 0 makes it
    adamw (optax's default 1e-4 where the JAX trainer calls adamw)."""

    def __init__(self, params, lr, clip: float | None = None,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr = lr if callable(lr) else (lambda step: lr)
        self.clip, self.weight_decay = clip, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.step_count = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, grads=None):
        grads = [p.grad for p in self.params] if grads is None else \
            list(grads)
        if self.clip is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            grads = [torch.where(norm < self.clip, g, g / norm * self.clip)
                     for g in grads]
        k = self.step_count + 1
        f32 = torch.float32
        c1 = 1.0 - torch.tensor(self.b1, dtype=f32) ** k
        c2 = 1.0 - torch.tensor(self.b2, dtype=f32) ** k
        rate = self.lr(self.step_count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            u = (mu / c1.to(mu.device)) / (
                torch.sqrt(nu / c2.to(nu.device)) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(-rate * u)
        self.step_count = k
