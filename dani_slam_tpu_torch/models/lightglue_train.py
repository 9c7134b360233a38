"""LightGlue training on synthetic homography pairs (counterpart of
dani_slam_tpu/models/lightglue_train.py): pairs made by warping synthetic
corner scenes with random homographies, ground-truth correspondences
known exactly from the warp, and the LightGlue paper's supervision — the
NLL of the soft assignment on true matches plus a matchability penalty on
unmatched points.

The host draws base images and homography parameters (numpy, the JAX
package's generators); a step runs on `device`: warp, the frozen bf16
SuperPoint on both views as one batch, keypoint selection and descriptor
sampling (ops/frontend), ground-truth association, LightGlue forward and
backward (its dense layers in bf16, as in the JAX module), clip 1 + AdamW
on a cosine schedule (optax's formulas, models/optim.py).
`official=True` trains LightGlueOfficial 256 x 9, the reference's
deployed size.

    python -m dani_slam_tpu_torch.models.lightglue_train --steps 1500 \
        [--official] --out lightglue_synthetic.npz [--device cpu]
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from dani_slam_tpu_torch.models import convert
from dani_slam_tpu_torch.models import superpoint as sp_mod
from dani_slam_tpu_torch.models.lightglue import (LightGlue,
                                                  normalize_keypoints)
from dani_slam_tpu_torch.models.lightglue_official import LightGlueOfficial
from dani_slam_tpu_torch.models.optim import Adam, cosine_decay
from dani_slam_tpu_torch.models.superpoint_train import (make_corner_batch,
                                                         save_params,
                                                         warp_batch)
from dani_slam_tpu_torch.ops import frontend
from dani_slam_tpu_torch.utils.device import no_tf32, resolve_device


# ---------------------------------------------------------------------------
# Host-side pair generation: base image + random homography
# ---------------------------------------------------------------------------

def sample_homographies(rng: np.random.RandomState, batch: int, h: int,
                        w: int, rot_deg: float = 25.0,
                        scale_rng=(0.85, 1.2), trans_frac: float = 0.12,
                        persp: float = 2e-4) -> np.ndarray:
    """Random homographies mapping img0 pixel coords -> img1 coords
    [B,3,3]."""
    Hs = np.zeros((batch, 3, 3), np.float32)
    cx, cy = w / 2.0, h / 2.0
    for b in range(batch):
        th = np.deg2rad(rng.uniform(-rot_deg, rot_deg))
        s = rng.uniform(*scale_rng)
        tx = rng.uniform(-trans_frac, trans_frac) * w
        ty = rng.uniform(-trans_frac, trans_frac) * h
        ca, sa = np.cos(th) * s, np.sin(th) * s
        A = np.array([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]])
        A[0, 2] = tx + cx - (A[0, 0] * cx + A[0, 1] * cy)
        A[1, 2] = ty + cy - (A[1, 0] * cx + A[1, 1] * cy)
        A[2, 0] = rng.uniform(-persp, persp)
        A[2, 1] = rng.uniform(-persp, persp)
        Hs[b] = A
    return Hs


def make_training_batch(rng: np.random.RandomState, batch: int, h: int,
                        w: int, n_pts: int = 80):
    """Base corner images, homographies and the warped view's photometric
    jitter (gain, bias) — host side, cheap."""
    imgs, _, _ = make_corner_batch(rng, batch, h, w, n_pts=n_pts)
    Hs = sample_homographies(rng, batch, h, w)
    gain = rng.uniform(0.8, 1.2, (batch, 1, 1, 1)).astype(np.float32)
    bias = rng.uniform(-0.05, 0.05, (batch, 1, 1, 1)).astype(np.float32)
    return imgs, Hs, gain, bias


# ---------------------------------------------------------------------------
# Device-side pipeline pieces
# ---------------------------------------------------------------------------

def apply_homography(Hs: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """xy [B,N,2] through H [B,3,3]."""
    q = torch.einsum('bij,bnj->bni', Hs,
                     torch.cat([xy, torch.ones_like(xy[..., :1])], -1))
    return q[..., :2] / torch.clamp(torch.abs(q[..., 2:]), min=1e-9) * \
        torch.sign(q[..., 2:])


def gt_assignment(xy0, v0, xy1, v1, Hs, w: int, h: int, px_th: float = 3.0):
    """Ground-truth matches from the homography: mutual pixel-space NN of
    the warped keypoints within px_th. Returns (M [B,N,N] bool match
    matrix, un0 [B,N] valid but unmatched, un1 [B,N])."""
    xy0w = apply_homography(Hs, xy0)
    inside = ((xy0w[..., 0] >= 0) & (xy0w[..., 0] <= w - 1) &
              (xy0w[..., 1] >= 0) & (xy0w[..., 1] <= h - 1))
    d2 = torch.sum((xy0w[..., :, None, :] - xy1[..., None, :, :]) ** 2, -1)
    big = torch.where((v0 & inside)[..., :, None] & v1[..., None, :], d2,
                      torch.full_like(d2, 1e12))
    j = torch.argmin(big, -1)
    i = torch.argmin(big, -2)
    N = xy0.shape[-2]
    mutual = torch.gather(i, -1, j) == torch.arange(N, device=xy0.device)
    dbest = torch.gather(big, -1, j[..., None])[..., 0]
    ok = mutual & (dbest <= px_th ** 2)
    M = ok[..., :, None] & F.one_hot(j, N).bool()
    un0 = v0 & ~torch.any(M, -1)
    un1 = v1 & ~torch.any(M, -2)
    return M, un0, un1


@torch.no_grad()
def extract_batch(sp_model, imgs: torch.Tensor, n_kp: int,
                  threshold: float = 0.010):
    """Batched SuperPoint extraction: imgs [B,h,w,1] -> (xy [B,n,2], desc
    [B,n,D], valid [B,n]) through frontend.select_keypoints and
    sample_descriptors."""
    heat, dmap = sp_model(imgs.permute(0, 3, 1, 2))
    out = []
    for hm, dm in zip(heat, dmap):
        xy, _, valid = frontend.select_keypoints(hm, n_max=n_kp,
                                                 threshold=threshold)
        out.append((xy, frontend.sample_descriptors(dm, xy), valid))
    return tuple(torch.stack(t) for t in zip(*out))


def matcher_loss(model, xy0n, xy1n, d0, d1, v0, v1, M, un0, un1):
    """LightGlue supervision: NLL of the ground-truth matches on the log
    assignment, plus the matchability penalty softplus(z) =
    -log(1 - sigmoid(z)) on unmatched points."""
    scores, z0, z1 = model(xy0n, xy1n, d0, d1, v0, v1)
    zero = torch.zeros((), device=scores.device)
    n_pos = torch.clamp(torch.sum(M), min=1.0)
    l_pos = -torch.sum(torch.where(M, scores, zero)) / n_pos
    l_un0 = torch.sum(torch.where(un0, F.softplus(z0), zero)) / \
        torch.clamp(torch.sum(un0), min=1.0)
    l_un1 = torch.sum(torch.where(un1, F.softplus(z1), zero)) / \
        torch.clamp(torch.sum(un1), min=1.0)
    return l_pos + 0.5 * (l_un0 + l_un1)


class StepOut(NamedTuple):
    loss: torch.Tensor
    n_gt: torch.Tensor


def pair_inputs(sp_model, imgs, Hs, gain, bias, n_kp: int, w: int, h: int):
    """Warp, extract both views as one batch, associate: the matcher's
    inputs (xy0n, xy1n, d0, d1, v0, v1) and targets (M, un0, un1)."""
    B = imgs.shape[0]
    imgs1 = torch.clamp(warp_batch(imgs, Hs) * gain + bias, 0.0, 1.0)
    xy, desc, valid = extract_batch(sp_model, torch.cat([imgs, imgs1]),
                                    n_kp)
    xy0, xy1 = xy[:B], xy[B:]
    v0, v1 = valid[:B], valid[B:]
    M, un0, un1 = gt_assignment(xy0, v0, xy1, v1, Hs, w, h)
    return ((normalize_keypoints(xy0, w, h), normalize_keypoints(xy1, w, h),
             desc[:B], desc[B:], v0, v1), (M, un0, un1))


def make_matcher(official: bool, dim: int, depth: int, seed: int):
    """The matcher to train, with Flax's initialization from seed."""
    if official:
        model = LightGlueOfficial(dim=256, depth=9, input_dim=256)
    else:
        model = LightGlue(dim=dim, depth=depth, input_dim=256)
    return convert.flax_init(model, seed)


def train_lightglue(steps: int = 1500, batch: int = 16, h: int = 160,
                    w: int = 160, n_kp: int = 128, dim: int = 128,
                    depth: int = 6, lr: float = 2e-4, seed: int = 0,
                    sp_model=None, log_every: int = 0,
                    official: bool = False, device="cuda", on_step=None,
                    init=None):
    """Train LightGlue on `device`; returns (model, StepOut of the last
    step). sp_model defaults to the shipped SuperPoint. official=True
    trains LightGlueOfficial (256-dim x 9 layers); the loss and labels are
    the same. `init` starts from that model instead of the seed's
    initialization; on_step(i, loss) is called after each step with the
    step's loss tensor."""
    device = resolve_device(device)
    if device.type == "cuda":
        no_tf32()
    rng = np.random.RandomState(seed)
    if sp_model is None:
        sp_model = sp_mod.load_default_params(device)
    model = (init if init is not None else
             make_matcher(official, dim, depth, seed)).to(device)
    opt = Adam(model.parameters(), cosine_decay(lr, steps), clip=1.0,
               weight_decay=1e-4)
    out = None
    for i in range(steps):
        arrays = make_training_batch(rng, batch, h, w)
        imgs, Hs, gain, bias = (torch.as_tensor(a).to(device)
                                for a in arrays)
        inputs, (M, un0, un1) = pair_inputs(sp_model, imgs, Hs, gain, bias,
                                            n_kp, w, h)
        loss = matcher_loss(model, *inputs, M, un0, un1)
        opt.zero_grad()
        loss.backward()
        opt.step()
        out = StepOut(loss.detach(), torch.sum(M))
        if on_step is not None:
            on_step(i, out.loss)
        if log_every and i % log_every == 0:
            print(f"step {i}: loss {float(out.loss):.4f} "
                  f"gt_matches {int(out.n_gt)}", flush=True)
    return model, out


@torch.no_grad()
def evaluate_matcher(model, sp_model=None, n_pairs: int = 32,
                     batch: int = 16, h: int = 160, w: int = 160,
                     n_kp: int = 128, seed: int = 1234,
                     threshold: float = 0.05):
    """Held-out precision / recall against the homography ground truth
    (the reference's accept gate: score >= 0.05 and mutual). Runs on the
    model's device."""
    device = next(model.parameters()).device
    rng = np.random.RandomState(seed)
    if sp_model is None:
        sp_model = sp_mod.load_default_params(device)
    n_c = n_p = n_g = 0
    for _ in range(max(n_pairs // batch, 1)):
        imgs, Hs, gain, bias = (torch.as_tensor(a).to(device) for a in
                                make_training_batch(rng, batch, h, w))
        (xy0n, xy1n, d0, d1, v0, v1), (M, _, _) = pair_inputs(
            sp_model, imgs, Hs, gain, bias, n_kp, w, h)
        scores, _, _ = model(xy0n, xy1n, d0, d1, v0, v1)
        s = torch.exp(scores)
        best, j = torch.max(s, -1)
        i = torch.argmax(s, -2)
        N = xy0n.shape[-2]
        mutual = torch.gather(i, -1, j) == torch.arange(N, device=device)
        pred = mutual & (best >= threshold) & v0 & torch.gather(v1, -1, j)
        correct = pred & torch.gather(M, -1, j[..., None])[..., 0]
        n_c += int(correct.sum())
        n_p += int(pred.sum())
        n_g += int(M.sum())
    return n_c / max(n_p, 1), n_c / max(n_g, 1), n_g


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n-kp", type=int, default=128)
    ap.add_argument("--official", action="store_true",
                    help="train the reference-scale official architecture "
                    "(256-dim x 9 layers) instead of the compact layout")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = args.out or ("lightglue_official_synthetic.npz" if args.official
                       else "lightglue_synthetic.npz")
    model, _ = train_lightglue(steps=args.steps, batch=args.batch,
                               n_kp=args.n_kp, log_every=50,
                               official=args.official, device=args.device)
    prec, rec, n_gt = evaluate_matcher(model, n_kp=args.n_kp)
    print(f"held-out: precision {prec:.3f} recall {rec:.3f} "
          f"(gt pairs {n_gt})")
    save_params(out, model)
    print("saved", out)


if __name__ == "__main__":
    main()
