"""SuperPoint training on synthetic corner data (counterpart of
dani_slam_tpu/models/superpoint_train.py): supervised detector training on
synthetic shapes with known corner ground truth, plus a descriptor
contrastive term across warped views.

The host draws scenes with numpy (the generators are copies of the JAX
package's, so a seed gives bitwise the same arrays); the step (warp,
forward of both views, losses, backward, update) runs on `device`, in
float32 with TF32 off, as the JAX trainer runs in float32. The optimizer
is optax's (models/optim.py). Trained weights are saved as the JAX
package's npz (convert.to_flax: the layer names are SuperPoint's), so they
load in both packages.

    python -m dani_slam_tpu_torch.models.superpoint_train --steps 2500 \
        --out superpoint_synthetic.npz [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dani_slam_tpu_torch.models import convert
from dani_slam_tpu_torch.models.optim import Adam, cosine_decay, report_step
from dani_slam_tpu_torch.models.superpoint import SuperPoint
from dani_slam_tpu_torch.ops.image import remap_bilinear
from dani_slam_tpu_torch.utils.device import no_tf32, resolve_device


# ---------------------------------------------------------------------------
# Synthetic corner images (host-side numpy generators)
# ---------------------------------------------------------------------------

def make_corner_batch(rng: np.random.RandomState, batch: int, h: int, w: int,
                      n_pts: int = 24, shift=(0, 0)):
    """Random bright spots on noisy backgrounds; returns (images [B,H,W,1],
    corner coords [B,n_pts,2] (x,y), valid [B,n_pts])."""
    imgs = rng.uniform(0.1, 0.25, (batch, h, w)).astype(np.float32)
    imgs += rng.randn(batch, h, w).astype(np.float32) * 0.02
    xs = rng.uniform(6, w - 7, (batch, n_pts)).astype(np.float32) + shift[1]
    ys = rng.uniform(6, h - 7, (batch, n_pts)).astype(np.float32) + shift[0]
    valid = (xs > 4) & (xs < w - 5) & (ys > 4) & (ys < h - 5)
    yy, xx = np.mgrid[0:h, 0:w]
    for b in range(batch):
        for i in range(n_pts):
            if not valid[b, i]:
                continue
            du = xx - xs[b, i]
            dv = yy - ys[b, i]
            m = (np.abs(du) < 5) & (np.abs(dv) < 5)
            amp = rng.uniform(0.4, 0.8)
            g = amp * np.exp(-(du ** 2 + dv ** 2) / (2 * 1.5 ** 2))
            imgs[b] = np.where(m, np.maximum(imgs[b], 0.2 + g), imgs[b])
    xy = np.stack([xs, ys], -1)
    return (imgs[..., None], xy.astype(np.float32), valid)


def cell_labels(xy: np.ndarray, valid: np.ndarray, h: int, w: int):
    """Corner coords -> per-cell 65-class labels (8x8 cells; 64 = dustbin)
    matching the detector head's pixel-shuffle layout."""
    hc, wc = h // 8, w // 8
    lab = np.full((xy.shape[0], hc, wc), 64, np.int32)
    for b in range(xy.shape[0]):
        for i in range(xy.shape[1]):
            if not valid[b, i]:
                continue
            x, y = xy[b, i]
            cx, cy = int(x) // 8, int(y) // 8
            if 0 <= cx < wc and 0 <= cy < hc:
                lab[b, cy, cx] = (int(y) % 8) * 8 + (int(x) % 8)
    return lab


def make_textured_batch(rng: np.random.RandomState, batch: int, h: int,
                        w: int, n_pts: int = 24, n_sub: int = 4):
    """Scenes whose interest points are individually distinguishable: each
    point = dominant central blob + n_sub unique satellite micro-blobs
    within +-6.5 px. Returns (images [B,h,w,1], xy [B,n_pts,2],
    valid [B,n_pts])."""
    imgs = rng.uniform(0.1, 0.25, (batch, h, w)).astype(np.float32)
    imgs += rng.randn(batch, h, w).astype(np.float32) * 0.02
    xs = rng.uniform(10, w - 11, (batch, n_pts)).astype(np.float32)
    ys = rng.uniform(10, h - 11, (batch, n_pts)).astype(np.float32)
    valid = np.ones((batch, n_pts), bool)
    K = 1 + n_sub
    cx = np.repeat(xs[..., None], K, -1)          # [B,n,K]
    cy = np.repeat(ys[..., None], K, -1)
    ang = rng.uniform(0, 2 * np.pi, (batch, n_pts, K))
    rad = rng.uniform(2.5, 6.5, (batch, n_pts, K))
    cx[..., 1:] += (np.cos(ang) * rad)[..., 1:]
    cy[..., 1:] += (np.sin(ang) * rad)[..., 1:]
    amp = rng.uniform(0.25, 0.6, (batch, n_pts, K)).astype(np.float32)
    amp[..., 0] = rng.uniform(0.45, 0.8, (batch, n_pts))
    sig = rng.uniform(0.7, 1.3, (batch, n_pts, K)).astype(np.float32)
    sig[..., 0] = rng.uniform(1.2, 1.8, (batch, n_pts))
    P, r = 9, 4
    off = np.arange(-r, r + 1)
    u0 = np.round(cx).astype(np.int32)
    v0 = np.round(cy).astype(np.int32)
    dx = off[None, None, None, None, :] + (u0 - cx)[..., None, None]
    dy = off[None, None, None, :, None] + (v0 - cy)[..., None, None]
    g = amp[..., None, None] * np.exp(
        -(dx ** 2 + dy ** 2) / (2 * sig[..., None, None] ** 2))
    bb = np.broadcast_to(np.arange(batch)[:, None, None, None, None],
                         g.shape)
    xs_i = (u0[..., None, None] + off[None, None, None, None, :] +
            np.zeros((P, 1), np.int32))
    ys_i = (v0[..., None, None] + off[None, None, None, :, None] +
            np.zeros((1, P), np.int32))
    inb = ((xs_i >= 0) & (xs_i < w) & (ys_i >= 0) & (ys_i < h))
    np.maximum.at(imgs, (bb[inb], np.clip(ys_i, 0, h - 1)[inb],
                         np.clip(xs_i, 0, w - 1)[inb]),
                  (0.2 + g)[inb])
    xy = np.stack([xs, ys], -1)
    return imgs[..., None], xy.astype(np.float32), valid


def sample_homographies_np(rng: np.random.RandomState, batch: int, h: int,
                           w: int, rot_deg: float = 25.0,
                           scale_rng=(0.85, 1.2), trans_frac: float = 0.1,
                           persp: float = 2e-4) -> np.ndarray:
    """Random homographies img0 -> img1 pixel coords [B,3,3]."""
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


def warp_batch(imgs: torch.Tensor, Hs: torch.Tensor) -> torch.Tensor:
    """Warp imgs [B,h,w,1] by homographies H (img0 -> img1): img1 is
    sampled at Hinv @ p1 (cv::warpPerspective), 0 outside."""
    B, h, w = imgs.shape[:3]
    dev = imgs.device
    Hinv = torch.linalg.inv(Hs)
    yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    p1 = torch.stack([xx, yy, torch.ones_like(xx)], 0).to(
        torch.float32).reshape(3, -1)
    out = []
    for img, Hi in zip(imgs, Hinv):
        q = Hi @ p1
        out.append(remap_bilinear(img[..., 0], (q[0] / q[2]).reshape(h, w),
                                  (q[1] / q[2]).reshape(h, w))[..., None])
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Model and losses
# ---------------------------------------------------------------------------

def detector_loss(semi_logits: torch.Tensor, labels: torch.Tensor):
    """Cross-entropy over the 65-way cell classification: semi_logits
    [B,Hc,Wc,65], labels [B,Hc,Wc]."""
    return F.cross_entropy(semi_logits.permute(0, 3, 1, 2), labels.long())


class SuperPointLogits(SuperPoint):
    """The SuperPoint trunk in float32 exposing the raw detector logits:
    gray (B,1,H,W) -> (semi [B,H/8,W/8,65], desc [B,H/8,W/8,D]). The layer
    names are SuperPoint's, so trained weights load into the inference
    module unchanged."""

    def __init__(self, descriptor_dim: int = 256):
        super().__init__(descriptor_dim, compute_dtype=torch.float32)

    def forward(self, x: torch.Tensor):
        semi, desc = self.logits(x)
        return semi.permute(0, 2, 3, 1), desc


def init_logits_model(seed: int = 0, device="cuda") -> SuperPointLogits:
    """SuperPointLogits with Flax's initialization from seed."""
    return convert.flax_init(SuperPointLogits(), seed).to(
        resolve_device(device))


def _nchw(imgs) -> torch.Tensor:
    return imgs.permute(0, 3, 1, 2)


def _setup(device, seed: int, init):
    device = resolve_device(device)
    if device.type == "cuda":
        no_tf32()
    model = init.to(device) if init is not None else \
        init_logits_model(seed, device)
    return device, np.random.RandomState(seed), model


def _to(device, *arrays):
    return [torch.as_tensor(a).to(device) for a in arrays]


def v1_batch(rng: np.random.RandomState, batch: int, h: int, w: int):
    """One step's host data of train_superpoint: (imgs, labels, imgs_s,
    labels_s, shift_cells)."""
    shift = (8 * rng.randint(0, 2), 8 * rng.randint(0, 2))
    imgs, xy, valid = make_corner_batch(rng, batch, h, w)
    labels = cell_labels(xy, valid, h, w)
    # the SAME scene displaced by whole cells (the descriptor target is
    # exact under the roll)
    imgs_s = np.roll(imgs, (shift[0], shift[1]), axis=(1, 2))
    xy_sh = xy + np.asarray([shift[1], shift[0]], np.float32)
    valid_sh = valid & (xy_sh[..., 0] < w - 5) & (xy_sh[..., 1] < h - 5)
    labels_s = cell_labels(xy_sh, valid_sh, h, w)
    return imgs, labels, imgs_s, labels_s, (shift[0] // 8, shift[1] // 8)


def v1_loss(model, imgs, labels, imgs_s, labels_s, shift_cells):
    """Detector CE on both views + 0.2 x InfoNCE of each cell's descriptor
    against the cell grid of the view shifted by whole cells."""
    semi, desc = model(_nchw(imgs))
    semi_s, desc_s = model(_nchw(imgs_s))
    det = detector_loss(semi, labels) + detector_loss(semi_s, labels_s)
    B, Hc, Wc, D = desc.shape
    d0 = desc.reshape(B, -1, D)
    d1 = torch.roll(desc_s, (-shift_cells[0], -shift_cells[1]),
                    dims=(1, 2)).reshape(B, -1, D)
    sim = torch.einsum('bnd,bmd->bnm', d0, d1) / 0.1
    lab = torch.arange(Hc * Wc, device=desc.device)[None].expand(B, -1)
    nce = F.cross_entropy(sim.permute(0, 2, 1), lab)
    return det + 0.2 * nce


def train_superpoint(steps: int = 800, batch: int = 8, h: int = 96,
                     w: int = 96, lr: float = 1e-3, seed: int = 0,
                     log_every: int = 0, device="cuda", on_step=None,
                     init=None):
    """Train a full-size SuperPoint (v1 recipe). Returns (model,
    last_loss). on_step(i, loss) is called after each step with the step's
    loss tensor (on the device; reading it waits for the step); `init`
    (a SuperPointLogits) starts from that model instead of the seed's
    initialization."""
    device, rng, model = _setup(device, seed, init)
    opt = Adam(model.parameters(), lr)
    loss = None
    for i in range(steps):
        imgs, labels, imgs_s, labels_s, cells = v1_batch(rng, batch, h, w)
        loss = v1_loss(model, *_to(device, imgs, labels, imgs_s, labels_s),
                       cells)
        opt.zero_grad()
        loss.backward()
        opt.step()
        report_step(i, loss, log_every, on_step)
    return model, float(loss.detach())


# ---------------------------------------------------------------------------
# v2: homography pairs, per-point distinctive micro-texture, point-level
# cross-view InfoNCE over the whole batch
# ---------------------------------------------------------------------------

def v2_batch(rng: np.random.RandomState, i: int, batch: int, h: int, w: int,
             n_pts: int):
    """Step i's host data of train_superpoint_v2: (imgs, Hs, labels0,
    labels1, xy0, xy1, pvalid, gain, bias). Every third step draws plain
    isotropic blobs, the others the textured points."""
    if i % 3 == 2:
        imgs, xy, valid = make_corner_batch(rng, batch, h, w, n_pts=n_pts)
    else:
        imgs, xy, valid = make_textured_batch(rng, batch, h, w, n_pts=n_pts)
    Hs = sample_homographies_np(rng, batch, h, w)
    xy1 = np.einsum('bij,bnj->bni', Hs, np.concatenate(
        [xy, np.ones_like(xy[..., :1])], -1))
    xy1 = xy1[..., :2] / np.maximum(np.abs(xy1[..., 2:]), 1e-9) * \
        np.sign(xy1[..., 2:])
    in1 = ((xy1[..., 0] > 8) & (xy1[..., 0] < w - 9) &
           (xy1[..., 1] > 8) & (xy1[..., 1] < h - 9))
    pvalid = valid & in1
    labels0 = cell_labels(xy, valid, h, w)
    labels1 = cell_labels(xy1.astype(np.float32), pvalid, h, w)
    gain = rng.uniform(0.8, 1.2, (batch, 1, 1, 1)).astype(np.float32)
    bias = rng.uniform(-0.05, 0.05, (batch, 1, 1, 1)).astype(np.float32)
    return (imgs, Hs, labels0, labels1, xy, xy1.astype(np.float32), pvalid,
            gain, bias)


def sample_desc(desc_map: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of the /8 descriptor maps [B,Hc,Wc,D] at pixel
    coords [B,n,2] (cell centres at 8 k + 4), re-normalized."""
    B, Hc, Wc, _ = desc_map.shape
    gx = xy[..., 0] / 8.0 - 0.5
    gy = xy[..., 1] / 8.0 - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0)[..., None]
    fy = (gy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    bi = torch.arange(B, device=xy.device)[:, None]

    def at(yi, xi):
        return desc_map[bi, torch.clamp(yi, 0, Hc - 1),
                        torch.clamp(xi, 0, Wc - 1)]
    d = (at(y0, x0) * ((1 - fx) * (1 - fy)) +
         at(y0, x0 + 1) * (fx * (1 - fy)) +
         at(y0 + 1, x0) * ((1 - fx) * fy) +
         at(y0 + 1, x0 + 1) * (fx * fy))
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                           min=1e-8)


def v2_loss(model, imgs, Hs, labels0, labels1, xy0, xy1, pvalid, gain,
            bias, nce_weight: float = 1.0, temp: float = 0.1):
    """Detector CE on both views + nce_weight/2 x the symmetric InfoNCE of
    the points' descriptors across the two views, every other point of the
    batch a negative."""
    imgs1 = torch.clamp(warp_batch(imgs, Hs) * gain + bias, 0.0, 1.0)
    semi0, desc0 = model(_nchw(imgs))
    semi1, desc1 = model(_nchw(imgs1))
    det = detector_loss(semi0, labels0) + detector_loss(semi1, labels1)
    d0 = sample_desc(desc0, xy0)
    d1 = sample_desc(desc1, xy1)
    B, n, D = d0.shape
    f0 = d0.reshape(B * n, D)
    f1 = d1.reshape(B * n, D)
    pv = pvalid.reshape(B * n)
    neg = torch.full((), -1e9, device=f0.device)
    sim = (f0 @ f1.T) / temp                        # [Bn,Bn]
    sim = torch.where(pv[None, :], sim, neg)
    simT = torch.where(pv[:, None], sim, neg)
    lab = torch.arange(B * n, device=f0.device)
    ce0 = F.cross_entropy(sim, lab, reduction="none")
    ce1 = F.cross_entropy(simT.T, lab, reduction="none")
    nce = (torch.sum(torch.where(pv, ce0 + ce1, torch.zeros_like(ce0))) /
           torch.clamp(torch.sum(pv), min=1.0))
    return det + nce_weight * 0.5 * nce


def train_superpoint_v2(steps: int = 2500, batch: int = 12, h: int = 120,
                        w: int = 120, n_pts: int = 28, lr: float = 1e-3,
                        seed: int = 0, log_every: int = 0,
                        nce_weight: float = 1.0, temp: float = 0.1,
                        device="cuda", on_step=None, init=None):
    """Homography-pair training: detector CE on both views + point-level
    cross-view InfoNCE over the whole batch, clip 5 + Adam on a cosine
    schedule. Returns (model, last_loss); on_step and init as
    train_superpoint."""
    device, rng, model = _setup(device, seed, init)
    opt = Adam(model.parameters(), cosine_decay(lr, steps), clip=5.0)
    loss = None
    for i in range(steps):
        loss = v2_loss(model, *_to(device, *v2_batch(rng, i, batch, h, w,
                                                     n_pts)),
                       nce_weight=nce_weight, temp=temp)
        opt.zero_grad()
        loss.backward()
        opt.step()
        report_step(i, loss, log_every, on_step)
    return model, float(loss.detach())


def save_params(path: str, model):
    """The model's weights as the JAX package's npz ('params/conv1a/
    kernel', HWIO, ...)."""
    convert.save_params(path, convert.to_flax(model))


load_params = convert.load_params


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--out", default="superpoint_synthetic.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    model, loss = train_superpoint_v2(steps=args.steps, batch=args.batch,
                                      log_every=50, device=args.device)
    save_params(args.out, model)
    print("final loss", loss, "saved", args.out)


if __name__ == "__main__":
    main()
