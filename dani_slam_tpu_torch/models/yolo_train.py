"""Detector training on synthetic movable-object scenes (counterpart of
dani_slam_tpu/models/yolo_train.py): the compact YoloNet, or the folded
yolov5s (YoloV5Net) at the reference's deployed size, trained so the
dynamic-masking pipeline runs on real image input with no oracle boxes.

Scenes are corner blobs on a noisy background (the SuperPoint training
distribution) with two object classes: 0 "movable", a warm-tinted bright
envelope filled with corner texture, and 1 "static", a cool-tinted dark
one. The host rasterizes them with numpy (the JAX package's renderer, so a
seed gives bitwise the same scenes); a step (forward in bf16 as the JAX
modules run, target assembly, loss, backward, clip 5 + AdamW on a cosine
schedule, optax's formulas) runs on `device`.

    python -m dani_slam_tpu_torch.models.yolo_train --steps 1200 \
        [--official] --out yolo_synthetic.npz [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dani_slam_tpu_torch.models import convert
from dani_slam_tpu_torch.models.optim import Adam, cosine_decay, report_step
from dani_slam_tpu_torch.models.superpoint_train import save_params
from dani_slam_tpu_torch.models.yolo import (ANCHORS, STRIDES, YoloNet,
                                             box_iou, decode_predictions, nms)
from dani_slam_tpu_torch.utils.device import no_tf32, resolve_device

MAX_GT = 6


# ---------------------------------------------------------------------------
# Scene rendering (host-side numpy)
# ---------------------------------------------------------------------------

def _blobs(rng, img, x1, y1, x2, y2, n, amp_lo=0.35, amp_hi=0.7):
    """Sprinkle corner blobs into img[y1:y2, x1:x2] (all channels), each
    computed on its ~11x11 window."""
    h, w = img.shape[:2]
    for _ in range(n):
        cx = rng.uniform(x1 + 3, max(x2 - 3, x1 + 4))
        cy = rng.uniform(y1 + 3, max(y2 - 3, y1 + 4))
        amp = rng.uniform(amp_lo, amp_hi)
        ix1 = max(int(np.floor(cx - 5)), 0)
        ix2 = min(int(np.ceil(cx + 5)) + 1, w)
        iy1 = max(int(np.floor(cy - 5)), 0)
        iy2 = min(int(np.ceil(cy + 5)) + 1, h)
        if ix2 <= ix1 or iy2 <= iy1:
            continue
        yy, xx = np.mgrid[iy1:iy2, ix1:ix2]
        du, dv = xx - cx, yy - cy
        m = (np.abs(du) < 5) & (np.abs(dv) < 5)
        g = amp * np.exp(-(du ** 2 + dv ** 2) / (2 * 1.5 ** 2))
        sub = img[iy1:iy2, ix1:ix2]
        sub[m] = np.maximum(sub[m], (0.2 + g[m])[:, None])
    return img


# object envelope tints (RGB multipliers)
DYN_TINT = np.array([1.0, 0.55, 0.45], np.float32)    # warm = movable
STAT_TINT = np.array([0.45, 0.6, 1.0], np.float32)    # cool = static


def render_detection_scene(rng: np.random.RandomState, h: int, w: int,
                           n_bg_blobs: int = 30):
    """One scene -> (img [h,w,3] float [0,1], boxes [MAX_GT,4] xyxy,
    cls [MAX_GT], valid [MAX_GT])."""
    base = rng.uniform(0.10, 0.22)
    img = np.full((h, w, 3), base, np.float32)
    img += rng.randn(h, w, 1).astype(np.float32) * 0.02
    img = _blobs(rng, img, 0, 0, w, h, n_bg_blobs)

    boxes = np.zeros((MAX_GT, 4), np.float32)
    cls = np.zeros((MAX_GT,), np.int32)
    valid = np.zeros((MAX_GT,), bool)
    n_dyn = rng.randint(0, 3)
    n_stat = rng.randint(0, 2)
    k = 0
    for i in range(n_dyn + n_stat):
        is_dyn = i < n_dyn
        bw = rng.uniform(0.12, 0.45) * w
        bh = rng.uniform(0.12, 0.45) * h
        x1 = rng.uniform(0, w - bw)
        y1 = rng.uniform(0, h - bh)
        x2, y2 = x1 + bw, y1 + bh
        xi1, yi1, xi2, yi2 = int(x1), int(y1), int(x2), int(y2)
        tint = DYN_TINT if is_dyn else STAT_TINT
        level = rng.uniform(0.45, 0.65) if is_dyn else rng.uniform(0.28, 0.4)
        img[yi1:yi2, xi1:xi2] = level * tint
        img[yi1:yi2, xi1:xi2] += rng.randn(
            yi2 - yi1, xi2 - xi1, 1).astype(np.float32) * 0.02
        img = _blobs(rng, img, xi1, yi1, xi2, yi2,
                     max(3, int(bw * bh / 900)))
        if k < MAX_GT:
            boxes[k] = (x1, y1, x2, y2)
            cls[k] = 0 if is_dyn else 1
            valid[k] = True
            k += 1
    return np.clip(img, 0, 1), boxes, cls, valid


def make_detection_batch(rng, batch: int, h: int, w: int):
    imgs = np.zeros((batch, h, w, 3), np.float32)
    boxes = np.zeros((batch, MAX_GT, 4), np.float32)
    cls = np.zeros((batch, MAX_GT), np.int32)
    valid = np.zeros((batch, MAX_GT), bool)
    for b in range(batch):
        imgs[b], boxes[b], cls[b], valid[b] = render_detection_scene(
            rng, h, w)
    return imgs, boxes, cls, valid


# ---------------------------------------------------------------------------
# Target assembly + loss (YOLOv5 semantics, single-cell assignment)
# ---------------------------------------------------------------------------

def _anchor_wh(anchors, device):
    aw = torch.tensor([a[0] for a in anchors], dtype=torch.float32,
                      device=device)
    ah = torch.tensor([a[1] for a in anchors], dtype=torch.float32,
                      device=device)
    return aw, ah


def _build_targets_scale(gt_boxes, gt_cls, gt_valid, H: int, W: int,
                         stride: int, anchors, num_classes: int):
    """Assign each ground-truth box of every image [B,MAX_GT] to its centre
    cell and best-ratio anchor at this scale. Returns (tobj [B,H,W,3],
    tbox [B,H,W,3,4] xyxy, tcls [B,H,W,3]). The boxes go in order, so a
    later box wins a cell it shares with an earlier one; each pass writes
    one cell per image (no duplicate indices)."""
    B = gt_boxes.shape[0]
    dev = gt_boxes.device
    aw, ah = _anchor_wh(anchors, dev)
    tobj = torch.zeros((B, H, W, 3), dtype=gt_boxes.dtype, device=dev)
    tbox = torch.zeros((B, H, W, 3, 4), dtype=gt_boxes.dtype, device=dev)
    tcls = torch.zeros((B, H, W, 3), dtype=torch.int64, device=dev)
    bi = torch.arange(B, device=dev)
    for g in range(MAX_GT):
        b = gt_boxes[:, g]
        bw = b[:, 2] - b[:, 0]
        bh = b[:, 3] - b[:, 1]
        cx = (b[:, 0] + b[:, 2]) / 2.0
        cy = (b[:, 1] + b[:, 3]) / 2.0
        # the anchor whose shape best matches (YOLOv5 ratio gate r < 4)
        rw = torch.maximum(bw[:, None] / aw, aw / bw[:, None])
        rh = torch.maximum(bh[:, None] / ah, ah / bh[:, None])
        r = torch.maximum(rw, rh)
        a = torch.argmin(r, -1)
        ok = gt_valid[:, g] & (torch.gather(r, 1, a[:, None])[:, 0] < 4.0)
        ci = torch.clamp((cx / stride).to(torch.int64), 0, W - 1)
        cj = torch.clamp((cy / stride).to(torch.int64), 0, H - 1)
        idx = (bi, cj, ci, a)
        tobj[idx] = torch.maximum(tobj[idx], ok.to(tobj.dtype))
        tbox[idx] = torch.where(ok[:, None], b, tbox[idx])
        tcls[idx] = torch.where(ok, gt_cls[:, g].long(), tcls[idx])
    return tobj, tbox, tcls


def _decode_scale(p_sig, stride: int, anchors):
    """Sigmoid head activations [...,H,W,3,5+nc] -> xyxy boxes (the decode
    of models/yolo.decode_predictions)."""
    H, W = p_sig.shape[-4], p_sig.shape[-3]
    dev = p_sig.device
    gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None, None]
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
    aw, ah = _anchor_wh(anchors, dev)
    cx = (2 * p_sig[..., 0] - 0.5 + gx) * stride
    cy = (2 * p_sig[..., 1] - 0.5 + gy) * stride
    bw = (2 * p_sig[..., 2]) ** 2 * aw
    bh = (2 * p_sig[..., 3]) ** 2 * ah
    return torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                       -1)


def _iou_elementwise(a, b):
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area = (torch.clamp(a[..., 2] - a[..., 0], min=0) *
            torch.clamp(a[..., 3] - a[..., 1], min=0) +
            torch.clamp(b[..., 2] - b[..., 0], min=0) *
            torch.clamp(b[..., 3] - b[..., 1], min=0) - inter)
    return inter / torch.clamp(area, min=1e-9)


def _sigmoid_bce(logits, labels):
    """optax.sigmoid_binary_cross_entropy."""
    return -labels * F.logsigmoid(logits) - (1 - labels) * \
        F.logsigmoid(-logits)


def yolo_loss(model, imgs, gt_boxes, gt_cls, gt_valid, num_classes: int):
    """Mean over the batch of objectness BCE (positives x 20) + 2 x (1 -
    IoU) on positives + class BCE on positives, summed over the three
    scales; imgs [B,H,W,3]."""
    outs = model(imgs)
    total = 0.0
    for out, anchors, stride in zip(outs, ANCHORS, STRIDES):
        H, W = out.shape[1], out.shape[2]
        tobj, tbox, tcls = _build_targets_scale(
            gt_boxes, gt_cls, gt_valid, H, W, stride, anchors, num_classes)
        pos = tobj > 0.5
        zero = torch.zeros((), device=out.device)
        n_pos = torch.clamp(torch.sum(pos, (1, 2, 3)), min=1.0)
        bce = _sigmoid_bce(out[..., 4], tobj)
        obj = torch.sum(torch.where(pos, bce * 20.0, bce), (1, 2, 3)) / \
            (H * W * 3)
        iou = _iou_elementwise(_decode_scale(torch.sigmoid(out), stride,
                                             anchors), tbox)
        box = torch.sum(torch.where(pos, 1.0 - iou, zero), (1, 2, 3)) / n_pos
        onehot = F.one_hot(tcls, num_classes).to(torch.float32)
        cbce = torch.sum(_sigmoid_bce(out[..., 5:], onehot), -1)
        clsl = torch.sum(torch.where(pos, cbce, zero), (1, 2, 3)) / n_pos
        total = total + obj + 2.0 * box + clsl
    return torch.mean(total)


def train_yolo(steps: int = 1200, batch: int = 16, h: int = 192,
               w: int = 256, width: int = 16, num_classes: int = 2,
               lr: float = 1e-3, seed: int = 0, log_every: int = 0,
               model=None, device="cuda", on_step=None, init=None):
    """Train the compact YoloNet, or `model` (any module with the head
    output contract, e.g. yolo_official.YoloV5Net(80, 0.33, 0.50), the
    size the reference deploys) from Flax's initialization drawn from
    seed; `init` starts from that ready model instead. Returns (model,
    last_loss); on_step(i, loss) is called after each step with the step's
    loss tensor."""
    device = resolve_device(device)
    if device.type == "cuda":
        no_tf32()
    rng = np.random.RandomState(seed)
    if init is not None:
        model = init
    else:
        if model is None:
            model = YoloNet(num_classes=num_classes, width=width)
        model = convert.flax_init(model, seed)
    num_classes = model.num_classes
    model = model.to(device)
    opt = Adam(model.parameters(), cosine_decay(lr, steps), clip=5.0,
               weight_decay=1e-4)
    loss = None
    for i in range(steps):
        imgs, boxes, cls, valid = (torch.as_tensor(a).to(device) for a in
                                   make_detection_batch(rng, batch, h, w))
        loss = yolo_loss(model, imgs, boxes, cls, valid, num_classes)
        opt.zero_grad()
        loss.backward()
        opt.step()
        report_step(i, loss, log_every, on_step)
    return model, float(loss.detach())


@torch.no_grad()
def evaluate_detector(model, n_scenes: int = 32, h: int = 192,
                      w: int = 256, seed: int = 999, score_th: float = 0.4,
                      iou_th: float = 0.5):
    """Precision / recall of the detections of both classes at IoU 0.5
    (greedy one-to-one), on the model's device."""
    device = next(model.parameters()).device
    rng = np.random.RandomState(seed)
    n_gt = n_pred = n_hit = 0
    for _ in range(n_scenes):
        img, gtb, gtc, gtv = render_detection_scene(rng, h, w)
        outs = model(torch.as_tensor(img, device=device))
        b, s, c, ok = nms(*decode_predictions(outs), score_th=score_th)
        b, c, ok = b.cpu().numpy(), c.cpu().numpy(), ok.cpu().numpy()
        for cls_id in (0, 1):
            gt = gtb[gtv & (gtc == cls_id)]
            pr = b[ok & (c == cls_id)]
            n_gt += len(gt)
            n_pred += len(pr)
            if len(gt) and len(pr):
                iou = box_iou(torch.as_tensor(pr),
                              torch.as_tensor(gt)).numpy()
                used = np.zeros(len(gt), bool)
                for i in range(len(pr)):
                    j = int(np.argmax(np.where(used, -1.0, iou[i])))
                    if iou[i, j] >= iou_th and not used[j]:
                        used[j] = True
                        n_hit += 1
    return n_hit / max(n_pred, 1), n_hit / max(n_gt, 1), n_gt


def save_detector(path: str, model, meta):
    """The model's weights as the JAX package's npz plus __meta__ (width,
    classes, input h, w; width 0 for the official graph), which the
    detector loaders read."""
    save_params(path, model)
    data = dict(np.load(path))
    data["__meta__"] = np.asarray(meta, np.int32)
    np.savez_compressed(path, **data)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--official", action="store_true",
                    help="train the reference-scale yolov5s architecture "
                    "(v6.0 graph, depth 0.33 / width 0.50, 80-class head) "
                    "at 384x512 input instead of the compact layout")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = args.out or ("yolo_official_synthetic.npz" if args.official
                       else "yolo_synthetic.npz")
    if args.official:
        from dani_slam_tpu_torch.models.yolo_official import YoloV5Net
        h, w = 384, 512
        model, loss = train_yolo(steps=args.steps, batch=args.batch, h=h,
                                 w=w, model=YoloV5Net(80, 0.33, 0.50),
                                 log_every=50, device=args.device)
        meta = [0, 80, h, w]
    else:
        h, w = 192, 256
        model, loss = train_yolo(steps=args.steps, batch=args.batch,
                                 width=args.width, log_every=50,
                                 device=args.device)
        meta = [args.width, 2, h, w]
    prec, rec, n_gt = evaluate_detector(model, h=h, w=w)
    print(f"held-out: precision {prec:.3f} recall {rec:.3f} (gt {n_gt})")
    save_detector(out, model, meta)
    print("saved", out)


if __name__ == "__main__":
    main()
