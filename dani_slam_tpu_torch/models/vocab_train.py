"""Offline vocabulary training (counterpart of
dani_slam_tpu/models/vocab_train.py): the place-recognition codebook that
loop detection and relocalization score against from the first keyframe
on (the reference loads a pre-trained vocabulary before any tracking).

Corpus: the textured synthetic scenes the shipped SuperPoint was trained on
(superpoint_train.make_textured_batch), so the vocabulary partitions the
descriptor distribution the extractor emits; SuperPoint and
frontend.extract run on `device`. Spherical k-means (vocab.train_codebook)
on the unit descriptors, seeded with a random subset of the corpus.

    python -m dani_slam_tpu_torch.models.vocab_train [--images N] \
        [--words V] --out superpoint_voc.npz [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from dani_slam_tpu_torch.models import superpoint, vocab
from dani_slam_tpu_torch.models.superpoint_train import make_textured_batch
from dani_slam_tpu_torch.ops import frontend
from dani_slam_tpu_torch.utils.checkpoint import codebook_checksum
from dani_slam_tpu_torch.utils.device import resolve_device


def build_corpus(sp_model, n_images: int = 400, h: int = 240, w: int = 320,
                 n_per: int = 512, seed: int = 0,
                 threshold: float = 0.002) -> np.ndarray:
    """Render textured scenes, extract SuperPoint descriptors on the
    model's device, return the stacked [M,D] unit descriptor corpus."""
    device = next(sp_model.parameters()).device
    rng = np.random.RandomState(seed)
    descs = []
    bs = 4
    for _ in range(0, n_images, bs):
        imgs, _, _ = make_textured_batch(rng, bs, h, w)
        for b in range(bs):
            heat, dm = superpoint.apply(
                sp_model, torch.as_tensor(imgs[b, ..., 0], device=device))
            out = frontend.extract(heat, dm, n_max=n_per,
                                   threshold=threshold)
            d = out["desc"][out["valid"]].cpu().numpy()
            if len(d):
                descs.append(d.astype(np.float32))
    corpus = np.concatenate(descs, 0)
    n = np.linalg.norm(corpus, axis=-1, keepdims=True)
    return corpus / np.maximum(n, 1e-9)


def train_vocab(corpus: np.ndarray, n_words: int = 1024, iters: int = 40,
                seed: int = 0, device="cuda") -> np.ndarray:
    """Spherical k-means codebook [n_words, D] of the corpus, seeded with a
    random subset of it (every word starts on the data)."""
    device = resolve_device(device)
    pick = np.random.RandomState(seed).choice(len(corpus), n_words,
                                              replace=False)
    desc = torch.as_tensor(corpus, device=device)
    cb = vocab.train_codebook(
        desc, torch.ones(len(corpus), dtype=torch.bool, device=device),
        torch.as_tensor(corpus[pick], device=device), iters=iters)
    return cb.cpu().numpy()


def save_vocab(path: str, codebook: np.ndarray):
    """{codebook [V,D] f32, sha}: the file vocab.load_default_codebook and
    the JAX package read."""
    np.savez(path, codebook=codebook.astype(np.float32),
             sha=np.frombuffer(codebook_checksum(
                 codebook.astype(np.float32)).encode(), np.uint8))


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=400)
    ap.add_argument("--words", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--out", default="superpoint_voc.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sp_model = superpoint.load_default_params(args.device)
    corpus = build_corpus(sp_model, n_images=args.images)
    print(f"corpus: {corpus.shape[0]} descriptors")
    cb = train_vocab(corpus, n_words=args.words, iters=args.iters,
                     device=args.device)
    # quantization balance: no dead words, no mega-words
    sim = corpus[:20000] @ cb.T
    words, counts = np.unique(np.argmax(sim, -1), return_counts=True)
    print(f"words used by 20k sample: {len(words)}/{args.words}, "
          f"top word {counts.max()} hits")
    save_vocab(args.out, cb)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
