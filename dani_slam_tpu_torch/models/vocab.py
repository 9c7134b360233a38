"""Place recognition: descriptor quantization and a dense bag-of-words
database (counterpart of dani_slam_tpu/models/vocab.py).

The vocabulary tree of DBoW3 is one matmul (descriptors x codebook^T, argmax
word per descriptor), a keyframe's BoW is a dense L1-normalized
term-frequency vector [V], and the keyframe database is a [K, V] tensor
scored with one matvec; the covisibility-group accumulation is a [K, K]
matmul with the covisibility mask.

Translation notes: every function keeps its reference arithmetic in f32
(TF32 is off, see System); `.at[w].add` over word ids becomes a
deterministic id reduction (core/scatterless); the random codebook is drawn
from an explicit torch.Generator; `jax.lax.top_k` becomes a stable
descending sort (lower index first on ties, as top_k).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dani_slam_tpu_torch.core import scatterless as sless
from dani_slam_tpu_torch.core import state as mstate
from dani_slam_tpu_torch.utils.device import resolve_device


def random_codebook(gen: torch.Generator, n_words: int = 1024,
                    dim: int = 256) -> torch.Tensor:
    """[n_words, dim] unit vectors drawn from `gen`, on its device."""
    c = torch.randn((n_words, dim), generator=gen, device=gen.device)
    return c / torch.linalg.norm(c, dim=-1, keepdim=True)


def load_default_codebook(dim: int = 256, device="cuda", path=None):
    """The shipped vocabulary (dani_slam_tpu/weights/superpoint_voc.npz, or
    the file at `path` that vocab_train.save_vocab writes) as a [V, dim]
    tensor on `device`, after checking its SHA-256; None when the file is
    absent or its width is not `dim` (synthetic-feature runs at D = 64
    train a live vocabulary instead)."""
    from dani_slam_tpu_torch.utils.checkpoint import codebook_checksum
    if path is None:
        path = os.path.join(os.path.dirname(__file__), "..", "..",
                            "dani_slam_tpu", "weights", "superpoint_voc.npz")
    if not os.path.exists(path):
        return None
    data = np.load(path)
    cb = data["codebook"]
    if cb.shape[1] != dim:
        return None
    if "sha" in data.files:
        want = bytes(data["sha"]).decode()
        if codebook_checksum(cb) != want:
            raise ValueError(f"vocabulary checksum mismatch: {path}")
    return torch.as_tensor(cb, device=resolve_device(device))


def train_codebook(desc: torch.Tensor, mask: torch.Tensor,
                   codebook0: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Spherical k-means on unit descriptors [N, D] (masked): one matmul and
    one per-word sum per iteration."""
    V = codebook0.shape[0]
    cb = codebook0
    for _ in range(iters):
        w = torch.argmax(desc @ cb.T, dim=-1)
        sums = sless.id_sum(w, mask, desc, V)
        norm = torch.linalg.norm(sums, dim=-1, keepdim=True)
        cb = torch.where(norm > 1e-6, sums / torch.clamp(norm, min=1e-6), cb)
    return cb


def quantize(desc: torch.Tensor, mask: torch.Tensor,
             codebook: torch.Tensor) -> torch.Tensor:
    """Descriptors [N, D] -> word ids [N] int32 (argmax cosine in f32; -1
    where masked)."""
    w = torch.argmax(desc @ codebook.T, dim=-1).to(torch.int32)
    return torch.where(mask, w, torch.full_like(w, -1))


def bow_vector(words: torch.Tensor, n_words: int) -> torch.Tensor:
    """Word ids [..., N] -> L1-normalized term-frequency vectors [..., V]."""
    valid = words >= 0
    lead = words.shape[:-1]
    w = words.reshape(-1, words.shape[-1]).long()
    v = valid.reshape(w.shape)
    B = w.shape[0]
    off = torch.arange(B, device=w.device)[:, None] * n_words
    tf = sless.id_count((w + off).reshape(-1), v.reshape(-1),
                        B * n_words).reshape(lead + (n_words,))
    tf = tf.to(torch.float32)
    return tf / torch.clamp(tf.sum(-1, keepdim=True), min=1.0)


def update_bow_row(bow: torch.Tensor, kf_desc: torch.Tensor,
                   kf_kp_mask: torch.Tensor, k: torch.Tensor,
                   codebook: torch.Tensor):
    """Quantize keyframe k's descriptors (k a 0-d device tensor, read with
    no host sync) and write its BoW row. Returns (bow, row)."""
    w = quantize(sless.row(kf_desc, k), sless.row(kf_kp_mask, k), codebook)
    row = bow_vector(w, codebook.shape[0])
    return mstate._set(bow, k, row), row


def bow_l1_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DBoW3 L1 similarity of L1-normalized BoW vectors, broadcastable:
    s = 1 - 0.5 |a - b|_1."""
    return 1.0 - 0.5 * torch.sum(torch.abs(a - b), dim=-1)


def idf_weights(bow_db: torch.Tensor, kf_mask: torch.Tensor) -> torch.Tensor:
    """Inverse document frequency over the live database [V] (the keyframe
    database is the corpus)."""
    present = (bow_db > 0) & kf_mask[:, None]
    df = torch.sum(present.to(torch.float32), dim=0)
    n = torch.clamp(torch.sum(kf_mask.to(torch.float32)), min=1.0)
    return torch.log((n + 1.0) / (df + 1.0)) + 1.0


def _tfidf_rows(bow: torch.Tensor, idf: torch.Tensor) -> torch.Tensor:
    w = bow * idf
    return w / torch.clamp(torch.sum(torch.abs(w), dim=-1, keepdim=True),
                           min=1e-9)


def rebuild_bow_rows(kf_desc: torch.Tensor, kf_kp_mask: torch.Tensor,
                     kf_mask: torch.Tensor,
                     codebook: torch.Tensor) -> torch.Tensor:
    """Re-quantize every keyframe against a (new) codebook: the [K, V]
    database in one batched pass."""
    w = torch.argmax(kf_desc @ codebook.T, dim=-1).to(torch.int32)
    w = torch.where(kf_kp_mask & kf_mask[:, None], w, torch.full_like(w, -1))
    return bow_vector(w, codebook.shape[0])


class PlaceDB:
    """Dense BoW database over keyframe slots (device-resident)."""

    def __init__(self, codebook: torch.Tensor, n_kf: int):
        self.codebook = codebook
        self.bow = torch.zeros((n_kf, codebook.shape[0]),
                               device=codebook.device)

    def add(self, kf: int, desc: torch.Tensor, mask: torch.Tensor):
        w = quantize(desc, mask, self.codebook)
        self.bow = self.bow.clone()
        self.bow[kf] = bow_vector(w, self.codebook.shape[0])

    def remove(self, kf: int):
        self.bow = self.bow.clone()
        self.bow[kf] = 0.0


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries, lower index first on
    ties (jax.lax.top_k's order; torch.topk leaves it unspecified)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _group_matrix(covis: torch.Tensor) -> torch.Tensor:
    """1 on the diagonal and where two keyframes share > 10 observations."""
    K = covis.shape[0]
    eye = torch.eye(K, dtype=torch.bool, device=covis.device)
    return torch.where(eye, 1.0, (covis > 10).to(torch.float32))


def detect_candidates(bow_db: torch.Tensor, kf_mask: torch.Tensor,
                      query_bow: torch.Tensor, covis: torch.Tensor,
                      query_kf: torch.Tensor, n_best: int = 3,
                      min_covis_exclude: int = 15):
    """Loop/merge candidates (reference: KeyFrameDatabase::
    DetectNBestCandidates): tf-idf L1 scores of the keyframes outside the
    query's connected neighborhood that pass the shared-word gate, summed
    over covisible groups; returns (idx [n_best] int32, scores)."""
    idf = idf_weights(bow_db, kf_mask)
    db_w = _tfidf_rows(bow_db, idf)
    q_w = _tfidf_rows(query_bow[None], idf)[0]
    K = bow_db.shape[0]
    connected = sless.row(covis, query_kf) >= min_covis_exclude
    eligible = kf_mask & ~connected & \
        (torch.arange(K, device=kf_mask.device) != query_kf)
    shared = (bow_db > 0).to(torch.float32) @ \
        (query_bow > 0).to(torch.float32)
    shared = torch.where(eligible, shared, torch.zeros_like(shared))
    gated = eligible & (shared > 0.8 * torch.max(shared)) & (shared > 0)
    scores = torch.where(gated, bow_l1_score(db_w, q_w[None]),
                         torch.zeros_like(shared))
    acc = _group_matrix(covis) @ scores
    acc = torch.where(gated, acc, torch.full_like(acc, -1.0))
    vals, idx = _top_k(acc, n_best)
    return idx.to(torch.int32), vals


def detect_reloc_candidates(bow_db: torch.Tensor, kf_mask: torch.Tensor,
                            query_bow: torch.Tensor, covis=None,
                            n_best: int = 5):
    """Relocalization candidates (reference: DetectRelocalizationCandidates):
    shared-word gate, L1 tf-idf scores, then covisible-group accumulation
    with each group represented by its best member and groups below 0.75 of
    the best cut. Returns (idx [n_best] int32, scores, keep [n_best] bool);
    covis=None skips the group stage."""
    idf = idf_weights(bow_db, kf_mask)
    db_w = _tfidf_rows(bow_db, idf)
    q_w = _tfidf_rows(query_bow[None], idf)[0]
    shared = (bow_db > 0).to(torch.float32) @ \
        (query_bow > 0).to(torch.float32)
    shared = torch.where(kf_mask, shared, torch.zeros_like(shared))
    min_common = 0.8 * torch.max(shared)
    gate = kf_mask & (shared >= torch.clamp(min_common, min=1.0))
    scores = torch.where(gate, bow_l1_score(db_w, q_w[None]),
                         torch.zeros_like(shared))
    if covis is None:
        acc = torch.where(gate, scores, torch.full_like(scores, -1.0))
        vals, idx = _top_k(acc, n_best)
        keep = (vals >= 0.8 * vals[0]) & (vals > 0)
        return idx.to(torch.int32), vals, keep
    group = _group_matrix(covis)
    acc = group @ scores
    in_group = torch.where(group > 0, scores[None, :],
                           torch.full_like(group, -1.0))
    member_best = torch.amax(in_group, dim=1)
    best_in_group = torch.argmax(in_group, dim=1)
    acc = torch.where(gate, acc, torch.full_like(acc, -1.0))
    vals, gidx = _top_k(acc, n_best)
    idx = best_in_group[gidx]
    keep = (vals >= 0.75 * vals[0]) & (vals > 0) & (member_best[gidx] > 0)
    # overlapping groups can share a best member: later ranks that repeat
    # an earlier one are dropped
    earlier = torch.tril(torch.ones((n_best, n_best), dtype=torch.bool,
                                    device=idx.device), diagonal=-1)
    dup = torch.any((idx[:, None] == idx[None, :]) & earlier, dim=1)
    return idx.to(torch.int32), vals, keep & ~dup
