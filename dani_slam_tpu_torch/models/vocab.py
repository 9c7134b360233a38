"""Bag-of-words place recognition (counterpart of
dani_slam_tpu/models/vocab.py). Only the similarity score that the Atlas
needs lives here so far; the codebook, the BoW transform and the database
queries come with the loop closer.
"""
from __future__ import annotations

import torch


def bow_l1_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DBoW3 L1 similarity of L1-normalized BoW vectors, broadcastable:
    s = 1 - 0.5 |a - b|_1."""
    return 1.0 - 0.5 * torch.sum(torch.abs(a - b), dim=-1)
