"""Checkpoint helpers (counterpart of dani_slam_tpu/utils/checkpoint.py).
Only the vocabulary checksum is here so far: the map save/load of the
reference package is not ported yet.
"""
from __future__ import annotations

import hashlib

import numpy as np


def codebook_checksum(codebook) -> str:
    """SHA-256 of the codebook's raw bytes (the value stored beside a
    shipped vocabulary)."""
    return hashlib.sha256(np.asarray(codebook).tobytes()).hexdigest()
