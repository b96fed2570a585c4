"""The yak invertible 64-bit integer hash (htab.h:150-160).

The numpy uint64 form (wrapping arithmetic). The k-mer hash used
throughout the assembler is ``yak_hash64_64(kmer_low) + yak_hash64_64
(kmer_high)`` on the strand-canonical 1-bit-per-base words (sketch.cpp:508).
"""

from __future__ import annotations

import numpy as np


def yak_hash64_np(key: np.ndarray) -> np.ndarray:
    """numpy uint64 version of yak_hash64_64 (wrapping arithmetic)."""
    key = np.asarray(key, dtype=np.uint64)
    with np.errstate(over="ignore"):
        key = ~key + (key << np.uint64(21))
        key = key ^ (key >> np.uint64(24))
        key = key + (key << np.uint64(3)) + (key << np.uint64(8))
        key = key ^ (key >> np.uint64(14))
        key = key + (key << np.uint64(2)) + (key << np.uint64(4))
        key = key ^ (key >> np.uint64(28))
        key = key + (key << np.uint64(31))
    return key


def kmer_hash_np(x_low: np.ndarray, x_high: np.ndarray) -> np.ndarray:
    """Hash of a canonical k-mer given its two 1-bit-per-base words."""
    return yak_hash64_np(x_low) + yak_hash64_np(x_high)

