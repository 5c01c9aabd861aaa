"""Sender: batched clue generation on the host.

PyTorch-package counterpart of :mod:`tfhe_omr_tpu.core.sender` (its host
path ``Sender.gen_clues``, numpy only, bit-identical for the same numpy
stream). ``gen_clues`` encrypts ``clue_count`` zeros into one compact
ciphertext per message: a = u*pk_a + e_a and b = u*pk_b + e_b with binary u.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from tfhe_omr_tpu_torch.core.keygen import ClueKey
from tfhe_omr_tpu_torch.core.params import OmrParameters


class ClueBatch(NamedTuple):
    """Compact multi-message LWE ciphertexts for a batch of messages: ring
    mask ``a`` (B, n0) plus the ``clue_count`` masked coefficients ``b7``
    (B, clue_count), mod q0."""

    a: np.ndarray
    b7: np.ndarray

    @staticmethod
    def concat(batches):
        return ClueBatch(
            np.concatenate([x.a for x in batches]),
            np.concatenate([x.b7 for x in batches]),
        )


class Sender:
    def __init__(self, clue_key: ClueKey, params: OmrParameters):
        self.clue_key = clue_key
        self.params = params

    def gen_clues(self, count: int, rng: np.random.Generator) -> ClueBatch:
        """Encrypt ``count`` all-zero clue vectors under this sender's key."""
        k = self.clue_key
        n = k.mat_a.shape[0]
        q0 = k.q0
        u = rng.integers(0, 2, size=(count, n), dtype=np.int64)
        e_a = np.rint(rng.normal(0, k.noise_std, size=(count, n))).astype(np.int64)
        e_b = np.rint(
            rng.normal(0, k.noise_std, size=(count, k.clue_count))
        ).astype(np.int64)
        a = np.mod(u @ k.mat_a + e_a, q0)
        b7 = np.mod(u @ k.mat_b7 + e_b, q0)
        return ClueBatch(a=a, b7=b7)
