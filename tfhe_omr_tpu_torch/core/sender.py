"""Sender: batched clue generation, on the host or on the device.

PyTorch-package counterpart of :mod:`tfhe_omr_tpu.core.sender`. Each clue
encrypts ``clue_count`` zeros into one compact ciphertext per message:
a = u*pk_a + e_a and b = u*pk_b + e_b with binary u (``clue.rs:26-34``).

* ``gen_clues``: numpy, bit-identical to the JAX package for the same
  numpy stream.
* ``gen_clues_device_resident`` / ``gen_clues_device``: masks and noise
  from a ``torch.Generator`` on the sender's device, the public-key product
  a float64 ``torch.matmul`` (exact: entries below 2**11, sums below
  2**21). The JAX package's threefry bits cannot be reproduced; these
  clues are held by decryption (each decrypts to 0 under its pack).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tfhe_omr_tpu_torch.core.keygen import ClueKey
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.utils.build import resolve_device


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
    #: rows per device draw: a count's clues are the first rows of the
    #: stream of whole chunks, so they do not depend on the count
    CHUNK = 8192

    def __init__(self, clue_key: ClueKey, params: OmrParameters, device=None):
        self.clue_key = clue_key
        self.params = params
        self.device = resolve_device(device)
        k = clue_key
        #: (n, n + clue_count) public-key columns a | b7, for the matmul
        self._mat = torch.as_tensor(
            np.concatenate([k.mat_a, k.mat_b7], axis=1), dtype=torch.float64,
            device=self.device)

    def clue_key_size(self) -> int:
        """Bytes of the public key (the reference's ``Size`` accounting):
        (pk_a, pk_b) of u16 coefficients."""
        return 2 * self.clue_key.mat_a.shape[0] * 2

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

    def gen_clues_device_resident(self, count: int, seed: int) -> torch.Tensor:
        """``count`` clues as one (count, n + clue_count) int64 tensor on the
        sender's device (columns a | b7, mod q0), never fetched to the host.

        One ``torch.Generator`` seeded with ``seed`` draws whole chunks of
        :attr:`CHUNK` rows: the binary masks u, then the rounded Gaussian
        noise of a and of b7.
        """
        k = self.clue_key
        n = k.mat_a.shape[0]
        width = n + k.clue_count
        if count <= 0:
            # all-pertinent boards ask for 0 decoy clues
            return torch.zeros((0, width), dtype=torch.int64, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        outs = []
        for _ in range(-(-count // self.CHUNK)):
            u = torch.randint(0, 2, (self.CHUNK, n), generator=gen,
                              device=self.device, dtype=torch.int64)
            r = torch.matmul(u.to(torch.float64), self._mat).to(torch.int64)
            if k.noise_std > 0.0:
                e = torch.randn((self.CHUNK, width), generator=gen,
                                device=self.device, dtype=torch.float64)
                r = r + torch.round(e * k.noise_std).to(torch.int64)
            outs.append(r & (k.q0 - 1))  # q0 is a power of two
        return torch.cat(outs)[:count]

    def gen_clues_device(self, count: int, seed: int) -> ClueBatch:
        """:meth:`gen_clues_device_resident`, fetched into a host
        :class:`ClueBatch` (the layout of :meth:`gen_clues`)."""
        out = self.gen_clues_device_resident(count, seed).cpu().numpy()
        n = self.clue_key.mat_a.shape[0]
        return ClueBatch(a=out[:, :n], b7=out[:, n:])
