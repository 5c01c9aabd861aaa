"""Gadget decomposition: approximate signed (TFHE-style) and exact digits.

PyTorch counterpart of :mod:`tfhe_omr_tpu.ops.decompose`, with the same
convention so digits and gadget values are bit-equal to the JAX package:

* **approx** (``d * log_B < ceil(log q)``; both blind-rotation keys):
  ``u = round(x * B**d / q)`` through a first-order Solinas correction,
  then balanced signed digits of ``u`` LSB-first; the final carry
  multiplies ``q`` and vanishes mod q. ``h_j = round(q * B**j / B**d)``.
* **exact** (``d * log_B >= ceil(log q)``; key-switching and trace bases):
  unsigned base-B digits of x, ``h_j = B**j``, zero error.

The CUDA kernels compute the same digits: ``csrc/trace.cuh`` the exact
ones of the trace, ``csrc/blind_rotate.cuh`` the approximate ones from one
rounding and an offset (``H = sum_j (B/2) B**j``: the balanced digits of u
are the plain base-B digits of ``u + H`` less ``B/2``).
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_omr_tpu_torch.ops.modmath import PrimeField


class SignedGadget:
    """Decomposition basis for modulus q, base ``B = 2**log_b``, ``d`` digits."""

    def __init__(self, field: PrimeField, log_b: int, d: int):
        self.field = field
        self.log_b = log_b
        self.d = d
        q = field.q
        qbits = field.bits
        self.exact = d * log_b >= qbits
        if self.exact:
            self.h = [(1 << (log_b * j)) % q for j in range(d)]
            self.shift = 0
        else:
            self.shift = qbits - d * log_b
            assert self.shift > 0
            self.h = [
                ((q << (log_b * j)) + (1 << (d * log_b - 1))) >> (d * log_b)
                for j in range(d)
            ]
        # Solinas correction corr = ((x >> pre) * eps) >> post, exact in int64
        eps_bits = field.eps.bit_length()
        self.corr_pre = max(0, qbits + eps_bits - 62)
        self.corr_post = qbits - self.corr_pre

    # ---------------------------------------------------------------- tensor
    def decompose(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Digits of x (int64, [0,q)) stacked along a new axis ``dim``.

        Approx mode gives balanced signed digits in [-B/2, B/2), exact mode
        unsigned digits in [0, B).
        """
        log_b = self.log_b
        bmask = (1 << log_b) - 1
        if self.exact:
            digs = [(x >> (log_b * j)) & bmask for j in range(self.d)]
            return torch.stack(digs, dim=dim)
        corr = ((x >> self.corr_pre) * self.field.eps) >> self.corr_post
        u = (x + corr + (1 << (self.shift - 1))) >> self.shift
        half_b = 1 << (log_b - 1)
        digs = []
        r = u
        for _ in range(self.d):
            dj = r & bmask
            r = r >> log_b
            carry = (dj >= half_b).to(torch.int64)
            digs.append(dj - (carry << log_b))
            r = r + carry
        return torch.stack(digs, dim=dim)

    def decompose_to_field(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Digits mapped into [0, q) (ready for NTT input)."""
        return self.field.to_field(self.decompose(x, dim=dim))

    # ------------------------------------------------------------------ host
    def gadget_values(self) -> np.ndarray:
        """h_j values (int64 numpy) used by key generation."""
        return np.asarray(self.h, dtype=np.int64)

    def recompose_host(self, digits: np.ndarray) -> np.ndarray:
        """Host-side sum of d_j h_j mod q over the first axis (for tests)."""
        acc = np.zeros(digits.shape[1:], dtype=object)
        for j in range(self.d):
            acc = acc + np.asarray(digits[j]).astype(object) * self.h[j]
        return np.mod(acc, self.field.q).astype(np.int64)
