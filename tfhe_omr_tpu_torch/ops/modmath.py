"""Exact modular arithmetic over NTT-friendly prime fields, on int64 tensors.

PyTorch counterpart of :mod:`tfhe_omr_tpu.ops.modmath`. Same moduli
(``q = 2**bits - eps``, Solinas-like, ``bits <= 50``), same algorithms and
the same Shoup companions, so every result is bit-equal to the JAX package.

Torch int64 semantics the algorithms rely on (the same as XLA's): ``*``
wraps modulo 2**64, ``>>`` is arithmetic on negative values and ``//``
floors. Every value here lives in int64; the only int32 words of the port are
the blind-rotation kernel's first-level key and tables (``ops/fused.py``).
"""

from __future__ import annotations

import numpy as np
import torch

_I64 = torch.int64


class PrimeField:
    """Modular arithmetic helpers for a fixed prime ``q = 2**bits - eps``."""

    #: Shoup precomputation shift for the small-field path (bits <= 28).
    SMALL_SHOUP_SHIFT = 30
    #: Shoup precomputation shift for the large-field path (bits <= 50).
    BIG_SHOUP_SHIFT = 52

    def __init__(self, q: int):
        if q.bit_length() > 50:
            raise ValueError("moduli above 2**50 are not supported")
        self.q = int(q)
        self.bits = q.bit_length()
        self.eps = (1 << self.bits) - q
        if self.eps >= (1 << (self.bits // 2)):
            raise ValueError(
                f"modulus {q} is not Solinas-like (eps={self.eps} too large)"
            )
        self.small = self.bits <= 31
        self.mid = 31 < self.bits <= 38
        if not (self.small or self.mid or 46 <= self.bits <= 50):
            raise ValueError(
                "generic modmul supports bits <= 38 or 46..50 "
                f"(got {self.bits})"
            )
        self.small_shoup = self.bits <= 28
        self.mask = (1 << self.bits) - 1
        self.shoup_shift = (
            self.SMALL_SHOUP_SHIFT if self.small_shoup else self.BIG_SHOUP_SHIFT
        )

    # ------------------------------------------------------------------ host
    def shoup(self, w):
        """Host Shoup companion ``floor(w << shift / q)`` as int64 numpy."""
        w = np.asarray(w, dtype=np.uint64)
        q = np.uint64(self.q)
        quot = np.zeros_like(w)
        rem = w.copy()
        shift = self.shoup_shift
        while shift > 0:
            step = min(13, shift)
            shift -= step
            rem = rem << np.uint64(step)
            quot = (quot << np.uint64(step)) + rem // q
            rem = rem % q
        return quot.astype(np.int64)

    def shoup_t(self, w: torch.Tensor) -> torch.Tensor:
        """Shoup companions of a tensor, on its device (the same chunked
        long division as :meth:`shoup`; every intermediate stays < 2**63)."""
        q = self.q
        quot = torch.zeros_like(w)
        rem = w.clone()
        shift = self.shoup_shift
        while shift > 0:
            step = min(13, shift)
            shift -= step
            rem = rem << step
            quot = (quot << step) + rem // q
            rem = rem % q
        return quot

    def inv(self, x: int) -> int:
        return pow(int(x), self.q - 2, self.q)

    def pow(self, x: int, e: int) -> int:
        return pow(int(x), int(e), self.q)

    def find_primitive_root_of_unity(self, order: int) -> int:
        """Host: a primitive ``order``-th root of unity mod q (order | q-1)."""
        q = self.q
        assert (q - 1) % order == 0, (q, order)
        n = q - 1
        factors = set()
        d = 2
        while d * d <= n:
            while n % d == 0:
                factors.add(d)
                n //= d
            d += 1
        if n > 1:
            factors.add(n)
        for g in range(2, 10_000):
            if all(pow(g, (q - 1) // f, q) != 1 for f in factors):
                break
        else:  # pragma: no cover
            raise RuntimeError("no generator found")
        root = pow(g, (q - 1) // order, q)
        assert pow(root, order, q) == 1
        assert pow(root, order // 2, q) == q - 1
        return root

    # ---------------------------------------------------------------- tensor
    def add(self, a, b):
        s = a + b
        return s - self.q * (s >= self.q).to(_I64)

    def sub(self, a, b):
        d = a - b
        return d + self.q * (d < 0).to(_I64)

    def neg(self, a):
        return torch.where(a == 0, torch.zeros_like(a), self.q - a)

    def to_field(self, a):
        """Map signed values in (-q, q) into [0, q)."""
        return a + self.q * (a < 0).to(_I64)

    def mul(self, a, b):
        """Generic modmul, both operands variable, values in [0, q)."""
        if self.small:
            return self.reduce(a * b)  # product < 2**62
        if self.mid:
            t = (self.bits + 1) // 2
            tm = (1 << t) - 1
            a1, a0 = a >> t, a & tm
            b1, b0 = b >> t, b & tm
            e2t = (1 << (2 * t)) % self.q
            big = a1 * b1 * e2t + (a1 * b0 + a0 * b1) * (1 << t) + a0 * b0
            return self.reduce(big, 3 * self.bits // 2 + 4)
        l25 = (1 << 25) - 1
        a1, a0 = a >> 25, a & l25
        b1, b0 = b >> 25, b & l25
        hh = a1 * b1  # < 2**50
        mm = a1 * b0 + a0 * b1  # < 2**51
        ll = a0 * b0  # < 2**50
        e50 = (1 << 50) % self.q
        h1, h0 = hh >> 25, hh & l25
        mp = h1 * e50 + mm  # < 2**52
        lp = h0 * e50 + ll  # < 2**51
        m1, m0 = mp >> 25, mp & l25
        big = m1 * e50 + (m0 << 25) + lp  # < 2**56
        return self.reduce(big, 56)

    def mul_shoup(self, x, w, w_sh):
        """Modmul by fixed ``w`` with precomputed companion ``w_sh``.

        Requires x in [0, 2**shoup_shift); w in [0, q). Result in [0, q).
        """
        q = self.q
        if self.small_shoup:
            t = (x * w_sh) >> self.SMALL_SHOUP_SHIFT  # x*w_sh < 2**58
            r = x * w - t * q
            return r - q * (r >= q).to(_I64)
        l26 = (1 << 26) - 1
        x1, x0 = x >> 26, x & l26
        w1, w0 = w_sh >> 26, w_sh & l26
        mid = x1 * w0 + x0 * w1 + ((x0 * w0) >> 26)  # < 2**53
        t = x1 * w1 + (mid >> 26)  # == floor(x * w_sh / 2**52)
        r = x * w - t * q  # wrapping; true value in [0, 2q)
        return r - q * (r >= q).to(_I64)

    def reduce(self, v, bound_bits: int = 62):
        """Reduce non-negative int64 v < 2**bound_bits to [0, q)."""
        q = self.q
        bits = self.bits
        eps_bits = self.eps.bit_length()
        bound = bound_bits
        while True:
            nb = max(bits, (bound - bits) + eps_bits) + 1
            if nb >= bound:
                break
            v = (v >> bits) * self.eps + (v & self.mask)
            bound = nb
        assert bound <= bits + 2, (bound, bits)
        v = v - q * (v >= q).to(_I64)
        return v - q * (v >= q).to(_I64)

    def mod_sum(self, x, dim: int):
        """Exact modular sum along ``dim`` with overflow-safe chunking."""
        chunk = max(2, (1 << 62) // (1 << self.bits) // 2)
        x = torch.movedim(x, dim, 0)
        while x.shape[0] > 1:
            c = min(chunk, x.shape[0])
            pad = (-x.shape[0]) % c
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            x = x.reshape((x.shape[0] // c, c) + tuple(x.shape[1:])).sum(dim=1)
            x = self.reduce(x)
        return x[0]

    # ------------------------------------------------------------- utilities
    def rand(self, rng: np.random.Generator, shape) -> np.ndarray:
        """Host: uniform field elements as int64 numpy."""
        return rng.integers(0, self.q, size=shape, dtype=np.int64)

    def gaussian(self, rng: np.random.Generator, sigma: float, shape):
        """Host: rounded discrete Gaussian noise, mapped into [0, q);
        ``sigma == 0`` gives the noise-free mode and draws nothing."""
        if sigma == 0.0:
            return np.zeros(shape, dtype=np.int64)
        e = np.rint(rng.normal(0.0, sigma, size=shape)).astype(np.int64)
        return np.mod(e, self.q)
