"""Runtime context: fields, NTTs, gadgets and LUTs for a parameter set.

PyTorch counterpart of :mod:`tfhe_omr_tpu.core.context`. The NTT of each
level evaluates in the slot order the JAX ``make_ntt`` picks for that field
and ring (see :func:`tfhe_omr_tpu_torch.ops.ntt.reference_radices`); its
tables live on ``device``.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

from tfhe_omr_tpu_torch.core.lut import first_level_lut, second_level_lut
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.ops.decompose import SignedGadget
from tfhe_omr_tpu_torch.ops.modmath import PrimeField
from tfhe_omr_tpu_torch.ops.ntt import Ntt
from tfhe_omr_tpu_torch.utils.build import resolve_device


class OmrContext:
    """Derived (non-secret) state for one parameter set on one device."""

    def __init__(self, params: OmrParameters, device=None):
        self.params = params
        #: the card unless the caller names another (``device="cpu"``)
        self.device = resolve_device(device)
        self.f1 = PrimeField(params.q1)
        self.f2 = PrimeField(params.q2)

    @cached_property
    def ntt1(self) -> Ntt:
        return Ntt(self.f1, self.params.n1, self.device, name="ntt1")

    @cached_property
    def ntt2(self) -> Ntt:
        return Ntt(self.f2, self.params.n2, self.device, name="ntt2")

    @cached_property
    def gadget_br1(self) -> SignedGadget:
        br = self.params.first_level_br
        return SignedGadget(self.f1, br.log_basis, br.basis_len)

    @cached_property
    def gadget_br2(self) -> SignedGadget:
        br = self.params.second_level_br
        return SignedGadget(self.f2, br.log_basis, br.basis_len)

    @cached_property
    def gadget_ks(self) -> SignedGadget:
        ks = self.params.first_level_ks
        return SignedGadget(self.f1, ks.log_basis, ks.digits)

    @cached_property
    def gadget_trace(self) -> SignedGadget:
        tr = self.params.trace
        return SignedGadget(self.f2, tr.log_basis, tr.basis_len)

    # ------------------------------------------------------------------ LUTs
    @cached_property
    def lut1_ext(self) -> np.ndarray:
        """[LUT1, -LUT1] length 2*N1 — X^-b init by small-table lookup."""
        lut = first_level_lut(self.params)
        return np.concatenate([lut, (self.f1.q - lut) % self.f1.q])

    @cached_property
    def lut2_ext(self) -> np.ndarray:
        lut = second_level_lut(self.params)
        return np.concatenate([lut, (self.f2.q - lut) % self.f2.q])

    # -------------------------------------------------- clue sample extraction
    @cached_property
    def clue_extract_tables(self):
        """(idx, neg) of shape (clue_count, n): extraction at coefficient i
        of a ring ciphertext gives ``a_vec[j] = a[i-j]`` for j <= i and
        ``-a[n+i-j]`` for j > i (``CmLweCiphertext::extract_all``)."""
        n = self.params.clue_params.dimension
        c = self.params.clue_count
        i = np.arange(c)[:, None]
        j = np.arange(n)[None, :]
        neg = (j > i).astype(np.int64)
        idx = np.where(j <= i, i - j, n + i - j).astype(np.int64)
        return idx, neg

    # ------------------------------------------------------ trace automorphisms
    @cached_property
    def trace_autos(self):
        """(g, gidx, gsign) per EvalTr round, g_r = N / 2**r + 1:
        ``sigma_g(c)[k] = gsign[k] * c[gidx[k]]``."""
        n = self.params.n2
        autos = []
        r = n
        while r >= 2:
            g = r + 1
            p = (g * np.arange(n, dtype=np.int64)) % (2 * n)
            dest = np.where(p < n, p, p - n)
            sgn = np.where(p < n, 1, -1).astype(np.int64)
            gidx = np.zeros(n, dtype=np.int64)
            gsign = np.zeros(n, dtype=np.int64)
            gidx[dest] = np.arange(n)
            gsign[dest] = sgn
            autos.append((g, gidx, gsign))
            r //= 2
        return autos
