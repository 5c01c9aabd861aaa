"""Negacyclic NTT over prime fields in any reference slot order.

PyTorch counterpart of :mod:`tfhe_omr_tpu.ops.ntt` (radix-2),
:mod:`tfhe_omr_tpu.ops.ntt_smallfield` (its host plan only) and
:mod:`tfhe_omr_tpu.ops.pallas_ntt` (``PallasNtt`` / ``PallasNtt50``).

Every NTT of the JAX package is a pointwise evaluation: forward output slot
k holds the input polynomial at ``psi**orders[k]`` (``psi`` the primitive
2N-th root of :meth:`PrimeField.find_primitive_root_of_unity`). The
packages differ only in ``orders``. So the port has ONE transform — radix-2
Cooley-Tukey forward and Gentleman-Sande inverse with Shoup twiddles, the
butterflies of ``NegacyclicNtt`` — composed with a static permutation into
the reference order the JAX ``make_ntt`` would pick for the field:

* q < 2**27, N >= 1024:  ``PallasNtt`` / ``SmallFieldNtt([32, N/32])``;
* 50-bit q, N >= 1024:   ``PallasNtt50`` (the same two-level plan);
* other small fields:    ``SmallFieldNtt`` with its default radices;
* otherwise:             the radix-2 order itself.

The reference orders come from exact host evaluation of the monomial X
through the mixed-radix plan (:func:`build_mixed_radix_plan`), as
``PallasNtt50._host_apply`` does.

Key tensors, the output of ``Detector.detect`` and the input of
``decrypt_rlwe2_ntt`` are in the reference order. Inside the CUDA kernels
the NTT domain is the radix-2 ("base") order; keys are permuted into it
once when a kernel key is prepared (:mod:`tfhe_omr_tpu_torch.ops.fused`).

:meth:`Ntt.fwd_last` / :meth:`Ntt.inv_last` are the kernel wrappers: a CPU
tensor runs the plain torch version, a CUDA tensor launches the
``csrc/ntt.cu`` kernel (the counterpart of ``PallasNtt._make_call`` and
``PallasNtt50._make_call``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from tfhe_omr_tpu_torch.ops.modmath import PrimeField
from tfhe_omr_tpu_torch.utils import build


def _bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def _factorize(n: int) -> list[int]:
    """Factor n into radices in {4, 8, 16} (``SmallFieldNtt``'s default)."""
    out = []
    while n > 16:
        out.append(8)
        n //= 8
    assert n in (2, 4, 8, 16), n
    out.append(n)
    return out


def build_mixed_radix_plan(field, n: int, radices, psi: int):
    """Per-level (dft_matrix, twiddle, r, m_l, pre) of the FORWARD
    mixed-radix NTT: a port of the forward half of
    ``tfhe_omr_tpu.ops.ntt_smallfield.build_mixed_radix_plan`` (exact host
    Python-int arithmetic). The port only evaluates it on the host, to
    recover the JAX package's slot orders.
    """
    q = field.q
    omega = psi * psi % q

    rads = list(radices)
    levels = len(rads)
    s = [1] * levels
    for lv in range(levels - 2, -1, -1):
        s[lv] = s[lv + 1] * rads[lv + 1]
    m = s

    plan = []
    pre = 1
    for lv, r in enumerate(rads):
        wc = pow(omega, pre, q)
        w_l = pow(wc, m[lv], q)
        mat = np.empty((r, r), dtype=object)
        for k in range(r):
            for i in range(r):
                mat[k, i] = pow(w_l, (k * i) % r, q)
        for i in range(r):
            mat[:, i] = mat[:, i] * pow(psi, i * s[lv], q) % q
        tw = None
        if m[lv] > 1:
            tw = np.empty((r, m[lv]), dtype=object)
            for k in range(r):
                tw[k, :] = [pow(wc, k * j, q) for j in range(m[lv])]
        plan.append((mat, tw, r, m[lv], pre))
        pre *= r
    return plan


def mixed_radix_orders(field, n: int, radices, psi: int) -> np.ndarray:
    """Slot orders of the forward mixed-radix transform: the exact image of
    the monomial X through the plan (levels in order, twiddle after each
    level, as ``SmallFieldNtt._apply`` runs it), read back as exponents."""
    q = field.q
    plan = build_mixed_radix_plan(field, n, radices, psi)
    x = np.zeros(n, dtype=object)
    x[1] = 1
    for mat, tw, r, m_l, pre in plan:
        y = np.matmul(mat, x.reshape(pre, r, m_l)) % q
        if tw is not None:
            y = (y * tw[None, :, :]) % q
        x = y.reshape(n)
    dlog = {}
    acc = 1
    for e in range(2 * n):
        dlog[acc] = e
        acc = acc * psi % q
    return np.array([dlog[int(v)] for v in x], dtype=np.int64)


def reference_radices(field: PrimeField, n: int):
    """The mixed-radix factorisation whose order the JAX ``make_ntt`` gives
    this field and ring, or None for the radix-2 order."""
    if field.bits <= 27 and n >= 1024 and n % 32 == 0:
        return [32, n // 32]  # PallasNtt
    if field.bits == 50 and n >= 1024 and n % 32 == 0:
        return [32, n // 32]  # PallasNtt50
    if 2 * field.bits + 4 <= 62 and n >= 32:
        return _factorize(n)  # SmallFieldNtt
    return None  # NegacyclicNtt


def shoup_companion(w, q: int, shift: int) -> np.ndarray:
    """``floor(w * 2**shift / q)`` as uint64 (exact host integers): the
    Shoup companion at the kernel's word size. For any x < 2**shift,
    ``x * w - ((x * w_sh) >> shift) * q`` lies in [0, 2q), whatever the
    shift, so the canonical residue is the one of ``PrimeField.mul_shoup``."""
    flat = [(int(v) << shift) // q for v in np.asarray(w).reshape(-1)]
    return np.array(flat, dtype=np.uint64).reshape(np.shape(w))


def as_words(a: np.ndarray, word_bits: int) -> np.ndarray:
    """Unsigned values below 2**word_bits as the signed dtype torch holds
    (the same bits)."""
    if word_bits == 32:
        return np.asarray(a, dtype=np.uint64).astype(np.uint32).view(np.int32)
    return np.asarray(a, dtype=np.uint64).view(np.int64)


def pass_stages(log_n: int, rlog: int) -> list[int]:
    """Radix-2 stages of each NTT pass: ``rlog`` each, the rest last."""
    return [min(rlog, log_n - s0) for s0 in range(0, log_n, rlog)]


def pass_twiddles(tw: np.ndarray, log_n: int, rlog: int, inverse: bool) -> np.ndarray:
    """The radix-2 twiddle table of :class:`Ntt` (entry ``m + i`` at stage
    ``m``) regrouped in the order the kernels' passes read it
    (``csrc/ntt_passes.cuh``).

    A forward pass over stages ``[s0, s0 + r)`` keeps ``2**r`` points
    ``h * 2**(log_n - s0) + i * 2**low + l`` in registers; at stage
    ``s0 + k`` the butterfly of local index ``i`` uses entry
    ``2**(s0 + k) + h * 2**k + (i >> (r - k))``. The pass's table is
    ``[t, h]`` with ``t = 2**k - 1 + (i >> (r - k))``, ``h`` innermost, so
    the threads of a warp read neighbouring words. The inverse pass over
    pair strides ``2**g0 .. 2**(g0 + r - 1)`` uses entry
    ``(N >> (g0 + k + 1)) + h * 2**(r - 1 - k) + (i >> (k + 1))`` at
    ``t = 2**r - 2**(r - k) + (i >> (k + 1))``.
    """
    n = 1 << log_n
    out = []
    s0 = 0
    for r in pass_stages(log_n, rlog):
        if not inverse:
            hi = 1 << s0
            for k in range(r):
                for ihi in range(1 << k):
                    out.extend(tw[(1 << (s0 + k)) + h * (1 << k) + ihi] for h in range(hi))
        else:
            hi = n >> (s0 + r)
            for k in range(r):
                cnt = 1 << (r - 1 - k)
                for ii in range(cnt):
                    out.extend(tw[(n >> (s0 + k + 1)) + h * cnt + ii] for h in range(hi))
        s0 += r
    return np.array(out, dtype=np.int64)


@dataclass(frozen=True)
class NttLayout:
    """Layout constants of one instantiation of ``csrc/ntt.cu``: word size,
    rows a block takes per turn, radix-2 stages per pass, entries of a
    regrouped twiddle table, blocks an SM holds."""

    word_bits: int
    rows: int
    rlog: int
    tw: int
    blocks_per_sm: int


class Ntt:
    """Negacyclic NTT over Z_q[X]/(X^N + 1) in a reference slot order.

    Tables live on ``device`` (the card unless the caller names another). ``orders`` is the reference order;
    ``base_orders`` the order of the radix-2 butterflies; ``perm`` maps one
    to the other: ``ref[..., k] == base[..., perm[k]]``.
    """

    def __init__(self, field: PrimeField, n: int, device=None,
                 name: str = "ntt"):
        assert n & (n - 1) == 0, "N must be a power of two"
        self.field = field
        self.n = n
        self.log_n = n.bit_length() - 1
        self.device = build.resolve_device(device)
        self.name = name
        q = field.q
        psi = field.find_primitive_root_of_unity(2 * n)
        self.psi = psi
        psi_inv = field.inv(psi)
        self.n_inv = field.inv(n)

        br = _bit_reverse_indices(n)
        pw = [1] * n
        ipw = [1] * n
        for i in range(1, n):
            pw[i] = pw[i - 1] * psi % q
            ipw[i] = ipw[i - 1] * psi_inv % q
        fwd_tw = np.array([pw[int(b)] for b in br], dtype=np.int64)
        inv_tw = np.array([ipw[int(b)] for b in br], dtype=np.int64)
        # the 1/N scale folds into the last GS stage (h == 1 uses index 1)
        inv_tw[1] = int(inv_tw[1]) * self.n_inv % q

        pow2n = np.empty(2 * n, dtype=np.int64)
        acc = 1
        for i in range(2 * n):
            pow2n[i] = acc
            acc = acc * psi % q
        mono = (pow2n - 1) % q

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.device)

        self.fwd_tw = dev(fwd_tw)
        self.fwd_tw_sh = dev(field.shoup(fwd_tw))
        self.inv_tw = dev(inv_tw)
        self.inv_tw_sh = dev(field.shoup(inv_tw))
        self.n_inv_sh = int(field.shoup(self.n_inv))
        self.mono = dev(mono)

        # base order: where the radix-2 butterflies leave psi**e (host)
        cpu_tw = (torch.as_tensor(fwd_tw), torch.as_tensor(field.shoup(fwd_tw)))
        delta = torch.zeros(n, 1, dtype=torch.int64)
        delta[1, 0] = 1
        root_of_slot = self._fwd_base(delta, *cpu_tw)[:, 0].numpy()
        dlog = {int(pow2n[i]): i for i in range(2 * n)}
        self.base_orders = np.array(
            [dlog[int(r)] for r in root_of_slot], dtype=np.int64
        )
        radices = reference_radices(field, n)
        if radices is None:
            self.orders = self.base_orders.copy()
        else:
            self.orders = mixed_radix_orders(field, n, radices, psi)
        assert np.all(self.orders % 2 == 1)
        base_pos = {int(o): i for i, o in enumerate(self.base_orders)}
        perm = np.array([base_pos[int(o)] for o in self.orders], dtype=np.int64)
        self.perm = dev(perm)
        self.perm_inv = dev(np.argsort(perm))
        self.base_orders_t = dev(self.base_orders)
        self.orders_t = dev(self.orders)

    # ----------------------------------------------------------- plain torch
    def _fwd_base(self, x, tw, tw_sh):
        """Radix-2 CT forward along axis 0, base order out (the
        ``NegacyclicNtt.fwd`` butterflies)."""
        f = self.field
        n = self.n
        batch = tuple(x.shape[1:])
        ones = (1,) * len(batch)
        m = 1
        t = n
        while m < n:
            t //= 2
            xr = x.reshape((m, 2, t) + batch)
            u = xr[:, 0]
            w = tw[m : 2 * m].reshape((m, 1) + ones)
            w_sh = tw_sh[m : 2 * m].reshape((m, 1) + ones)
            v = f.mul_shoup(xr[:, 1], w, w_sh)
            x = torch.stack((f.add(u, v), f.sub(u, v)), dim=1).reshape((n,) + batch)
            m *= 2
        return x

    def _inv_base(self, x):
        """Radix-2 GS inverse along axis 0 from base order, including 1/N."""
        f = self.field
        n = self.n
        batch = tuple(x.shape[1:])
        ones = (1,) * len(batch)
        t = 1
        h = n // 2
        while h >= 1:
            xr = x.reshape((h, 2, t) + batch)
            u = xr[:, 0]
            v = xr[:, 1]
            w = self.inv_tw[h : 2 * h].reshape((h, 1) + ones)
            w_sh = self.inv_tw_sh[h : 2 * h].reshape((h, 1) + ones)
            s = f.add(u, v)
            if h == 1:
                s = f.mul_shoup(s, self.n_inv, self.n_inv_sh)
            x = torch.stack(
                (s, f.mul_shoup(f.sub(u, v), w, w_sh)), dim=1
            ).reshape((n,) + batch)
            t *= 2
            h //= 2
        return x

    def fwd_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Forward NTT along axis 0 into the reference order (plain torch)."""
        return self._fwd_base(x, self.fwd_tw, self.fwd_tw_sh)[self.perm]

    def inv_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse NTT along axis 0 from the reference order (plain torch)."""
        return self._inv_base(x[self.perm_inv])

    def fwd_last_plain(self, x: torch.Tensor) -> torch.Tensor:
        return torch.movedim(self.fwd_plain(torch.movedim(x, -1, 0)), 0, -1)

    def inv_last_plain(self, x: torch.Tensor) -> torch.Tensor:
        return torch.movedim(self.inv_plain(torch.movedim(x, -1, 0)), 0, -1)

    # -------------------------------------------------------- kernel wrapper
    def operand_table(self, rlog: int, word_bits: int, inverse: bool) -> torch.Tensor:
        """The forward or inverse twiddles regrouped for passes of ``rlog``
        stages, each followed by its companion at the word's shift (one
        vector load brings both), in words of ``word_bits``."""
        tw = (self.inv_tw if inverse else self.fwd_tw).cpu().numpy()
        t = pass_twiddles(tw, self.log_n, rlog, inverse)
        both = np.stack([t.astype(np.uint64),
                         shoup_companion(t, self.field.q, word_bits)], axis=1)
        return torch.as_tensor(as_words(both.reshape(-1), word_bits), device=self.device)

    def kernel_layout(self) -> NttLayout:
        """The kernel instantiation compiled for this ring and field, or
        raise. The ``NttConfig`` typedefs of ``csrc/ntt.cu`` are the only
        table of these constants; this asks the built library for them."""
        out = (ctypes.c_int * 5)()
        lib = build.library()
        with torch.cuda.device(self.device):  # the occupancy is the card's
            rc = lib.omr_ntt_config(self.log_n, self.field.q, out)
        if rc:
            raise ValueError("no NTT kernel is instantiated for (log N, q) = "
                             f"{(self.log_n, self.field.q)}")
        rows, rlog, word_bytes, tw, blocks_per_sm = out
        return NttLayout(8 * word_bytes, rows, rlog, tw, blocks_per_sm)

    @cached_property
    def row_kernel_tables(self):
        """(layout, per direction (twiddles, 16-bit permutation), 1/N's
        companion, blocks that fill the card), made at the first launch."""
        lay = self.kernel_layout()
        tables = []
        for inverse, perm in ((False, self.perm), (True, self.perm_inv)):
            tw = self.operand_table(lay.rlog, lay.word_bits, inverse)
            if tw.numel() != 2 * lay.tw:
                raise ValueError(f"{self.name}: {tw.numel() // 2} twiddles regrouped, "
                                 f"the kernel reads {lay.tw}")
            tables.append((tw, perm.to(torch.int16)))
        n_inv_sh = int(shoup_companion(self.n_inv, self.field.q, lay.word_bits))
        sms = torch.cuda.get_device_properties(self.device).multi_processor_count
        return lay, tables, n_inv_sh, lay.blocks_per_sm * sms

    def _launch(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        if x.shape[-1] != self.n:
            raise ValueError(f"expected (..., {self.n}), got {tuple(x.shape)}")
        rows = x.reshape(-1, self.n).contiguous()
        if rows.data_ptr() % 16:
            rows = rows.clone()  # the kernel moves 16 bytes at a time
        out = torch.empty_like(rows)
        lay, tables, n_inv_sh, resident = self.row_kernel_tables
        tw, perm = tables[int(inverse)]
        build.require_cuda("ntt", rows, out)
        build.require_cuda("ntt", rows, tw, perm,
                           dtypes=(torch.int64, torch.int32, torch.int16))
        if rows.shape[0] == 0:
            return out.reshape(x.shape)
        # a block outlives its rows: no more blocks than the card holds
        groups = -(-rows.shape[0] // lay.rows)
        lib = build.library()
        with torch.cuda.device(rows.device):
            rc = lib.omr_ntt(
                build.ptr(rows), build.ptr(out), rows.shape[0], build.ptr(tw),
                build.ptr(perm), self.n_inv, n_inv_sh, self.log_n, self.field.q,
                int(inverse), min(groups, resident), build.stream_of(rows),
            )
        build.check(lib, rc, self.name)
        build.LAUNCHES[self.name] += 1
        return out.reshape(x.shape)

    def fwd_last(self, x: torch.Tensor) -> torch.Tensor:
        """Forward NTT along the last axis: plain torch on the CPU, the
        ``csrc/ntt.cu`` kernel on a CUDA tensor."""
        kind = build.device_kind(x)
        if kind == "cpu":
            return self.fwd_last_plain(x)
        return self._launch(x, inverse=False)

    def inv_last(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse NTT along the last axis (see :meth:`fwd_last`)."""
        kind = build.device_kind(x)
        if kind == "cpu":
            return self.inv_last_plain(x)
        return self._launch(x, inverse=True)

    # ----------------------------------------------------- monomial products
    def monomial_minus_one(self, a: torch.Tensor) -> torch.Tensor:
        """``NTT(X^a - 1)`` in the reference order: (N,) + a.shape, the
        lookup ``psi**((a * o_k) mod 2N) - 1`` in the 2N-entry table."""
        idx = (self.orders_t.reshape((self.n,) + (1,) * a.dim()) * a[None]) % (
            2 * self.n
        )
        return self.mono[idx]
