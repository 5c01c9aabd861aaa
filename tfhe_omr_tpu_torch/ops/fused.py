"""Kernel wrappers for the blind rotations and the trace.

PyTorch counterpart of :mod:`tfhe_omr_tpu.ops.pallas_fused`: the CUDA
kernels ``csrc/blind_rotate.cu`` (``FusedBlindRotateL1`` /
``FusedBlindRotateL2``) and ``csrc/trace.cu`` (``FusedTrace``).

The wrappers work message-major — acc ``(M, 2, N)``, one row per sample —
which is the layout the kernels run in. A CPU tensor runs the plain torch
version (:mod:`tfhe_omr_tpu_torch.ops.bootstrap`, in the JAX layout
``(N, 2, M)``); a CUDA tensor launches the kernel or raises.

The key objects take the plain NTT-domain keys in the JAX package's layout
and reference slot order, with their Shoup companions, and hold one layout
on their device: the reference one on the CPU; on a card the kernel's,
permuted once into the radix-2 slot order of the in-kernel NTT with the
coefficient slot innermost (the blind-rotation keys in the order and word
size of ``csrc/blind_rotate.cu``, see :func:`kernel_key_layout`).
``reference()`` gives the reference layout back (gathered on the card) for
the plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from tfhe_omr_tpu_torch.ops.bootstrap import make_blind_rotate, make_trace
from tfhe_omr_tpu_torch.ops.decompose import SignedGadget
from tfhe_omr_tpu_torch.ops.ntt import Ntt
from tfhe_omr_tpu_torch.utils import build


def _ntt_args(ntt: Ntt):
    f = ntt.field
    return (
        build.ptr(ntt.fwd_tw), build.ptr(ntt.fwd_tw_sh),
        build.ptr(ntt.inv_tw), build.ptr(ntt.inv_tw_sh),
        ntt.log_n, f.q, f.shoup_shift, ntt.n_inv, ntt.n_inv_sh,
    )


@dataclass(frozen=True)
class BrLayout:
    """Layout constants of one instantiation of ``csrc/blind_rotate.cu``:
    word size, samples per block, digits per NTT pass, radix-2 stages per
    NTT pass, entries of the regrouped forward / inverse twiddle tables."""

    word_bits: int
    s: int
    dj: int
    rlog: int
    tw_fwd: int
    tw_inv: int

    @property
    def dtype(self) -> torch.dtype:
        return torch.int32 if self.word_bits == 32 else torch.int64


def br_layout(ntt: Ntt, gadget: SignedGadget) -> BrLayout:
    """The kernel instantiation compiled for a ring, field and gadget, or
    raise. The ``BrConfig`` typedefs of ``csrc/blind_rotate.cu`` are the
    only table of these constants; this asks the built library for them."""
    sig = (ntt.log_n, ntt.field.q, gadget.d, gadget.log_b)
    out = (ctypes.c_int * 6)()
    if build.library().omr_blind_rotate_config(*sig, out):
        raise ValueError(
            f"no blind-rotation kernel is instantiated for (log N, q, d, log B) = {sig}")
    s, dj, rlog, word_bytes, tw_fwd, tw_inv = out
    return BrLayout(8 * word_bytes, s, dj, rlog, tw_fwd, tw_inv)


def n_blocks(n_msgs: int, s: int) -> int:
    """Blocks of a launch that serves ``s`` samples per block; the last
    block masks the samples beyond ``n_msgs`` inside the kernel."""
    return -(-n_msgs // s)


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
    ``m``) regrouped in the order the kernel's passes read it.

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


def kernel_key_layout(bsk: torch.Tensor, n_steps: int, n: int, d: int, dj: int,
                      perm_inv: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Reference layout ``(3 * n_steps, N, d, 2, 2)`` (row, slot, digit, in,
    out) -> the kernel's ``(n_steps, d / dj, 3, dj, 2, 2, N)``: the order in
    which a block consumes the planes, slots in the radix-2 order."""
    k = bsk.reshape(n_steps, 3, n, d // dj, dj, 2, 2).permute(0, 3, 1, 4, 5, 6, 2)
    return k[..., perm_inv].to(dtype).contiguous()


def reference_key_layout(k: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`kernel_key_layout`, as int64."""
    n_steps, jp, _three, dj, _c, _o, n = k.shape
    ref = k[..., perm].permute(0, 2, 6, 1, 3, 4, 5)
    return ref.reshape(3 * n_steps, n, jp * dj, 2, 2).to(torch.int64)


class BlindRotateKey:
    """A paired bootstrapping key for :func:`blind_rotate`.

    bsk / bsk_sh: (3*n_steps, N, d, 2, 2) int64, reference order (the
    layout of ``tfhe_omr_tpu.core.keygen.DetectionKey.bsk1`` / ``bsk2``).
    On the CPU both are kept as given. On a card only the kernel's layout
    is held (:func:`kernel_key_layout`, int32 words for a field below
    2**31, no companions: the kernel reduces its sums lazily), beside the
    kernel's tables in its word size.
    """

    def __init__(self, bsk: torch.Tensor, bsk_sh: torch.Tensor, ntt: Ntt,
                 gadget: SignedGadget, name: str):
        self.ntt = ntt
        self.gadget = gadget
        self.name = name
        self.n_steps = bsk.shape[0] // 3
        self.plain = make_blind_rotate(ntt.field, ntt, gadget)
        self.on_card = bsk.device.type == "cuda"
        self.keys = (bsk, bsk_sh)
        if self.on_card:
            lay = self.layout = br_layout(ntt, gadget)
            self.keys = (kernel_key_layout(bsk, self.n_steps, ntt.n, gadget.d,
                                           lay.dj, ntt.perm_inv, lay.dtype),)
            self._kernel_tables(bsk.device)

    def _kernel_tables(self, dev) -> None:
        """Twiddles regrouped per pass, interleaved with companions at the word's shift,
        the psi-power table and the base orders, in the kernel's words."""
        ntt, lay = self.ntt, self.layout
        q, wb = ntt.field.q, lay.word_bits

        def table(tw, inverse):
            t = pass_twiddles(tw.cpu().numpy(), ntt.log_n, lay.rlog, inverse)
            # each twiddle followed by its companion: one vector load
            if len(t) != (lay.tw_inv if inverse else lay.tw_fwd):
                raise ValueError(f"{self.name}: {len(t)} twiddles regrouped, the "
                                 f"kernel reads {lay.tw_inv if inverse else lay.tw_fwd}")
            both = np.stack([t.astype(np.uint64), shoup_companion(t, q, wb)], axis=1)
            return torch.as_tensor(as_words(both.reshape(-1), wb), device=dev)

        self.tw_fwd = table(ntt.fwd_tw, False)
        self.tw_inv = table(ntt.inv_tw, True)
        self.mono = ntt.mono.to(lay.dtype)
        self.orders = ntt.base_orders_t.to(torch.int32)
        self.n_inv = ntt.n_inv
        self.n_inv_sh = int(shoup_companion(ntt.n_inv, q, wb))

    def reference(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(bsk, bsk_sh) in the reference layout and slot order, int64."""
        if not self.on_card:
            return self.keys
        bsk = reference_key_layout(self.keys[0], self.ntt.perm)
        return bsk, self.ntt.field.shoup_t(bsk)

    def nbytes(self) -> int:
        return sum(k.numel() * k.element_size() for k in self.keys)


def blind_rotate_plain(acc: torch.Tensor, amounts: torch.Tensor,
                       key: BlindRotateKey) -> torch.Tensor:
    """acc (M, 2, N), amounts (2*n_steps, M) -> (M, 2, N), plain torch."""
    out = key.plain(acc.permute(2, 1, 0), amounts, *key.reference())
    return out.permute(2, 1, 0).contiguous()


def blind_rotate(acc: torch.Tensor, amounts: torch.Tensor,
                 key: BlindRotateKey) -> torch.Tensor:
    """The paired CMUX chain on every sample: acc (M, 2, N) coefficient
    domain, amounts (2*n_steps, M) in [0, 2N) -> (M, 2, N). Any M: the
    kernel serves ``layout.s`` samples per block and masks the rest of the
    last block."""
    if build.device_kind(acc) == "cpu":
        return blind_rotate_plain(acc, amounts, key)
    ntt, g = key.ntt, key.gadget
    n_msgs = acc.shape[0]
    if acc.shape != (n_msgs, 2, ntt.n) or amounts.shape != (2 * key.n_steps, n_msgs):
        raise ValueError(f"blind_rotate: acc {tuple(acc.shape)}, amounts {tuple(amounts.shape)}")
    if not key.on_card:
        raise ValueError("blind_rotate: the key is not on the card")
    acc = acc.contiguous()
    amounts = amounts.contiguous()
    out = torch.empty_like(acc)
    build.require_cuda("blind_rotate", acc, amounts)
    build.require_cuda("blind_rotate", acc, key.keys[0], key.mono, key.tw_fwd,
                       key.tw_inv, key.orders, dtypes=(torch.int64, torch.int32))
    if n_msgs == 0:
        return out
    lib = build.library()
    rc = lib.omr_blind_rotate(
        build.ptr(acc), build.ptr(out), build.ptr(amounts), n_msgs,
        key.n_steps, build.ptr(key.keys[0]), build.ptr(key.mono),
        build.ptr(key.orders), build.ptr(key.tw_fwd), build.ptr(key.tw_inv),
        key.n_inv, key.n_inv_sh, ntt.log_n, ntt.field.q, g.d, g.log_b,
        n_blocks(n_msgs, key.layout.s), build.stream_of(acc),
    )
    build.check(lib, rc, key.name)
    build.LAUNCHES[key.name] += 1
    return out


class TraceKey:
    """The automorphism key-switching keys for :func:`trace`.

    trace_k / trace_k_sh: (rounds, N, d, 2) int64, reference order;
    ``autos`` is ``OmrContext.trace_autos``.
    """

    def __init__(self, trace_k: torch.Tensor, trace_k_sh: torch.Tensor,
                 ntt: Ntt, gadget: SignedGadget, autos, name: str = "trace"):
        assert gadget.exact, "the trace kernel takes exact digits"
        self.ntt = ntt
        self.gadget = gadget
        self.name = name
        self.rounds = len(autos)
        self.plain = make_trace(ntt.field, ntt, gadget, autos)
        self.on_card = trace_k.device.type == "cuda"
        self.keys = (trace_k, trace_k_sh)
        if self.on_card:
            dev = trace_k.device
            self.gidx = torch.stack(
                [torch.as_tensor(gi) for _g, gi, _s in autos]).to(dev)
            self.gsign = torch.stack(
                [torch.as_tensor(gs) for _g, _i, gs in autos]).to(dev)
            # kernel layout (rounds, d, 2, N), radix-2 slot order
            self.keys = tuple(
                k.permute(0, 2, 3, 1)[..., ntt.perm_inv].contiguous()
                for k in self.keys
            )

    def reference(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(trace_k, trace_k_sh) in the reference layout and slot order."""
        if not self.on_card:
            return self.keys
        return tuple(k[..., self.ntt.perm].permute(0, 3, 1, 2) for k in self.keys)

    def nbytes(self) -> int:
        return sum(k.numel() * k.element_size() for k in self.keys)


def trace_plain(acc: torch.Tensor, key: TraceKey) -> torch.Tensor:
    """acc (B, 2, N) -> (B, 2, N), plain torch."""
    out = key.plain(acc.permute(2, 1, 0), *key.reference())
    return out.permute(2, 1, 0).contiguous()


def trace(acc: torch.Tensor, key: TraceKey) -> torch.Tensor:
    """EvalTr on every message: acc (B, 2, N) coefficient domain, already
    multiplied by N^{-1} -> (B, 2, N)."""
    if build.device_kind(acc) == "cpu":
        return trace_plain(acc, key)
    ntt, g = key.ntt, key.gadget
    n_msgs = acc.shape[0]
    if acc.shape != (n_msgs, 2, ntt.n):
        raise ValueError(f"trace: acc {tuple(acc.shape)}")
    if not key.on_card:
        raise ValueError("trace: the key is not on the card")
    acc = acc.contiguous()
    out = torch.empty_like(acc)
    kk, kk_sh = key.keys
    build.require_cuda("trace", acc, kk, kk_sh, key.gidx, key.gsign, ntt.fwd_tw)
    if n_msgs == 0:
        return out
    lib = build.library()
    rc = lib.omr_trace(
        build.ptr(acc), build.ptr(out), n_msgs, key.rounds,
        build.ptr(key.gidx), build.ptr(key.gsign), build.ptr(kk),
        build.ptr(kk_sh), *_ntt_args(ntt), g.log_b, g.d,
        build.stream_of(acc),
    )
    build.check(lib, rc, key.name)
    build.LAUNCHES[key.name] += 1
    return out
