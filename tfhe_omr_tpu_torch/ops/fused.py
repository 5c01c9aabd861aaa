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
coefficient slot innermost. ``reference()`` gives the reference layout back
(gathered on the card) for the plain version.
"""

from __future__ import annotations

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


class BlindRotateKey:
    """A paired bootstrapping key for :func:`blind_rotate`.

    bsk / bsk_sh: (3*n_steps, N, d, 2, 2) int64, reference order (the
    layout of ``tfhe_omr_tpu.core.keygen.DetectionKey.bsk1`` / ``bsk2``).
    """

    def __init__(self, bsk: torch.Tensor, bsk_sh: torch.Tensor, ntt: Ntt,
                 gadget: SignedGadget, name: str):
        self.ntt = ntt
        self.gadget = gadget
        self.name = name
        self.n_steps = bsk.shape[0] // 3
        self.plain = make_blind_rotate(ntt.field, ntt, gadget)
        self.on_card = bsk.device.type == "cuda"
        keys = (bsk, bsk_sh)
        # kernel layout (n_steps, 3, d, 2, 2, N), radix-2 slot order
        self.keys = tuple(self._kernel_layout(k) for k in keys) if self.on_card else keys

    def _kernel_layout(self, k: torch.Tensor) -> torch.Tensor:
        n, d = self.ntt.n, self.gadget.d
        k = k.reshape(self.n_steps, 3, n, d, 2, 2).permute(0, 1, 3, 4, 5, 2)
        return k[..., self.ntt.perm_inv].contiguous()

    def reference(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(bsk, bsk_sh) in the reference layout and slot order."""
        if not self.on_card:
            return self.keys
        n, d = self.ntt.n, self.gadget.d
        return tuple(
            k[..., self.ntt.perm].permute(0, 1, 5, 2, 3, 4)
            .reshape(3 * self.n_steps, n, d, 2, 2)
            for k in self.keys
        )

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
    domain, amounts (2*n_steps, M) in [0, 2N) -> (M, 2, N)."""
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
    kk, kk_sh = key.keys
    build.require_cuda("blind_rotate", acc, amounts, kk, kk_sh, ntt.mono,
                       ntt.mono_sh, ntt.base_orders_t, ntt.fwd_tw)
    if n_msgs == 0:
        return out
    lib = build.library()
    rc = lib.omr_blind_rotate(
        build.ptr(acc), build.ptr(out), build.ptr(amounts), n_msgs,
        key.n_steps, build.ptr(kk), build.ptr(kk_sh), build.ptr(ntt.mono),
        build.ptr(ntt.mono_sh), build.ptr(ntt.base_orders_t), *_ntt_args(ntt),
        *g.kernel_params(), ntt.field.eps, build.stream_of(acc),
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
