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
coefficient slot innermost, in the order and word size in which the kernel
consumes it and without companions (the kernels sum their key products
lazily): :func:`kernel_key_layout`, :func:`trace_key_layout`.
``reference(r)`` gives recipient r's key back in the reference layout
(gathered on the card, the companions recomputed) for the plain version.
The layout constants of each kernel come from the built library
(:func:`br_layout`, :func:`tr_layout`).

A key object holds the keys of ``recipients`` recipients, one after
another on a leading axis: one recipient's as made, several filled in one
at a time (:meth:`StackedKey.empty_stack`, :meth:`put`). The samples of a
launch split into ``recipients`` equal runs, run r taking recipient r's
key, and one kernel launch serves them all (``csrc/blind_rotate.cu``,
``csrc/trace.cu``: a block's samples are one recipient's); the plain
versions take each run with its recipient's key.

A second-level blind rotation whose one-sample blocks would leave SMs
idle runs each sample on a thread-block cluster of C CTAs instead, each
CTA taking d / C of the gadget digits (:func:`cluster_size` chooses C from
the launch's shape and the card).
"""

from __future__ import annotations

import copy
import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from tfhe_omr_tpu_torch.ops.bootstrap import make_blind_rotate, make_trace
from tfhe_omr_tpu_torch.ops.decompose import SignedGadget
from tfhe_omr_tpu_torch.ops.ntt import (  # noqa: F401  (the layout tests reach them here)
    Ntt, as_words, pass_stages, pass_twiddles, shoup_companion,
)
from tfhe_omr_tpu_torch.utils import build


@dataclass(frozen=True)
class BrLayout:
    """Layout constants of one instantiation of ``csrc/blind_rotate.cu`` or
    ``csrc/trace.cu``: word size, samples per block, digits per NTT pass,
    radix-2 stages per NTT pass, entries of the regrouped forward / inverse
    twiddle tables; and, for a blind rotation, whether its monomial stage
    reads the psi-power table from shared memory (where the configuration
    has room beside the rest) rather than through the read-only cache, and
    the cluster sizes of its cluster variants (none for the first level)."""

    word_bits: int
    s: int
    dj: int
    rlog: int
    tw_fwd: int
    tw_inv: int
    mono_shared: bool = False
    clusters: tuple[int, ...] = ()

    @property
    def dtype(self) -> torch.dtype:
        return torch.int32 if self.word_bits == 32 else torch.int64


def _layout(config, what: str, ntt: Ntt, gadget: SignedGadget) -> BrLayout:
    sig = (ntt.log_n, ntt.field.q, gadget.d, gadget.log_b)
    out = (ctypes.c_int * 8)()  # the trace's query fills the first six
    if config(*sig, out):
        raise ValueError(
            f"no {what} kernel is instantiated for (log N, q, d, log B) = {sig}")
    s, dj, rlog, word_bytes, tw_fwd, tw_inv, mono_shared, clusters = out
    return BrLayout(8 * word_bytes, s, dj, rlog, tw_fwd, tw_inv, bool(mono_shared),
                    tuple(c for c in range(2, CLUSTER_MAX + 1) if clusters >> c & 1))


def br_layout(ntt: Ntt, gadget: SignedGadget) -> BrLayout:
    """The kernel instantiation compiled for a ring, field and gadget, or
    raise. The ``BrConfig`` typedefs of ``csrc/blind_rotate.cu`` are the
    only table of these constants; this asks the built library for them."""
    return _layout(build.library().omr_blind_rotate_config, "blind-rotation", ntt, gadget)


def tr_layout(ntt: Ntt, gadget: SignedGadget) -> BrLayout:
    """The same for the ``TrConfig`` typedefs of ``csrc/trace.cu``."""
    return _layout(build.library().omr_trace_config, "trace", ntt, gadget)


def kernel_tables(ntt: Ntt, lay: BrLayout, name: str):
    """(forward twiddles, inverse twiddles, companion of 1/N) as a kernel
    of layout ``lay`` reads them (:meth:`Ntt.operand_table`)."""
    tables = []
    for inverse, expect in ((False, lay.tw_fwd), (True, lay.tw_inv)):
        t = ntt.operand_table(lay.rlog, lay.word_bits, inverse)
        if t.numel() != 2 * expect:
            raise ValueError(f"{name}: {t.numel() // 2} twiddles regrouped, the "
                             f"kernel reads {expect}")
        tables.append(t)
    return (*tables, int(shoup_companion(ntt.n_inv, ntt.field.q, lay.word_bits)))


def n_blocks(n_msgs: int, s: int) -> int:
    """Blocks of a launch that serves ``s`` samples per block; the last
    block masks the samples beyond ``n_msgs`` inside the kernel."""
    return -(-n_msgs // s)


#: the most CTAs a cluster may have on every card of the architecture
CLUSTER_MAX = 8


def cluster_size(blocks: int, sms: int, fits: dict[int, int]) -> int:
    """CTAs a sample for a launch of ``blocks`` one-sample blocks on a card
    of ``sms`` SMs: the largest C of the kernel's cluster variants
    (``fits``: {C: clusters of C CTAs the card holds at once}, each C one
    that :attr:`BrLayout.clusters` reports, :func:`cluster_fits`) with which
    every cluster runs at once (``blocks * C <= sms`` and ``blocks <=
    fits[C]``); else 1, the one-block kernel. On an H100 a cluster of 6, 3
    or 2 runs K2's chain in about a third, a half or two thirds of one
    block's time (``csrc/blind_rotate.cu``, "Clusters"), and two waves of
    clusters take longer than one of a smaller C, so a launch that would
    leave SMs idle takes the largest C that runs in one wave."""
    for c in sorted(fits, reverse=True):
        if blocks * c <= sms and blocks <= fits[c]:
            return c
    return 1


def cluster_fits(ntt: Ntt, gadget: SignedGadget, lay: BrLayout,
                 device: torch.device) -> dict[int, int]:
    """{C: clusters of the cluster variant of C CTAs that ``device`` holds
    at once} for each cluster size of layout ``lay`` (the CUDA occupancy
    query; empty for a layout without cluster variants)."""
    lib = build.library()
    sig = (ntt.log_n, ntt.field.q, gadget.d, gadget.log_b)
    fits = {}
    for c in lay.clusters:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.omr_blind_rotate_cluster_fit(*sig, c, ctypes.byref(out))
        build.check(lib, rc, f"blind-rotation cluster of {c} (occupancy)")
        fits[c] = out.value
    return fits


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


class StackedKey:
    """What the key objects share: the keys of ``recipients`` recipients,
    one after another on the leading axis of each tensor of ``keys`` (one
    recipient's for a key object made from one recipient's tensors)."""

    @property
    def recipients(self) -> int:
        return self.keys[0].shape[0]

    def empty_stack(self, count: int):
        """A key object of ``count`` recipients with this key's tables and
        its key tensors' shapes, the keys themselves not yet filled in
        (:meth:`put`): a stack is filled one key at a time, so that only
        one recipient's key lies beside it as it fills."""
        out = copy.copy(self)
        out.keys = tuple(torch.empty((count, *k.shape[1:]), dtype=k.dtype, device=k.device)
                         for k in self.keys)
        return out

    def put(self, r: int, key) -> None:
        """Recipient ``r``'s key (one recipient's key object of the same
        ring, on this stack's device and in its layout) into the stack."""
        if [tuple(k.shape) for k in key.keys] != [(1, *k.shape[1:]) for k in self.keys]:
            raise ValueError(f"{self.name}: a key of shapes "
                             f"{[tuple(k.shape) for k in key.keys]} does not fit the stack")
        for dst, src in zip(self.keys, key.keys):
            dst[r].copy_(src[0])

    def runs(self, n_msgs: int, what: str) -> int:
        """Samples a recipient's run of a launch of ``n_msgs`` samples: the
        samples split into ``recipients`` equal runs, run r under recipient
        r's key."""
        if n_msgs % self.recipients:
            raise ValueError(f"{what}: {n_msgs} samples do not split into "
                             f"{self.recipients} recipients' runs")
        return n_msgs // self.recipients

    def nbytes(self) -> int:
        return sum(k.numel() * k.element_size() for k in self.keys)


def _key_on(key, ntt: Ntt, plain, tensors: tuple[str, ...]):
    """A copy of a key object on the device of ``ntt`` (the same ring's NTT
    of another context): what the key holds is copied as it lies, in its
    layout, so nothing is gathered back and no companion is recomputed.
    Only between devices of one kind: the CPU and a card hold different
    layouts."""
    dev = ntt.device
    if dev.type != key.keys[0].device.type:
        raise ValueError(f"{key.name}: the key lies on {key.keys[0].device} in that "
                         f"device kind's layout; it cannot be copied to {dev}")
    other = copy.copy(key)
    other.ntt = ntt
    other.plain = plain
    other.keys = tuple(k.to(dev) for k in key.keys)
    if key.on_card:
        for name in tensors:
            setattr(other, name, getattr(key, name).to(dev))
    return other


class BlindRotateKey(StackedKey):
    """A paired bootstrapping key for :func:`blind_rotate`.

    bsk / bsk_sh: (3*n_steps, N, d, 2, 2) int64, reference order (the
    layout of ``tfhe_omr_tpu.core.keygen.DetectionKey.bsk1`` / ``bsk2``),
    one recipient's. On the CPU both are kept as given. On a card only the
    kernel's layout is held (:func:`kernel_key_layout`, int32 words for a
    field below 2**31, no companions: the kernel reduces its sums lazily),
    beside the kernel's tables in its word size and the clusters of each
    cluster variant that the card holds at once (:func:`cluster_fits`).
    Either is held as a stack of one recipient's key.
    """

    def __init__(self, bsk: torch.Tensor, bsk_sh: torch.Tensor, ntt: Ntt,
                 gadget: SignedGadget, name: str):
        self.ntt = ntt
        self.gadget = gadget
        self.name = name
        self.n_steps = bsk.shape[0] // 3
        self.plain = make_blind_rotate(ntt.field, ntt, gadget)
        self.on_card = build.device_kind(bsk) == "cuda"
        self.keys = (bsk[None], bsk_sh[None])
        if self.on_card:
            lay = self.layout = br_layout(ntt, gadget)
            self.keys = (kernel_key_layout(bsk, self.n_steps, ntt.n, gadget.d,
                                           lay.dj, ntt.perm_inv, lay.dtype)[None],)
            # the kernel's tables, in its word: per-pass twiddles beside their
            # companions, the psi-power table and the base orders
            self.tw_fwd, self.tw_inv, self.n_inv_sh = kernel_tables(ntt, lay, name)
            self.mono = ntt.mono.to(lay.dtype)
            self.orders = ntt.base_orders_t.to(torch.int32)
            self.n_inv = ntt.n_inv
            self.cluster_fits = cluster_fits(ntt, gadget, lay, bsk.device)

    def to(self, ntt: Ntt) -> "BlindRotateKey":
        """This key for another device: ``ntt`` is that device's NTT of the
        same ring (:func:`_key_on`)."""
        other = _key_on(self, ntt, make_blind_rotate(ntt.field, ntt, self.gadget),
                        ("tw_fwd", "tw_inv", "mono", "orders"))
        if other.on_card:
            other.cluster_fits = cluster_fits(ntt, self.gadget, self.layout, ntt.device)
        return other

    def reference(self, r: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """(bsk, bsk_sh) of recipient ``r`` in the reference layout and slot
        order, int64."""
        if not self.on_card:
            return tuple(k[r] for k in self.keys)
        bsk = reference_key_layout(self.keys[0][r], self.ntt.perm)
        return bsk, self.ntt.field.shoup_t(bsk)


def blind_rotate_plain(acc: torch.Tensor, amounts: torch.Tensor,
                       key: BlindRotateKey) -> torch.Tensor:
    """acc (M, 2, N), amounts (2*n_steps, M) -> (M, 2, N), plain torch,
    each recipient's run of M with its own key."""
    per = key.runs(acc.shape[0], "blind_rotate")
    out = torch.cat([key.plain(acc[r * per:(r + 1) * per].permute(2, 1, 0),
                               amounts[:, r * per:(r + 1) * per], *key.reference(r))
                     for r in range(key.recipients)], dim=2)
    return out.permute(2, 1, 0).contiguous()


#: the stages of a CMUX step that a profiled launch times apart, in the
#: order of ``csrc/blind_rotate.cuh BrStage``
BR_STAGES = ("digits_fwd", "staging", "mac", "monomial", "inv_acc", "barrier")


def blind_rotate(acc: torch.Tensor, amounts: torch.Tensor,
                 key: BlindRotateKey, stage_clocks: torch.Tensor | None = None,
                 plane_stamps: bool = True, plain: bool = False) -> torch.Tensor:
    """The paired CMUX chain on every sample: acc (M, 2, N) coefficient
    domain, amounts (2*n_steps, M) in [0, 2N) -> (M, 2, N). Any M: the
    kernel serves ``layout.s`` samples per block and masks the rest of the
    last block. With a stack of R keys, M splits into R equal runs, run r
    under recipient r's key, in one launch: each run takes blocks of its
    own and masks the rest of its last one. Where the kernel has cluster
    variants and :func:`cluster_size` gives C > 1, a cluster of C CTAs
    serves each sample in place of a block; the launch counts as
    ``<key name>_cluster`` in ``build.LAUNCHES``.

    With ``stage_clocks``, an int64 tensor of (blocks, len(BR_STAGES)) on
    the card (blocks: :func:`n_blocks` of M and ``key.layout.s``), the
    profiled instantiation of the reference rings runs instead and adds the
    SM clocks that thread 0 of each block spent in each stage of all its
    steps (:data:`BR_STAGES`) to it (blocks: R runs of :func:`n_blocks` of
    a run with a stack of R keys); its output is the same. It counts as
    ``<key name>_profiled`` in ``build.LAUNCHES``. ``plane_stamps=False``
    leaves out the two stamps of every key plane: "staging" stays 0 and is
    counted in "mac", at less cost to the other stages. A CPU tensor or
    ``plain`` runs :func:`blind_rotate_plain`, which has no clocks: with
    ``stage_clocks`` it raises."""
    if build.runs_plain(acc, plain):
        if stage_clocks is not None:
            raise ValueError("blind_rotate: stage clocks come from the kernel; "
                             "the plain path has none")
        return blind_rotate_plain(acc, amounts, key)
    ntt, g = key.ntt, key.gadget
    n_msgs = acc.shape[0]
    if acc.shape != (n_msgs, 2, ntt.n) or amounts.shape != (2 * key.n_steps, n_msgs):
        raise ValueError(f"blind_rotate: acc {tuple(acc.shape)}, amounts {tuple(amounts.shape)}")
    if not key.on_card:
        raise ValueError("blind_rotate: the key is not on the card")
    per_key = key.runs(n_msgs, "blind_rotate")
    acc = acc.contiguous()
    amounts = amounts.contiguous()
    out = torch.empty_like(acc)
    build.require_cuda("blind_rotate", acc, amounts)
    build.require_cuda("blind_rotate", acc, key.keys[0], key.mono, key.tw_fwd,
                       key.tw_inv, key.orders, dtypes=(torch.int64, torch.int32))
    blocks = key.recipients * n_blocks(per_key, key.layout.s)
    if stage_clocks is not None:
        build.require_cuda("blind_rotate", acc, stage_clocks)
        if stage_clocks.shape != (blocks, len(BR_STAGES)):
            raise ValueError(f"blind_rotate: stage clocks {tuple(stage_clocks.shape)}, the "
                             f"launch has {blocks} blocks of {len(BR_STAGES)} stages")
    if n_msgs == 0:
        return out
    lib = build.library()
    cluster = 1
    if stage_clocks is None and key.cluster_fits:
        sms = torch.cuda.get_device_properties(acc.device).multi_processor_count
        cluster = cluster_size(blocks, sms, key.cluster_fits)
    args = (build.ptr(acc), build.ptr(out), build.ptr(amounts), n_msgs,
            key.n_steps, build.ptr(key.keys[0]), build.ptr(key.mono),
            build.ptr(key.orders), build.ptr(key.tw_fwd), build.ptr(key.tw_inv),
            key.n_inv, key.n_inv_sh, ntt.log_n, ntt.field.q, g.d, g.log_b,
            blocks * cluster, build.stream_of(acc), per_key)
    with torch.cuda.device(acc.device):
        if stage_clocks is not None:
            rc = lib.omr_blind_rotate_profiled(*args, build.ptr(stage_clocks),
                                               int(plane_stamps))
        elif cluster > 1:
            rc = lib.omr_blind_rotate_cluster(*args, cluster)
        else:
            rc = lib.omr_blind_rotate(*args)
    name = (f"{key.name}_profiled" if stage_clocks is not None
            else f"{key.name}_cluster" if cluster > 1 else key.name)
    build.check(lib, rc, name)
    build.LAUNCHES[name] += 1
    return out


def auto_multipliers(autos, n: int) -> list[int]:
    """Per round, the inverse mod 2N of the Galois element: ``csrc/trace.cu``
    takes index and sign of the automorphism from one multiply,
    ``sigma_g(c)[k] = +-c[m mod N]`` with ``m = g**-1 * k mod 2N``, negated
    where ``m >= N``: the source index in the low ``log N`` bits of ``m``,
    the sign in the bit above them."""
    return [pow(int(g), -1, 2 * n) for g, _gidx, _gsign in autos]


def trace_key_layout(trace_k: torch.Tensor, perm_inv: torch.Tensor) -> torch.Tensor:
    """Reference layout ``(rounds, N, d, 2)`` (slot, digit, out) -> the
    kernel's ``(rounds, d, 2, N)``, slots in the radix-2 order."""
    return trace_k.permute(0, 2, 3, 1)[..., perm_inv].contiguous()


def trace_reference_layout(k: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`trace_key_layout`."""
    return k[..., perm].permute(0, 3, 1, 2)


class TraceKey(StackedKey):
    """The automorphism key-switching keys for :func:`trace`.

    trace_k / trace_k_sh: (rounds, N, d, 2) int64, reference order;
    ``autos`` is ``OmrContext.trace_autos``, one recipient's. On the CPU
    both are kept as given. On a card only the kernel's layout is held
    (:func:`trace_key_layout`, no companions: the kernel sums its products
    lazily), beside the kernel's twiddle tables and the rounds'
    automorphism multipliers. Either is held as a stack of one
    recipient's key.
    """

    def __init__(self, trace_k: torch.Tensor, trace_k_sh: torch.Tensor,
                 ntt: Ntt, gadget: SignedGadget, autos, name: str = "trace"):
        assert gadget.exact, "the trace kernel takes exact digits"
        self.ntt = ntt
        self.gadget = gadget
        self.name = name
        self.rounds = len(autos)
        self.plain = make_trace(ntt.field, ntt, gadget, autos)
        self.on_card = build.device_kind(trace_k) == "cuda"
        self.keys = (trace_k[None], trace_k_sh[None])
        if self.on_card:
            lay = self.layout = tr_layout(ntt, gadget)
            self.keys = (trace_key_layout(trace_k, ntt.perm_inv)[None],)
            self.tw_fwd, self.tw_inv, self.n_inv_sh = kernel_tables(ntt, lay, name)
            self.ginv = torch.tensor(auto_multipliers(autos, ntt.n),
                                     dtype=torch.int32, device=trace_k.device)

    def to(self, ntt: Ntt, autos) -> "TraceKey":
        """This key for another device: ``ntt`` and ``autos`` are that
        device's context's (:func:`_key_on`)."""
        return _key_on(self, ntt, make_trace(ntt.field, ntt, self.gadget, autos),
                       ("tw_fwd", "tw_inv", "ginv"))

    def reference(self, r: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """(trace_k, trace_k_sh) of recipient ``r`` in the reference layout
        and slot order."""
        if not self.on_card:
            return tuple(k[r] for k in self.keys)
        k = trace_reference_layout(self.keys[0][r], self.ntt.perm)
        return k, self.ntt.field.shoup_t(k)


def trace_plain(acc: torch.Tensor, key: TraceKey) -> torch.Tensor:
    """acc (B, 2, N) -> (B, 2, N), plain torch, each recipient's run of B
    with its own key."""
    per = key.runs(acc.shape[0], "trace")
    out = torch.cat([key.plain(acc[r * per:(r + 1) * per].permute(2, 1, 0), *key.reference(r))
                     for r in range(key.recipients)], dim=2)
    return out.permute(2, 1, 0).contiguous()


def trace(acc: torch.Tensor, key: TraceKey, plain: bool = False) -> torch.Tensor:
    """EvalTr on every message: acc (B, 2, N) coefficient domain, already
    multiplied by N^{-1} -> (B, 2, N). Any B: the kernel serves
    ``layout.s`` messages per block and masks the rest of the last block.
    With a stack of R keys, B splits into R equal runs, run r under
    recipient r's key, in one launch. A CPU tensor or ``plain`` runs
    :func:`trace_plain`."""
    if build.runs_plain(acc, plain):
        return trace_plain(acc, key)
    ntt, g = key.ntt, key.gadget
    n_msgs = acc.shape[0]
    if acc.shape != (n_msgs, 2, ntt.n):
        raise ValueError(f"trace: acc {tuple(acc.shape)}")
    if not key.on_card:
        raise ValueError("trace: the key is not on the card")
    per_key = key.runs(n_msgs, "trace")
    acc = acc.contiguous()
    out = torch.empty_like(acc)
    build.require_cuda("trace", acc, key.keys[0], key.tw_fwd, key.tw_inv, key.ginv,
                       dtypes=(torch.int64, torch.int32))
    if n_msgs == 0:
        return out
    lib = build.library()
    with torch.cuda.device(acc.device):
        rc = lib.omr_trace(
            build.ptr(acc), build.ptr(out), n_msgs, key.rounds, build.ptr(key.ginv),
            build.ptr(key.keys[0]), build.ptr(key.tw_fwd), build.ptr(key.tw_inv),
            ntt.n_inv, key.n_inv_sh, ntt.log_n, ntt.field.q, g.d, g.log_b,
            build.stream_of(acc), per_key,
        )
    build.check(lib, rc, key.name)
    build.LAUNCHES[key.name] += 1
    return out
