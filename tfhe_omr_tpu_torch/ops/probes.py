"""Unit-rate probes: the wrappers of ``csrc/probes.cu`` and their plain
versions.

PyTorch counterparts of the Pallas probes in ``benches/`` (vpu_probe.py,
vpu_peak_probe.py, mac_probe.py, mosaic_unsupported_probe.py): each keeps
one execution unit busy with work no compiler can fold, so its time on
the card gives that unit's rate.

* :func:`probe_chain` - the mutual recurrence ``a' = fa(a, b); b' = fb(b,
  a')`` on S independent (a, b) pairs an element, ``out = a_0 + sum b_s``
  (int32 ALU chains, the signed high word of a 32 x 32 product and both
  words of the unsigned one, int64 multiply, float32 FMA); :func:`chain_plan`
  says how its pairs are laid over the card's threads;
* :func:`probe_mac` - ``acc_s += (v_s + i) * k_s`` with loop-invariant v, k;
* :func:`probe_i8dot` - int8 (g, m, k) @ (g, k, n) -> int32 summed over
  ``rounds``, on the tensor cores (``wgmma`` s8 from TMA-fed shared memory).

Integer sums wrap mod 2^32 (2^64 for int64) as the TPU's do. A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches its
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tfhe_omr_tpu_torch.utils import build

#: the ops of :func:`probe_chain`, in the order of ``ProbeOp`` in probes.cu
CHAIN_OPS = ("add", "mul", "mul_add", "sub_add", "shift_add", "mask_add", "sel_add",
             "mulhi_add", "fma", "mulwide_add")
#: the element types a chain op runs in on the card
CHAIN_DTYPES = {torch.int32: CHAIN_OPS[:8] + ("mulwide_add",), torch.int64: ("mul_add",),
                torch.float32: ("fma",)}
STREAMS = (1, 4, 16)
_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2}


def _check_chain(x: torch.Tensor, y: torch.Tensor, op: str, streams: int) -> None:
    if x.shape != y.shape or x.dtype != y.dtype:
        raise ValueError(f"probe_chain: x {x.dtype}{tuple(x.shape)} and y "
                         f"{y.dtype}{tuple(y.shape)} differ")
    if op not in CHAIN_DTYPES.get(x.dtype, ()):
        raise ValueError(f"probe_chain: no {op} chain in {x.dtype}")
    if streams not in STREAMS:
        raise ValueError(f"probe_chain: streams must be one of {STREAMS}")


def _fmaf(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """fmaf(a, b, c), rounded once. The product of two float32s is exact in
    float64; its sum with c is rounded to odd in float64 (the sum rounded
    to nearest, its error from TwoSum, and a sum whose error is not zero
    moved one ulp toward it where its last bit is even), and a sum rounded
    to odd with 53 bits rounds to the float32 nearest the exact sum (at
    least 24 + 2 bits), so the cast to float32 is fmaf's one rounding."""
    p = a.double() * b.double()
    s = p + c
    pp = s - c
    err = (p - pp) + (c - (s - pp))
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf).to(s))
    return torch.where((err != 0) & err.isfinite() & even, away, s).float()


def _chain_step(op: str, a: torch.Tensor, b: torch.Tensor):
    if op == "fma":  # each product and sum rounded once, as fmaf does
        a = _fmaf(a, b, 1.5)
        return a, _fmaf(b, a, 0.5)
    if op == "add":
        a2 = a + b
        return a2, b + a2
    if op == "mul":
        a2 = a * b
        return a2, b * a2
    if op == "mulwide_add":  # b + both words of the unsigned product, in int64
        au, bu = a.long() & 0xFFFFFFFF, b.long() & 0xFFFFFFFF
        low, high = au * (bu & 0xFFFF), au * (bu >> 16)  # each below 2^48
        lo = (low + ((high & 0xFFFF) << 16)) & 0xFFFFFFFF
        hi = ((low >> 16) + high) >> 16
        a2 = (bu + lo + hi) & 0xFFFFFFFF
        a2 = (a2 - ((a2 >> 31) << 32)).int()
        return a2, a2
    a2 = {
        "mul_add": lambda: a * b,
        "sub_add": lambda: a - b,
        "shift_add": lambda: a >> 1,
        "mask_add": lambda: a & b,
        "sel_add": lambda: torch.where(a > b, a - b, a),
        "mulhi_add": lambda: ((a.long() * b.long()) >> 32).int(),
    }[op]()
    return a2, b + a2


def probe_chain_plain(x: torch.Tensor, y: torch.Tensor, op: str, iters: int,
                      streams: int) -> torch.Tensor:
    """The chain in torch's own arithmetic on x's device: int32 and int64
    wrap, ``fma`` rounds its product-and-sum once (:func:`_fmaf`)."""
    _check_chain(x, y, op, streams)
    if op == "fma":
        st = [(x + float(s), y * torch.tensor(1 + 0.01 * s, dtype=torch.float32))
              for s in range(streams)]
    else:
        st = [(x + s, y + s) for s in range(streams)]
    for _ in range(iters):
        st = [_chain_step(op, a, b) for a, b in st]
    acc = st[0][0]
    for _a, b in st:
        acc = acc + b
    return acc


#: the fields of ``omr_probe_chain_plan`` (csrc/probes.cu ``chain_plan``), in order
CHAIN_PLAN_FIELDS = ("per_thread", "split", "blocks")


def chain_plan(n: int, streams: int, sms: int, dtype: torch.dtype = torch.int32) -> dict:
    """How the kernel lays n elements of ``dtype`` with ``streams`` streams
    over the threads of a card of ``sms`` SMs: the streams a thread holds,
    the threads an element's streams are split over and the blocks."""
    lib = build.library()
    out = (ctypes.c_int64 * len(CHAIN_PLAN_FIELDS))()
    build.check(lib, lib.omr_probe_chain_plan(n, _DTYPE_CODE[dtype], streams, sms, out),
                "probe_chain_plan")
    return dict(zip(CHAIN_PLAN_FIELDS, out))


def probe_chain(x: torch.Tensor, y: torch.Tensor, op: str, iters: int,
                streams: int) -> torch.Tensor:
    """:func:`probe_chain_plain` through ``csrc/probes.cu`` on a card: the
    S pairs in registers, an element's pairs split over adjacent threads
    where the elements alone do not fill the card (:func:`chain_plan`),
    ``iters`` given at run time."""
    _check_chain(x, y, op, streams)
    if build.runs_plain(x) or x.numel() == 0:
        return probe_chain_split(x, y, op, iters, streams, 1)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return probe_chain_split(x, y, op, iters, streams,
                             chain_plan(x.numel(), streams, sms, x.dtype)["split"])


def probe_chain_split(x: torch.Tensor, y: torch.Tensor, op: str, iters: int,
                      streams: int, split: int) -> torch.Tensor:
    """:func:`probe_chain` with each element's streams over ``split``
    adjacent threads (a power of two up to ``streams``), whatever
    :func:`chain_plan` would pick: how ``benches/chain_plan_torch.py`` times
    every split."""
    _check_chain(x, y, op, streams)
    if build.runs_plain(x):
        return probe_chain_plain(x, y, op, iters, streams)
    out = torch.empty_like(x)
    build.require_cuda("probe_chain", x, y, out, dtypes=(x.dtype,))
    if x.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(x.device):
        rc = lib.omr_probe_chain(CHAIN_OPS.index(op), _DTYPE_CODE[x.dtype], streams,
                                 build.ptr(x), build.ptr(y), build.ptr(out), x.numel(),
                                 iters, split, build.stream_of(x))
    build.check(lib, rc, "probe_chain")
    build.LAUNCHES["probe_chain"] += 1
    return out


def _check_mac(x: torch.Tensor, y: torch.Tensor, streams: int) -> None:
    if x.shape != y.shape or x.dtype != torch.int32 or y.dtype != torch.int32:
        raise ValueError("probe_mac: x and y must be int32 of one shape")
    if streams not in STREAMS:
        raise ValueError(f"probe_mac: streams must be one of {STREAMS}")


def probe_mac_plain(x: torch.Tensor, y: torch.Tensor, iters: int,
                    streams: int) -> torch.Tensor:
    """acc_s += (v_s + i) * k_s, v_s = x + s, k_s = y - s, int32 wrapping;
    the sum of the S accumulators."""
    _check_mac(x, y, streams)
    vs = [x + s for s in range(streams)]
    ks = [y - s for s in range(streams)]
    accs = [torch.zeros_like(x) for _ in range(streams)]
    for i in range(iters):
        accs = [acc + (v + i) * k for acc, v, k in zip(accs, vs, ks)]
    acc = accs[0]
    for a in accs[1:]:
        acc = acc + a
    return acc


def probe_mac(x: torch.Tensor, y: torch.Tensor, iters: int, streams: int) -> torch.Tensor:
    """:func:`probe_mac_plain` through ``csrc/probes.cu`` on a card."""
    _check_mac(x, y, streams)
    if build.runs_plain(x):
        return probe_mac_plain(x, y, iters, streams)
    out = torch.empty_like(x)
    build.require_cuda("probe_mac", x, y, out, dtypes=(torch.int32,))
    if x.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(x.device):
        rc = lib.omr_probe_mac(streams, build.ptr(x), build.ptr(y), build.ptr(out),
                               x.numel(), iters, build.stream_of(x))
    build.check(lib, rc, "probe_mac")
    build.LAUNCHES["probe_mac"] += 1
    return out


def _check_dot(a: torch.Tensor, b: torch.Tensor) -> None:
    if (a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() not in (2, 3)
            or b.dim() != a.dim() or a.shape[:-2] != b.shape[:-2]
            or a.shape[-1] != b.shape[-2]):
        raise ValueError(f"probe_i8dot: needs int8 (g,) m x k and (g,) k x n, got "
                         f"{a.dtype}{tuple(a.shape)} and {b.dtype}{tuple(b.shape)}")


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 mod 2^32 (two's complement)."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def probe_i8dot_plain(a: torch.Tensor, b: torch.Tensor, rounds: int) -> torch.Tensor:
    """sum over ``rounds`` of a @ b, int32 wrapping: each round's product in
    float64 (exact: every sum stays below 2^53), summed in int64 and
    reduced mod 2^32 once."""
    _check_dot(a, b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.int64, device=a.device)
    for _ in range(rounds):
        acc = acc + torch.matmul(a.double(), b.double()).long()
    return _wrap_int32(acc)


#: the fields of ``omr_probe_i8dot_plan`` (csrc/probes.cu ``dot_plan``), in order
DOT_PLAN_FIELDS = ("n_tile", "split_k", "split_r", "stages", "blocks", "smem", "kp", "scratch")


def i8dot_plan(g: int, m: int, k: int, n: int, rounds: int, sms: int) -> dict:
    """How the kernel cuts a product for a card of ``sms`` SMs: the tile's
    columns, the blocks a tile shares its k atoms and its rounds between, the
    ring's stages, the blocks, the shared memory, k padded to 16 bytes and
    the bytes of the packed operands."""
    lib = build.library()
    out = (ctypes.c_int64 * len(DOT_PLAN_FIELDS))()
    build.check(lib, lib.omr_probe_i8dot_plan(g, m, k, n, rounds, sms, out),
                "probe_i8dot_plan")
    return dict(zip(DOT_PLAN_FIELDS, out))


@functools.lru_cache(maxsize=64)
def _scratch_bytes(g: int, m: int, k: int, n: int, rounds: int, sms: int) -> int:
    """The plan's scratch bytes, asked once a shape: the plan's ctypes round
    trip took as much host time as the rest of the wrapper, and a small
    product's call is bound by the host (PERF.md section 6)."""
    return i8dot_plan(g, m, k, n, rounds, sms)["scratch"]


def probe_i8dot(a: torch.Tensor, b: torch.Tensor, rounds: int) -> torch.Tensor:
    """:func:`probe_i8dot_plain` through ``csrc/probes.cu`` on a card:
    ``wgmma`` m64nNk32 s8 over TMA-fed shared memory, after a pre-pass that
    packs b K-major (and a where k is not a multiple of 16) into one scratch
    buffer, k zero-padded to 16 bytes."""
    _check_dot(a, b)
    if build.runs_plain(a):
        return probe_i8dot_plain(a, b, rounds)
    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    b3 = b if b.dim() == 3 else b.unsqueeze(0)
    g, m, k = a3.shape
    n = b3.shape[2]
    build.require_cuda("probe_i8dot", a3, b3, dtypes=(torch.int8,))
    if g * m * n == 0 or k == 0:
        return torch.zeros((g, m, n), dtype=torch.int32,
                           device=a.device).reshape(a.shape[:-1] + b.shape[-1:])
    if a3.data_ptr() % 16:  # TMA reads from 16-byte aligned rows
        a3 = a3.clone()
    lib = build.library()
    with torch.cuda.device(a.device):
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        scratch = torch.empty(_scratch_bytes(g, m, k, n, rounds, sms), dtype=torch.int8,
                              device=a.device)
        # C's rows rounded up to 4 words, so that TMA can write every tile
        out = torch.empty((g, m, -(-n // 4) * 4), dtype=torch.int32, device=a.device)
        rc = lib.omr_probe_i8dot(build.ptr(a3), build.ptr(b3), build.ptr(out),
                                 build.ptr(scratch), g, m, k, n, rounds, sms,
                                 build.stream_of(a))
    build.check(lib, rc, "probe_i8dot")
    build.LAUNCHES["probe_i8dot"] += 1
    if out.shape[2] != n:
        out = out[..., :n].contiguous()
    return out.reshape(a.shape[:-1] + b.shape[-1:])
