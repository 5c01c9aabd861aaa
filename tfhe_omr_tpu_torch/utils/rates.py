"""The card's unit rates, the least time a piece of work could take on it,
and the result lines of the unit-rate probes.

Shared by ``chip_smoke.py`` and the probe benches (``benches/*_probe_torch.py``)
so that both bound a run the same way. Spec rates are a clock a streaming
multiprocessor of an H100 (SM 9.0), times the SMs and the top SM clock
(``nvidia-smi clocks.max.sm``):

* ``int32``: 128 integer instructions (four schedulers issue one warp
  instruction each a clock; IADD3, LOP3, LEA, SHF, ISETP, SEL on the ALU
  pipe, IMAD on the FMA pipe, side by side);
* ``int32_mul``: 64 of them multiplies (IMAD, IMAD.HI, IMAD.WIDE: the FMA
  pipe's integer half);
* ``f32_fma``: 128 float32 FMAs;
* ``int8_mma``: 8192 dense int8 tensor-core operations (4096 MACs).

A bound is the larger of each unit's work over its rate and the bytes
(inputs read once, outputs written once) over the memory rate.
"""

from __future__ import annotations

import subprocess

import torch

from tfhe_omr_tpu_torch.utils.timing import median_ms

SPEC_PER_CLK_SM = {"int32": 128, "int32_mul": 64, "f32_fma": 128, "int8_mma": 8192}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

#: the least work of one step of a probe chain, an element and a stream, by
#: unit: int32 instructions (of them multiplies; a multiply-add is one) or
#: float32 FMAs. Folds the compiler may make are taken: sub_add's
#: b + (a - b) is a, shift_add's run of shifts of a becomes the add's own
#: shift (LEA.HI), sel_add's compare and select fold where the order of a and
#: b is known, so each of them needs one add a step at least. int64 is the
#: low word of a 64 x 64 product (three 32-bit multiplies) and a 64-bit add
#: (two). The MAC's step is the add of i and one multiply-add.
STEP_WORK = {
    ("int32", "add"): {"int32": 2},
    ("int32", "mul"): {"int32": 2, "int32_mul": 2},
    ("int32", "mul_add"): {"int32": 2, "int32_mul": 1},
    ("int32", "sub_add"): {"int32": 1},
    ("int32", "shift_add"): {"int32": 1},
    ("int32", "mask_add"): {"int32": 2},
    ("int32", "sel_add"): {"int32": 1},
    ("int32", "mulhi_add"): {"int32": 2, "int32_mul": 1},
    ("int32", "mac"): {"int32": 2, "int32_mul": 1},
    ("int64", "mul_add"): {"int32": 5, "int32_mul": 3},
    ("float32", "fma"): {"f32_fma": 2},
}


def step_work(dtype: torch.dtype, op: str, steps: int) -> dict:
    """The least work of ``steps`` steps (elements x iterations x streams)
    of the chain ``op`` in ``dtype`` (``op="mac"``: the MAC), by unit."""
    per = STEP_WORK[(str(dtype).removeprefix("torch."), op)]
    return {unit: n * steps for unit, n in per.items()}


def dot_work(g: int, m: int, k: int, n: int, rounds: int) -> dict:
    """int8 tensor-core operations (a MAC is two) of ``rounds`` (g, m, k) @
    (g, k, n) products."""
    return {"int8_mma": 2 * g * m * k * n * rounds}


def bound(work: dict, rates: dict, n_bytes: int) -> dict:
    """The least milliseconds the card could take: the largest of each
    unit's ``work`` over its rate in ``rates`` (per second) and ``n_bytes``
    over the memory rate, with the unit (or ``"bytes"``) that sets it."""
    by_unit = {unit: 1e3 * n / rates[unit] for unit, n in work.items()}
    unit = max(by_unit, key=by_unit.get, default=None)
    by_ops = by_unit.get(unit, 0.0)
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    if by_ops >= by_bytes:
        return {"bound_ms": by_ops, "bound_by": "operations", "bound_unit": unit}
    return {"bound_ms": by_bytes, "bound_by": "bytes", "bound_unit": "bytes"}


def spec_rates(device: torch.device) -> dict:
    """Each unit's spec rate a second on ``device``: :data:`SPEC_PER_CLK_SM`
    x SMs x the top SM clock."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rates = {unit: per * sms * mhz * 1e6 for unit, per in SPEC_PER_CLK_SM.items()}
    return {"clock_max_sm_mhz": mhz, "sms": sms, "ops_per_s": rates}


def rate_record(variant: str, counted: float, ms: float, unit: str, device: torch.device,
                rates: dict | None = None, work: dict | None = None,
                n_bytes: int = 0) -> dict:
    """One result line of a probe: ``counted`` operations (as the TPU probe
    counts them) in ``ms`` as ``unit`` (1e9 a second); given the card's
    ``rates`` and the run's least ``work``, also its :func:`bound` and the
    share of the bound that the run reached."""
    rec = {"variant": variant, unit: counted / ms / 1e6, "ms": ms,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if rates and work:
        b = bound(work, rates, n_bytes)
        rec.update(b, share_of_bound=b["bound_ms"] / ms)
    return rec


def library_i8dot(af: torch.Tensor, bf: torch.Tensor, rounds: int) -> torch.Tensor:
    """The sums of ``probe_i8dot`` by a float32 library product: one
    ``torch.bmm`` a round (exact while every sum stays below 2^24), added
    into an int32 total (wrapping). Not the function the kernel computes
    (an int8 product); :func:`library_int_mm` is."""
    acc = torch.zeros((af.shape[0], af.shape[1], bf.shape[2]), dtype=torch.int32,
                      device=af.device)
    for _ in range(rounds):
        acc += torch.bmm(af, bf).to(torch.int32)
    return acc


def int_mm_k(k: int) -> int:
    """The depth ``torch._int_mm`` takes for a product of depth ``k``: above
    16 (torch's condition) and a multiple of 16 (cuBLASLt refuses an int8
    operand whose rows are not 16-byte aligned: k = 24 is refused on an
    H100); zero rows and columns add nothing to the sums."""
    return max(32, -(-k // 16) * 16)


def _int_mm_operands(a: torch.Tensor, b: torch.Tensor, b_col_major: bool):
    """(a3, b3, m): the operands of :func:`library_int_mm` as (g, m', k')
    and (g, k', n), zero-padded; ``b_col_major`` lays each b3[i] out
    column-major (k-contiguous), the layout cuBLASLt's int8 kernels read."""
    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    b3 = b if b.dim() == 3 else b.unsqueeze(0)
    m, k = a3.shape[1:]
    n = b3.shape[2]
    if n % 16:
        raise ValueError(f"torch._int_mm needs n a multiple of 16, got {n}")
    pad_k, pad_m = int_mm_k(k) - k, -m % 128
    if pad_k or pad_m:
        a3 = torch.nn.functional.pad(a3, (0, pad_k, 0, pad_m))
        b3 = torch.nn.functional.pad(b3, (0, 0, 0, pad_k))
    if b_col_major:
        b3 = b3.transpose(1, 2).contiguous().transpose(1, 2)
    return a3.contiguous(), b3, m


def _int_mm_rounds(a3: torch.Tensor, b3: torch.Tensor, acc: torch.Tensor,
                   rounds: int) -> None:
    for _ in range(rounds):
        for i in range(a3.shape[0]):
            acc[i] += torch._int_mm(a3[i], b3[i])


def library_int_mm(a: torch.Tensor, b: torch.Tensor, rounds: int,
                   b_col_major: bool = False) -> torch.Tensor:
    """The sums of ``probe_i8dot`` by the library's int8 product:
    ``torch._int_mm`` (2-D int8 x int8 -> int32) a round, added into an
    int32 total (wrapping), k zero-padded to :func:`int_mm_k`. torch has no
    batched int8 product, so a batched dot (g, m, k) @ (g, k, n) is a loop
    of g ``_int_mm`` calls a round, not one call. m is zero-padded to a
    multiple of 128 (cuBLASLt on an H100 refused m = 48 at every k tried,
    24 and 32; m = 128, 384, 768 and 2048 ran) and n must be a multiple of
    16 (16-byte rows); other shapes raise. ``b_col_major`` hands b to the
    library column-major (the copy is made before the first call)."""
    a3, b3, m = _int_mm_operands(a, b, b_col_major)
    acc = torch.zeros((a3.shape[0], a3.shape[1], b3.shape[2]), dtype=torch.int32,
                      device=a.device)
    _int_mm_rounds(a3, b3, acc, rounds)
    return acc[:, :m].reshape(a.shape[:-1] + b.shape[-1:])


#: calls captured in one CUDA graph by :func:`library_int_mm_graphed`, at most
#: (a graph of one round if a round has more)
GRAPH_CALLS = 1024


def library_int_mm_graphed(a: torch.Tensor, b: torch.Tensor, rounds: int,
                           b_col_major: bool = False):
    """A callable that returns :func:`library_int_mm` ``(a, b, rounds,
    b_col_major)``. On a card the calls of ``per`` rounds (the largest
    divisor of ``rounds`` with ``per * g <= GRAPH_CALLS``, at least 1) are
    captured once in a CUDA graph, and the callable zeroes the total and
    replays the graph ``rounds / per`` times: its time is the card's, not
    that of the host's launches (some 20-30 us a call on an H100 machine,
    more than a small product takes). On the CPU it runs the loop."""
    if a.device.type != "cuda":
        return lambda: library_int_mm(a, b, rounds, b_col_major)
    a3, b3, m = _int_mm_operands(a, b, b_col_major)
    g = a3.shape[0]
    per = max([d for d in range(1, rounds + 1) if rounds % d == 0 and d * g <= GRAPH_CALLS],
              default=1)
    acc = torch.zeros((g, a3.shape[1], b3.shape[2]), dtype=torch.int32, device=a.device)
    side = torch.cuda.Stream(a.device)
    side.wait_stream(torch.cuda.current_stream(a.device))
    with torch.cuda.stream(side):  # the library's first calls, outside the capture
        _int_mm_rounds(a3, b3, torch.zeros_like(acc), 1)
    torch.cuda.current_stream(a.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _int_mm_rounds(a3, b3, acc, per)

    def run() -> torch.Tensor:
        acc.zero_()
        for _ in range(rounds // per):
            graph.replay()
        return acc[:, :m].reshape(a.shape[:-1] + b.shape[-1:])

    return run


def library_int_mm_ms(a: torch.Tensor, b: torch.Tensor, rounds: int,
                      reps: int = 3) -> dict:
    """``{"b_row_major": ms, "b_col_major": ms}``: the median time of
    :func:`library_int_mm_graphed` with b in each layout, each first held
    equal to ``rounds`` times the product (int32 wrapping); raises if not."""
    one = torch.matmul(a.double(), b.double()).long()
    want = ((one * rounds + 2**31) % 2**32 - 2**31).to(torch.int32)
    out = {}
    for layout, col in (("b_row_major", False), ("b_col_major", True)):
        fn = library_int_mm_graphed(a, b, rounds, col)
        if not torch.equal(fn(), want):  # also the warm call
            raise AssertionError(f"torch._int_mm ({layout}) != the plain product")
        out[layout] = median_ms(fn, a.device, reps, warm=False)
    return out
