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
    """The sums of ``probe_i8dot`` by the library: one float32 ``torch.bmm``
    a round (exact while every sum stays below 2^24), added into an int32
    total (wrapping)."""
    acc = torch.zeros((af.shape[0], af.shape[1], bf.shape[2]), dtype=torch.int32,
                      device=af.device)
    for _ in range(rounds):
        acc += torch.bmm(af, bf).to(torch.int32)
    return acc
