"""The wide multiplies and the batched int8 dot on the PyTorch / CUDA port.

The counterpart of benches/mosaic_unsupported_probe.py, whose primitives a
TPU kernel could not use. On the card every one is supported, so each line
says so and carries a rate: chains on (64, 512), 4096 iterations, 4
streams, ``a2 = a * b; b2 = b + a2`` (2 ops an element an iteration) in

  1. int32 (the baseline), int64 (mul.lo.s64) and the signed high word of
     the 32 x 32 product (__mulhi), through ``csrc/probes.cu`` probe_chain;
  2. int64 in plain torch operations, the counterpart of the original's
     XLA-level chain;
  3. one batched int8 dot (2048, 48, 12) @ (2048, 12, 128) -> int32 on the
     tensor cores (probe_i8dot), beside the library's int8 product
     (``torch._int_mm``, a loop over the 2048 groups: torch has no batched
     int8 product).

Each time is the median of 5 calls after a warm one, with CUDA events.

Usage: python benches/mosaic_unsupported_probe_torch.py
       python benches/mosaic_unsupported_probe_torch.py --tiny --device cpu

Prints one JSON line per attempt, on a card with its bound and the share
of it reached (``tfhe_omr_tpu_torch/utils/rates.py``), then the card's
name, power limit and spec rates. The card is the
default; with no card and no ``--device cpu`` the script exits non-zero
and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SHAPE = (64, 512)
ITERS = 4096
STREAMS = 4
BDOT = (2048, 48, 12, 128)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true", help="small shapes and loops")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    args = ap.parse_args()

    import torch

    from bench_torch import card_line
    from tfhe_omr_tpu_torch.ops.probes import probe_chain, probe_chain_plain, probe_i8dot
    from tfhe_omr_tpu_torch.utils.build import resolve_device
    from tfhe_omr_tpu_torch.utils.rates import (
        dot_work, library_int_mm_ms, rate_record, spec_rates, step_work)
    from tfhe_omr_tpu_torch.utils.timing import median_ms

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"mosaic_unsupported_probe_torch: {err}")
    spec = spec_rates(device) if device.type == "cuda" else {}
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({"device": name, "int64": True}), flush=True)
    shape, iters = ((8, 128), 3) if args.tiny else (SHAPE, ITERS)
    g, m, k, n = (4, 48, 12, 16) if args.tiny else BDOT
    rng = np.random.default_rng(0)
    x32 = torch.as_tensor(rng.integers(1, 1 << 20, shape).astype(np.int32), device=device)
    y32 = torch.as_tensor(rng.integers(1, 1 << 10, shape).astype(np.int32), device=device)
    x64, y64 = x32.long(), y32.long()
    steps = iters * STREAMS * x32.numel()

    def attempt(label, fn, counted, work, n_bytes):
        ms = median_ms(fn, device)
        print(json.dumps({"supported": True,
                          **rate_record(label, counted, ms, "gops", device,
                                        spec.get("ops_per_s"), work, n_bytes)}),
              flush=True)

    b32, b64 = 12 * x32.numel(), 24 * x32.numel()
    attempt("i32_mul_chain", lambda: probe_chain(x32, y32, "mul_add", iters, STREAMS),
            2 * steps, step_work(torch.int32, "mul_add", steps), b32)
    attempt("i64_mul_chain", lambda: probe_chain(x64, y64, "mul_add", iters, STREAMS),
            2 * steps, step_work(torch.int64, "mul_add", steps), b64)
    attempt("mulhi_chain", lambda: probe_chain(x32, y32, "mulhi_add", iters, STREAMS),
            2 * steps, step_work(torch.int32, "mulhi_add", steps), b32)
    attempt("torch_i64_mul_chain",
            lambda: probe_chain_plain(x64, y64, "mul_add", iters, STREAMS),
            2 * steps, step_work(torch.int64, "mul_add", steps), b64)
    a = torch.as_tensor(rng.integers(-64, 64, (g, m, k), dtype=np.int8), device=device)
    b = torch.as_tensor(rng.integers(-64, 64, (g, k, n), dtype=np.int8), device=device)
    attempt("batched_i8_dot", lambda: probe_i8dot(a, b, 1), 2 * g * m * k * n,
            dot_work(g, m, k, n, 1), g * (m * k + k * n + 4 * m * n))
    for layout, ms in library_int_mm_ms(a, b, 1).items():
        print(json.dumps({"library": f"torch._int_mm, a loop of {g} calls (k, m padded) "
                          f"(a CUDA graph on a card), {layout}",
                          **rate_record(f"torch_int_mm_batched_i8_dot_{layout}",
                                        2 * g * m * k * n, ms, "gops", device)}), flush=True)
    print(json.dumps({"card": card_line() if device.type == "cuda" else "cpu", **spec}))


if __name__ == "__main__":
    main()
