"""int32 ALU and int8 tensor-core rates on the PyTorch / CUDA port.

The counterpart of benches/vpu_probe.py: the same seven int32 mutual
recurrences (a = fa(a, b); b = fb(b, a), 2 ops an element an iteration) at
(size, 1024) with 1 and 4 independent streams, and int8 dots summed over
rounds at the same shapes, through ``csrc/probes.cu`` (probe_chain,
probe_i8dot on the tensor cores). On a card the chains' times are the
card's, from CUDA graphs of 10 calls (utils/timing.py card_ms: a chain of
0.01-0.1 ms called one at a time is timed by the host's work between
launches); the dots' times are the median of 5 calls after a warm one, with
CUDA events.

Usage: python benches/vpu_probe_torch.py [--size 256] [--iters 512]
       python benches/vpu_probe_torch.py --tiny --device cpu   # plain torch

Prints one JSON line per variant ({"variant", "gops", "ms"}; on a card
also ``bound_ms``, the least time at the units' spec rates of
``tfhe_omr_tpu_torch/utils/rates.py``, and ``share_of_bound``), then the
card's name, power limit and spec rates. The card is the default; with no card and no ``--device cpu``
the script exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

VARIANTS = ("add", "mul", "mul_add", "sub_add", "shift_add", "mask_add", "sel_add")
DOTS = ((2048, 2048, 256, 8), (128, 12, 256, 64), (128, 128, 256, 64))
TINY_DOTS = ((32, 64, 32, 2), (24, 12, 32, 2), (24, 40, 32, 2))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256, help="rows of (size, 1024)")
    ap.add_argument("--iters", type=int, default=512)
    ap.add_argument("--tiny", action="store_true", help="small shapes and loops")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    args = ap.parse_args()

    import torch

    from bench_torch import card_line
    from tfhe_omr_tpu_torch.ops.probes import probe_chain, probe_i8dot
    from tfhe_omr_tpu_torch.utils.build import resolve_device
    from tfhe_omr_tpu_torch.utils.rates import (
        dot_work, library_int_mm_ms, rate_record, spec_rates, step_work)
    from tfhe_omr_tpu_torch.utils.timing import card_ms, median_ms

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"vpu_probe_torch: {err}")
    spec = spec_rates(device) if device.type == "cuda" else {}
    shape = (8, 128) if args.tiny else (args.size, 1024)
    iters = 3 if args.tiny else args.iters
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(1, 1 << 20, size=shape, dtype=np.int32), device=device)
    y = torch.as_tensor(rng.integers(1, 1 << 10, size=shape, dtype=np.int32), device=device)
    elems = x.numel()
    for op in VARIANTS:
        for streams in (1, 4):
            ms = card_ms(lambda: probe_chain(x, y, op, iters, streams), device)
            steps = elems * iters * streams
            print(json.dumps(rate_record(f"i32_{op}_s{streams}", 2 * steps, ms, "gops",
                                         device, spec.get("ops_per_s"),
                                         step_work(torch.int32, op, steps), 12 * elems)),
                  flush=True)
    for m, k, n, rounds in TINY_DOTS if args.tiny else DOTS:
        a = torch.as_tensor(rng.integers(-64, 64, size=(m, k), dtype=np.int8), device=device)
        b = torch.as_tensor(rng.integers(-64, 64, size=(k, n), dtype=np.int8), device=device)
        ms = median_ms(lambda: probe_i8dot(a, b, rounds), device)
        print(json.dumps(rate_record(f"i8dot_{m}x{k}x{n}", 2 * m * k * n * rounds, ms,
                                     "gops", device, spec.get("ops_per_s"),
                                     dot_work(1, m, k, n, rounds),
                                     m * k + k * n + 4 * m * n)), flush=True)
        for layout, ms in library_int_mm_ms(a, b, rounds).items():
            print(json.dumps({"library": f"torch._int_mm a round (a CUDA graph on a card), "
                              f"{layout}", **rate_record(
                                  f"torch_int_mm_{m}x{k}x{n}_{layout}",
                                  2 * m * k * n * rounds, ms, "gops", device)}), flush=True)
    print(json.dumps({"card": card_line() if device.type == "cuda" else "cpu", **spec}))


if __name__ == "__main__":
    main()
