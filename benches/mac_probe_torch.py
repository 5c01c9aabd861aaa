"""float32 FMA and int8 tensor-core MAC rates on the PyTorch / CUDA port.

The counterpart of benches/mac_probe.py, through ``csrc/probes.cu``:

  1. float32 FMA chains ``a = a * b + 1.5; b = b * a + 0.5`` at (256, 1024),
     8192 iterations, 1 and 4 streams (probe_chain, fmaf);
  2. batched int8 dots (g, m, k) @ (g, k, n) -> int32 summed over 512
     rounds at the MAC-offload shapes (probe_i8dot, mma.sync s8), beside
     the library's two ways to the same sums: one float32 ``torch.bmm`` a
     round (exact: every sum stays below 2^24) added into an int32 total,
     and the library's int8 product ``torch._int_mm`` (a loop over the
     groups, one round: torch has no batched int8 product);
  3. 2-D int8 dots at the block-diagonal sizes (probe_i8dot, g = 1), beside
     ``torch._int_mm`` a round.

Rates count MACs (FMAs), as the original does. On a card the FMA chains'
times are the card's, from CUDA graphs of 10 calls (utils/timing.py
card_ms: a short kernel called one at a time is timed by the host's work
between launches); every other time is the median of 5 calls after a warm
one, with CUDA events.

Usage: python benches/mac_probe_torch.py
       python benches/mac_probe_torch.py --tiny --device cpu   # plain torch

Prints one JSON line per variant, on a card with its bound and the share
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

BDOTS = ((2048, 48, 12, 128, 512), (256, 384, 96, 128, 512), (128, 768, 192, 128, 512))
DOT2D = ((384, 96, 128, 32768), (768, 192, 128, 16384), (384, 768, 128, 8192))
TINY_BDOTS = ((4, 48, 12, 16, 2), (2, 40, 24, 16, 2))
TINY_DOT2D = ((48, 24, 16, 4),)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true", help="small shapes and loops")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    args = ap.parse_args()

    import torch

    from bench_torch import card_line
    from tfhe_omr_tpu_torch.ops.probes import probe_chain, probe_i8dot
    from tfhe_omr_tpu_torch.utils.build import resolve_device
    from tfhe_omr_tpu_torch.utils.rates import (
        dot_work, library_i8dot, library_int_mm_ms, rate_record, spec_rates, step_work)
    from tfhe_omr_tpu_torch.utils.timing import card_ms, median_ms

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"mac_probe_torch: {err}")
    spec = spec_rates(device) if device.type == "cuda" else {}
    rates = spec.get("ops_per_s")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({"device": name}), flush=True)
    rng = np.random.default_rng(0)

    shape, iters = ((8, 128), 3) if args.tiny else ((256, 1024), 8192)
    xf = torch.as_tensor(rng.uniform(0.5, 1.0, size=shape).astype(np.float32), device=device)
    yf = torch.as_tensor(rng.uniform(0.9, 1.1, size=shape).astype(np.float32), device=device)
    for streams in (1, 4):
        ms = card_ms(lambda: probe_chain(xf, yf, "fma", iters, streams), device)
        steps = xf.numel() * iters * streams
        print(json.dumps(rate_record(f"f32_fma_s{streams}", 2 * steps, ms, "gfma/s", device,
                                     rates, step_work(torch.float32, "fma", steps),
                                     12 * xf.numel())), flush=True)

    for g, m, k, n, rounds in TINY_BDOTS if args.tiny else BDOTS:
        a = torch.as_tensor(rng.integers(-64, 64, size=(g, m, k), dtype=np.int8), device=device)
        b = torch.as_tensor(rng.integers(-64, 64, size=(g, k, n), dtype=np.int8), device=device)
        work = g * m * k * n * rounds
        ms = median_ms(lambda: probe_i8dot(a, b, rounds), device)
        dot_bytes = g * (m * k + k * n + 4 * m * n)
        print(json.dumps(rate_record(f"bdot_{g}x{m}x{k}x{n}", work, ms, "gmac/s",
                                     device, rates, dot_work(g, m, k, n, rounds),
                                     dot_bytes)), flush=True)
        af, bf = a.float(), b.float()
        ms = median_ms(lambda: library_i8dot(af, bf, rounds), device)
        print(json.dumps({"library": "float32 torch.bmm a round", **rate_record(
            f"torch_bdot_{g}x{m}x{k}x{n}", work, ms, "gmac/s", device)}), flush=True)
        for layout, ms in library_int_mm_ms(a, b, rounds).items():
            print(json.dumps({"library": f"torch._int_mm, a loop of {g} x {rounds} calls "
                              f"(a CUDA graph on a card), {layout}",
                              **rate_record(f"torch_int_mm_bdot_{g}x{m}x{k}x{n}_{layout}",
                                            work, ms, "gmac/s", device)}), flush=True)

    for m, k, n, rounds in TINY_DOT2D if args.tiny else DOT2D:
        a = torch.as_tensor(rng.integers(-64, 64, size=(m, k), dtype=np.int8), device=device)
        b = torch.as_tensor(rng.integers(-64, 64, size=(k, n), dtype=np.int8), device=device)
        ms = median_ms(lambda: probe_i8dot(a, b, rounds), device)
        print(json.dumps(rate_record(f"dot2d_{m}x{k}x{n}", m * k * n * rounds, ms,
                                     "gmac/s", device, rates, dot_work(1, m, k, n, rounds),
                                     m * k + k * n + 4 * m * n)), flush=True)
        for layout, ms in library_int_mm_ms(a, b, rounds).items():
            print(json.dumps({"library": f"torch._int_mm, {rounds} calls (a CUDA graph "
                              f"on a card), {layout}", **rate_record(
                                  f"torch_int_mm_dot2d_{m}x{k}x{n}_{layout}",
                                  m * k * n * rounds, ms, "gmac/s", device)}), flush=True)
    print(json.dumps({"card": card_line() if device.type == "cuda" else "cpu", **spec}))


if __name__ == "__main__":
    main()
