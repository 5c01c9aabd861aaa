"""C1 (probe_chain) with an element's streams split over 1, 2, ..., S threads.

Where the elements alone give the card few threads, ``csrc/probes.cu``
chain_plan splits each element's S streams over adjacent threads. This
bench times every split the plan could make at the shapes where it has a
choice: P8's (64, 512) with S = 4 (the int32 and int64 multiply chains and
mulhi_add, benches/mosaic_unsupported_probe.py), P3's smallest shape
(8, 512) with S = 16 and S = 4 (benches/vpu_peak_probe.py) and (64, 512)
with S = 16. Each split is launched as it is (ops/probes.py
probe_chain_split; the plan splits while n x split is below SMs x 128
threads a 32-bit word of a stream). Each point is first
held bit-equal to the plain version at 70 iterations, then timed from a CUDA
graph of 10 calls (utils/timing.py card_ms) against its bound
(utils/rates.py).

Usage: python benches/chain_plan_torch.py
       python benches/chain_plan_torch.py --tiny --device cpu   # plain torch

Prints one JSON line a point ({"variant", "split", "per_thread", "plan":
true where the plan picks it on this card, "ms", "bound_ms",
"share_of_bound", "device"}; on the CPU one line a case, the plain version),
then the card's name, power limit and spec rates. The card is the default;
with no card and no ``--device cpu`` the script exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# (label, shape, dtype name, op, iterations, streams)
CASES = (
    ("p8_i32_mul_add", (64, 512), "int32", "mul_add", 4096, 4),
    ("p8_i64_mul_add", (64, 512), "int64", "mul_add", 4096, 4),
    ("p8_i32_mulhi_add", (64, 512), "int32", "mulhi_add", 4096, 4),
    ("p3_8x512_mul_add_s16", (8, 512), "int32", "mul_add", 4768, 16),
    ("p3_8x512_mulhi_add_s4", (8, 512), "int32", "mulhi_add", 4768, 4),
    ("64x512_mulhi_add_s16", (64, 512), "int32", "mulhi_add", 1024, 16),
)
CHECK_ITERS = 70  # one 64-step turn of the unrolled loop and some of its rest


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true", help="small shapes and loops")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    args = ap.parse_args()

    import torch

    from bench_torch import card_line
    from tfhe_omr_tpu_torch.ops.probes import chain_plan, probe_chain_plain, probe_chain_split
    from tfhe_omr_tpu_torch.utils.build import resolve_device
    from tfhe_omr_tpu_torch.utils.rates import rate_record, spec_rates, step_work
    from tfhe_omr_tpu_torch.utils.timing import card_ms

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"chain_plan_torch: {err}")
    spec = spec_rates(device) if device.type == "cuda" else {}
    sms = spec.get("sms", 0)
    rng = np.random.default_rng(0)
    for label, shape, dname, op, iters, streams in CASES:
        dtype = getattr(torch, dname)
        if args.tiny:
            shape, iters = (2, 64), 3
        x = torch.as_tensor(rng.integers(1, 1 << 20, size=shape), device=device).to(dtype)
        y = torch.as_tensor(rng.integers(1, 1 << 10, size=shape), device=device).to(dtype)
        n, steps = x.numel(), x.numel() * iters * streams
        work = step_work(dtype, op, steps)
        if device.type != "cuda":
            ms = card_ms(lambda: probe_chain_plain(x, y, op, iters, streams), device)
            print(json.dumps({"split": "plain", **rate_record(
                label, 2 * steps, ms, "gops", device)}), flush=True)
            continue
        chosen = chain_plan(n, streams, sms, dtype)["split"]
        split = 1
        while split <= streams:
            got = probe_chain_split(x, y, op, CHECK_ITERS, streams, split)
            if not torch.equal(got, probe_chain_plain(x, y, op, CHECK_ITERS, streams)):
                raise AssertionError(f"{label} split {split}: kernel != plain")
            ms = card_ms(lambda: probe_chain_split(x, y, op, iters, streams, split), device)
            print(json.dumps({"split": split, "per_thread": streams // split,
                              "plan": split == chosen, **rate_record(
                                  label, 2 * steps, ms, "gops", device,
                                  spec["ops_per_s"], work, 3 * n * x.element_size())}),
                  flush=True)
            split *= 2
    print(json.dumps({"card": card_line() if device.type == "cuda" else "cpu", **spec}))


if __name__ == "__main__":
    main()
