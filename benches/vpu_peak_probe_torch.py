"""The sustained int32 ALU rate on the PyTorch / CUDA port.

The counterpart of benches/vpu_peak_probe.py: int32 mutual-recurrence
chains (``a2 = a op b; b2 = b + a2``, op mul or add, 2 ops an element an
iteration) and the MAC shape ``acc_s += (v_s + i) * k_s`` (counted as 3
ops: the add, the multiply and the +i), each over a shape sweep (8, 512),
(64, 512), (256, 1024) and 1, 4, 16 independent streams, with loop counts
that keep about ``--target-ops`` operations in one call. The state lives in
registers (``csrc/probes.cu`` probe_chain, probe_mac; probe_chain splits an
element's streams over adjacent threads where the elements alone do not
fill the card). On a card each time is the card's, from CUDA graphs of 10
calls (utils/timing.py card_ms); (8, 512) is 4096 elements on the card's
SMs, so its low rate is the finding.

Usage: python benches/vpu_peak_probe_torch.py [--quick] [--target-ops 4e10]
       python benches/vpu_peak_probe_torch.py --tiny --device cpu   # plain torch

Prints one JSON line per point (on a card with its bound and the share of
it reached, ``tfhe_omr_tpu_torch/utils/rates.py``), then the peak with the
card's name, power limit and spec rates. The card is the default; with no card and no ``--device cpu`` the
script exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--target-ops", type=float, default=4e10,
                    help="operations of one call")
    ap.add_argument("--tiny", action="store_true", help="small shapes and loops")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    args = ap.parse_args()

    import torch

    from bench_torch import card_line
    from tfhe_omr_tpu_torch.ops.probes import probe_chain, probe_mac
    from tfhe_omr_tpu_torch.utils.build import resolve_device
    from tfhe_omr_tpu_torch.utils.rates import rate_record, spec_rates, step_work
    from tfhe_omr_tpu_torch.utils.timing import card_ms

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"vpu_peak_probe_torch: {err}")
    spec = spec_rates(device) if device.type == "cuda" else {}
    shapes = [(8, 512), (64, 512), (256, 1024)]
    streams_l = [1, 4, 16]
    if args.quick:
        shapes, streams_l = [(64, 512), (256, 1024)], [4, 16]
    if args.tiny:
        shapes, streams_l = [(8, 128)], [1, 4]
    rng = np.random.default_rng(0)
    results = {}
    for shape in shapes:
        elems = shape[0] * shape[1]
        x = torch.as_tensor(rng.integers(1, 1 << 20, size=shape, dtype=np.int32),
                            device=device)
        y = torch.as_tensor(rng.integers(1, 1 << 10, size=shape, dtype=np.int32),
                            device=device)
        for streams in streams_l:
            iters = 3 if args.tiny else max(256, int(args.target_ops / (2 * streams * elems)))
            points = [(f"chain_{op}_{shape[0]}x{shape[1]}_s{streams}", 2, chain_op,
                       lambda op=chain_op: probe_chain(x, y, op, iters, streams))
                      for op, chain_op in (("mul", "mul_add"), ("add", "add"))]
            points.append((f"mac_{shape[0]}x{shape[1]}_s{streams}", 3, "mac",
                           lambda: probe_mac(x, y, iters, streams)))
            for label, per_iter, op, fn in points:
                ms = card_ms(fn, device)
                steps = elems * iters * streams
                rec = rate_record(label, steps * per_iter, ms, "gops", device,
                                  spec.get("ops_per_s"), step_work(torch.int32, op, steps),
                                  12 * elems)
                results[label] = rec["gops"]
                print(json.dumps(rec), flush=True)
    print(json.dumps({"peak_gops": max(results.values()),
                      "peak_variant": max(results, key=results.get),
                      "card": card_line() if device.type == "cuda" else "cpu",
                      **spec}))


if __name__ == "__main__":
    main()
