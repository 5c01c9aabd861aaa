"""Timing sweep over payload counts on the PyTorch / CUDA port -> CSV.

The counterpart of examples/omr_time_analyze.py for ``tfhe_omr_tpu_torch``
(reference ``omr_core/examples/omr_time_analyze.rs``): one key generation,
then boards of D = 1, 2, 4, ... up to ``--max-d`` messages through
examples/omr_torch.py's pipeline on ``--device``, per-stage seconds in a
CSV of the same schema, and the decode verified at every point (the true
indices a subset of the decoded ones, byte-exact payloads, every extra a
confirmed protocol false positive).

Usage:
    python examples/omr_time_analyze_torch.py --max-d 4096                  # the card
    python examples/omr_time_analyze_torch.py --tiny --max-d 32 --device cpu

The card is the default; with no card and no ``--device cpu`` the script
exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

log = logging.getLogger("omr_time_analyze_torch")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true", help="the small test preset")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    ap.add_argument("--max-d", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1024,
                    help="messages per detect call")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", default="benchmark_torch.csv")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    sys.path.insert(0, here)
    from omr_torch import make_keys, run_board

    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.utils import build
    from tfhe_omr_tpu_torch.utils.timing import write_csv

    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    try:
        device = build.resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"omr_time_analyze_torch: {err}")
    keys = make_keys(params, args.seed, device)
    rng = np.random.default_rng(None if args.seed is None else args.seed + 2)
    records = []
    d = 1
    while d <= args.max_d:
        run = run_board(keys, d, min(d, 8 if args.tiny else 50), rng, args.batch)
        if not run.ok:
            raise AssertionError(
                f"D={d}: decode failed (true {run.true_indices}, decoded "
                f"{run.indices}, byte_exact {run.payload_ok}, extras "
                f"{run.fp_events})")
        rec = run.rec
        rec.total_time = (
            rec.gen_clues_time + rec.detect_time + rec.encode_indices_time
            + rec.encode_payloads_time + rec.decode_time
        )
        log.info("D=%d: detect %.3fs (%.2f ms/msg) encode %.3fs+%.3fs "
                 "decode %.3fs", d, rec.detect_time,
                 1e3 * rec.detect_time_per_message, rec.encode_indices_time,
                 rec.encode_payloads_time, rec.decode_time)
        records.append(rec)
        d *= 2
    write_csv(args.out, records)
    log.info("wrote %s (%d records)", args.out, len(records))


if __name__ == "__main__":
    main()
