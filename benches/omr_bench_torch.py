"""OMR operation micro-benchmarks on the PyTorch / CUDA port.

The counterpart of benches/omr_bench.py for ``tfhe_omr_tpu_torch``
(reference ``omr_core/benches/omr.rs``: clue generation :23-25, detect
:29-31, encode_pertinent_indices :72-79, decode_pertinent_indices :83-89).
Prints one JSON object; every device time is the best of ``--reps``
synchronised runs after one warm call.

Usage: python benches/omr_bench_torch.py [--batch 128] [--tiny] [--device cpu] [--reps 3]

The card is the default; with no card and no ``--device cpu`` the script
exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiny", action="store_true", help="the small test preset")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    args = ap.parse_args()

    from two_level_bs_torch import best_seconds, device_name

    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.utils.build import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"omr_bench_torch: {err}")
    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    skp = SecretKeyPack(params, rng=0, ctx=OmrContext(params, device))
    sender = skp.generate_sender()
    detector = skp.generate_detector()
    rng = np.random.default_rng(1)
    bsz = args.batch
    results = {"batch": bsz}

    # clue generation (host numpy, as a client makes them)
    t0 = time.perf_counter()
    clues = sender.gen_clues(bsz, rng)
    results["gen_clues_ms"] = 1e3 * (time.perf_counter() - t0) / bsz

    t = best_seconds(lambda: detector.detect(clues), args.reps, device)
    results["detect_ms"] = 1e3 * t / bsz
    results["detect_msgs_per_sec"] = bsz / t

    out, st = detector.detect_with_time_info(clues)
    results["stage_first_level_ms"] = 1e3 * st.first_level_bootstrapping_time / bsz
    results["stage_second_level_ms"] = 1e3 * st.second_level_bootstrapping_time / bsz
    results["stage_trace_ms"] = 1e3 * st.trace_time / bsz

    # encode / decode pertinent indices
    retr = skp.generate_retriever(bsz, min(bsz, 8 if args.tiny else 50)).warm()
    rp = retr.params
    t = best_seconds(lambda: detector.encode_pertinent_indices(rp, out, rng),
                     args.reps, device)
    results["encode_indices_ms_per_ct"] = 1e3 * t
    ct = detector.encode_pertinent_indices(rp, out, rng)

    def decode():
        retr.pertinent_indices_set.clear()
        retr.decode_pertinent_indices(ct)

    results["decode_indices_ms_per_ct"] = 1e3 * best_seconds(decode, args.reps, device)
    results["device"] = device_name(device)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
