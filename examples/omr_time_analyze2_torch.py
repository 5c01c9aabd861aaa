"""Timing sweep of the digest encoders and the decode only, on the PyTorch /
CUDA port -> CSV.

The counterpart of examples/omr_time_analyze2.py for ``tfhe_omr_tpu_torch``
(reference ``omr_core/examples/omr_time_analyze2.rs``): one key generation
and ONE detect over ``--max-d`` messages outside the sweep, then for
D = 1, 2, 4, ... the first D pertinency ciphertexts go through both digest
encoders and the recipient's decode, each stage synchronised
(``omr_time_analyze2.rs:81-117``). Every point is verified: the true indices
are a subset of the decoded ones and every decoded payload is byte-exact.
Writes ``benchmark_compress_and_retrieve_torch.csv``.

Usage:
    python examples/omr_time_analyze2_torch.py --max-d 4096                  # the card
    python examples/omr_time_analyze2_torch.py --tiny --max-d 32 --device cpu

The card is the default; with no card and no ``--device cpu`` the script
exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

log = logging.getLogger("omr_time_analyze2_torch")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true", help="the small test preset")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    ap.add_argument("--max-d", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1024,
                    help="messages per detect call")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", default="benchmark_compress_and_retrieve_torch.csv")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    sys.path.insert(0, here)
    import torch
    from omr_torch import make_keys

    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.core.payload import random_payloads
    from tfhe_omr_tpu_torch.core.sender import ClueBatch
    from tfhe_omr_tpu_torch.utils import build
    from tfhe_omr_tpu_torch.utils.timing import StageTimer, TimingRecord, write_csv

    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    try:
        device = build.resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"omr_time_analyze2_torch: {err}")
    keys = make_keys(params, args.seed, device)
    detector = keys.detector
    rng = np.random.default_rng(None if args.seed is None else args.seed + 2)

    # detect once at the largest D; every point reads a prefix of the stack
    d_max = args.max_d
    pertinent = np.zeros(d_max, dtype=bool)
    pertinent[:min(d_max, 8 if args.tiny else 50)] = True
    rng.shuffle(pertinent)
    own = keys.sender.gen_clues(int(pertinent.sum()), rng)
    other = keys.sender2.gen_clues(int((~pertinent).sum()), rng)
    a = np.zeros((d_max, own.a.shape[1]), dtype=np.int64)
    b7 = np.zeros((d_max, own.b7.shape[1]), dtype=np.int64)
    a[pertinent], b7[pertinent] = own.a, own.b7
    a[~pertinent], b7[~pertinent] = other.a, other.b7
    payloads_all = random_payloads(rng, d_max, params.payload_length)
    log.info("detecting %d messages once (outside the sweep)...", d_max)
    pv_all = torch.cat([
        detector.detect(ClueBatch(a[s:s + args.batch], b7[s:s + args.batch]))
        for s in range(0, d_max, args.batch)])

    records = []
    d = 1
    while d <= d_max:
        true_indices = np.nonzero(pertinent[:d])[0].tolist()
        if not true_indices:
            d *= 2
            continue
        rec = TimingRecord(device_count=1, payload_count=d)
        retriever = keys.skp.generate_retriever(d, len(true_indices)).warm()
        rp = retriever.params
        pv, payloads = pv_all[:d], payloads_all[:d]
        timer = StageTimer(device)
        index_cts = timer.time("indices", lambda: [
            detector.encode_pertinent_indices(rp, pv, rng)
            for _ in range(rp.max_encode_indices_cipher_count)])
        seed = int(rng.integers(0, 2**63))
        payload_cts = timer.time("payloads", detector.encode_pertinent_payloads,
                                 rp, pv, payloads, seed)
        t0 = time.perf_counter()
        indices, solved = retriever.decode_digest(index_cts, payload_cts, seed)
        rec.decode_time = time.perf_counter() - t0
        rec.encode_indices_time = timer.stages["indices"]
        rec.encode_payloads_time = timer.stages["payloads"]

        assert set(true_indices) <= set(indices), (d, indices, true_indices)
        assert np.array_equal(solved, payloads[indices]), d
        rec.total_time = (
            rec.encode_indices_time + rec.encode_payloads_time + rec.decode_time
        )
        log.info("D=%d: encode %.3fs+%.3fs decode %.3fs", d,
                 rec.encode_indices_time, rec.encode_payloads_time,
                 rec.decode_time)
        records.append(rec)
        d *= 2

    write_csv(args.out, records)
    log.info("wrote %s (%d records)", args.out, len(records))


if __name__ == "__main__":
    main()
