"""Benchmark of the PyTorch / CUDA port: batched detect throughput on one
card at the reference parameters.

The port's counterpart of bench.py. The first line of standard output is

  {"metric": "detect_throughput_per_chip", "value": N, "unit": "msg/s",
   "vs_baseline": N}

against the reference's single-core detect throughput, 4.27 msg/s
(234.073 ms/msg at D = 65536, BASELINE.md). A second JSON object with the
detail goes to standard error: the batch, the streaming seconds per batch
(several ``detect`` calls back to back, one synchronisation at the end), the
stage split of one separately timed run, key generation, the kernels' build,
``Detector.warm`` (``warm_seconds``) and the first detect after it
(``first_call_seconds``), and the digest side at D = ``OMR_BENCH_D`` on a random
pertinency stack (the encoders' work does not depend on the values), after
``Detector.warm_encoders``: the 5
redundant index digests streamed with one synchronisation, the payload
encoder as the median of 3, and the recipient's decode.

Environment: OMR_BENCH_BATCH (1024), OMR_BENCH_REPS (3), OMR_BENCH_D
(65536; 0 skips the digest side).

Usage: python bench_torch.py                      # the card
       python bench_torch.py --tiny --device cpu  # plain torch, small preset

The card is the default; with no card and no ``--device cpu`` the script
exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_MSGS_PER_SEC = 4.27  # the reference on one CPU core (BASELINE.md)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bench_digest(skp, detector, d_scale: int, pertinent: int, device) -> dict:
    """Both encoders and the decode at D = ``d_scale`` on random residues."""
    import torch

    from tfhe_omr_tpu_torch.core.matrix import solve_matrix
    from tfhe_omr_tpu_torch.utils.timing import synchronize

    retr = skp.generate_retriever(d_scale, pertinent).warm()
    rp = retr.params
    q2 = skp.ctx.f2.q
    gen = torch.Generator(device=device).manual_seed(0)
    pert = torch.randint(0, q2, (d_scale, 2, rp.polynomial_size), generator=gen,
                         device=device)
    warm = detector.warm_encoders(rp, d_scale)
    enc_rng = np.random.default_rng(7)
    n_idx = rp.max_encode_indices_cipher_count
    t0 = time.perf_counter()
    cts = [detector.encode_pertinent_indices(rp, pert, enc_rng) for _ in range(n_idx)]
    synchronize(device)
    idx_total_s = time.perf_counter() - t0

    payloads = enc_rng.integers(0, 256, size=(d_scale, rp.payload_length))
    pay_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        pay_cts = detector.encode_pertinent_payloads(rp, pert, payloads, 9)
        synchronize(device)
        pay_runs.append(time.perf_counter() - t0)

    # the decode's stages on these digests: one index-ct scan, every payload
    # ct's decrypt and one k x k solve (random digests decode to nothing; the
    # work per stage is the same)
    p = int(rp.index_modulus)
    sm = enc_rng.integers(0, p, size=(rp.combination_count, rp.pertinent_count))
    srhs = enc_rng.integers(0, p, size=(rp.combination_count, rp.payload_length))
    retr.decode_pertinent_indices(cts[-1])  # warm
    t0 = time.perf_counter()
    retr.decode_pertinent_indices(cts[0])
    retr.decode_combined_payloads(pay_cts)
    solve_matrix(sm, srhs, p)
    decode_s = time.perf_counter() - t0
    return {
        "digest_d": d_scale,
        "warm_encoders": warm,
        "index_cts": n_idx,
        "payload_cts": int(rp.cmb_cipher_count),
        "encode_indices_s_per_ct": idx_total_s / n_idx,
        "encode_indices_total_s": idx_total_s,
        "encode_payloads_s": sorted(pay_runs)[1],
        "encode_payloads_runs_s": pay_runs,
        "decode_s": decode_s,
        # the Rust reference on its authors' machine (README.md:122-125)
        "ref_baseline_s": {"encode_indices_total": 3.482,
                           "encode_payloads": 24.26, "decode": 0.30553},
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="the small test preset (batch 4, D = 64 unless the "
                         "environment says otherwise)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    args = ap.parse_args()
    batch = int(os.environ.get("OMR_BENCH_BATCH", "4" if args.tiny else "1024"))
    reps = int(os.environ.get("OMR_BENCH_REPS", "3"))
    d_scale = int(os.environ.get("OMR_BENCH_D", "64" if args.tiny else "65536"))

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.utils import build
    from tfhe_omr_tpu_torch.utils.timing import synchronize

    try:
        device = build.resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"bench_torch: {err}")
    on_card = device.type == "cuda"
    build_s = 0.0
    if on_card:
        t0 = time.perf_counter()
        build.library()  # nvcc, unless an earlier process left the library
        build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    skp = SecretKeyPack(params, rng=0, ctx=OmrContext(params, device))
    detector = skp.generate_detector()
    sender = skp.generate_sender()
    synchronize(device)
    keygen_s = time.perf_counter() - t0
    clues = sender.gen_clues(batch, np.random.default_rng(1))

    t0 = time.perf_counter()
    warm = detector.warm(batch)  # the library, allocator and first launches
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    detector.detect(clues)  # the first detect after the warm one
    synchronize(device)
    first_call_s = time.perf_counter() - t0

    # throughput: `reps` detect calls back to back, one synchronisation at
    # the end (a server feeds the next batch while this one runs)
    t0 = time.perf_counter()
    for _ in range(reps):
        detector.detect(clues)
    synchronize(device)
    per_batch_s = (time.perf_counter() - t0) / reps
    msgs_per_sec = batch / per_batch_s
    # the stage split of one separately timed run (a synchronisation a stage)
    _out, stages = detector.detect_with_time_info(clues)

    digest = {}
    if d_scale:
        digest = bench_digest(skp, detector, d_scale,
                              min(d_scale, 8 if args.tiny else 50), device)

    print(json.dumps({
        "metric": "detect_throughput_per_chip",
        "value": round(msgs_per_sec, 3),
        "unit": "msg/s",
        "vs_baseline": round(msgs_per_sec / BASELINE_MSGS_PER_SEC, 3),
    }), flush=True)
    print(json.dumps({"detail": {
        "batch": batch,
        "reps": reps,
        "batch_seconds_streaming": per_batch_s,
        "ms_per_message": 1e3 * per_batch_s / batch,
        "stage_ms_per_message": {
            "first_level": 1e3 * stages.first_level_bootstrapping_time / batch,
            "second_level": 1e3 * stages.second_level_bootstrapping_time / batch,
            "trace": 1e3 * stages.trace_time / batch,
        },
        "keygen_seconds": keygen_s,
        "kernel_build_seconds": build_s,
        "nvcc_seconds": build.build_seconds,
        "warm_seconds": warm_s,
        "warm": warm,
        "first_call_seconds": first_call_s,
        "detection_key_bytes": detector.detect_key_size(),
        "peak_device_memory_bytes": (
            torch.cuda.max_memory_allocated(device) if on_card else None),
        "digest": digest,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "card": card_line() if on_card else None,
    }}), file=sys.stderr)


if __name__ == "__main__":
    main()
