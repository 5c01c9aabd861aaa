"""Client-decode microbench on the PyTorch / CUDA port.

The counterpart of benches/decode_bench.py for ``tfhe_omr_tpu_torch``: the
Retriever's path stage by stage at the reference's flagship scale
(D = 65536, k = 50) on random digests: index-ct decrypt + bucket scan,
payload-ct decrypts, and the k x k solve mod 257 (reference
``omr_core/benches/omr.rs:83-89``; its decode takes 305.53 ms on the
authors' AVX-512 machine, ``README.md:125``). The decrypts run on
``--device`` (the q2 NTT kernel on a card), the scan and the solve in the
native library on the host.

Usage: python benches/decode_bench_torch.py [--tiny] [--device cpu] [--reps 10]

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

import numpy as np


def mean_seconds(fn, reps: int) -> float:
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="the small test preset (D = 64, k = 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch

    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.matrix import solve_matrix, solve_matrix_numpy
    from tfhe_omr_tpu_torch.core.params import OmrParameters, RetrievalParams
    from tfhe_omr_tpu_torch.core.retriever import Retriever
    from tfhe_omr_tpu_torch.utils.build import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"decode_bench_torch: {err}")
    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    ctx = OmrContext(params, device)
    rp = RetrievalParams.for_params(params, *((64, 8) if args.tiny else (65536, 50)))
    rng = np.random.default_rng(0)
    q2 = ctx.f2.q

    def uniform(high, shape):
        return rng.integers(0, high, size=shape, dtype=np.int64)

    retr = Retriever(rp, ctx, torch.as_tensor(uniform(q2, (params.n2,)), device=device))
    t0 = time.perf_counter()
    retr.warm()
    warm_s = time.perf_counter() - t0

    idx_ct = torch.as_tensor(uniform(q2, (2, params.n2)), device=device)
    pay_cts = torch.as_tensor(uniform(q2, (rp.cmb_cipher_count, 2, params.n2)),
                              device=device)
    p = int(rp.index_modulus)
    m = uniform(p, (rp.combination_count, rp.pertinent_count))
    rhs = uniform(p, (rp.combination_count, rp.payload_length))

    def ms(fn):
        return round(1e3 * mean_seconds(fn, args.reps), 3)

    res = {
        "warm_setup_s": round(warm_s, 3),
        "index_decode_ms": ms(lambda: retr.decode_pertinent_indices(idx_ct)),
        "payload_decrypt_ms": ms(lambda: retr.decode_combined_payloads(pay_cts)),
        "solve_native_ms": ms(lambda: solve_matrix(m, rhs, p)),
        "solve_numpy_ms": ms(lambda: solve_matrix_numpy(m, rhs, p)),
        "ref_decode_ms": 305.53,
    }
    res["decode_total_ms"] = round(
        res["index_decode_ms"] + res["payload_decrypt_ms"] + res["solve_native_ms"], 3)
    res["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(res))


if __name__ == "__main__":
    main()
