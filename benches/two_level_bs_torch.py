"""Per-stage bootstrap micro-benchmarks on the PyTorch / CUDA port.

The counterpart of benches/two_level_bs.py for ``tfhe_omr_tpu_torch``
(reference ``omr_core/benches/two_level_bs.rs``: first-level blind rotation
:47-53, key switch :62-73, second-level blind rotation :124-130, trace
:143-145). Each stage runs alone on random inputs under a real detection
key, through the entry points the Detector uses: on a card the CUDA
kernels, on the CPU their plain torch versions.

Prints one JSON object with per-message amortised times (the best of
``--reps`` synchronised runs after one warm call).

Usage: python benches/two_level_bs_torch.py [--batch 64] [--tiny] [--device cpu] [--reps 3]

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


def best_seconds(fn, reps: int, device) -> float:
    """The least synchronised wall time of ``reps`` calls after one warm
    call."""
    from tfhe_omr_tpu_torch.utils.timing import synchronize

    fn()
    synchronize(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return min(times)


def device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiny", action="store_true", help="the small test preset")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    args = ap.parse_args()

    import torch

    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.ops.bootstrap import init_accumulator
    from tfhe_omr_tpu_torch.ops.fused import blind_rotate, trace
    from tfhe_omr_tpu_torch.utils.build import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"two_level_bs_torch: {err}")
    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    det = SecretKeyPack(params, rng=0, ctx=OmrContext(params, device)).generate_detector()
    gen = torch.Generator(device=device).manual_seed(1)
    bsz = args.batch

    def uniform(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=device)

    results = {}
    # first-level blind rotation (one clue sample per message)
    n0, q0 = params.clue_params.dimension, params.clue_params.cipher_modulus
    a1, b1 = uniform(q0, (n0, bsz)), uniform(q0, (bsz,))
    t = best_seconds(lambda: blind_rotate(
        init_accumulator(det.lut1, b1, params.n1).permute(2, 1, 0), a1, det.br1),
        args.reps, device)
    results["first_level_blind_rotation_ms"] = 1e3 * t / bsz

    # key switch (N1 -> the intermediate LWE dimension)
    av, bv = uniform(params.q1, (bsz, params.n1)), uniform(params.q1, (bsz,))
    t = best_seconds(lambda: det.keyswitch(av, bv, det.ksk_f64), args.reps, device)
    results["key_switch_ms"] = 1e3 * t / bsz

    # second-level blind rotation
    n_int = params.intermediate_lwe.dimension
    qi = params.intermediate_lwe.cipher_modulus
    a2, b2 = uniform(qi, (n_int, bsz)), uniform(qi, (bsz,))
    t = best_seconds(lambda: blind_rotate(
        init_accumulator(det.lut2, b2, params.n2).permute(2, 1, 0), a2, det.br2),
        args.reps, device)
    results["second_level_blind_rotation_ms"] = 1e3 * t / bsz

    # homomorphic trace
    acc2 = uniform(params.q2, (bsz, 2, params.n2))
    t = best_seconds(lambda: trace(acc2, det.tr), args.reps, device)
    results["trace_ms"] = 1e3 * t / bsz

    results["batch"] = bsz
    results["device"] = device_name(device)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
