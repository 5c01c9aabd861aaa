"""Prove that the false-positive rate probe's accept predicate IS the port's
detector's.

The counterpart of benches/fp_criterion_probe.py for ``tfhe_omr_tpu_torch``.
Crafts compact clue ciphertexts with CONTROLLED phases (b_i = a . W_i +
delta_i, so clue i decrypts to exactly delta_i), runs them through the
port's real ``Detector.detect`` (two-level blind rotation + trace) and holds
the decrypted pertinency bit against the analytic criterion of
benches/fp_rate_probe_torch.py:

    accept(delta) == all_i round_half_up(delta_i * t / q0) mod t == 0
                  == all_i delta_i in [0, q0/2t) U [q0 - q0/2t, q0)

Sweeps the phase values at clue position 0 (all q0 of them; every
``--stride``-th plus the window's boundaries when a stride is given) and
the window's boundaries at every other position, with noise-free keys, so
the decision is deterministic (the LUT window map is independent of key and
noise, ``detector.rs:457-503``). Prints one JSON object; exits 0 only with
zero mismatches.

Usage: python benches/fp_criterion_probe_torch.py
       python benches/fp_criterion_probe_torch.py --tiny --device cpu --stride 64

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

BATCH = 1024  # messages per detect call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stride", type=int, default=1,
                    help="sweep every stride-th phase at position 0")
    ap.add_argument("--tiny", action="store_true", help="the small test preset")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    args = ap.parse_args()

    import torch
    from fp_rate_probe_torch import extraction_weights

    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.core.sender import ClueBatch
    from tfhe_omr_tpu_torch.utils.build import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"fp_criterion_probe_torch: {err}")
    params = (OmrParameters.tiny if args.tiny else OmrParameters.default)(noise_free=True)
    cp = params.clue_params
    q0, t, c, n = cp.cipher_modulus, cp.plain_modulus, params.clue_count, cp.dimension
    half_win = q0 // (2 * t)

    t0 = time.perf_counter()
    skp = SecretKeyPack(params, rng=11, ctx=OmrContext(params, device))
    detector = skp.generate_detector()
    w = extraction_weights(skp)
    keygen_s = time.perf_counter() - t0

    boundary = [0, half_win - 1, half_win, half_win + 1,
                q0 - half_win - 1, q0 - half_win, q0 - 1]
    cases = [(0, v) for v in sorted({*range(0, q0, args.stride), *boundary})]
    for pos in range(1, c):
        cases += [(pos, v) for v in boundary]

    rng = np.random.default_rng(13)
    a = rng.integers(0, q0, size=(len(cases), n), dtype=np.int64)
    b7 = np.mod(a @ w, q0)  # phase 0 everywhere
    for m, (pos, v) in enumerate(cases):
        b7[m, pos] = (b7[m, pos] + v) % q0

    q2, tp = params.q2, params.output_plain_modulus
    accepts = np.zeros(len(cases), dtype=bool)
    t0 = time.perf_counter()
    for s in range(0, len(cases), BATCH):  # a ragged last batch is masked
        e = s + BATCH
        dec = skp.decrypt_rlwe2_ntt(detector.detect(ClueBatch(a[s:e], b7[s:e])))
        decoded = np.mod((dec * (2 * tp) + q2) // (2 * q2), tp)
        assert not decoded[:, 1:].any()  # the trace clears every other slot
        accepts[s:e] = decoded[:, 0] == 1
    wall = time.perf_counter() - t0

    mismatches = []
    for (pos, v), got in zip(cases, accepts):
        predicted = v < half_win or v >= q0 - half_win
        if bool(got) != predicted:
            mismatches.append({"position": pos, "delta": int(v),
                               "detector": bool(got), "criterion": predicted})
    print(json.dumps({
        "cases": len(cases),
        "sweep_position0": sum(1 for pos, _v in cases if pos == 0),
        "boundary_positions": list(range(1, c)),
        "accept_window": [0, half_win - 1, q0 - half_win, q0 - 1],
        "mismatches": mismatches,
        "mismatch_count": len(mismatches),
        "keygen_s": round(keygen_s, 1),
        "detect_wall_s": round(wall, 1),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }), flush=True)
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
