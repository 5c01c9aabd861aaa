"""The digest encoders' wall time, phase by phase, on the PyTorch / CUDA port.

The counterpart of benches/encoder_probe.py. At D = ``--d`` messages (65536
by default) of a random pertinency stack on the device (the encoders' work
does not depend on its values), the reference parameters and the D = 65536
digest layout, each phase synchronised:

  warm_encoders   Detector.warm_encoders (one chunk of each encoder, K4)
  idx_1ct         one index digest (Detector.encode_pertinent_indices)
  idx_5ct_stream  the 5 redundant index digests back to back, one sync
  pay_host_prep   the weight stream drawn on the host (payload_weights)
  pay_upload      payloads and weights to the device
  pay_encode      the payload digests from device-resident payloads and
                  weights (Detector.encode_payload_rows)

One JSON line per phase, ``{"phase", "seconds", "runs_s", "device"}``
(``seconds`` the median of ``--reps`` runs after a warm one, where a phase
repeats), then the card's name and power limit.

Usage: python benches/encoder_probe_torch.py [--d 65536] [--reps 3]
       python benches/encoder_probe_torch.py --tiny --device cpu   # plain torch

The card is the default; with no card and no ``--device cpu`` the script
exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, default=65536, help="messages on the board")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiny", action="store_true", help="the small test preset")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    args = ap.parse_args()

    import torch

    from bench_torch import card_line
    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.detector import payload_weights
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.utils.build import resolve_device
    from tfhe_omr_tpu_torch.utils.timing import synchronize

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"encoder_probe_torch: {err}")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    skp = SecretKeyPack(params, rng=0, ctx=OmrContext(params, device))
    detector = skp.generate_detector()
    rp = skp.generate_retriever(args.d, min(args.d, 50)).params
    gen = torch.Generator(device=device).manual_seed(0)
    pert = torch.randint(0, params.q2, (args.d, 2, rp.polynomial_size), generator=gen,
                         device=device)
    rng = np.random.default_rng(7)
    payloads = rng.integers(0, 256, size=(args.d, rp.payload_length))

    def line(phase, runs, **extra):
        print(json.dumps({"phase": phase, "seconds": statistics.median(runs),
                          "runs_s": runs, **extra, "device": name}), flush=True)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        return out, time.perf_counter() - t0

    warm, s = timed(lambda: detector.warm_encoders(rp, args.d))
    line("warm_encoders", [s], warm=warm)

    def stamp(phase, fn, reps=args.reps):
        timed(fn)
        line(phase, [timed(fn)[1] for _ in range(reps)])

    stamp("idx_1ct", lambda: detector.encode_pertinent_indices(rp, pert, rng))
    stamp("idx_5ct_stream", lambda: [detector.encode_pertinent_indices(rp, pert, rng)
                                     for _ in range(rp.max_encode_indices_cipher_count)],
          reps=2)
    weights, s = timed(lambda: payload_weights(rp, 9, args.d))
    line("pay_host_prep", [s])
    (pay_d, w_d), s = timed(lambda: (detector._on_device(payloads),
                                     detector._on_device(weights)))
    line("pay_upload", [s], mb=(payloads.nbytes + weights.nbytes) / 1e6)
    stamp("pay_encode", lambda: detector.encode_payload_rows(rp, pert, pay_d, w_d))
    print(json.dumps({"card": card_line() if device.type == "cuda" else "cpu"}))


if __name__ == "__main__":
    main()
