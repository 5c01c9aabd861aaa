"""Oblivious message detection check on the PyTorch / CUDA port.

The counterpart of examples/omd.py for ``tfhe_omr_tpu_torch``: generate two
recipients' keys, clues for two messages under the first and the rest of
the batch under the second, detect the whole batch, decrypt,
and check ``[1, 0, ..., 0]`` for each pertinent message and zeros for the
others.

Usage:
    python examples/omd_torch.py --batch 1024         # on the card, the kernels
    python examples/omd_torch.py --tiny --device cpu  # plain torch on the host

The card is the default; with no card and no ``--device cpu`` the script
exits non-zero and says so.

On a CUDA device every step runs there: key generation, detection (the
hand-written kernels) and decryption.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass

import numpy as np


@dataclass
class OmdRun:
    """What one oracle run produced and how long each part took (seconds;
    every part ends in a device synchronisation)."""

    params: object
    skp: object
    detector: object
    clues: object
    result: object  # (B, 2, N2) torch tensor on the device
    decoded: np.ndarray
    pertinent: int
    keygen_s: float
    clues_s: float
    detect_s: float
    decrypt_s: float


def run_omd(params, batch: int = 4, pertinent: int = 2, seed: int = 3,
            device=None) -> OmdRun:
    """Keygen, clues, detect and decrypt; raises AssertionError unless the
    decrypted pertinency vectors are [1, 0, ..., 0] for the first
    ``pertinent`` messages and all zeros for the rest. Runs on the card
    unless ``device="cpu"``; with no card it raises."""
    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
    from tfhe_omr_tpu_torch.core.sender import ClueBatch
    from tfhe_omr_tpu_torch.utils.timing import synchronize

    if not 0 < pertinent <= batch:
        raise ValueError(f"need 0 < pertinent <= batch, got {pertinent}, {batch}")
    ctx = OmrContext(params, device)
    t0 = time.perf_counter()
    skp = SecretKeyPack(params, rng=seed, ctx=ctx)
    skp2 = SecretKeyPack(params, rng=seed + 1, ctx=ctx)
    sender = skp.generate_sender()
    sender2 = skp2.generate_sender()
    detector = skp.generate_detector()
    synchronize(ctx.device)
    t1 = time.perf_counter()
    rng = np.random.default_rng(seed + 2)
    parts = [sender.gen_clues(pertinent, rng)]
    if batch > pertinent:
        parts.append(sender2.gen_clues(batch - pertinent, rng))
    clues = ClueBatch.concat(parts)
    t2 = time.perf_counter()
    result = detector.detect(clues)
    synchronize(ctx.device)
    t3 = time.perf_counter()
    dec = skp.decrypt_rlwe2_ntt(result)
    t4 = time.perf_counter()
    q, t = params.q2, params.output_plain_modulus
    decoded = np.mod((dec * (2 * t) + q) // (2 * q), t)
    bad_pert = [i for i in range(pertinent)
                if decoded[i, 0] != 1 or decoded[i, 1:].any()]
    bad_other = np.nonzero(decoded[pertinent:].any(axis=1))[0] + pertinent
    assert not bad_pert, f"pertinent messages not [1,0,...,0]: {bad_pert}"
    assert not len(bad_other), f"non-pertinent messages not zero: {bad_other.tolist()}"
    return OmdRun(params, skp, detector, clues, result, decoded, pertinent,
                  t1 - t0, t2 - t1, t3 - t2, t4 - t3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true", help="the small test preset")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    ap.add_argument("--batch", type=int, default=4, help="messages per detect")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.utils.build import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"omd_torch: {err}")
    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    run = run_omd(params, batch=args.batch, pertinent=min(2, args.batch),
                  seed=args.seed, device=device)
    print(f"keygen {run.keygen_s:.3f}s clues {run.clues_s:.3f}s "
          f"detect {run.detect_s:.3f}s (first call) decrypt {run.decrypt_s:.3f}s "
          f"on {device}")
    print(f"omd check passed: [1,0,...,0] for {run.pertinent} pertinent, "
          f"zeros for {args.batch - run.pertinent} others")


if __name__ == "__main__":
    main()
