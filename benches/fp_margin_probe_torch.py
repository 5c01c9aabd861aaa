"""Intermediate-LWE noise margin against the detection false-positive design,
on the PyTorch / CUDA port.

The counterpart of benches/fp_margin_probe.py for ``tfhe_omr_tpu_torch``.
The protocol's designed per-message false-positive rate is 8^-7 ~= 4.8e-7
(all 7 uniform clue values landing in LUT1's accept chunk, reference
``detector.rs:479-503``). A defect of the implementation would show as a
higher rate through the only other mechanism: intermediate noise pushing a
slot sum of 13 across the Delta/2 boundary of the second level's input
(sum chunk 13 -> 14).

This probe decrypts the stage-1 output of the port's ``Detector`` (the
mod-switched LWE under ``inter_sk``) for B pertinent and B non-pertinent
clues and reports

* the residual sigma around the nearest chunk centre (the margin is
  Delta/2 over sigma);
* the chunk placement: every pertinent message must land in chunk
  2 * clue_count, the sums of the others spread around clue_count.

Prints "OK" and exits 0 when both hold.

Usage: python benches/fp_margin_probe_torch.py [--batch 1024] [--tiny] [--device cpu]

The card is the default; with no card and no ``--device cpu`` the script
exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--tiny", action="store_true", help="the small test preset")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    args = ap.parse_args()

    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.utils.build import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"fp_margin_probe_torch: {err}")
    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    ctx = OmrContext(params, device)
    skp = SecretKeyPack(params, rng=0, ctx=ctx)
    skp2 = SecretKeyPack(params, rng=1, ctx=ctx)
    det = skp.generate_detector()
    rng = np.random.default_rng(2)
    batch = args.batch
    print(f"warm: {det.warm(batch)}")
    own = skp.generate_sender().gen_clues(batch, rng)
    other = skp2.generate_sender().gen_clues(batch, rng)

    q_inter = params.intermediate_lwe.cipher_modulus
    delta = q_inter // params.intermediate_lwe.plain_modulus
    target = 2 * params.clue_count

    ok = True
    for name, clues in (("pertinent", own), ("non-pertinent", other)):
        ms_a, ms_b = det.stage1(*det._clues(clues))
        m = np.mod(ms_b.cpu().numpy() - ms_a.cpu().numpy() @ skp.inter_sk, q_inter)
        k = np.round(m / delta).astype(np.int64) % (q_inter // delta)
        resid = m - np.round(m / delta) * delta
        sigma = float(resid.std())
        print(f"{name}: sigma={sigma:.2f} margin={delta // 2}"
              f" ({delta / 2 / max(sigma, 1e-300):.2f} sigma)"
              f" max|resid|={int(np.abs(resid).max())}")
        if name == "pertinent":
            hits = int((k == target).sum())
            print(f"  chunk {target}: {hits}/{batch}")
            ok &= hits == batch
        else:
            vals, cnts = np.unique(k, return_counts=True)
            print("  sum distribution:", {int(v): int(c) for v, c in zip(vals, cnts)})
            ok &= not (k == target).any() or batch > 10**5
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
