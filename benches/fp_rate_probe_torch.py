"""Measure the protocol's false-positive rate on the PyTorch / CUDA port.

The counterpart of benches/fp_rate_probe.py for ``tfhe_omr_tpu_torch``. The
detector flags a message iff ALL clue_count of its clues decrypt to 0 under
the recipient's key (LUT1's accept value, reference ``detector.rs:457-503``);
the independence model puts the rate at t^-clue_count = 8^-7 ~= 4.768e-7 a
message. This probe runs the port's device clue generator
(``Sender.gen_clues_device_resident``, the program the pipeline's device
clue path runs) under a wrong key, extracts and decrypts all clue_count LWE
samples of every message on the device (the extraction folded into one
signed matrix W, so the decrypt is one float64 matmul: entries below 2**11
against -1 / 0 / 1, exact), applies the accept criterion and counts

* the accept fraction of each clue (expect 1/t = 0.125);
* the messages whose clues all accept (the false positives);
* the same after the clue columns are rolled against each other by 131 * j
  rows: the independence control.

A small lane under the recipient's own key asserts the wiring: those clues
must accept with rate ~1. Prints one JSON object per key pair and one for
the whole run; ``--out`` also writes the last to a file.

Usage: python benches/fp_rate_probe_torch.py [--messages 100000000] [--pairs 4]
       python benches/fp_rate_probe_torch.py --tiny --device cpu --messages 40000

The card is the default; with no card and no ``--device cpu`` the script
exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def extraction_weights(skp) -> np.ndarray:
    """W (n, clue_count) with phase_i = b_i - a . W[:, i] mod q0: the signed
    index map of ``CmLweCiphertext::extract_all`` (``detector.rs:505-531``)
    and the LWE decrypt folded into one signed permutation of the clue
    secret, W[idx[i, j], i] = (-1)^neg[i, j] * s[j]."""
    idx, neg = skp.ctx.clue_extract_tables
    s = np.asarray(skp.clue_sk, dtype=np.int64)
    c, n = idx.shape
    w = np.zeros((n, c), dtype=np.int64)
    for i in range(c):
        w[idx[i], i] = np.where(neg[i] == 1, -1, 1) * s
    return w


def count_accepts(sender, w, seed: int, count: int, q0: int, t: int):
    """Generate ``count`` clues under ``sender``'s key and test them against
    the key behind ``w`` -> (per-clue accepts (c,), all-accept count,
    shuffled all-accept count), tensors on the sender's device."""
    import torch

    clues = sender.gen_clues_device_resident(count, seed)
    n = w.shape[0]
    a, b7 = clues[:, :n], clues[:, n:]
    dots = torch.matmul(a.to(torch.float64), w).to(torch.int64)
    phase = torch.remainder(b7 - dots, q0)
    accept = ((phase * (2 * t) + q0) // (2 * q0)) % t == 0  # decrypt_clue's rounding
    shuffled = torch.stack([torch.roll(accept[:, j], 131 * j)
                            for j in range(accept.shape[1])], dim=1)
    return accept.sum(dim=0), accept.all(dim=1).sum(), shuffled.all(dim=1).sum()


def pois_tails(k: int, lam: float):
    """(P[X <= k], P[X >= k]) for X ~ Poisson(lam), in log space."""

    def cdf(kk):
        if kk < 0:
            return 0.0
        return min(sum(math.exp(j * math.log(lam) - lam - math.lgamma(j + 1))
                       for j in range(kk + 1)), 1.0)

    return cdf(k), 1.0 - cdf(k - 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--messages", type=int, default=100_000_000,
                    help="total across all key pairs")
    ap.add_argument("--pairs", type=int, default=4,
                    help="distinct (recipient, sender) key pairs")
    ap.add_argument("--chunk", type=int, default=65536, help="messages a call")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tiny", action="store_true", help="the small test preset")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    ap.add_argument("--out", default=None, help="also write the result here")
    args = ap.parse_args()

    import torch

    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.utils.build import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"fp_rate_probe_torch: {err}")
    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    ctx = OmrContext(params, device)
    cp = params.clue_params
    q0, t, c = cp.cipher_modulus, cp.plain_modulus, params.clue_count

    def weights(skp):
        return torch.as_tensor(extraction_weights(skp), dtype=torch.float64,
                               device=device)

    # sanity lane: clues under the recipient's own key accept with rate ~1
    skp0 = SecretKeyPack(params, rng=args.seed, ctx=ctx)
    _pc, fp_own, _fs = count_accepts(skp0.generate_sender(), weights(skp0),
                                     args.seed + 100, args.chunk, q0, t)
    own_rate = int(fp_own) / args.chunk
    print(json.dumps({"own_key_accept_rate": own_rate,
                      "own_key_messages": args.chunk}), flush=True)
    assert own_rate > 0.999, own_rate

    calls = -(-(args.messages // args.pairs) // args.chunk)
    expected_rate = t ** (-c)
    pair_results = []
    tot_fp = tot_shuf = tot_msgs = 0
    tot_per_clue = np.zeros((c,), dtype=np.int64)
    t_all = time.perf_counter()
    for pair in range(args.pairs):
        skp_r = SecretKeyPack(params, rng=args.seed + 10 * pair, ctx=ctx)
        skp_s = SecretKeyPack(params, rng=args.seed + 10 * pair + 1, ctx=ctx)
        sender, w = skp_s.generate_sender(), weights(skp_r)
        per_clue = torch.zeros((c,), dtype=torch.int64, device=device)
        fp = torch.zeros((), dtype=torch.int64, device=device)
        shuf = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(calls):  # the counts stay on the device until the end
            pc, f, fs = count_accepts(
                sender, w, (args.seed + 1000 + pair) * 1_000_003 + i, args.chunk, q0, t)
            per_clue, fp, shuf = per_clue + pc, fp + f, shuf + fs
        per_clue = per_clue.cpu().numpy()
        fp_count, shuf_count = int(fp), int(shuf)
        msgs = calls * args.chunk
        lam = msgs * expected_rate
        rec = {
            "pair": pair,
            "messages": msgs,
            "fp_count": fp_count,
            "fp_rate": fp_count / msgs,
            "shuffled_fp_count": shuf_count,
            "shuffled_fp_rate": shuf_count / msgs,
            "expected_count_independence": lam,
            "poisson_p_le": pois_tails(fp_count, lam)[0],
            "per_clue_accept_rate": [round(float(x) / msgs, 6) for x in per_clue],
        }
        print(json.dumps(rec), flush=True)
        pair_results.append(rec)
        tot_fp += fp_count
        tot_shuf += shuf_count
        tot_msgs += msgs
        tot_per_clue += per_clue
    wall = time.perf_counter() - t_all

    lam = tot_msgs * expected_rate
    p_le, p_ge = pois_tails(tot_fp, lam)
    sp_le, sp_ge = pois_tails(tot_shuf, lam)
    result = {
        "messages": tot_msgs,
        "key_pairs": args.pairs,
        "fp_count": tot_fp,
        "observed_rate": tot_fp / tot_msgs,
        "independence_model_rate": expected_rate,
        "expected_count_independence": lam,
        "poisson_p_le": p_le,
        "poisson_p_ge": p_ge,
        "shuffled_fp_count": tot_shuf,
        "shuffled_rate": tot_shuf / tot_msgs,
        "shuffled_poisson_p_le": sp_le,
        "shuffled_poisson_p_ge": sp_ge,
        "per_clue_accept_rate": [round(float(x) / tot_msgs, 6) for x in tot_per_clue],
        "per_clue_design_rate": 1.0 / t,
        "own_key_accept_rate": own_rate,
        "pairs": pair_results,
        "generator": "tfhe_omr_tpu_torch.core.sender.Sender.gen_clues_device_resident "
                     "(the pipeline's device clue program)",
        "wall_s": round(wall, 1),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
