"""Time the two blind-rotation kernels alone at the main path's shapes.

The first level on 7 x B samples with 256 steps and the second on B samples
with 335 steps (B = 1024 by default), random keys and rotations from a
seed, full chains. Each kernel is first held bit-equal to its plain version
on ``--check`` samples of the same chain. Needs a CUDA card.

To compare two commits on one card, run each checkout's own copy of this
script in one session.

Usage:
    python examples/bench_blind_rotate_torch.py [--batch 1024] [--reps 3]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--check", type=int, default=5,
                    help="samples compared with the plain version (0: none)")
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.ops.bootstrap import init_accumulator
    from tfhe_omr_tpu_torch.ops.fused import (
        BlindRotateKey, blind_rotate, blind_rotate_plain,
    )
    from tfhe_omr_tpu_torch.utils import build

    params = OmrParameters.default()
    dev = torch.device("cuda")
    ctx = OmrContext(params, dev)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    build.library()
    for line in build.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    levels = (
        ("blind_rotate1", ctx.f1, ctx.ntt1, ctx.gadget_br1, ctx.lut1_ext,
         params.clue_params.dimension, params.clue_count * args.batch),
        ("blind_rotate2", ctx.f2, ctx.ntt2, ctx.gadget_br2, ctx.lut2_ext,
         params.intermediate_lwe.dimension, args.batch),
    )
    for name, f, ntt, g, lut, n_lwe, m in levels:
        bsk = torch.randint(0, f.q, (3 * n_lwe // 2, ntt.n, g.d, 2, 2),
                            generator=gen, device=dev)
        key = BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, name)
        del bsk
        b = torch.randint(0, 2 * ntt.n, (m,), generator=gen, device=dev)
        amounts = torch.randint(0, 2 * ntt.n, (n_lwe, m), generator=gen, device=dev)
        acc = init_accumulator(torch.as_tensor(lut, device=dev), b, ntt.n)
        acc = acc.permute(2, 1, 0).contiguous()
        if args.check:
            c = args.check
            sub_acc, sub_am = acc[:c].contiguous(), amounts[:, :c].contiguous()
            same = torch.equal(blind_rotate(sub_acc, sub_am, key),
                               blind_rotate_plain(sub_acc, sub_am, key))
            print(f"{name}: {c} samples x {n_lwe // 2} steps "
                  f"{'bit-equal to' if same else 'DIFFER from'} plain", flush=True)
            if not same:
                sys.exit(1)
        blind_rotate(acc, amounts, key)  # warm
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            blind_rotate(acc, amounts, key)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / args.reps
        print(f"{name}: {m} samples x {n_lwe // 2} steps: {ms:.3f} ms "
              f"(mean of {args.reps}), key {key.nbytes()} bytes, on {gpu}",
              flush=True)
        del key
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
