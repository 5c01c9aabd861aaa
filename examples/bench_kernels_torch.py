"""Time the five CUDA kernels alone at the main path's shapes.

K1 / K2: the blind rotations on 7 x B and B samples with all 256 / 335
steps (B = 1024 by default; ``--steps`` cuts the chains to fewer). K3: the trace on B messages, all rounds.
K4: the q2 NTT, forward and inverse, on 1, 28 and 2048 rows (the
Retriever's index and payload digests, the encoders' chunk). K5: the q1
NTT on 7 x B rows (key generation). Random keys and inputs from a seed.
Each kernel is first held bit-equal to its plain version on ``--check``
samples or rows. Prints the card's name and power limit and what ptxas
said of every kernel. Needs a CUDA card.

To compare two commits, run this script against each checkout on the same
card, one after the other, in turns (parent, change, change, parent).

It stands in for the JAX package's benches/fused_l1.py, fused_l2.py and
fused_trace.py (``--batch``, ``--steps``; the kernels are held against
the plain version where those held the fused kernel against the XLA path).

With ``--grid`` the row NTT's C entry point is also timed alone (no
wrapper) over grids of 1, 2 and 3 blocks an SM, the grid the wrapper picks,
and one block a row group: blocks that outlive their rows against blocks
that do not.

Usage:
    python examples/bench_kernels_torch.py [--batch 1024] [--steps S] [--reps 3]
        [--only k1,k2,k3,k4,k5] [--grid]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch


def held(name: str, what: str, got, want) -> None:
    same = torch.equal(got, want)
    print(f"{name}: {what} {'bit-equal to' if same else 'DIFFER from'} plain",
          flush=True)
    if not same:
        sys.exit(1)


def sweep_grid(ntt, x, reps: int, gpu: str) -> None:
    """The forward kernel alone on ``x`` over several grids."""
    from tfhe_omr_tpu_torch.utils import build
    from tfhe_omr_tpu_torch.utils.timing import median_ms

    lay, tables, n_inv_sh, resident = ntt.row_kernel_tables
    tw, perm = tables[0]
    rows = x.shape[0]
    groups = -(-rows // lay.rows)
    out = torch.empty_like(x)
    want = ntt.fwd_last(x)
    lib = build.library()
    per_sm = resident // lay.blocks_per_sm
    for blocks in sorted({min(groups, b) for b in
                          (per_sm, 2 * per_sm, 3 * per_sm, resident, groups)}):
        def launch():
            rc = lib.omr_ntt(build.ptr(x), build.ptr(out), rows, build.ptr(tw),
                             build.ptr(perm), ntt.n_inv, n_inv_sh, ntt.log_n,
                             ntt.field.q, 0, blocks, build.stream_of(x))
            build.check(lib, rc, ntt.name)
        ms = median_ms(launch, "cuda", reps)
        if not torch.equal(out, want):
            sys.exit(f"{ntt.name}: grid of {blocks} blocks DIFFERS")
        print(f"{ntt.name}: {rows} rows, kernel alone, {blocks} blocks of {groups} "
              f"row groups ({lay.blocks_per_sm} resident an SM): forward {ms:.4f} ms "
              f"(median of {reps}), on {gpu}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int,
                    help="CMUX steps of K1 and K2 (default all: 256 and 335)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed launches of K1-K3 (the NTTs take 50 times as many)")
    ap.add_argument("--check", type=int, default=5,
                    help="samples or rows compared with the plain version (0: none)")
    ap.add_argument("--only", default="k1,k2,k3,k4,k5")
    ap.add_argument("--grid", action="store_true",
                    help="sweep the row NTT's grid, the kernel timed without its wrapper")
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()
    only = set(args.only.split(","))

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.ops.bootstrap import init_accumulator
    from tfhe_omr_tpu_torch.ops.fused import (
        BlindRotateKey, TraceKey, blind_rotate, blind_rotate_plain, trace,
        trace_plain,
    )
    from tfhe_omr_tpu_torch.utils import build
    from tfhe_omr_tpu_torch.utils.timing import median_ms

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

    def uniform(q, shape):
        return torch.randint(0, q, shape, generator=gen, device=dev)

    levels = (
        ("k1", "blind_rotate1", ctx.f1, ctx.ntt1, ctx.gadget_br1, ctx.lut1_ext,
         params.clue_params.dimension, params.clue_count * args.batch),
        ("k2", "blind_rotate2", ctx.f2, ctx.ntt2, ctx.gadget_br2, ctx.lut2_ext,
         params.intermediate_lwe.dimension, args.batch),
    )
    for kid, name, f, ntt, g, lut, n_lwe, m in levels:
        if kid not in only:
            continue
        n_lwe = 2 * min(args.steps or n_lwe // 2, n_lwe // 2)
        bsk = uniform(f.q, (3 * n_lwe // 2, ntt.n, g.d, 2, 2))
        key = BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, name)
        del bsk
        b = uniform(2 * ntt.n, (m,))
        amounts = uniform(2 * ntt.n, (n_lwe, m))
        acc = init_accumulator(torch.as_tensor(lut, device=dev), b, ntt.n)
        acc = acc.permute(2, 1, 0).contiguous()
        if args.check:
            c = args.check
            sub_acc, sub_am = acc[:c].contiguous(), amounts[:, :c].contiguous()
            held(name, f"{c} samples x {n_lwe // 2} steps",
                 blind_rotate(sub_acc, sub_am, key),
                 blind_rotate_plain(sub_acc, sub_am, key))
        ms = median_ms(lambda: blind_rotate(acc, amounts, key), "cuda", args.reps)
        print(f"{name}: {m} samples x {n_lwe // 2} steps: {ms:.3f} ms "
              f"(median of {args.reps}), key {key.nbytes()} bytes, on {gpu}",
              flush=True)
        del key, acc, amounts
        torch.cuda.empty_cache()

    if "k3" in only:
        f, g, autos = ctx.f2, ctx.gadget_trace, ctx.trace_autos
        tk = uniform(f.q, (len(autos), params.n2, g.d, 2))
        key = TraceKey(tk, f.shoup_t(tk), ctx.ntt2, g, autos)
        del tk
        acc = uniform(f.q, (args.batch, 2, params.n2))
        if args.check:
            sub = acc[:args.check].contiguous()
            held("trace", f"{args.check} messages x {len(autos)} rounds",
                 trace(sub, key), trace_plain(sub, key))
        for m in (args.batch, 1):
            part = acc[:m].contiguous()
            ms = median_ms(lambda: trace(part, key), "cuda", args.reps)
            print(f"trace: {m} messages x {len(autos)} rounds: {ms:.3f} ms "
                  f"(median of {args.reps}), key {key.nbytes()} bytes, on {gpu}",
                  flush=True)
        del key, acc
        torch.cuda.empty_cache()

    ntts = (("k4", ctx.ntt2, (1, 28, 2 * args.batch)),
            ("k5", ctx.ntt1, (params.clue_count * args.batch,)))
    for kid, ntt, row_counts in ntts:
        if kid not in only:
            continue
        for rows in row_counts:
            x = uniform(ntt.field.q, (rows, ntt.n))
            if args.check:
                sub = x[:args.check].contiguous()
                held(ntt.name, f"{sub.shape[0]} rows forward and inverse",
                     torch.stack([ntt.fwd_last(sub), ntt.inv_last(sub)]),
                     torch.stack([ntt.fwd_last_plain(sub), ntt.inv_last_plain(sub)]))
            reps = 50 * args.reps
            fwd = median_ms(lambda: ntt.fwd_last(x), "cuda", reps)
            inv = median_ms(lambda: ntt.inv_last(x), "cuda", reps)
            print(f"{ntt.name}: {rows} rows x {ntt.n}: forward {fwd:.4f} ms, "
                  f"inverse {inv:.4f} ms (median of {reps}), on {gpu}", flush=True)
            if args.grid:
                sweep_grid(ntt, x, reps, gpu)
            del x


if __name__ == "__main__":
    main()
