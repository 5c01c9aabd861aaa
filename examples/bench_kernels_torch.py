"""Time the five CUDA kernels alone at the main path's shapes.

K1 / K2: the blind rotations on 7 x B and B samples with all 256 / 335
steps (B = 1024 by default; ``--batch 1,8,22`` times them at each of those
B in turn; ``--steps`` cuts the chains to fewer). Each line names the
launch it took: ``blind_rotate2`` or, where the card would otherwise stand
mostly idle, ``blind_rotate2_cluster``. K3: the trace on B messages, all
rounds, and on 1. K4: the q2 NTT, forward and inverse, on 1, 28 and 2 x B
rows (the Retriever's index and payload digests, the encoders' chunk). K5:
the q1 NTT on 7 x B rows (key generation). K4 and K5 take the largest B.
Random keys and inputs from a seed. Each kernel is first held bit-equal to
its plain version on ``--check`` samples or rows. Prints the card's name
and power limit and what ptxas said of every kernel. Needs a CUDA card.

To compare two commits, run this script against each checkout on the same
card, one after the other, in turns (parent, change, change, parent).

It stands in for the JAX package's benches/fused_l1.py, fused_l2.py and
fused_trace.py (``--batch``, ``--steps``; the kernels are held against
the plain version where those held the fused kernel against the XLA path).

With ``--only c3`` it times the int8 tensor-core probe C3 (``probe_i8dot``,
csrc/probes.cu) at the TPU dot probes' shapes and rounds (P2, P5, P7, P9,
utils/rates.py DOT_PROBES), each first held bit-equal to plain at 2
rounds, beside its bound (int8 tensor-core operations at the spec rate or
bytes) and where a call's time goes: the host's time a call and each
kernel's device time (torch.profiler). ``chip_smoke.py`` phase 9 times
``torch._int_mm`` at the same shapes.

With ``--grid`` the row NTT's C entry point is also timed alone (no
wrapper) over grids of 1, 2 and 3 blocks an SM, the grid the wrapper picks,
and one block a row group: blocks that outlive their rows against blocks
that do not.

Usage:
    python examples/bench_kernels_torch.py [--batch 1024 | --batch 1,8,22,44,96,1024]
        [--steps S] [--reps 3] [--only k1,k2,k3,k4,k5,c3] [--grid]
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


def c3_split(fn, dev, calls: int = 5) -> str:
    """Where a call's time goes: the host's microseconds a call (``calls``
    calls queued without waiting, so the card keeps up unless the host is
    the slower) and each kernel's device microseconds a call
    (torch.profiler)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(dev)
    parts = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
        if us and ev.device_type.name == "CUDA":
            parts.append(f"{ev.key[:40]} {us / calls:.2f}")
    return f"host {host_us:.2f} us a call; device us a call: " + ", ".join(parts)


def bench_c3(gen, reps: int, gpu: str) -> None:
    """C3 at each of ``rates.DOT_PROBES``: bit-equal to plain at 2 rounds,
    then its median time, bound and :func:`c3_split`."""
    from tfhe_omr_tpu_torch.ops import probes
    from tfhe_omr_tpu_torch.utils import rates
    from tfhe_omr_tpu_torch.utils.timing import median_ms

    dev = gen.device
    spec = rates.spec_rates(dev)["ops_per_s"]
    for probe, (g, m, k, n, rounds) in rates.DOT_PROBES.items():
        a = torch.randint(-128, 128, (g, m, k), generator=gen, device=dev).to(torch.int8)
        b = torch.randint(-128, 128, (g, k, n), generator=gen, device=dev).to(torch.int8)
        if g == 1:
            a, b = a[0], b[0]
        held(f"probe_i8dot {probe}", f"{(g, m, k, n)} x 2",
             probes.probe_i8dot(a, b, 2), probes.probe_i8dot_plain(a, b, 2))
        ms = median_ms(lambda: probes.probe_i8dot(a, b, rounds), dev, 5 * reps)
        bnd = rates.bound(rates.dot_work(g, m, k, n, rounds), spec,
                          a.numel() + b.numel() + 4 * g * m * n)
        print(f"probe_i8dot {probe} {(g, m, k, n)} x {rounds}: {ms:.4f} ms (median of "
              f"{5 * reps}), bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
              f"{bnd['bound_ms'] / ms:.4f} of it reached; "
              f"{c3_split(lambda: probes.probe_i8dot(a, b, rounds), dev)}, on {gpu}",
              flush=True)
        del a, b
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", default="1024",
                    help="B, or comma-separated B at which to time K1-K3 in turn")
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
    batches = [int(b) for b in args.batch.split(",")]
    batch = max(batches)

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
         params.clue_params.dimension, params.clue_count),
        ("k2", "blind_rotate2", ctx.f2, ctx.ntt2, ctx.gadget_br2, ctx.lut2_ext,
         params.intermediate_lwe.dimension, 1),
    )
    for kid, name, f, ntt, g, lut, n_lwe, per_msg in levels:
        if kid not in only:
            continue
        n_lwe = 2 * min(args.steps or n_lwe // 2, n_lwe // 2)
        bsk = uniform(f.q, (3 * n_lwe // 2, ntt.n, g.d, 2, 2))
        key = BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, name)
        del bsk
        for m in [per_msg * n for n in batches]:
            b = uniform(2 * ntt.n, (m,))
            amounts = uniform(2 * ntt.n, (n_lwe, m))
            acc = init_accumulator(torch.as_tensor(lut, device=dev), b, ntt.n)
            acc = acc.permute(2, 1, 0).contiguous()
            if args.check:
                c = min(args.check, m)
                sub_acc, sub_am = acc[:c].contiguous(), amounts[:, :c].contiguous()
                held(name, f"{c} samples x {n_lwe // 2} steps",
                     blind_rotate(sub_acc, sub_am, key),
                     blind_rotate_plain(sub_acc, sub_am, key))
            build.reset_launches()
            ms = median_ms(lambda: blind_rotate(acc, amounts, key), "cuda", args.reps)
            path = ",".join(sorted(c for c, n in build.LAUNCHES.items() if n))
            print(f"{name}: {m} samples x {n_lwe // 2} steps: {ms:.3f} ms "
                  f"(median of {args.reps}, launch {path}), key {key.nbytes()} bytes, "
                  f"on {gpu}", flush=True)
            del acc, amounts
        del key
        torch.cuda.empty_cache()

    if "k3" in only:
        f, g, autos = ctx.f2, ctx.gadget_trace, ctx.trace_autos
        tk = uniform(f.q, (len(autos), params.n2, g.d, 2))
        key = TraceKey(tk, f.shoup_t(tk), ctx.ntt2, g, autos)
        del tk
        acc = uniform(f.q, (batch, 2, params.n2))
        if args.check:
            sub = acc[:args.check].contiguous()
            held("trace", f"{args.check} messages x {len(autos)} rounds",
                 trace(sub, key), trace_plain(sub, key))
        for m in sorted({*batches, 1}, reverse=True):
            part = acc[:m].contiguous()
            ms = median_ms(lambda: trace(part, key), "cuda", args.reps)
            print(f"trace: {m} messages x {len(autos)} rounds: {ms:.3f} ms "
                  f"(median of {args.reps}), key {key.nbytes()} bytes, on {gpu}",
                  flush=True)
        del key, acc
        torch.cuda.empty_cache()

    ntts = (("k4", ctx.ntt2, (1, 28, 2 * batch)),
            ("k5", ctx.ntt1, (params.clue_count * batch,)))
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

    if "c3" in only:
        bench_c3(gen, args.reps, gpu)


if __name__ == "__main__":
    main()
