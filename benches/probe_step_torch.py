"""Where one CMUX step of the blind rotations spends its time, on the card.

The counterpart of benches/probe_step.py for the PyTorch / CUDA port. The
JAX probe times the stages of a step (digits, forward NTT, MAC, monomial
multiply, inverse NTT) as separate programs; the port computes the whole
chain inside one fused kernel (``csrc/blind_rotate.cuh``), so the stages are
timed inside it: the profiled instantiation of K1 (``--level 1``) or K2
(``--level 2``) reads the SM clock at every stage boundary of every step in
thread 0 of each block (``ops/fused.py blind_rotate(..., stage_clocks=)``).

At the hot shapes by default: 7168 samples x 256 steps at the first level
(7 clues x B = 1024), 1024 x 335 at the second. Random key and inputs from
``--seed``. First the profiled kernel's output is held bit-equal to the
plain torch version on 5 samples and to the production kernel on the whole
batch; then one JSON line per stage: clocks a step (the mean over blocks),
microseconds a step at the card's top SM clock (``clocks.max.sm``) and the
share of the step. That for each of two profiled variants (``stamps``):
``per_plane`` stamps every key plane, so the key staging is timed apart
from the multiply-accumulate, at a cost that shows in the other stages;
``per_pass`` stamps each digit pass once around both (its "staging" is 0).
Each level's record gives the production kernel's time beside each
variant's (the cost of the stamps); last the card's name and power limit.

Usage: python benches/probe_step_torch.py [--level 1|2] [--batch B] [--steps S]
       python benches/probe_step_torch.py --tiny --device cpu   # plain torch

On the CPU there is no kernel and no clock: the plain version runs at the
small preset and every stage's clocks print as null. The card is the
default; with no card and no ``--device cpu`` the script exits non-zero
and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHECK = 5  # samples held against the plain version
# the profiled variants: two stamps a key plane (the staging apart from the
# multiply-accumulate), or one around each digit pass's whole MAC and
# staging (less disturbed; "staging" is then 0 and counted in "mac")
STAMPS = {"per_plane": True, "per_pass": False}


def run_level(ctx, level: int, batch: int | None, steps: int | None, reps: int,
              seed: int, out) -> dict:
    """Check and profile one level; prints its lines through ``out`` and
    returns the summary record."""
    import torch

    from tfhe_omr_tpu_torch.ops.fused import (
        BR_STAGES, BlindRotateKey, blind_rotate, blind_rotate_plain, n_blocks)
    from tfhe_omr_tpu_torch.utils import rates
    from tfhe_omr_tpu_torch.utils.timing import median_ms

    p = ctx.params
    dev = ctx.device
    f, ntt, g, n_lwe = ((ctx.f1, ctx.ntt1, ctx.gadget_br1, p.clue_params.dimension)
                        if level == 1 else
                        (ctx.f2, ctx.ntt2, ctx.gadget_br2, p.intermediate_lwe.dimension))
    samples = batch or ((p.clue_count * 1024) if level == 1 else 1024)
    steps = min(steps or n_lwe // 2, n_lwe // 2)
    gen = torch.Generator(device=dev).manual_seed(seed + level)

    def uniform(q, shape):
        return torch.randint(0, q, shape, generator=gen, device=dev)

    bsk = uniform(f.q, (3 * steps, ntt.n, g.d, 2, 2))
    key = BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, f"blind_rotate{level}")
    del bsk
    acc = uniform(f.q, (samples, 2, ntt.n))
    amounts = uniform(2 * ntt.n, (2 * steps, samples))
    c = min(CHECK, samples)
    sub_acc, sub_am = acc[:c].contiguous(), amounts[:, :c].contiguous()
    rec = {"level": level, "samples": samples, "steps": steps,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if dev.type != "cuda":
        rec["plain_ms"] = median_ms(lambda: blind_rotate_plain(sub_acc, sub_am, key), dev, 1)
        for stage in BR_STAGES:
            out({"level": level, "stamps": None, "stage": stage, "clocks_per_step": None,
                 "us_per_step": None, "share": None})
        rec["checked_samples"] = c
        return rec

    blocks = n_blocks(samples, key.layout.s)

    def profiled(a, am, clocks=None, planes=True):
        clocks = clocks if clocks is not None else torch.zeros(
            (n_blocks(a.shape[0], key.layout.s), len(BR_STAGES)), dtype=torch.int64,
            device=dev)
        return blind_rotate(a, am, key, stage_clocks=clocks, plane_stamps=planes), clocks

    plain = blind_rotate_plain(sub_acc, sub_am, key)
    production = blind_rotate(acc, amounts, key)
    ms = median_ms(lambda: blind_rotate(acc, amounts, key), dev, reps)
    mhz = rates.spec_rates(dev)["clock_max_sm_mhz"]
    rec.update(checked_samples=c, bit_equal=True, blocks=blocks,
               samples_per_block=key.layout.s, clock_max_sm_mhz=mhz, kernel_ms=ms)
    for stamps, planes in STAMPS.items():
        if not torch.equal(profiled(sub_acc, sub_am, planes=planes)[0], plain):
            raise AssertionError(f"level {level} ({stamps}): profiled kernel != plain "
                                 f"on {c} samples")
        clocks = torch.zeros((blocks, len(BR_STAGES)), dtype=torch.int64, device=dev)
        if not torch.equal(profiled(acc, amounts, clocks, planes)[0], production):
            raise AssertionError(f"level {level} ({stamps}): profiled kernel != "
                                 "production kernel")
        torch.cuda.synchronize(dev)
        per_step = clocks.double().mean(dim=0) / steps  # a block's clocks a stage a step
        total = float(per_step.sum())
        stages = {}
        for stage, clk in zip(BR_STAGES, per_step.tolist()):
            stages[stage] = {"clocks_per_step": clk, "us_per_step": clk / mhz,
                             "share": clk / total}
            out({"level": level, "stamps": stamps, "stage": stage, **stages[stage]})
        prof_ms = median_ms(lambda: profiled(acc, amounts, clocks, planes), dev, reps)
        part = dict(clocks_per_step=total, us_per_step=total / mhz,
                    block_clocks_max_over_mean=float(
                        clocks.sum(1).max() / clocks.sum(1).double().mean()),
                    profiled_ms=prof_ms, stamp_cost_pct=100 * (prof_ms / ms - 1),
                    stages=stages)
        if planes:
            rec.update(part)
        else:
            rec[stamps] = part
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--level", type=int, choices=(1, 2), action="append",
                    help="1 (K1), 2 (K2); both when not given")
    ap.add_argument("--batch", type=int, help="samples (default 7168 / 1024)")
    ap.add_argument("--steps", type=int, help="CMUX steps (default all: 256 / 335)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--tiny", action="store_true", help="the small test preset")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    args = ap.parse_args()

    from bench_torch import card_line
    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.utils.build import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"probe_step_torch: {err}")
    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    ctx = OmrContext(params, device)

    def out(rec):
        print(json.dumps(rec), flush=True)

    for level in args.level or (1, 2):
        out(run_level(ctx, level, args.batch, args.steps, args.reps, args.seed, out))
    out({"card": card_line() if device.type == "cuda" else "cpu"})


if __name__ == "__main__":
    main()
