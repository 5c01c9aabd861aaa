"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its result; any failure exits non-zero):
  1. require a CUDA card; print its name and power limit (nvidia-smi),
     the torch and CUDA versions;
  2. build the kernels from tfhe_omr_tpu_torch/csrc with nvcc;
  3. hold each kernel bit-equal to its plain torch version on the card at
     the main path's shapes (NTT q1 at 7*1024 rows and q2 at 2*1024 rows,
     and both at 1 and 37 rows; both blind rotations with all 256 / 335
     steps on a 32-message sub-batch, and at ragged batches of 1 and 5
     samples on the first 4 steps; the trace on 32 messages and on 1 and
     5), timing both; then time the blind
     rotations and the trace alone at the main path's batch (7*1024, 1024
     and 1024 samples) and compute each kernel's bound there: the larger
     of its bytes (every input read once, every output written once) over
     3.35 TB/s and the int32 multiplies of its modular products over
     1.675e13 multiplies a second (half the card's 67 TFLOP/s float32
     lanes). A product with a twiddle or the 1/N scale (Shoup) is 3
     multiplies in a 27-bit field and 10 in a 50-bit one; a product that is
     summed with others before one reduction (against a key, against the
     monomial table) is 1 and 4;
  4+5. the omd oracle at the reference parameters, B = 1024 (8 pertinent
     messages, 1016 from a second key pack): key generation on the card,
     clues, Detector.warm(1024), detect through the kernels, decrypt,
     [1,0,...,0] / zeros; every kernel's launch count must have grown
     without the warm's launches, which are counted apart (``warm_launches``
     in the kernels line), and the first 32 outputs must equal the plain
     path's detect on the card;
  6. warm detect throughput at B = 1024 (median of 3) and its stage split;
     each of the three detects must launch K1-K4; the first detect after
     the warm one must take at most 1.25 x that median;
  7. the whole OMR pipeline of examples/omr_torch.py at the reference
     parameters through the kernels: D = 8192 messages (50 pertinent),
     B = 1024, clues on the card, both digest encoders, the recipient's
     decode. The true indices must be a subset of the decoded ones, every
     decoded payload byte-exact and every extra a confirmed protocol false
     positive; every kernel must have launched, the q2 NTT (K4) in both
     encoders and in the decode; both digests of the first 2048 messages
     must equal the plain path's (plain=True), and the Retriever's decrypt
     the plain inverse NTT's.
  8. sharded and multi-process detection at the reference parameters, with
     phase 7's keys: a ShardedDetector over every visible card, warmed on
     every card (ShardedDetector.warm), on a ragged batch (B = 1000): detect, one index digest and the payload digests
     bit-equal to the single Detector's with the same numpy streams, the
     blind rotations, the trace and the q2 NTT launched; warm seconds per
     batch of the plain and the sharded path (several detects, one
     synchronisation; order plain, sharded, sharded, plain) and the
     overhead. Then the same through a process group: one rank per visible
     card runs examples/omr_torch.py at D = 2048 with --coordinator on
     127.0.0.1, backend nccl, so the digests' int64 all_reduce runs through
     NCCL on the card even with one rank; rank 0's record must say
     byte_exact and true_subset_of_decoded and count a launch of every
     kernel, the q1 NTT in its key generation, and a rank that fails or
     outlives its time limit fails the script. Then the dry-run entry
     (tfhe_omr_tpu_torch/entry.py dryrun_multichip) over every visible card
     at the small preset: sharded detect and both encoders equal to one card.
  9. the unit-rate probes (csrc/probes.cu, the twins of the TPU probes of
     benches/): probe_chain for every op, type and stream count, probe_mac
     and probe_i8dot (mma.sync s8) at the probes' shapes, one of them with
     int32 sums that wrap, each bit-equal to its plain version at small
     loop counts; then, with the launch counts set to 0, one short timed
     run of each (the int32 multiply chains and the MAC at (256, 1024) with
     4 and 16 streams, mulhi, int64 multiply, float32 FMA, the int8 dot at
     (256, 384, 96, 128)), every rate beside its unit's spec rate at the
     card's top SM clock and each run's bound, the least time at the spec
     rates of its least instruction mix (tfhe_omr_tpu_torch/utils/rates.py:
     int32 multiplies 64 and int32 instructions 128 a clock an SM); the
     measured int32 multiply peak against the
     1.675e13 that ``bound`` assumes, and K1-K5's bound at the measured
     int32 multiply rate and, if every multiply took as long as a high
     word (__mulhi), at that rate; the library's int8 product
     (torch._int_mm, k zero-padded, a loop over the groups of a batched dot)
     at the TPU dot probes' shapes and rounds (P2, P5, P7, P9), its calls
     replayed from a CUDA graph so that the time is the card's, with b
     row-major and column-major, each held equal to plain;
  10. the pinned golden vectors (tests/golden/golden_vectors.npz) through the
     kernels, no jax: one CMUX step of each level through K1 and K2, the
     trace through K3, both NTTs and their inverses through K5 and K4, each
     np.array_equal to its pin (utils/golden.py); then the profiled K1 and
     K2 (the stage clocks of csrc/blind_rotate.cuh, instantiated in
     csrc/blind_rotate_profiled.cu) bit-equal to plain on 5
     samples and to the production kernels at the hot shapes, and the split
     of a CMUX step into its stages there (benches/probe_step_torch.py).
The line before the last is a JSON record of the kernels (``launches``:
phases 4+5, 7 and 8 together for K1-K5, phase 9's timed runs for the probes,
``launches_by_path`` each (the ranks of phase
8 are processes of their own: ``ranks`` is what rank 0's record counts),
``launches_per_detect`` one warm detect at B = 1024; ``ms`` / ``plain_ms`` at the compared shape,
``ms_main_path`` and ``bound_ms`` at the main path's; K1-K5 ``golden_launches``
of phase 10, K1 and K2 ``profiled`` with the profiled instantiation's
launches, times and stage split, with stamps at every key plane, and
``per_pass`` the same with one stamp a digit pass around the MAC and the
key staging); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

SEED = 20261016
BATCH = 1024
PERTINENT = 8
SUB = 32  # messages in the kernel-vs-plain comparisons of the long chains
RAGGED = (1, 5)  # batches that fill no whole block, on RAGGED_STEPS steps
RAGGED_STEPS = 4
NTT_RAGGED_ROWS = (1, 37)  # row counts that fill no whole group of a block
INT32_MULS_PER_S = 67e12 / 4  # int32 multiply-adds: half the float32 lanes
# phase 7: D = 8192 has the digest layout of D = 65536 at these parameters
# (2 index digits per bucket, 5 segments and 5 index cts, 55 combinations
# in 28 payload cts); only the board is shorter
OMR_D = 8192
OMR_PERTINENT = 50
ENCODE_CHUNK = 2048  # the encoders' default chunk
# phase 8: a batch that no shard count divides evenly, and the ranks' board
SHARDED_BATCH = 1000
SHARDED_REPS = 3
RANKS_D = 2048
RANK_TIMEOUT_S = 420
WARM_FIRST_MAX = 1.25  # the first detect after Detector.warm, over the warm median

# phase 9: the probes' compared loop counts, the timed runs' shape and work
PROBE_SHAPE = (256, 1024)
PROBE_CMP_ITERS = 9
PROBE_FMA_CMP_ITERS = 3  # every float64 sum exact: the plain fmaf emulation holds
PROBE_TARGET_OPS = 4e10  # operations of one timed chain or MAC call
PROBE_FMA_ITERS = 8192
# (g, m, k, n, rounds): P2, P5, P7 and P9's shapes with few rounds, and
# the 2-D dot of P7 whose int32 sums wrap at its own rounds
PROBE_DOTS = [
    (1, 2048, 2048, 256, 1), (1, 128, 12, 256, 2), (1, 128, 128, 256, 2),
    (2048, 48, 12, 128, 2), (256, 384, 96, 128, 2), (128, 768, 192, 128, 2),
    (1, 384, 96, 128, 2), (1, 768, 192, 128, 2), (1, 384, 768, 128, 8192),
]
PROBE_DOT_MAIN = (256, 384, 96, 128, 512)
# the library's int8 product (torch._int_mm) at the TPU dot probes' shapes
# and rounds, (g, m, k, n, rounds)
LIBRARY_DOTS = {"P2": (1, 2048, 2048, 256, 8), "P5": (256, 384, 96, 128, 512),
                "P7": (1, 768, 192, 128, 16384), "P9": (2048, 48, 12, 128, 1)}

# (counter name, JSON name, source, the TPU kernel it replaces)
KERNELS = [
    ("ntt1", "ntt_q1", "tfhe_omr_tpu_torch/csrc/ntt.cu",
     "tfhe_omr_tpu/ops/pallas_ntt.py:190"),
    ("ntt2", "ntt_q2", "tfhe_omr_tpu_torch/csrc/ntt.cu",
     "tfhe_omr_tpu/ops/pallas_ntt.py:498"),
    ("blind_rotate1", "blind_rotate_l1", "tfhe_omr_tpu_torch/csrc/blind_rotate.cu",
     "tfhe_omr_tpu/ops/pallas_fused.py:436"),
    ("blind_rotate2", "blind_rotate_l2", "tfhe_omr_tpu_torch/csrc/blind_rotate.cu",
     "tfhe_omr_tpu/ops/pallas_fused.py:1218"),
    ("trace", "trace", "tfhe_omr_tpu_torch/csrc/trace.cu",
     "tfhe_omr_tpu/ops/pallas_fused.py:1765"),
]
# the kernels every detect launches (the q1 NTT runs in keygen only)
DETECT_KERNELS = ("ntt2", "blind_rotate1", "blind_rotate2", "trace")
PROBE_KERNELS = [
    ("probe_chain", "probe_chain", "tfhe_omr_tpu_torch/csrc/probes.cu",
     "benches/vpu_probe.py:42, benches/vpu_peak_probe.py:38, benches/mac_probe.py:112, "
     "benches/mosaic_unsupported_probe.py:69"),
    ("probe_mac", "probe_mac", "tfhe_omr_tpu_torch/csrc/probes.cu",
     "benches/vpu_peak_probe.py:80"),
    ("probe_i8dot", "probe_i8dot", "tfhe_omr_tpu_torch/csrc/probes.cu",
     "benches/vpu_probe.py:76, benches/mac_probe.py:62, benches/mac_probe.py:146, "
     "benches/mosaic_unsupported_probe.py:161"),
]


def say(*parts):
    print(*parts, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def compare(name, kernel_fn, plain_fn, reps, shape):
    """Kernel vs plain on the same inputs: bit-equality and both times."""
    from tfhe_omr_tpu_torch.utils.timing import median_ms

    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain, max |diff| {err}, "
                             f"{int((got != want).sum())} entries")
    ms = median_ms(kernel_fn, "cuda", reps, warm=False)
    plain_ms = median_ms(plain_fn, "cuda", 1, warm=False)
    say(f"[compare] {name} {shape}: bit-equal (max_abs_err {err}), "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, shoup_products: int, summed_products: int, field) -> dict:
    """The least time the card could take: bytes over the memory rate or
    the modular products' int32 multiplies over the integer rate. A Shoup
    product (a twiddle, the 1/N scale) is 3 multiplies in 32-bit words and
    10 in 64-bit ones; a product summed in double width with others before
    one reduction is 1 and 4."""
    from tfhe_omr_tpu_torch.utils import rates

    per_shoup, per_summed = (3, 1) if field.bits <= 31 else (10, 4)
    muls = shoup_products * per_shoup + summed_products * per_summed
    return {**rates.bound({"int32_mul": muls}, {"int32_mul": INT32_MULS_PER_S}, n_bytes),
            "bound_unit": "int32 multiplies", "bound_bytes": n_bytes,
            "bound_products": shoup_products + summed_products,
            "bound_multiplies": muls, "library_ms": None}


def ntt_products(n: int) -> int:
    """One transform: N/2 log N butterflies (the 1/N scale of the inverse
    adds N/2, counted with the blind rotation's own inverses below)."""
    return n // 2 * (n.bit_length() - 1)


def blind_rotate_products(n: int, d: int) -> tuple[int, int]:
    """Per sample and step, (Shoup, summed): 2d forward NTTs and two inverse
    NTTs with the 1/N scale; 3 rows x d digits x 2 x 2 x N products against
    the key and 6N against the monomial table."""
    return 2 * d * ntt_products(n) + 2 * (ntt_products(n) + n), 12 * d * n + 6 * n


def random_field(gen, field, shape):
    return torch.randint(0, field.q, shape, generator=gen, device=gen.device,
                         dtype=torch.int64)


def phase_compare(ctx):
    from tfhe_omr_tpu_torch.ops.bootstrap import init_accumulator
    from tfhe_omr_tpu_torch.ops.fused import (
        BlindRotateKey, TraceKey, blind_rotate, blind_rotate_plain, trace,
        trace_plain,
    )
    from tfhe_omr_tpu_torch.utils.timing import median_ms

    p = ctx.params
    dev = ctx.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    res = {}
    for ntt, rows, jname in ((ctx.ntt1, 7 * BATCH, "ntt_q1"),
                             (ctx.ntt2, 2 * BATCH, "ntt_q2")):
        x = random_field(gen, ntt.field, (rows, ntt.n))
        fwd = compare(f"{jname} fwd", lambda: ntt.fwd_last(x),
                      lambda: ntt.fwd_last_plain(x), 20, [rows, ntt.n])
        inv = compare(f"{jname} inv", lambda: ntt.inv_last(x),
                      lambda: ntt.inv_last_plain(x), 20, [rows, ntt.n])
        for r in NTT_RAGGED_ROWS:
            xr = x[:r].contiguous()
            if not (torch.equal(ntt.fwd_last(xr), ntt.fwd_last_plain(xr))
                    and torch.equal(ntt.inv_last(xr), ntt.inv_last_plain(xr))):
                raise AssertionError(f"{jname}: kernel != plain at {r} rows")
        say(f"[compare] {jname}: forward and inverse bit-equal at {NTT_RAGGED_ROWS} rows")
        res[jname] = dict(fwd, inv_ms=inv["ms"], plain_inv_ms=inv["plain_ms"],
                          max_abs_err=max(fwd["max_abs_err"], inv["max_abs_err"]),
                          ms_main_path=fwd["ms"], main_path_shape=[rows, ntt.n],
                          **bound(2 * nbytes(x) + nbytes(ntt.fwd_tw, ntt.fwd_tw_sh,
                                                         ntt.perm),
                                  rows * ntt_products(ntt.n), 0, ntt.field))

    levels = (
        (1, ctx.f1, ctx.ntt1, ctx.gadget_br1, ctx.lut1_ext, p.clue_params.dimension,
         7, "blind_rotate_l1"),
        (2, ctx.f2, ctx.ntt2, ctx.gadget_br2, ctx.lut2_ext,
         p.intermediate_lwe.dimension, 1, "blind_rotate_l2"),
    )
    for level, f, ntt, g, lut, n_lwe, per_msg, jname in levels:
        bsk = random_field(gen, f, (3 * n_lwe // 2, ntt.n, g.d, 2, 2))
        key = BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, f"blind_rotate{level}")
        m_main = per_msg * BATCH
        b = torch.randint(0, 2 * ntt.n, (m_main,), generator=gen, device=dev)
        amounts = torch.randint(0, 2 * ntt.n, (n_lwe, m_main), generator=gen,
                                device=dev)
        acc = init_accumulator(torch.as_tensor(lut, device=dev), b, ntt.n)
        acc = acc.permute(2, 1, 0).contiguous()
        m = per_msg * SUB
        sub_acc, sub_am = acc[:m].contiguous(), amounts[:, :m].contiguous()
        res[jname] = compare(jname, lambda: blind_rotate(sub_acc, sub_am, key),
                             lambda: blind_rotate_plain(sub_acc, sub_am, key), 3,
                             [m, 2, ntt.n, n_lwe // 2])
        short = BlindRotateKey(bsk[:3 * RAGGED_STEPS], f.shoup_t(bsk[:3 * RAGGED_STEPS]),
                               ntt, g, f"blind_rotate{level}")
        for mr in RAGGED:
            r_acc = acc[:mr].contiguous()
            r_am = amounts[:2 * RAGGED_STEPS, :mr].contiguous()
            if not torch.equal(blind_rotate(r_acc, r_am, short),
                               blind_rotate_plain(r_acc, r_am, short)):
                raise AssertionError(f"{jname}: kernel != plain at {mr} samples")
        say(f"[compare] {jname}: bit-equal at ragged batches {RAGGED} "
            f"({RAGGED_STEPS} steps, {key.layout.s} samples a block)")
        del bsk, short
        ms = median_ms(lambda: blind_rotate(acc, amounts, key), dev, 3)
        shoup, summed = (m_main * (n_lwe // 2) * c
                         for c in blind_rotate_products(ntt.n, g.d))
        res[jname].update(
            ms_main_path=ms, main_path_shape=[m_main, 2, ntt.n, n_lwe // 2],
            **bound(2 * nbytes(acc) + nbytes(amounts, key.keys[0], key.mono,
                                             key.tw_fwd, key.tw_inv, key.orders),
                    shoup, summed, f))
        say(f"[main path] {jname} {res[jname]['main_path_shape']}: "
            f"{ms:.3f} ms, bound {res[jname]['bound_ms']:.3f} ms "
            f"({res[jname]['bound_by']}), key {key.nbytes()} bytes")
        del key, acc, amounts
        torch.cuda.empty_cache()
    f = ctx.f2
    g = ctx.gadget_trace
    rounds = len(ctx.trace_autos)
    tk = random_field(gen, f, (rounds, p.n2, g.d, 2))
    key = TraceKey(tk, f.shoup_t(tk), ctx.ntt2, g, ctx.trace_autos)
    acc = random_field(gen, f, (BATCH, 2, p.n2))
    sub_acc = acc[:SUB].contiguous()
    res["trace"] = compare("trace", lambda: trace(sub_acc, key),
                           lambda: trace_plain(sub_acc, key), 5, [SUB, 2, p.n2])
    for mr in RAGGED:
        r_acc = acc[SUB:SUB + mr].contiguous()
        if not torch.equal(trace(r_acc, key), trace_plain(r_acc, key)):
            raise AssertionError(f"trace: kernel != plain at {mr} messages")
    say(f"[compare] trace: bit-equal at ragged batches {RAGGED} "
        f"({key.layout.s} messages a block)")
    ms = median_ms(lambda: trace(acc, key), dev, 5)
    # per message and round: d forward NTTs and two inverse NTTs with the
    # 1/N scale (Shoup products), d x 2 x N products against the key (summed)
    shoup = BATCH * rounds * (g.d * ntt_products(p.n2) + 2 * (ntt_products(p.n2) + p.n2))
    summed = BATCH * rounds * 2 * g.d * p.n2
    res["trace"].update(
        ms_main_path=ms, main_path_shape=[BATCH, 2, p.n2],
        **bound(2 * nbytes(acc) + nbytes(*key.keys, key.ginv, key.tw_fwd, key.tw_inv),
                shoup, summed, f))
    say(f"[main path] trace {[BATCH, 2, p.n2]}: {ms:.3f} ms, bound "
        f"{res['trace']['bound_ms']:.3f} ms ({res['trace']['bound_by']})")
    return res


def phase_omr(params, gpu):
    """Phase 7; returns the kernel launches of the pipeline's run and the
    keys it made."""
    from omr_torch import make_keys, run_board
    from tfhe_omr_tpu_torch.utils import build

    build.reset_launches()
    t0 = time.perf_counter()
    keys = make_keys(params, SEED + 10)  # no device: the card
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    run = run_board(keys, OMR_D, OMR_PERTINENT, np.random.default_rng(SEED + 12),
                    batch=BATCH)
    launches = dict(build.LAUNCHES)
    rec = run.rec
    say(f"[omr] D={OMR_D}, {OMR_PERTINENT} pertinent, B={BATCH}: keygen "
        f"{keygen_s:.3f} s, clues {rec.gen_clues_time:.3f} s, detect "
        f"{rec.detect_time:.3f} s ({OMR_D / rec.detect_time:.3f} msg/s), index "
        f"encode {rec.encode_indices_time:.3f} s ({len(run.index_cts)} cts), "
        f"payload encode {rec.encode_payloads_time:.3f} s "
        f"({run.payload_cts.shape[0]} cts), decode {rec.decode_time:.3f} s "
        f"on {gpu}")
    say(f"[omr] launches by stage: {run.launches}")
    if not run.ok:
        raise AssertionError(
            f"OMR verification failed: subset {run.subset_ok}, byte-exact "
            f"{run.payload_ok}, extras {run.fp_events}")
    say(f"[omr] true indices subset of decoded ({len(run.indices)} decoded, "
        f"{len(run.extras)} confirmed protocol FPs), all payloads byte-exact")
    missing = [c for c, *_ in KERNELS if launches.get(c, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the OMR path: {missing}")
    for stage in ("encode_indices", "encode_payloads", "decode"):
        if run.launches[stage].get("ntt2", 0) <= 0:
            raise AssertionError(f"the q2 NTT kernel did not launch in {stage}")

    q2 = params.q2
    digests = [*run.index_cts, run.payload_cts]
    if any(not bool(((d >= 0) & (d < q2)).all()) for d in digests):
        raise AssertionError("a digest holds values outside [0, q2)")
    rp = run.retriever.params
    det = keys.detector
    pv0, pay0 = run.pertinency[:ENCODE_CHUNK], run.payloads[:ENCODE_CHUNK]

    def first_chunk_digests(plain: bool):
        return (det.encode_pertinent_indices(rp, pv0, np.random.default_rng(SEED),
                                             plain=plain),
                det.encode_pertinent_payloads(rp, pv0, pay0, run.digest_seed,
                                              plain=plain))

    k_idx, k_pay = first_chunk_digests(False)
    p_idx, p_pay = first_chunk_digests(True)
    if not (torch.equal(k_idx, p_idx) and torch.equal(k_pay, p_pay)):
        raise AssertionError("digests of the first chunk through K4 != plain")
    say(f"[omr] index and payload digests of the first {ENCODE_CHUNK} messages "
        "bit-equal to plain=True")
    for name, ct in (("index", run.index_cts[0]), ("payload", run.payload_cts)):
        got = run.retriever.decrypt(ct)
        want = run.retriever.decrypt(ct, plain=True)
        if not np.array_equal(got, want):
            raise AssertionError(f"Retriever decrypt of the {name} digest "
                                 "through K4 != inv_last_plain")
    say("[omr] Retriever decrypt (index and payload digests) bit-equal to "
        "inv_last_plain")
    return launches, keys


def phase_sharded(keys, gpu):
    """Phase 8, one process: the ShardedDetector over every visible card
    against the single Detector; returns the sharded run's launches."""
    from tfhe_omr_tpu_torch.core.payload import random_payloads
    from tfhe_omr_tpu_torch.core.sender import ClueBatch
    from tfhe_omr_tpu_torch.parallel import ShardedDetector, make_data_mesh
    from tfhe_omr_tpu_torch.utils import build

    det = keys.detector
    params = keys.skp.params
    n_dim = params.clue_params.dimension
    buf = keys.sender.gen_clues_device_resident(SHARDED_BATCH, SEED + 20)
    clues = ClueBatch(buf[:, :n_dim], buf[:, n_dim:])
    rp = keys.skp.generate_retriever(OMR_D, OMR_PERTINENT).params
    payloads = random_payloads(np.random.default_rng(SEED + 21), SHARDED_BATCH,
                               rp.payload_length)
    sharded = ShardedDetector(det, make_data_mesh())  # no devices: every card
    if sharded.n_dev != torch.cuda.device_count():
        raise AssertionError(f"the mesh holds {sharded.n_dev} devices")

    def digests(runner, pv):
        return (runner.encode_pertinent_indices(rp, pv, np.random.default_rng(SEED + 22)),
                runner.encode_pertinent_payloads(rp, pv, payloads, SEED + 23))

    warm = sharded.warm(SHARDED_BATCH)
    if [w["device"] for w in warm] != [str(r.device) for r in sharded.replicas] or sum(
            w["batch"] for w in warm) != SHARDED_BATCH:
        raise AssertionError(f"ShardedDetector.warm missed a card: {warm}")
    say(f"[sharded] ShardedDetector.warm({SHARDED_BATCH}) on {len(warm)} card(s): "
        + ", ".join(f"{w['device']} {w['batch']} msgs {w['first_launch_s']:.4f} s"
                    for w in warm))

    build.reset_launches()
    pv_s = sharded.detect(clues)
    idx_s, pay_s = digests(sharded, pv_s)
    sharded.synchronize()
    launches = dict(build.LAUNCHES)
    missing = [c for c in ("blind_rotate1", "blind_rotate2", "trace", "ntt2")
               if launches.get(c, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the sharded path: {missing}")
    pv = det.detect(clues)
    idx, pay = digests(det, pv)
    if len(pv_s.parts) != len(sharded.replicas) or any(
            part.device != rep.device for part, rep in zip(pv_s.parts, sharded.replicas)):
        raise AssertionError("a shard's rows do not lie on its replica's card")
    if not (np.array_equal(sharded.gather(pv_s), pv.cpu().numpy())
            and torch.equal(idx_s, idx) and torch.equal(pay_s, pay)):
        raise AssertionError("sharded detect or digests != the single Detector's")
    say(f"[sharded] {sharded.n_dev} device(s), B={SHARDED_BATCH}: detect, one index "
        f"digest and {pay.shape[0]} payload digests bit-equal to the single "
        f"Detector's; launches {launches}")

    def streamed(runner) -> float:
        t0 = time.perf_counter()
        for _ in range(SHARDED_REPS):
            runner.detect(clues)
        sharded.synchronize()
        return (time.perf_counter() - t0) / SHARDED_REPS

    plain_a, shard_a = streamed(det), streamed(sharded)
    shard_b, plain_b = streamed(sharded), streamed(det)
    plain_s, shard_s = (plain_a + plain_b) / 2, (shard_a + shard_b) / 2
    say(f"[sharded] warm detect at B={SHARDED_BATCH}, {SHARDED_REPS} calls a "
        f"synchronisation: plain {plain_s:.5f} s/batch ({plain_a:.5f}, {plain_b:.5f}), "
        f"sharded {shard_s:.5f} s/batch ({shard_a:.5f}, {shard_b:.5f}), "
        f"overhead_pct {100 * (shard_s / plain_s - 1):.3f} on {gpu}")
    return launches


def phase_probes(gpu, results):
    """Phase 9: the probe kernels against their plain versions, then one
    short timed run of each with the launch counts set to 0 just before;
    returns those runs' launches and each kernel's record."""
    from tfhe_omr_tpu_torch.ops import probes
    from tfhe_omr_tpu_torch.utils import build, rates
    from tfhe_omr_tpu_torch.utils.timing import median_ms

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 40)
    x = torch.randint(1, 1 << 20, PROBE_SHAPE, generator=gen, device=dev, dtype=torch.int32)
    y = torch.randint(1, 1 << 10, PROBE_SHAPE, generator=gen, device=dev, dtype=torch.int32)
    xf = torch.rand(PROBE_SHAPE, generator=gen, device=dev) * 0.5 + 0.5
    yf = torch.rand(PROBE_SHAPE, generator=gen, device=dev) * 0.2 + 0.9
    operands = {torch.int32: (x, y), torch.int64: (x.long(), y.long()),
                torch.float32: (xf, yf)}
    rec = {}

    def held(name, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain, "
                                 f"{int((got != want).sum())} entries differ")
        return float((got.double() - want.double()).abs().max())

    def kernel_and_plain(kernel_fn, plain_fn):
        return {"ms": median_ms(kernel_fn, dev, 5, warm=False),
                "plain_ms": median_ms(plain_fn, dev, 1, warm=False)}

    errs = []
    for dtype, ops in probes.CHAIN_DTYPES.items():
        a, b = operands[dtype]
        iters = PROBE_FMA_CMP_ITERS if dtype == torch.float32 else PROBE_CMP_ITERS
        for op in ops:
            for streams in probes.STREAMS:
                errs.append(held(f"probe_chain {op} {dtype} s{streams}",
                                 probes.probe_chain(a, b, op, iters, streams),
                                 probes.probe_chain_plain(a, b, op, iters, streams)))
    say(f"[probes] probe_chain bit-equal to plain: every op and type at {PROBE_SHAPE}, "
        f"streams {probes.STREAMS}, {PROBE_CMP_ITERS} iterations (fma {PROBE_FMA_CMP_ITERS})")
    rec["probe_chain"] = {"max_abs_err": max(errs), **kernel_and_plain(
        lambda: probes.probe_chain(x, y, "mul_add", PROBE_CMP_ITERS, 4),
        lambda: probes.probe_chain_plain(x, y, "mul_add", PROBE_CMP_ITERS, 4))}
    errs = [held(f"probe_mac s{streams}", probes.probe_mac(x, y, PROBE_CMP_ITERS, streams),
                 probes.probe_mac_plain(x, y, PROBE_CMP_ITERS, streams))
            for streams in probes.STREAMS]
    say(f"[probes] probe_mac bit-equal to plain at {PROBE_SHAPE}, streams {probes.STREAMS}")
    rec["probe_mac"] = {"max_abs_err": max(errs), **kernel_and_plain(
        lambda: probes.probe_mac(x, y, PROBE_CMP_ITERS, 4),
        lambda: probes.probe_mac_plain(x, y, PROBE_CMP_ITERS, 4))}
    errs = []
    for g, m, k, n, rounds in PROBE_DOTS:
        lo = 64 if rounds > 1000 else -128  # positive operands: the sums wrap
        a = torch.randint(lo, 128, (g, m, k), generator=gen, device=dev).to(torch.int8)
        b = torch.randint(lo, 128, (g, k, n), generator=gen, device=dev).to(torch.int8)
        want = probes.probe_i8dot_plain(a, b, rounds)
        if lo > 0 and not bool((want.long() != rounds * torch.matmul(
                a.double(), b.double()).long()).all()):
            raise AssertionError("the wrapping case does not wrap")
        errs.append(held(f"probe_i8dot {(g, m, k, n)} x{rounds}",
                         probes.probe_i8dot(a, b, rounds), want))
    say(f"[probes] probe_i8dot (mma.sync s8) bit-equal to plain at {len(PROBE_DOTS)} "
        "shapes (g, m, k, n, rounds): " + ", ".join(str(d) for d in PROBE_DOTS)
        + "; the last one's int32 sums wrap")
    g, m, k, n, _ = PROBE_DOT_MAIN
    a = torch.randint(-64, 64, (g, m, k), generator=gen, device=dev).to(torch.int8)
    b = torch.randint(-64, 64, (g, k, n), generator=gen, device=dev).to(torch.int8)
    rec["probe_i8dot"] = {"max_abs_err": max(errs), **kernel_and_plain(
        lambda: probes.probe_i8dot(a, b, 2), lambda: probes.probe_i8dot_plain(a, b, 2))}

    spec = rates.spec_rates(dev)
    spec_ops = spec["ops_per_s"]
    say(f"[probes] spec rates at clocks.max.sm {spec['clock_max_sm_mhz']} MHz x "
        f"{spec['sms']} SMs: int32 instructions {spec_ops['int32']:.4e} /s, of them "
        f"multiplies {spec_ops['int32_mul']:.4e} /s, f32 FMA {spec_ops['f32_fma']:.4e} "
        f"/s, int8 mma {spec_ops['int8_mma']:.4e} op/s on {gpu}")
    elems = x.numel()
    af, bf = a.float(), b.float()
    rounds = PROBE_DOT_MAIN[4]

    def chain_iters(streams):
        return int(PROBE_TARGET_OPS / (2 * streams * elems))

    # (label, kernel, fn, operations as the TPU probes count them, the
    # unit they are read against, the run's least work by unit
    # (rates.STEP_WORK), bytes read and written)
    runs = []
    for op in ("mul", "mul_add"):
        for streams in (4, 16):
            it = chain_iters(streams)
            runs.append((f"i32_{op}_s{streams}", "probe_chain",
                         lambda op=op, s=streams, it=it: probes.probe_chain(x, y, op, it, s),
                         2 * it * streams * elems, "int32_mul",
                         rates.step_work(torch.int32, op, it * streams * elems), 3 * nbytes(x)))
    for streams in (4, 16):
        it = int(PROBE_TARGET_OPS / (3 * streams * elems))
        runs.append((f"mac_s{streams}", "probe_mac",
                     lambda s=streams, it=it: probes.probe_mac(x, y, it, s),
                     3 * it * streams * elems, "int32_mul",
                     rates.step_work(torch.int32, "mac", it * streams * elems), 3 * nbytes(x)))
    for streams in (4, 16):
        it = chain_iters(streams)
        runs.append((f"mulhi_s{streams}", "probe_chain",
                     lambda s=streams, it=it: probes.probe_chain(x, y, "mulhi_add", it, s),
                     2 * it * streams * elems, "int32_mul",
                     rates.step_work(torch.int32, "mulhi_add", it * streams * elems),
                     3 * nbytes(x)))
    x64, y64 = operands[torch.int64]
    it = chain_iters(4) // 4
    runs.append(("i64_mul_s4", "probe_chain",
                 lambda: probes.probe_chain(x64, y64, "mul_add", it, 4),
                 2 * it * 4 * elems, "int32_mul",
                 rates.step_work(torch.int64, "mul_add", it * 4 * elems), 3 * nbytes(x64)))
    runs.append(("f32_fma_s4", "probe_chain",
                 lambda: probes.probe_chain(xf, yf, "fma", PROBE_FMA_ITERS, 4),
                 2 * PROBE_FMA_ITERS * 4 * elems, "f32_fma",
                 rates.step_work(torch.float32, "fma", PROBE_FMA_ITERS * 4 * elems),
                 3 * nbytes(xf)))
    runs.append((f"i8dot_{g}x{m}x{k}x{n}_r{rounds}", "probe_i8dot",
                 lambda: probes.probe_i8dot(a, b, rounds), 2 * g * m * k * n * rounds,
                 "int8_mma", rates.dot_work(g, m, k, n, rounds), nbytes(a, b) + 4 * g * m * n))

    build.reset_launches()
    measured = {}
    for label, kernel, fn, counted, unit, work, n_bytes in runs:
        ms = median_ms(fn, dev)
        rate = counted / (ms * 1e-3)
        measured[label] = {"kernel": kernel, "ms": ms, "rate": rate, "unit": unit,
                           **rates.bound(work, spec_ops, n_bytes)}
        say(f"[probes] {label}: {ms:.4f} ms, {rate / 1e9:.3f} Gops/s counted beside the "
            f"{unit} spec {spec_ops[unit] / 1e9:.3f}; bound {measured[label]['bound_ms']:.4f}"
            f" ms ({measured[label]['bound_by']}), {measured[label]['bound_ms'] / ms:.4f} "
            "of it reached")
    launches = dict(build.LAUNCHES)
    missing = [c for c, *_ in PROBE_KERNELS if launches.get(c, 0) <= 0]
    if missing:
        raise AssertionError(f"probe kernels never launched in the timed runs: {missing}")
    bmm_ms = median_ms(lambda: rates.library_i8dot(af, bf, rounds), dev)
    say(f"[probes] library: {rounds} float32 torch.bmm into an int32 total at "
        f"{(g, m, k, n)}: {bmm_ms:.4f} ms; launches {launches}")
    int_mm_ms = {}
    for probe, (lg, lm, lk, ln, lr) in LIBRARY_DOTS.items():
        la = torch.randint(-64, 64, (lg, lm, lk), generator=gen, device=dev).to(torch.int8)
        lb = torch.randint(-64, 64, (lg, lk, ln), generator=gen, device=dev).to(torch.int8)
        if lg == 1:
            la, lb = la[0], lb[0]
        # the calls replayed from a CUDA graph: the card's time, not the
        # host's launches of 131072 calls (P5); each layout == plain first
        int_mm_ms[probe] = rates.library_int_mm_ms(la, lb, lr)
        int_mm_ms[probe]["ms"] = min(int_mm_ms[probe].values())
        say(f"[probes] library {probe} {(lg, lm, lk, ln)} x {lr}: torch._int_mm "
            f"({lg * lr} calls from a CUDA graph, k {lk} -> {rates.int_mm_k(lk)}, m {lm} -> "
            f"{-(-lm // 128) * 128}), == plain; b row-major "
            f"{int_mm_ms[probe]['b_row_major']:.4f} ms, b column-major "
            f"{int_mm_ms[probe]['b_col_major']:.4f} ms on {gpu}")
    lib_ms = int_mm_ms["P5"]["ms"]

    # multiplies a second: every op of the i32 mul chain is one; the mulhi
    # chain's ops are one high word and one add
    int32_mul = max(r["rate"] for lbl, r in measured.items() if lbl.startswith("i32_mul_s"))
    mulhi = max(r["rate"] for lbl, r in measured.items() if lbl.startswith("mulhi_")) / 2
    say(f"[probes] measured int32 multiply peak {int32_mul:.4e} /s, high-word multiplies "
        f"(__mulhi) {mulhi:.4e} /s, against the {INT32_MULS_PER_S:.4e} that bound() assumes "
        f"({int32_mul / INT32_MULS_PER_S:.4f} x, {mulhi / INT32_MULS_PER_S:.4f} x)")
    for _c, jname, *_ in KERNELS:
        r = results[jname]
        work = {"int32_mul": r["bound_multiplies"]}
        r["bound_ms_at_measured_int32_mul"] = rates.bound(
            work, {"int32_mul": int32_mul}, r["bound_bytes"])["bound_ms"]
        r["bound_ms_at_measured_mulhi"] = rates.bound(
            work, {"int32_mul": mulhi}, r["bound_bytes"])["bound_ms"]
        say(f"[probes] {jname}: bound {r['bound_ms']:.4f} ms at 1.675e13, "
            f"{r['bound_ms_at_measured_int32_mul']:.4f} ms at the measured int32 multiply "
            f"rate, {r['bound_ms_at_measured_mulhi']:.4f} ms if every multiply took the "
            f"high word's; kernel {r['ms_main_path']:.4f} ms")

    main_label = {"probe_chain": "i32_mul_s16", "probe_mac": "mac_s16",
                  "probe_i8dot": f"i8dot_{g}x{m}x{k}x{n}_r{rounds}"}
    for kernel, r in rec.items():
        run = measured[main_label[kernel]]
        r.update(ms_main_path=run["ms"], main_path_shape=main_label[kernel],
                 bound_ms=run["bound_ms"], bound_by=run["bound_by"],
                 bound_unit=run["bound_unit"], rate_per_s=run["rate"],
                 spec_per_s=spec_ops[run["unit"]],
                 library_ms=lib_ms if kernel == "probe_i8dot" else None)
    rec["probe_i8dot"].update(
        library_call=f"torch._int_mm, a loop of {g} x {rounds} calls (torch has no "
                     "batched int8 product) replayed from a CUDA graph, b in the faster "
                     "of row- and column-major",
        library_bmm_ms=bmm_ms, library_int_mm_ms_by_probe=int_mm_ms)
    return launches, rec


def phase_dryrun(gpu):
    """Phase 8, the dry-run entry over every visible card."""
    from tfhe_omr_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    rec = dryrun_multichip(torch.cuda.device_count())
    say(f"[dryrun] dryrun_multichip({torch.cuda.device_count()}): {rec}, sharded == one "
        f"card, {time.perf_counter() - t0:.2f} s on {gpu}")


def phase_golden(ctx, gpu):
    """Phase 10, the golden pins through the kernels; returns their
    launches."""
    from tfhe_omr_tpu_torch.utils import build, golden

    pinned = golden.load()
    build.reset_launches()
    got = golden.through_kernels(ctx, golden.golden_inputs(ctx))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    for name, kernel in golden.KERNEL_PINS.items():
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"golden {name}: {kernel} never launched")
        if got[name].shape != pinned[name].shape or not np.array_equal(got[name], pinned[name]):
            raise AssertionError(f"golden {name} through {kernel} != the pinned vector")
    say(f"[golden] {', '.join(golden.KERNEL_PINS)} through K1-K5 np.array_equal to "
        f"tests/golden/golden_vectors.npz (shapes as pinned: 4 samples, 1 CMUX step; "
        f"4 messages; 2 rows); launches {launches} on {gpu}")
    return launches


def phase_profiled(ctx, gpu):
    """Phase 10, the profiled K1 and K2 against plain and the production
    kernels, and the stage split of a CMUX step at the hot shapes; returns
    each level's record and the profiled launches."""
    from probe_step_torch import run_level
    from tfhe_omr_tpu_torch.utils import build

    build.reset_launches()
    recs = {}
    for level in (1, 2):
        recs[level] = run_level(ctx, level, None, None, 3, SEED,
                                lambda line: say(f"[step] {json.dumps(line)}"))
        say(f"[step] {json.dumps(recs[level])} on {gpu}")
    launches = dict(build.LAUNCHES)
    for level in (1, 2):
        if launches.get(f"blind_rotate{level}_profiled", 0) <= 0:
            raise AssertionError(f"the profiled K{level} never launched")
    return recs, launches


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_ranks(gpu):
    """Phase 8, a process group: one rank per visible card through
    examples/omr_torch.py with the nccl backend; returns rank 0's kernel
    launches, its key generation included, as its record counts them."""
    here = os.path.dirname(os.path.abspath(__file__))
    world = torch.cuda.device_count()
    coordinator = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(here, "examples", "omr_torch.py"),
             "-p", str(RANKS_D), "--batch", str(BATCH), "--seed", str(SEED + 30),
             "--coordinator", coordinator, "--num-processes", str(world),
             "--process-id", str(rank), "--json", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]
        logs = []
        try:
            for proc in procs:
                left = max(1.0, RANK_TIMEOUT_S - (time.perf_counter() - t0))
                logs.append(proc.communicate(timeout=left)[0])
        except subprocess.TimeoutExpired:
            raise AssertionError(f"a rank outlived {RANK_TIMEOUT_S} s:\n" + "\n".join(logs))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        codes = [proc.returncode for proc in procs]
        if any(codes):
            raise AssertionError(f"ranks exited with {codes}:\n" + "\n".join(logs))
        with open(out) as fh:
            art = json.load(fh)
    wall = time.perf_counter() - t0
    if not (art["byte_exact"] is True and art["true_subset_of_decoded"] is True
            and art["device_count"] == world):
        raise AssertionError(f"rank 0's record: {art}")
    if art["process_group_backend"] != "nccl":
        raise AssertionError(f"the ranks' backend is {art['process_group_backend']}")
    say(f"[ranks] {world} rank(s), backend nccl, D={RANKS_D}: byte_exact, true "
        f"indices subset of decoded, {art['fp_count']} confirmed FPs; stages "
        f"{art['stages_s']}; wall with start-up {wall:.3f} s; rank 0's launches "
        f"by stage {art['kernel_launches']} on {gpu}")
    launches = Counter()
    for stage in art["kernel_launches"].values():
        launches.update(stage)
    missing = [c for c, *_ in KERNELS if launches[c] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on rank 0's path: {missing}")
    if art["kernel_launches"]["keygen"].get("ntt1", 0) <= 0:
        raise AssertionError("the q1 NTT kernel did not launch in rank 0's keygen")
    return dict(launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    # the port itself: absent when this script stands alone, which fails here
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    for sub in ("examples", "benches"):
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), sub))
    from omd_torch import run_omd
    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.core.sender import ClueBatch
    from tfhe_omr_tpu_torch.utils import build

    gpu = gpu_line()
    say(gpu)
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.library()
    say(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s)")
    for line in build.build_log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "error" in line):
            say(f"[build] {line.strip()}")

    params = OmrParameters.default()
    ctx = OmrContext(params)  # no device: the card
    if ctx.device.type != "cuda":
        raise AssertionError(f"the default device is {ctx.device}, not the card")
    results = phase_compare(ctx)
    torch.cuda.empty_cache()

    build.reset_launches()
    run = run_omd(params, batch=BATCH, pertinent=PERTINENT, seed=SEED)
    # the warm is set-up, not the main path: its launches are kept apart
    warm_launches = run.warm_launches
    launches = {c: n - warm_launches.get(c, 0) for c, n in build.LAUNCHES.items()}
    say(f"[omd] keygen {run.keygen_s:.3f} s, detection key on the card "
        f"{run.detector.detect_key_size()} bytes")
    say(f"[omd] warm {run.warm}; its launches, not counted below: {warm_launches}")
    say(f"[omd] clues {run.clues_s:.3f} s, detect (first call after warm) "
        f"{run.detect_s:.3f} s, decrypt {run.decrypt_s:.3f} s")
    say(f"[omd] passed at B={BATCH}: [1,0,...,0] for {PERTINENT} pertinent, "
        f"zeros for {BATCH - PERTINENT}; launches {launches}")
    missing = [c for c, *_ in KERNELS if launches.get(c, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    res = run.result
    if res.shape != (BATCH, 2, params.n2) or not bool(
            ((res >= 0) & (res < params.q2)).all()):
        raise AssertionError(f"detect output malformed: {tuple(res.shape)}")
    sub = ClueBatch(run.clues.a[:SUB], run.clues.b7[:SUB])
    plain = run.detector.detect(sub, plain=True)
    if not torch.equal(plain, res[:SUB]):
        raise AssertionError("detect through the kernels != plain detect "
                             f"on the first {SUB} messages")
    say(f"[omd] first {SUB} outputs bit-equal to the plain path's detect")

    build.reset_launches()
    runs = [run.detector.detect_with_time_info(run.clues)[1] for _ in range(3)]
    per_detect = {c: build.LAUNCHES[c] // 3 for c, *_ in KERNELS}
    say(f"[detect] kernel launches per detect at B={BATCH}: {per_detect}")
    missing = [c for c in DETECT_KERNELS if per_detect[c] < 1]
    if missing:
        raise AssertionError(f"a detect after warm launched no {missing}")
    med = sorted(runs, key=lambda r: r.detect_time)[1]
    say(f"[detect] B={BATCH} warm median of 3: {BATCH / med.detect_time:.3f} msg/s, "
        f"{1e3 * med.detect_time / BATCH:.5f} ms/msg; stage1 "
        f"{1e3 * med.first_level_bootstrapping_time:.3f} ms, stage2 "
        f"{1e3 * med.second_level_bootstrapping_time:.3f} ms, stage3 "
        f"{1e3 * med.trace_time:.3f} ms (all 3: "
        f"{[round(r.detect_time, 4) for r in runs]} s) on {gpu}")
    say(f"[detect] spread of detect_time over 3 runs: "
        f"{statistics.pstdev([r.detect_time for r in runs]):.5f} s")
    say(f"[warm] Detector.warm({BATCH}): build {run.warm['build_s']:.4f} s, warm detect "
        f"{run.warm['first_launch_s']:.4f} s; first detect after it {run.detect_s:.4f} s "
        f"against the warm median {med.detect_time:.4f} s "
        f"({run.detect_s / med.detect_time:.4f} x) on {gpu}")
    if run.detect_s > WARM_FIRST_MAX * med.detect_time:
        raise AssertionError(f"the first detect after warm took {run.detect_s:.4f} s, "
                             f"over {WARM_FIRST_MAX} x the warm median")
    del run, runs, plain, res
    torch.cuda.empty_cache()

    omr_launches, keys = phase_omr(params, gpu)
    torch.cuda.empty_cache()
    sharded_launches = phase_sharded(keys, gpu)
    del keys
    torch.cuda.empty_cache()
    ranks_launches = phase_ranks(gpu)
    phase_dryrun(gpu)
    t0 = time.perf_counter()
    probe_launches, probe_results = phase_probes(gpu, results)
    say(f"[probes] phase 9 took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    golden_launches = phase_golden(ctx, gpu)
    profiled, profiled_launches = phase_profiled(ctx, gpu)
    say(f"[golden] phase 10 took {time.perf_counter() - t0:.2f} s")

    kernels = []
    for counter, jname, source, replaces in KERNELS:
        r = results[jname]
        kernels.append({
            "name": jname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (launches.get(counter, 0) + omr_launches[counter]
                         + sharded_launches.get(counter, 0)
                         + ranks_launches[counter]),
            "launches_by_path": {"omd": launches.get(counter, 0),
                                 "omr": omr_launches[counter],
                                 "sharded": sharded_launches.get(counter, 0),
                                 "ranks": ranks_launches[counter]},
            "launches_per_detect": per_detect[counter],
            "warm_launches": warm_launches.get(counter, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            **{k: r[k] for k in ("ms_main_path", "main_path_shape", "bound_ms",
                                 "bound_by", "bound_unit", "bound_bytes",
                                 "bound_products", "bound_multiplies",
                                 "library_ms")},
            **({"inv_ms": r["inv_ms"], "plain_inv_ms": r["plain_inv_ms"]}
               if "inv_ms" in r else {}),
            "bound_ms_at_measured_int32_mul": r["bound_ms_at_measured_int32_mul"],
            "bound_ms_at_measured_mulhi": r["bound_ms_at_measured_mulhi"],
            "golden_launches": golden_launches.get(counter, 0),
        })
        if counter in ("blind_rotate1", "blind_rotate2"):
            p = profiled[int(counter[-1])]
            kernels[-1]["profiled"] = {
                "source": "tfhe_omr_tpu_torch/csrc/blind_rotate_profiled.cu",
                "launches": profiled_launches[f"{counter}_profiled"], "max_abs_err": 0,
                "ms": p["profiled_ms"], "production_ms": p["kernel_ms"],
                "stamp_cost_pct": p["stamp_cost_pct"], "shape": [p["samples"], p["steps"]],
                "clock_max_sm_mhz": p["clock_max_sm_mhz"], "stages": p["stages"],
                "per_pass": {k: p["per_pass"][k] for k in (
                    "profiled_ms", "stamp_cost_pct", "stages")}}
    for counter, jname, source, replaces in PROBE_KERNELS:
        r = probe_results[jname]
        kernels.append({
            "name": jname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": probe_launches[counter],
            "launches_by_path": {"probes": probe_launches[counter]},
            "launches_per_detect": 0,
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "ms_main_path",
                                 "main_path_shape", "bound_ms", "bound_by", "bound_unit",
                                 "rate_per_s", "spec_per_s", "library_ms")},
            **{k: r[k] for k in ("library_call", "library_bmm_ms",
                                 "library_int_mm_ms_by_probe") if k in r},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
