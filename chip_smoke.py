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
     clues, detect through the kernels, decrypt, [1,0,...,0] / zeros; every
     kernel's launch count must have grown, and the first 32 outputs must
     equal the plain path's detect on the card;
  6. warm detect throughput at B = 1024 (median of 3) and its stage split;
  7. the whole OMR pipeline of examples/omr_torch.py at the reference
     parameters through the kernels: D = 8192 messages (50 pertinent),
     B = 1024, clues on the card, both digest encoders, the recipient's
     decode. The true indices must be a subset of the decoded ones, every
     decoded payload byte-exact and every extra a confirmed protocol false
     positive; every kernel must have launched, the q2 NTT (K4) in both
     encoders and in the decode; both digests of the first 2048 messages
     must equal the plain path's (plain=True), and the Retriever's decrypt
     the plain inverse NTT's.
The line before the last is a JSON record of the kernels (``launches``:
phases 4+5 and 7 together, ``launches_by_path`` each, ``launches_per_detect``
one warm detect at B = 1024; ``ms`` / ``plain_ms`` at the compared shape,
``ms_main_path`` and ``bound_ms`` at the main path's); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
BATCH = 1024
PERTINENT = 8
SUB = 32  # messages in the kernel-vs-plain comparisons of the long chains
RAGGED = (1, 5)  # batches that fill no whole block, on RAGGED_STEPS steps
RAGGED_STEPS = 4
NTT_RAGGED_ROWS = (1, 37)  # row counts that fill no whole group of a block
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_MULS_PER_S = 67e12 / 4  # int32 multiply-adds: half the float32 lanes
# phase 7: D = 8192 has the digest layout of D = 65536 at these parameters
# (2 index digits per bucket, 5 segments and 5 index cts, 55 combinations
# in 28 payload cts); only the board is shorter
OMR_D = 8192
OMR_PERTINENT = 50
ENCODE_CHUNK = 2048  # the encoders' default chunk

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


def say(*parts):
    print(*parts, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, kernel_fn, plain_fn, reps, shape):
    """Kernel vs plain on the same inputs: bit-equality and both times."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain, max |diff| {err}, "
                             f"{int((got != want).sum())} entries")
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, 1)
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
    per_shoup, per_summed = (3, 1) if field.bits <= 31 else (10, 4)
    muls = shoup_products * per_shoup + summed_products * per_summed
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * muls / INT32_MULS_PER_S
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
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
        blind_rotate(acc, amounts, key)
        ms = cuda_ms(lambda: blind_rotate(acc, amounts, key), 3)
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
    trace(acc, key)
    ms = cuda_ms(lambda: trace(acc, key), 5)
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
    """Phase 7; returns the kernel launches of the pipeline's run."""
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
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    # the port itself: absent when this script stands alone, which fails here
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "examples"))
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
    launches = dict(build.LAUNCHES)
    say(f"[omd] keygen {run.keygen_s:.3f} s, detection key on the card "
        f"{run.detector.detect_key_size()} bytes")
    say(f"[omd] clues {run.clues_s:.3f} s, detect (first call) {run.detect_s:.3f} s, "
        f"decrypt {run.decrypt_s:.3f} s")
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
    med = sorted(runs, key=lambda r: r.detect_time)[1]
    say(f"[detect] B={BATCH} warm median of 3: {BATCH / med.detect_time:.3f} msg/s, "
        f"{1e3 * med.detect_time / BATCH:.5f} ms/msg; stage1 "
        f"{1e3 * med.first_level_bootstrapping_time:.3f} ms, stage2 "
        f"{1e3 * med.second_level_bootstrapping_time:.3f} ms, stage3 "
        f"{1e3 * med.trace_time:.3f} ms (all 3: "
        f"{[round(r.detect_time, 4) for r in runs]} s) on {gpu}")
    say(f"[detect] spread of detect_time over 3 runs: "
        f"{statistics.pstdev([r.detect_time for r in runs]):.5f} s")
    del run, runs, plain, res
    torch.cuda.empty_cache()

    omr_launches = phase_omr(params, gpu)

    kernels = []
    for counter, jname, source, replaces in KERNELS:
        r = results[jname]
        kernels.append({
            "name": jname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[counter] + omr_launches[counter],
            "launches_by_path": {"omd": launches[counter],
                                 "omr": omr_launches[counter]},
            "launches_per_detect": per_detect[counter],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            **{k: r[k] for k in ("ms_main_path", "main_path_shape", "bound_ms",
                                 "bound_by", "bound_unit", "bound_bytes",
                                 "bound_products", "bound_multiplies",
                                 "library_ms")},
            **({"inv_ms": r["inv_ms"], "plain_inv_ms": r["plain_inv_ms"]}
               if "inv_ms" in r else {}),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
