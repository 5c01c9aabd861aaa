"""Where the time of a warm detect goes on a CUDA card, and how it scales.

Runs the omd oracle of examples/omd_torch.py at the reference parameters
(B = 1024, so the keys and clues are real), then:

  1. profiles one warm ``detect`` with ``torch.profiler``: wall time, the
     summed device time of every kernel, the device's idle share
     (1 - kernel time / wall; the port runs on one stream) and the device
     time per kernel name;
  2. sweeps warm ``detect`` over B in {1, 8, 128, 1024, 2048, 4096}
     (median of 3, synchronised): msg/s, the stage split and the peak
     device memory, keys included.

With ``--digest`` it profiles the digest side instead: one warm
``encode_pertinent_payloads`` and one warm ``encode_pertinent_indices`` over
a board of D = 8192 pertinency ciphertexts (random residues: the encoders'
work does not depend on the values), with the encoders' steps (plaintext
build, the q2 NTT kernel, ``encode_mac``: ``ops/encode.py``) wrapped in
profiler ranges, so the device time divides between them and idle.

Usage (needs a CUDA card; builds the kernels at the first launch):
    python examples/profile_detect_torch.py [--digest]
"""

from __future__ import annotations

import os
import sys
import time

import torch

BATCH = 1024
SWEEP = (1, 8, 128, 1024, 2048, 4096)
SEED = 5
DIGEST_D = 8192
DIGEST_PERTINENT = 50


STEP = "step: "  # prefix of the profiler ranges around the encoders' steps


def device_ms(prof) -> float:
    """Summed time of the kernels and copies on the card (a profiler range
    is mirrored on the device's timeline too: not counted)."""
    return 1e-3 * sum(ev.device_time for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA
                      and not ev.name.startswith(STEP))


def print_top(prof, n: int) -> None:
    rows = sorted(((e.device_time_total, e.key, e.count) for e in prof.key_averages()),
                  reverse=True)
    for dt, key, cnt in rows[:n]:
        print(f"{dt / 1e3:12.3f} ms  x{cnt:5d}  {key[:90]}")


def profile_digest() -> int:
    """The encoders' split: device time per step of one warm encode."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function

    from omr_torch import make_keys
    from tfhe_omr_tpu_torch.core import detector as detector_mod
    from tfhe_omr_tpu_torch.core.params import OmrParameters, RetrievalParams
    from tfhe_omr_tpu_torch.core.payload import random_payloads

    params = OmrParameters.default()
    det = make_keys(params, SEED).detector
    ntt2 = det.ctx.ntt2
    rp = RetrievalParams.for_params(params, DIGEST_D, DIGEST_PERTINENT)
    gen = torch.Generator(device=det.device).manual_seed(SEED)
    pert = torch.randint(0, params.q2, (DIGEST_D, 2, params.n2), generator=gen,
                         device=det.device)
    payloads = random_payloads(np.random.default_rng(SEED), DIGEST_D, rp.payload_length)

    def ranged(owner, name, label):
        fn = getattr(owner, name)

        def wrapped(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        setattr(owner, name, wrapped)

    steps = [STEP + name for name in ("plaintext build", "K4 forward NTT",
                                      "encode_mac")]
    ranged(detector_mod, "payload_plaintexts", steps[0])
    ranged(detector_mod, "index_plaintexts", steps[0])
    ranged(ntt2, "fwd_last", steps[1])
    ranged(detector_mod, "encode_mac", steps[2])

    encoders = (
        ("encode_pertinent_payloads",
         lambda: det.encode_pertinent_payloads(rp, pert, payloads, SEED)),
        ("encode_pertinent_indices",
         lambda: det.encode_pertinent_indices(rp, pert, np.random.default_rng(SEED))),
    )
    for name, encode in encoders:
        encode()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            encode()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernel_ms = device_ms(prof)
        print(f"{name} at D={DIGEST_D} ({rp.cmb_cipher_count} payload cts): wall "
              f"{wall_ms:.3f} ms, summed device kernel time {kernel_ms:.3f} ms, idle "
              f"share {1 - kernel_ms / wall_ms:.4f}")
        # a range's device time is that of the kernels launched inside it
        # through torch; the kernels are launched through ctypes and show
        # under their own names
        for e in prof.key_averages():
            if e.key in steps or "ntt_kernel" in e.key or "encode_" in e.key:
                print(f"{e.device_time_total / 1e3:12.3f} ms  x{e.count:5d}  {e.key[:60]} "
                      f"({100 * e.device_time_total / 1e3 / kernel_ms:.1f} % of device time)")
        print_top(prof, 30)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_detect_torch: needs a CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    sys.path.insert(0, here)
    if "--digest" in sys.argv[1:]:
        return profile_digest()
    from torch.profiler import ProfilerActivity, profile

    from omd_torch import run_omd
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.core.sender import ClueBatch

    run = run_omd(OmrParameters.default(), batch=BATCH, pertinent=8, seed=SEED)
    det, clues = run.detector, run.clues
    print(f"detection key on the card {det.detect_key_size()} bytes")
    det.detect(clues)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.detect(clues)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernel_ms = device_ms(prof)
    print(f"B={BATCH} profiled detect: wall {wall_ms:.3f} ms, summed device "
          f"kernel time {kernel_ms:.3f} ms, idle share "
          f"{1 - kernel_ms / wall_ms:.4f}")
    print_top(prof, 25)

    for b in SWEEP:
        cb = (ClueBatch(clues.a[:b], clues.b7[:b]) if b <= BATCH
              else ClueBatch.concat([clues] * (b // BATCH)))
        torch.cuda.reset_peak_memory_stats()
        det.detect(cb)
        torch.cuda.synchronize()
        runs = sorted((det.detect_with_time_info(cb)[1] for _ in range(3)),
                      key=lambda r: r.detect_time)
        m = runs[1]
        print(f"B={b}: {b / m.detect_time:.3f} msg/s, detect "
              f"{1e3 * m.detect_time:.3f} ms, stage1 "
              f"{1e3 * m.first_level_bootstrapping_time:.3f} ms, stage2 "
              f"{1e3 * m.second_level_bootstrapping_time:.3f} ms, stage3 "
              f"{1e3 * m.trace_time:.3f} ms, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
