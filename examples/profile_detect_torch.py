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

Usage (needs a CUDA card; builds the kernels at the first launch):
    python examples/profile_detect_torch.py
"""

from __future__ import annotations

import os
import sys
import time

import torch

BATCH = 1024
SWEEP = (1, 8, 128, 1024, 2048, 4096)
SEED = 5


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_detect_torch: needs a CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    sys.path.insert(0, here)
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
    kernel_ms = 1e-3 * sum(ev.device_time for ev in prof.events()
                           if ev.device_type == torch.autograd.DeviceType.CUDA)
    print(f"B={BATCH} profiled detect: wall {wall_ms:.3f} ms, summed device "
          f"kernel time {kernel_ms:.3f} ms, idle share "
          f"{1 - kernel_ms / wall_ms:.4f}")
    rows = sorted(((e.device_time_total, e.key, e.count) for e in prof.key_averages()),
                  reverse=True)
    for dt, key, cnt in rows[:25]:
        print(f"{dt / 1e3:12.3f} ms  x{cnt:5d}  {key[:90]}")

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
