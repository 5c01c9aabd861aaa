"""Stage timers.

PyTorch counterpart of :mod:`tfhe_omr_tpu.utils.timing`. PyTorch returns
before a CUDA device finishes, so every timed stage ends in
``torch.cuda.synchronize`` on that device.
"""

from __future__ import annotations

import time

import torch


def synchronize(device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Accumulating wall-clock stage timer that synchronises ``device``."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.stages: dict[str, float] = {}

    def time(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` and add its synchronised wall seconds to ``name``."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(self.device)
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0
        return out
