"""Stage timers + CSV records.

PyTorch counterpart of :mod:`tfhe_omr_tpu.utils.timing`. PyTorch returns
before a CUDA device finishes, so every timed stage ends in
``torch.cuda.synchronize`` on that device. The CSV schema is the one of
``examples/omr_time_analyze.rs:18-38`` (device count, payload count,
per-stage seconds).
"""

from __future__ import annotations

import csv
import time
from dataclasses import asdict, dataclass

import torch

from tfhe_omr_tpu_torch.utils.build import resolve_device


@dataclass
class TimingRecord:
    """One sweep record (CSV row), mirroring omr_time_analyze's ``Record``."""

    device_count: int = 0
    payload_count: int = 0
    gen_clues_time: float = 0.0
    gen_payloads_time: float = 0.0
    detect_time: float = 0.0
    detect_time_per_message: float = 0.0
    encode_indices_time: float = 0.0
    encode_payloads_time: float = 0.0
    decode_time: float = 0.0
    total_time: float = 0.0


def write_csv(path: str, records: list[TimingRecord]):
    """Write sweep records (the ``benchmark.csv`` shape of
    ``examples/omr_time_analyze.rs:103-114``)."""
    if not records:
        return
    rows = [asdict(r) for r in records]
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)


def synchronize(device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Accumulating wall-clock stage timer that synchronises ``device``."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.stages: dict[str, float] = {}

    def time(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` and add its synchronised wall seconds to ``name``."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(self.device)
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0
        return out
