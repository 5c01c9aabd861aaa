"""Stage timers + CSV records.

PyTorch counterpart of :mod:`tfhe_omr_tpu.utils.timing`. PyTorch returns
before a CUDA device finishes, so every timed stage ends in
``torch.cuda.synchronize`` on that device. The CSV schema is the one of
``examples/omr_time_analyze.rs:18-38`` (device count, payload count,
per-stage seconds).
"""

from __future__ import annotations

import csv
import statistics
import time
from contextlib import contextmanager
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


def median_ms(fn, device, reps: int = 5, warm: bool = True) -> float:
    """Median milliseconds of ``reps`` back-to-back calls of ``fn``, after
    one warm call unless ``warm`` is false. On a card a CUDA event is
    recorded between the calls, so the queue does not drain between them;
    on the CPU the host clock."""
    device = torch.device(device)
    if warm:
        fn()
    synchronize(device)
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)
    with torch.cuda.device(device):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        marks[0].record()
        for mark in marks[1:]:
            fn()
            mark.record()
        marks[-1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))


def cuda_graph(fn, device, calls: int = 1) -> torch.cuda.CUDAGraph:
    """A CUDA graph of ``calls`` calls of ``fn`` on a card, captured after
    one call on a side stream (where a library sets itself up, outside the
    capture)."""
    device = torch.device(device)
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    return graph


def graphed_ms(fn, device, reps: int = 5, calls: int = 10) -> float:
    """Median milliseconds a call of ``fn`` on a card, from ``reps`` replays
    of a :func:`cuda_graph` of ``calls`` calls: the card's time, without the
    host's work between launches."""
    return median_ms(cuda_graph(fn, device, calls).replay, device, reps) / calls


def card_ms(fn, device, reps: int = 5) -> float:
    """Milliseconds a call of ``fn`` takes the device: on a card from a CUDA
    graph (:func:`graphed_ms`), so that a short kernel is not timed by the
    host's work between launches; on the CPU :func:`median_ms`."""
    device = torch.device(device)
    if device.type != "cuda":
        return median_ms(fn, device, reps)
    return graphed_ms(fn, device, reps)


class StageTimer:
    """Accumulating wall-clock stage timer that synchronises ``device``."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.stages: dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        """Add the synchronised wall seconds of the ``with`` body to
        ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def time(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` and add its synchronised wall seconds to ``name``."""
        with self.stage(name):
            return fn(*args, **kwargs)
