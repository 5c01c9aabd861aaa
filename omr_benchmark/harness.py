"""One run of one cell: inputs and keys from the seed, the program's
set-up, the measured window, the comparison that decides ``correct``, and
the metrics read by their own readers.

Everything that belongs to one cell is found by name:

* ``BENCHMARK.json`` names the cell's configuration, traffic and chips;
* ``omr_benchmark/configs/<config>.json`` holds the configuration as run;
* ``omr_benchmark/traffic/<traffic>.json`` holds the traffic's parameters
  and names its loop, ``omr_benchmark/loops/<loop>.py`` (``setup``,
  ``window``, ``check``);
* ``omr_benchmark/metrics/<metric>.py`` reads one metric (``read(run)``,
  None where it finds nothing to read).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import subprocess
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import torch

from omr_benchmark import reference, trace_read

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tfhe_omr_tpu"})


class BenchError(RuntimeError):
    """A run that cannot give a result."""


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise BenchError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "omr_benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, w["chips"], cfg, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], root)


def _module(path: Path):
    """A loop or metric module, loaded from its file."""
    name = f"omr_benchmark._{path.parent.name}.{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Spans:
    """Spans of the benchmark's own code around calls into the program.
    Traced, each is a profiler range that ends in a synchronisation of every
    device, and its host seconds are kept by name; untraced, nothing."""

    def __init__(self, devices, traced: bool):
        self.devices, self.traced = devices, traced
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.traced:
            yield
            return
        from torch.profiler import record_function

        with record_function(trace_read.SPAN + name):
            t0 = time.perf_counter()
            yield
            sync(self.devices)
            self.seconds[name].append(time.perf_counter() - t0)


@dataclass
class Ctx:
    """What a loop's ``setup`` gets: the cell, the reference (which made
    every input), the keys where the reference made them (the program's
    ``Detector`` takes them there, and the check reads them again), the
    devices and the seed."""

    cell: Cell
    omr: reference.Omr
    key: dict
    devices: list
    seed: int


@dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    setup_s: float
    record: dict
    spans: dict
    trace: trace_read.Summary | None
    clock: dict = field(default_factory=dict)


def card_clock(device: torch.device) -> dict:
    """SMs, top SM clock, name and power limit of a card (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0),
         "--query-gpu=clocks.max.sm,power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split(",")
    return {"sms": torch.cuda.get_device_properties(device).multi_processor_count,
            "clock_mhz": float(out[0]), "power_limit_w": float(out[1])}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, devices: list,
             t_start: float) -> dict:
    """One run; ``t_start`` is the process's start on the host clock."""
    dev0 = devices[0]
    on_card = dev0.type == "cuda"
    stamps = {"imports": time.perf_counter() - t_start}
    omr = reference.Omr(reference.Params(cell.cfg), dev0, seed)
    key = omr.detection_key()
    stamps["keys_made"] = time.perf_counter() - t_start
    if on_card:
        torch.cuda.empty_cache()
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    spans = Spans(devices, trace)
    loop = _module(cell.root / "omr_benchmark" / "loops" / f"{cell.traffic['loop']}.py")
    state = loop.setup(Ctx(cell, omr, key, devices, seed))
    sync(devices)
    setup_s = time.perf_counter() - t_start
    stamps["window_start"] = setup_s

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.start()
        with record_function(trace_read.WINDOW):
            record = loop.window(state, seconds, spans)
        prof.stop()
    else:
        record = loop.window(state, seconds, spans)
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices), default=0) if on_card else 0
    summary = trace_read.summarise(prof, devices) if prof is not None else None
    del prof
    checks = loop.check(state, record)
    del state
    gc.collect()

    run = Run(cell, setup_s, record, dict(spans.seconds), summary,
              card_clock(dev0) if trace and on_card else {})
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = _module(cell.root / "omr_benchmark" / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(dev0) if on_card else "cpu",
              "count": len(devices), "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": record["items"], "failed": record.get("failed", 0),
           "metrics": metrics, "device": device}
    if summary is not None:
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = summary.breakdown()
    out["setup_stamps_s"] = stamps
    out["item_seconds"] = record.get("item_s")
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    # last, so that it covers every module the result rests on: the check
    # and the readers load theirs after the window
    found = forbidden_modules()
    if found:
        raise BenchError(f"modules loaded in this process that the run may not load: {found}")
    return out

