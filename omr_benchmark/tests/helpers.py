"""Shared by the benchmark's CPU tests: the small parameter set, each
cell at small sizes, and a run of a cell on CPU replicas with the card
check skipped."""

from __future__ import annotations

import json
import time
from dataclasses import replace
from pathlib import Path

import torch

from omr_benchmark import harness

TINY = json.loads((Path(__file__).parent / "tiny.json").read_text())
SEED = 2**31 + 91
#: each cell's traffic at sizes a CPU test holds
SMALL = {
    "detect_b1024": ({}, {"batch": 4, "distinct_batches": 2, "pertinent": 1,
                          "per_messages": 4, "check_rows": 8}),
    "board_d4096": ({"board_messages": 8, "pertinent": 2},
                    {"detect_batch": 4, "distinct_boards": 2, "check_rows": 6}),
    "latency_d1": ({"board_messages": 1, "pertinent": 1},
                   {"distinct_boards": 3, "check_rows": 4, "check_digest_runs": 2}),
    "board_d16384_x4": ({"board_messages": 2, "pertinent": 2},
                        {"detect_batch": 2, "check_rows": 6}),
}


def small_cell(name: str) -> harness.Cell:
    """The cell with the small parameter set and its traffic at small sizes."""
    cfg_over, traffic = SMALL[name]
    cell = harness.load_cell(name)
    return replace(cell, cfg={**TINY, **cfg_over}, traffic={**cell.traffic, **traffic})


def run(cell: harness.Cell, trace: bool = False, seconds: float = 0.0, seed: int = SEED) -> dict:
    torch.set_num_threads(1)
    devices = [torch.device("cpu")] * cell.chips
    return harness.run_cell(cell, seed, seconds, trace, devices, time.perf_counter())
