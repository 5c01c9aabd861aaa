"""The control of ``correct``: the reference in the program's place with
the key switch's sums in float32 (TF32 off), the nearest precision below
the float64 that the configurations state, read as a run reads the
program: ``detect_words_off`` of a cell's sample of rows (a quarter of them
the recipient's), at the cell's parameters, once a seed.

    python3 omr_benchmark/control.py --workload detect_b1024 --seeds 11,12,13

Prints one JSON line a seed. Needs a CUDA card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from omr_benchmark import inputs, reference  # noqa: E402

CONTROL_DTYPE = torch.float32


def reading(cfg: dict, rows: int, seed: int, device) -> int:
    """Words of ``rows`` pertinency ciphertexts in which the control
    differs from the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    omr = reference.Omr(reference.Params(cfg), device, seed)
    key = omr.detection_key()
    mask = np.zeros(rows, dtype=bool)
    mask[: max(1, rows // 4)] = True
    clues = inputs.clues(omr, mask)
    want = omr.detect(clues, key)
    return int((omr.detect(clues, key, CONTROL_DTYPE) != want).sum())


def main() -> int:
    from omr_benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        off = reading(cell.cfg, cell.traffic["check_rows"], seed, torch.device("cuda", 0))
        print(json.dumps({"workload": cell.name, "seed": seed, "detect_words_off": off,
                          "words": cell.traffic["check_rows"] * 2 * cell.cfg["second_level_br"]["dimension"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
