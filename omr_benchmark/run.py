"""The benchmark of tfhe_omr_tpu_torch: one run of one cell of
BENCHMARK.json on the cards of this machine.

    python3 omr_benchmark/run.py --workload detect_b1024 --seed 7 --seconds 20 --trace 0

Prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones from a profiled window),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number that decides ``correct`` with its limit, also the last lines of
standard error. Exits non-zero with no result where there is no CUDA card,
fewer cards than the cell asks for, or where a module of JAX or of the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run lives at a fixed path in the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("omr_benchmark: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from omr_benchmark import harness

    cell = harness.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"omr_benchmark: {cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    torch.cuda.set_device(devices[0])
    try:
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), devices,
                                  T_START)
    except harness.BenchError as err:
        print(f"omr_benchmark: {err}", file=sys.stderr)
        return 3
    times = result.pop("item_seconds", None)
    if times:
        q = sorted(times)
        print(f"items {len(q)}: min {q[0]:.4f} median {q[len(q) // 2]:.4f} "
              f"max {q[-1]:.4f} s; set-up stamps {result['setup_stamps_s']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
