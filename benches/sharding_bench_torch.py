"""Sharding-overhead measurements on the PyTorch / CUDA port.

The counterpart of benches/sharding_bench.py for ``tfhe_omr_tpu_torch``:

(a) ``--card``: warm detect through the plain ``Detector`` against the
    ``ShardedDetector`` over a one-device mesh, on one device in one
    process: what the sharded path's splitting and bookkeeping cost by
    themselves (it should add no synchronisation). Several detect calls
    back to back, one synchronisation at the end, in the order plain,
    sharded, sharded, plain; also whether both outputs are bit-equal.

(b) ``--cpu-scaling``: 1 -> 2 (-> 4) OS processes of the whole sharded
    pipeline (detect + both digest encoders with the all_reduce over gloo)
    on the CPU at the tiny preset, one replica and one pinned core per
    process (benches/sharding_worker_torch.py). Speed-up across several
    cards needs a machine with several cards: run ``examples/omr_torch.py
    --sharded`` there.

Usage: python benches/sharding_bench_torch.py --card [--batch 1024] [--reps 3]
       python benches/sharding_bench_torch.py --cpu-scaling [--batch 64] [--procs 1,2,4]

``--card`` runs on the card unless ``--device cpu`` (with ``--tiny``) is
given; with no card it exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def run_card(batch: int, reps: int, tiny: bool, device_arg: str):
    import torch

    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.parallel import ShardedDetector, make_data_mesh
    from tfhe_omr_tpu_torch.utils.build import resolve_device
    from tfhe_omr_tpu_torch.utils.timing import synchronize

    try:
        device = resolve_device(device_arg)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"sharding_bench_torch: {err}")
    params = OmrParameters.tiny() if tiny else OmrParameters.default()
    skp = SecretKeyPack(params, rng=0, ctx=OmrContext(params, device))
    detector = skp.generate_detector()
    clues = skp.generate_sender().gen_clues(batch, np.random.default_rng(1))
    sharded = ShardedDetector(detector, make_data_mesh([device]))

    def streamed(runner) -> float:
        """Seconds per batch of ``reps`` detects with one synchronisation."""
        t0 = time.perf_counter()
        for _ in range(reps):
            runner.detect(clues)
        synchronize(device)
        return (time.perf_counter() - t0) / reps

    out = detector.detect(clues)  # warm both paths
    out_s = sharded.detect(clues)
    synchronize(device)
    plain_a, shard_a = streamed(detector), streamed(sharded)
    shard_b, plain_b = streamed(sharded), streamed(detector)
    plain_s, shard_s = (plain_a + plain_b) / 2, (shard_a + shard_b) / 2
    print(json.dumps({
        "mode": "card_1dev_mesh",
        "batch": batch,
        "plain_s_per_batch": plain_s,
        "sharded_s_per_batch": shard_s,
        "overhead_pct": 100.0 * (shard_s / plain_s - 1.0),
        "runs_s_per_batch": {"plain": [plain_a, plain_b], "sharded": [shard_a, shard_b]},
        "bit_exact": bool(np.array_equal(out.cpu().numpy(), sharded.gather(out_s))),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_cpu_scaling(batch: int, procs_list):
    results = []
    env = dict(os.environ, SHARD_BENCH_BATCH=str(batch), OMP_NUM_THREADS="1")
    worker = os.path.join(HERE, "sharding_worker_torch.py")
    ncores = os.cpu_count() or 1
    for n in procs_list:
        with tempfile.TemporaryDirectory() as tmp:
            out_path = os.path.join(tmp, "out.json")
            coordinator = f"127.0.0.1:{_free_port()}"
            handles = [subprocess.Popen(
                ["taskset", "-c", str(rank % ncores), sys.executable, worker,
                 coordinator, str(n), str(rank), out_path],
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                for rank in range(n)]
            errs = [h.communicate(timeout=1800)[1] for h in handles]
            if any(h.returncode for h in handles):
                sys.exit("sharding_bench_torch: a worker failed:\n" + "\n".join(errs))
            with open(out_path) as fh:
                results.append(json.load(fh))
    base = results[0]
    for r in results:
        # strong scaling: one batch split over n single-core processes
        speedup = (base["detect_s"] + base["encode_s"]) / (r["detect_s"] + r["encode_s"])
        r["speedup_vs_1proc"] = round(speedup, 3)
        r["scaling_efficiency"] = round(speedup / r["num_procs"], 3)
    print(json.dumps({"mode": "cpu_process_scaling", "runs": results}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--cpu-scaling", action="store_true")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--procs", default="1,2,4")
    ap.add_argument("--tiny", action="store_true",
                    help="--card at the small test preset")
    ap.add_argument("--device", default="cuda",
                    help="--card: cuda (the default; fails when no card is "
                         "present) or cpu")
    args = ap.parse_args()
    if not (args.card or args.cpu_scaling):
        ap.error("give --card or --cpu-scaling")
    if args.card:
        run_card(args.batch or 1024, args.reps, args.tiny, args.device)
    if args.cpu_scaling:
        run_cpu_scaling(args.batch or 64, [int(x) for x in args.procs.split(",")])


if __name__ == "__main__":
    main()
