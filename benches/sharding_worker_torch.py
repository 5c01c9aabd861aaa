"""Worker of benches/sharding_bench_torch.py --cpu-scaling: one rank.

Each process holds one CPU replica and is pinned to one core by its parent,
so 1 -> 2 processes measures what one more process brings to the sharded
pipeline: detect over the rank's rows and both digest encoders with their
all_reduce over gloo. Same-seed keys on every rank, tiny parameters.

Usage: sharding_worker_torch.py <coordinator> <num_procs> <rank> <out.json>
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

torch.set_num_threads(1)


def main():
    coordinator, num_procs, rank, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    batch = int(os.environ.get("SHARD_BENCH_BATCH", "64"))
    reps = int(os.environ.get("SHARD_BENCH_REPS", "3"))

    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.core.payload import random_payloads
    from tfhe_omr_tpu_torch.parallel import ShardedDetector, distributed, make_data_mesh

    if num_procs > 1:
        n_global = distributed.init(coordinator, num_procs, rank, device="cpu")
        assert n_global == num_procs, n_global

    params = OmrParameters.tiny()
    skp = SecretKeyPack(params, rng=21, ctx=OmrContext(params, "cpu"))
    detector = skp.generate_detector()
    rng = np.random.default_rng(5)
    clues = skp.generate_sender().gen_clues(batch, rng)
    sharded = ShardedDetector(detector, make_data_mesh(["cpu"]))
    rp = skp.generate_retriever(batch, 8).params
    payloads = random_payloads(rng, batch, params.payload_length)
    enc_rng = np.random.default_rng(9)

    t0 = time.perf_counter()
    for _ in range(reps):
        pert = sharded.detect(clues)
    detect_s = (time.perf_counter() - t0) / reps

    t0 = time.perf_counter()
    for _ in range(reps):
        sharded.encode_pertinent_indices(rp, pert, enc_rng)
        sharded.encode_pertinent_payloads(rp, pert, payloads, 3)
    encode_s = (time.perf_counter() - t0) / reps

    if rank == 0:
        with open(out_path, "w") as fh:
            json.dump({
                "num_procs": num_procs,
                "batch": batch,
                "detect_s": round(detect_s, 3),
                "encode_s": round(encode_s, 3),
                "detect_msgs_per_s": round(batch / detect_s, 2),
            }, fh)
    distributed.shutdown()


if __name__ == "__main__":
    main()
