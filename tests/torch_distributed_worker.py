"""Worker of tests/test_torch_distributed.py: one rank of a gloo group.

Each process holds 2 CPU replicas, so 2 processes make 4 global shards
(ranks x local devices): ``distributed.init``, same-seed key generation on
every rank, sharded detect of a ragged batch (each rank keeps its rows),
both digest encoders with the int64 all_reduce across the processes. Rank 0
writes the gathered stack and the digests to an .npz for the test to hold
against a single-process run. Imports torch and numpy, never jax.

Usage: torch_distributed_worker.py <coordinator> <num_procs> <rank> <out.npz>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

LOCAL_REPLICAS = 2
COUNT = 11  # 4 shards of 2, 3, 3, 3 messages


def main():
    coordinator, num_procs, rank, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.core.payload import random_payloads
    from tfhe_omr_tpu_torch.parallel import (
        RankRows, ShardedDetector, distributed, make_data_mesh)

    n_ranks = distributed.init(coordinator, num_procs, rank, device="cpu")
    assert distributed.is_multihost() and n_ranks == num_procs, n_ranks

    params = OmrParameters.tiny()
    skp = SecretKeyPack(params, rng=21, ctx=OmrContext(params, "cpu"))  # same seed on every rank
    detector = skp.generate_detector()
    clues = skp.generate_sender().gen_clues(COUNT, np.random.default_rng(22))

    mesh = make_data_mesh(["cpu"] * LOCAL_REPLICAS)
    assert (mesh.rank, mesh.world, mesh.n_dev) == (rank, num_procs,
                                                   num_procs * LOCAL_REPLICAS)
    sharded = ShardedDetector(detector, mesh)
    pv = sharded.detect(clues)
    b = sharded.bounds(COUNT)
    lo, hi = b[rank * LOCAL_REPLICAS], b[(rank + 1) * LOCAL_REPLICAS]
    assert isinstance(pv, RankRows) and (pv.lo, pv.total) == (lo, COUNT)
    assert sum(p.shape[0] for p in pv.parts) == hi - lo  # this rank's rows only

    rp = skp.generate_retriever(COUNT, 2).params
    idx_ct = sharded.encode_pertinent_indices(rp, pv, np.random.default_rng(7), chunk=2)
    payloads = random_payloads(np.random.default_rng(8), COUNT, rp.payload_length)
    pay_cts = sharded.encode_pertinent_payloads(rp, pv, payloads, 9, chunk=2)

    pv_np = sharded.gather(pv)  # a collective: every rank calls it
    if rank == 0:
        np.savez(out_path, pv=pv_np, idx_ct=idx_ct.numpy(), pay_cts=pay_cts.numpy())
    distributed.shutdown()


if __name__ == "__main__":
    main()
