"""Detector.warm / warm_encoders and ShardedDetector.warm / warm_encoders
on the CPU.

On the CPU a warm runs the plain path and says so; it builds nothing. A
warm draws from no numpy stream, so a detect and both digest encoders after
it give the same bits as without it (the digests stay the JAX package's).
Imports no jax.
"""

import numpy as np
import pytest
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
from tfhe_omr_tpu_torch.core.params import OmrParameters, RetrievalParams
from tfhe_omr_tpu_torch.core.payload import random_payloads
from tfhe_omr_tpu_torch.parallel import ShardedDetector, make_data_mesh
from tfhe_omr_tpu_torch.utils import build

torch.set_num_threads(1)

TOTAL, PERTINENT, CHUNK = 20, 4, 8


@pytest.fixture(scope="module")
def keys():
    params = OmrParameters.tiny()
    skp = SecretKeyPack(params, rng=11, ctx=OmrContext(params, "cpu"))
    sender = skp.generate_sender()
    return skp, sender, skp.generate_detector()


def _board(skp, sender, det, warm):
    """A detect of 6 messages and both encoders over a random stack of
    TOTAL, each from a fresh numpy stream; ``warm`` runs first."""
    rp = RetrievalParams.for_params(skp.params, TOTAL, PERTINENT)
    if warm:
        warm(rp)
    clues = sender.gen_clues(6, np.random.default_rng(1))
    pv = det.detect(clues)
    rng = np.random.default_rng(2)
    pert = rng.integers(0, skp.params.q2, size=(TOTAL, 2, skp.params.n2), dtype=np.int64)
    payloads = random_payloads(rng, TOTAL, rp.payload_length)
    idx = det.encode_pertinent_indices(rp, pert, rng, chunk=CHUNK)
    pay = det.encode_pertinent_payloads(rp, pert, payloads, 3, chunk=CHUNK)
    return pv, idx, pay, rng.integers(0, 1 << 30)


def test_warm_and_warm_encoders_return_their_dicts_on_cpu(keys):
    skp, _sender, det = keys
    built = build._library
    st = det.warm(5)
    assert st["device"] == "cpu" and st["path"] == "plain" and st["batch"] == 5
    assert st["first_launch_s"] > 0 and st["build_s"] >= 0 and "nvcc_s" in st
    rp = RetrievalParams.for_params(skp.params, TOTAL, PERTINENT)
    enc = det.warm_encoders(rp, TOTAL, chunk=CHUNK)
    assert enc["path"] == "plain" and enc["rows"] == CHUNK
    assert enc["index_s"] > 0 and enc["payload_s"] > 0
    assert det.warm_encoders(rp, 3, chunk=CHUNK)["rows"] == 3
    assert build._library is built  # nothing was built


def test_results_after_warm_are_the_results_without_it(keys):
    """The no-draw check: detect, index and payload digests, and the next
    draw of the caller's stream are the same with and without the warms."""
    skp, sender, det = keys
    cold = _board(skp, sender, det, None)

    def warm(rp):
        det.warm(6)
        det.warm_encoders(rp, TOTAL, chunk=CHUNK)

    warmed = _board(skp, sender, det, warm)
    for a, b in zip(cold[:3], warmed[:3]):
        assert torch.equal(a, b)
    assert cold[3] == warmed[3]


def test_sharded_warm_covers_every_replica(keys):
    """Over three CPU replicas (one detector object on the host), each gets
    its shard's size of the batch, in the replicas' order."""
    _skp, _sender, det = keys
    sharded = ShardedDetector(det, make_data_mesh(["cpu"] * 3))
    st = sharded.warm(7)
    assert [s["batch"] for s in st] == [2, 2, 3]
    assert [s["device"] for s in st] == ["cpu"] * 3
    assert all(s["path"] == "plain" and s["first_launch_s"] > 0 for s in st)
    assert [s["batch"] for s in sharded.warm(2)] == [0, 1, 1]


def test_sharded_warm_encoders_cover_every_replica(keys):
    """Each of three CPU replicas warms the chunk shape of its own shard;
    an empty shard launches nothing."""
    skp, _sender, det = keys
    sharded = ShardedDetector(det, make_data_mesh(["cpu"] * 3))
    rp = RetrievalParams.for_params(skp.params, TOTAL, PERTINENT)
    st = sharded.warm_encoders(rp, TOTAL, chunk=6)
    assert [s["rows"] for s in st] == [6, 6, 6]  # shards of 20: 6, 7, 7 in chunks of 6
    assert [s["rows"] for s in sharded.warm_encoders(rp, TOTAL, chunk=CHUNK)] == [6, 7, 7]
    assert all(s["path"] == "plain" and s["index_s"] > 0 and s["payload_s"] > 0
               for s in st)
    assert [s["rows"] for s in sharded.warm_encoders(rp, 2, chunk=CHUNK)] == [0, 1, 1]
