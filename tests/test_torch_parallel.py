"""The port's sharded detection and digests against the JAX package's.

The twin of tests/test_parallel.py. The same numpy inputs go through the
JAX ``ShardedDetector`` on the 8 virtual CPU devices of this suite's
conftest and through the port's over ``["cpu"] * n`` for n in {1, 2, 3, 8}
(3 gives uneven shards, 8 gives shards of one or two messages), with the
detection key made by the JAX package and carried across: ``detect`` on 16
and on a ragged 11 clues, ``encode_chunk`` and both full digest encoders
with ``chunk=8``. The port's sharded results must equal the port's
single-device ones and the JAX package's sharded ones. Tolerance: none, the
math is exact integer arithmetic.

One ``slow`` case runs the same at the default rings with the digest layout
of D = 65536, as tests/test_parallel.py does.
"""

import numpy as np
import jax
import pytest
import torch

from tfhe_omr_tpu.core.keygen import SecretKeyPack as JaxPack
from tfhe_omr_tpu.core.params import OmrParameters as JaxParams
from tfhe_omr_tpu.core.params import RetrievalParams as JaxRetrievalParams
from tfhe_omr_tpu.core.sender import ClueBatch as JaxClues
from tfhe_omr_tpu.parallel import ShardedDetector as JaxSharded
from tfhe_omr_tpu.parallel import make_data_mesh as jax_make_data_mesh
from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.detector import Detector
from tfhe_omr_tpu_torch.core.keygen import detection_key_from_numpy
from tfhe_omr_tpu_torch.core.params import OmrParameters, RetrievalParams
from tfhe_omr_tpu_torch.core.payload import random_payloads
from tfhe_omr_tpu_torch.core.sender import ClueBatch
from tfhe_omr_tpu_torch.parallel import ShardedDetector, make_data_mesh

# The suite runs in several xdist workers on one host: one torch thread each
# keeps their CPU thread pools from oversubscribing its cores.
torch.set_num_threads(1)

SHARDS = [1, 2, 3, 8]
COUNT, RAGGED, CHUNK = 16, 11, 8


def _carry(dkey, ctx) -> Detector:
    """The port's Detector on a detection key made by the JAX package."""
    key = detection_key_from_numpy(
        np.asarray(dkey.bsk1), np.asarray(dkey.ksk_limbs),
        np.asarray(dkey.bsk2), np.asarray(dkey.trace_k), ctx)
    return Detector(key, ctx)


def _both(jparams, params, seed, total, pertinent):
    """One run of the JAX sharded path and the port's single-device path on
    the same keys, clues, payloads and numpy streams."""
    skp = JaxPack(jparams, rng=seed)
    jdet = skp.generate_detector()
    clues = skp.generate_sender().gen_clues(COUNT, np.random.default_rng(seed + 1))
    jsh = JaxSharded(jdet, jax_make_data_mesh())
    assert jsh.n_dev == 8
    rp = RetrievalParams.for_params(params, total, pertinent)
    jrp = JaxRetrievalParams(**rp.__dict__)
    payloads = random_payloads(np.random.default_rng(8), COUNT, rp.payload_length)
    jpv = jsh.detect(clues)
    want = {
        "detect": np.asarray(jpv),
        "ragged": np.asarray(jsh.detect(JaxClues(clues.a[:RAGGED], clues.b7[:RAGGED]))),
        "idx": np.asarray(jsh.encode_pertinent_indices(
            jrp, jpv, np.random.default_rng(7), chunk=CHUNK)),
        "pay": np.asarray(jsh.encode_pertinent_payloads(
            jrp, jpv, payloads, 9, chunk=CHUNK)),
    }
    plain = jdet.build_index_plaintexts(jrp, COUNT, np.random.default_rng(5))
    want["chunk"] = np.asarray(jsh.encode_chunk(jpv, plain))
    jax.block_until_ready(jpv)

    det = _carry(jdet.key, OmrContext(params, "cpu"))
    clues = ClueBatch(np.asarray(clues.a), np.asarray(clues.b7))
    single = det.detect(clues)
    assert np.array_equal(single.numpy(), want["detect"])
    return det, clues, rp, payloads, np.asarray(plain), single, want


@pytest.fixture(scope="module")
def tiny():
    return _both(JaxParams.tiny(), OmrParameters.tiny(), 21, COUNT, 4)


def test_jax_mesh_has_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n", SHARDS)
def test_mesh_over_cpu_replicas(n):
    mesh = make_data_mesh(["cpu"] * n)
    assert mesh.n_dev == n and mesh.world == 1 and mesh.rank == 0
    assert all(d == torch.device("cpu") for d in mesh.devices)


def test_mesh_defaults_to_the_cards_and_never_to_the_host():
    """With no card the default mesh raises, naming the way to the CPU."""
    if torch.cuda.is_available():
        assert make_data_mesh().devices[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        make_data_mesh()


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_detect_matches_single_and_jax(tiny, n):
    det, clues, _rp, _pay, _plain, single, want = tiny
    sharded = ShardedDetector(det, make_data_mesh(["cpu"] * n))
    got = sharded.detect(clues)
    assert torch.equal(got, single)
    np.testing.assert_array_equal(got.numpy(), want["detect"])
    np.testing.assert_array_equal(sharded.gather(got), want["detect"])


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_detect_splits_ragged_batches(tiny, n):
    """A batch the shard count does not divide: uneven shards, no padding,
    the same rows."""
    det, clues, _rp, _pay, _plain, single, want = tiny
    sharded = ShardedDetector(det, make_data_mesh(["cpu"] * n))
    sizes = np.diff(sharded.bounds(RAGGED))
    assert sizes.sum() == RAGGED and sizes.max() - sizes.min() <= 1
    got = sharded.detect(ClueBatch(clues.a[:RAGGED], clues.b7[:RAGGED]))
    assert got.shape[0] == RAGGED
    assert torch.equal(got, single[:RAGGED])
    np.testing.assert_array_equal(got.numpy(), want["ragged"])


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_encode_chunk_matches_single_and_jax(tiny, n):
    det, _clues, _rp, _pay, plain, single, want = tiny
    sharded = ShardedDetector(det, make_data_mesh(["cpu"] * n))
    zero = torch.zeros((2, single.shape[2]), dtype=torch.int64)
    one = det._encode_chunk(single, torch.as_tensor(plain), zero, det._fwd(False))
    got = sharded.encode_chunk(single, plain)
    assert torch.equal(got, one)
    np.testing.assert_array_equal(got.numpy(), want["chunk"])


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_full_digests_match_single_and_jax(tiny, n):
    """Both encoders through the sharded reduce, same numpy streams."""
    det, _clues, rp, payloads, _plain, single, want = tiny
    sharded = ShardedDetector(det, make_data_mesh(["cpu"] * n))
    s_idx = det.encode_pertinent_indices(rp, single, np.random.default_rng(7),
                                         chunk=CHUNK)
    m_idx = sharded.encode_pertinent_indices(rp, single, np.random.default_rng(7),
                                             chunk=CHUNK)
    assert torch.equal(m_idx, s_idx)
    np.testing.assert_array_equal(m_idx.numpy(), want["idx"])
    s_pay = det.encode_pertinent_payloads(rp, single, payloads, 9, chunk=CHUNK)
    m_pay = sharded.encode_pertinent_payloads(rp, single, payloads, 9, chunk=CHUNK)
    assert torch.equal(m_pay, s_pay)
    np.testing.assert_array_equal(m_pay.numpy(), want["pay"])


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_digests_of_a_board_shorter_than_the_layout(tiny, n):
    """The weight stream is drawn for the layout's board and prefix-sliced:
    11 messages under a 16-message layout, split unevenly."""
    det, _clues, rp, payloads, _plain, single, _want = tiny
    sharded = ShardedDetector(det, make_data_mesh(["cpu"] * n))
    pv, pay = single[:RAGGED], payloads[:RAGGED]
    assert torch.equal(
        sharded.encode_pertinent_payloads(rp, pv, pay, 9, chunk=4),
        det.encode_pertinent_payloads(rp, pv, pay, 9, chunk=CHUNK))
    assert torch.equal(
        sharded.encode_pertinent_indices(rp, pv, np.random.default_rng(3), chunk=4),
        det.encode_pertinent_indices(rp, pv, np.random.default_rng(3), chunk=CHUNK))


def test_replica_on_its_own_device_is_the_detector(tiny):
    det = tiny[0]
    assert det.to("cpu") is det
    sharded = ShardedDetector(det, make_data_mesh(["cpu"] * 3))
    assert all(rep is det for rep in sharded.replicas)


def test_encoders_refuse_a_whole_stack_across_ranks(tiny):
    det, _clues, rp, _pay, _plain, single, _want = tiny
    sharded = ShardedDetector(det, make_data_mesh(["cpu"]))
    sharded.mesh = type(sharded.mesh)(sharded.mesh.devices, rank=0, world=2)
    with pytest.raises(ValueError, match="RankRows"):
        sharded.encode_pertinent_indices(rp, single, np.random.default_rng(1))


@pytest.mark.slow
def test_sharded_default_params_match_single_and_jax():
    """The same at the reference parameter set: 16 messages, the digest
    layout of D = 65536 (5 index cts, 28 payload cts), 3 uneven shards."""
    det, clues, rp, payloads, _plain, single, want = _both(
        JaxParams.default(), OmrParameters.default(), 51, 65536, 50)
    assert rp.max_encode_indices_cipher_count == 5 and rp.cmb_cipher_count == 28
    sharded = ShardedDetector(det, make_data_mesh(["cpu"] * 3))
    got = sharded.detect(clues)
    assert torch.equal(got, single)
    m_idx = sharded.encode_pertinent_indices(rp, got, np.random.default_rng(7),
                                             chunk=CHUNK)
    np.testing.assert_array_equal(m_idx.numpy(), want["idx"])
    m_pay = sharded.encode_pertinent_payloads(rp, got, payloads, 9, chunk=CHUNK)
    np.testing.assert_array_equal(m_pay.numpy(), want["pay"])
