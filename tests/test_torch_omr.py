"""The port's whole OMR pipeline against the JAX package's, at the tiny preset.

* The JAX pipeline runs once (module fixture): its keys, host clues,
  detect, both digests (one numpy stream) and its Retriever's decode.
* The port's ``Retriever.decode_digest``, on the JAX secrets carried across
  (``secret_key_pack_from_numpy``), decodes the JAX digests to the same
  indices and payloads.
* The port's pipeline on the JAX keys carried across
  (``detection_key_from_numpy``), with the same clues and the same numpy
  stream, gives the same pertinency stack, bit-equal digests and the same
  decode.
* Every clue from ``gen_clues_device`` decrypts to 0 under its own pack.
* examples/omr_torch.py's pipeline (device clues) verifies a board.
"""

import os
import sys

import numpy as np
import jax
import pytest
import torch

from tfhe_omr_tpu.core.keygen import SecretKeyPack as JaxPack
from tfhe_omr_tpu.core.params import OmrParameters as JaxParams
from tfhe_omr_tpu.core.payload import random_payloads as jax_random_payloads
from tfhe_omr_tpu.core.sender import ClueBatch as JaxClues
from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.detector import Detector
from tfhe_omr_tpu_torch.core.keygen import (
    SecretKeyPack,
    detection_key_from_numpy,
    secret_key_pack_from_numpy,
)
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.core.sender import ClueBatch

# The suite runs in several xdist workers on one host: one torch thread each
# keeps their CPU thread pools from oversubscribing its cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

SEED = 41
ALL, PERTINENT = 24, 4


@pytest.fixture(scope="module")
def jax_omr():
    """The JAX package's pipeline on a 24-message board, 4 pertinent."""
    params = JaxParams.tiny()
    skp = JaxPack(params, rng=SEED)
    skp2 = JaxPack(params, rng=SEED + 1)
    sender, sender2 = skp.generate_sender(), skp2.generate_sender()
    dkey = skp.generate_detection_key()
    from tfhe_omr_tpu.core.detector import Detector as JaxDetector

    detector = JaxDetector(dkey, skp.ctx)
    rng = np.random.default_rng(SEED + 2)
    clues = JaxClues.concat([sender.gen_clues(PERTINENT, rng),
                             sender2.gen_clues(ALL - PERTINENT, rng)])
    payloads = jax_random_payloads(rng, ALL, params.payload_length)
    pert = np.asarray(jax.block_until_ready(detector.detect(clues)))
    retriever = skp.generate_retriever(ALL, PERTINENT)
    rp = retriever.params
    enc_rng = np.random.default_rng(SEED + 3)
    index_cts = [np.asarray(detector.encode_pertinent_indices(rp, pert, enc_rng))
                 for _ in range(rp.max_encode_indices_cipher_count)]
    digest_seed = SEED + 4
    payload_cts = np.asarray(
        detector.encode_pertinent_payloads(rp, pert, payloads, digest_seed))
    indices, solved = retriever.decode_digest(index_cts, payload_cts, digest_seed)
    assert indices == list(range(PERTINENT))
    assert np.array_equal(solved, payloads[:PERTINENT])
    return dict(skp=skp, dkey=dkey, clues=clues, payloads=payloads, pert=pert,
                index_cts=index_cts, payload_cts=payload_cts,
                digest_seed=digest_seed, indices=indices, solved=solved)


def _port_pack(run, ctx):
    skp = run["skp"]
    return secret_key_pack_from_numpy(ctx.params, skp.clue_sk, skp.inter_sk,
                                      skp.z1, skp.z2, ctx)


def test_decode_matches_jax_on_jax_digests(jax_omr):
    run = jax_omr
    port = _port_pack(run, OmrContext(OmrParameters.tiny(), "cpu"))
    retriever = port.generate_retriever(ALL, PERTINENT)
    indices, solved = retriever.decode_digest(
        run["index_cts"], run["payload_cts"], run["digest_seed"])
    assert indices == run["indices"]
    assert np.array_equal(solved, run["solved"])


def test_pipeline_on_jax_keys_matches_jax(jax_omr):
    run = jax_omr
    ctx = OmrContext(OmrParameters.tiny(), "cpu")
    dkey = run["dkey"]
    detector = Detector(detection_key_from_numpy(
        np.asarray(dkey.bsk1), np.asarray(dkey.ksk_limbs), np.asarray(dkey.bsk2),
        np.asarray(dkey.trace_k), ctx), ctx)
    clues = ClueBatch(np.asarray(run["clues"].a), np.asarray(run["clues"].b7))
    pert = detector.detect(clues)
    assert np.array_equal(pert.numpy(), run["pert"])

    retriever = _port_pack(run, ctx).generate_retriever(ALL, PERTINENT)
    rp = retriever.params
    enc_rng = np.random.default_rng(SEED + 3)
    index_cts = [detector.encode_pertinent_indices(rp, pert, enc_rng)
                 for _ in range(rp.max_encode_indices_cipher_count)]
    for got, want in zip(index_cts, run["index_cts"], strict=True):
        assert np.array_equal(got.numpy(), want)
    payload_cts = detector.encode_pertinent_payloads(
        rp, pert, run["payloads"], run["digest_seed"])
    assert np.array_equal(payload_cts.numpy(), run["payload_cts"])
    indices, solved = retriever.decode_digest(index_cts, payload_cts,
                                              run["digest_seed"])
    assert indices == run["indices"]
    assert np.array_equal(solved, run["solved"])


@pytest.mark.parametrize("preset", ["tiny", "default"])
def test_device_clues_decrypt_to_zero(preset):
    params = getattr(OmrParameters, preset)()
    skp = SecretKeyPack(params, rng=SEED, ctx=OmrContext(params, "cpu"))
    other = SecretKeyPack(params, rng=SEED + 1, ctx=OmrContext(params, "cpu"))
    sender = skp.generate_sender()
    clues = sender.gen_clues_device(20, seed=9)
    n = params.clue_params.dimension
    assert clues.a.shape == (20, n) and clues.b7.shape == (20, params.clue_count)
    q0 = params.clue_params.cipher_modulus
    assert ((clues.a >= 0) & (clues.a < q0)).all()
    for i in range(20):
        assert not skp.decrypt_compact_clue(clues.a[i], clues.b7[i]).any(), i
    # another recipient's clues do not decrypt to 0 under this pack
    foreign = other.generate_sender().gen_clues_device(4, seed=9)
    assert all(skp.decrypt_compact_clue(foreign.a[i], foreign.b7[i]).any()
               for i in range(4))
    # whole chunks are drawn, so a count's clues are a prefix of a larger one's
    head = sender.gen_clues_device_resident(5, seed=9)
    assert np.array_equal(head.numpy(), np.concatenate([clues.a, clues.b7], 1)[:5])
    assert tuple(sender.gen_clues_device_resident(0, seed=9).shape) == (
        0, n + params.clue_count)


def test_example_pipeline_tiny(tmp_path):
    """examples/omr_torch.py's pipeline with device clues: the board
    verifies, every stage is timed, no kernel launches on the CPU, and the
    CSV record is written."""
    from omr_torch import make_keys, run_board

    from tfhe_omr_tpu_torch.utils.timing import write_csv

    keys = make_keys(OmrParameters.tiny(), seed=SEED, device="cpu")
    run = run_board(keys, 16, 3, np.random.default_rng(SEED), batch=8)
    assert run.ok and run.subset_ok and run.payload_ok
    assert set(run.true_indices) <= set(run.indices)
    assert run.extras == [] and run.fp_events == []
    assert tuple(run.pertinency.shape) == (16, 2, keys.skp.params.n2)
    rec = run.rec
    assert min(rec.detect_time, rec.encode_indices_time,
               rec.encode_payloads_time, rec.decode_time) > 0
    assert all(v == {} for v in run.launches.values()), run.launches
    write_csv(str(tmp_path / "rec.csv"), [rec])
    header = (tmp_path / "rec.csv").read_text().splitlines()[0]
    assert header.startswith("device_count,payload_count,gen_clues_time")
