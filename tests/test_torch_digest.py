"""The port's digest encoders against the JAX package, bit for bit.

* The committed golden pins: the port's encoders, given the golden
  ``detect_tiny`` stack and the numpy streams of tests/test_golden.py,
  reproduce ``digest_idx_tiny`` and ``digest_pay_tiny``.
* ``encode_pertinent_indices`` / ``encode_pertinent_payloads`` of both
  packages on one seeded random pertinency stack: at the tiny preset with a
  ragged tail (D = 40, chunk 16) and with D < chunk, and at the default
  rings with D = 300, chunk 128, which has the digest layout of D = 65536
  (2 index digits per bucket, 5 segments, 55 combinations in 28 cts). The
  encoders read no detection key, so the JAX detectors hold none; the
  default-ring one takes its context from a pack with the reduced LWE
  dimensions of tests/test_torch_bootstrap.py.
* The port's plaintext builders against the JAX package's host builders
  (the twin of
  tests/test_omr_roundtrip.py::test_device_encoders_match_host_plaintext_path).
* ``sample_weights`` equal to the JAX one.
"""

import os
from dataclasses import replace

import numpy as np
import jax
import pytest
import torch

from tfhe_omr_tpu.core.detector import Detector as JaxDetector
from tfhe_omr_tpu.core.detector import sample_weights as jax_sample_weights
from tfhe_omr_tpu.core.keygen import DetectionKey as JaxDetectionKey
from tfhe_omr_tpu.core.keygen import SecretKeyPack as JaxPack
from tfhe_omr_tpu.core.params import KeySwitchParams as JaxKs
from tfhe_omr_tpu.core.params import LweParams as JaxLwe
from tfhe_omr_tpu.core.params import OmrParameters as JaxParams
from tfhe_omr_tpu.core.params import RetrievalParams as JaxRetrievalParams
from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.detector import Detector, sample_weights
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
from tfhe_omr_tpu_torch.core.params import (
    KeySwitchParams,
    LweParams,
    OmrParameters,
    RetrievalParams,
)
from tfhe_omr_tpu_torch.core.payload import random_payloads
from tfhe_omr_tpu_torch.ops.encode import index_poly_device, payload_plain_device

# The suite runs in several xdist workers on one host: one torch thread each
# keeps their CPU thread pools from oversubscribing its cores.
torch.set_num_threads(1)

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "golden", "golden_vectors.npz")
GOLDEN_SEED = 20250817  # tests/test_golden.py's SEED


def _reduced(base, lwe, ks):
    """The default rings with the reduced LWE dimensions of
    tests/test_torch_bootstrap.py (32 clue, 16 intermediate coefficients)."""
    return replace(
        base.default(),
        clue_params=lwe(32, 8, 2048, "binary", 0.8293),
        first_level_ks=ks(1024, 16, 27, 1, 10.0),
        intermediate_lwe=lwe(16, 32, 4096, "binary", 10.3260),
    )


PRESETS = {
    "tiny": (OmrParameters.tiny, JaxParams.tiny),
    "default": (lambda: _reduced(OmrParameters, LweParams, KeySwitchParams),
                lambda: _reduced(JaxParams, JaxLwe, JaxKs)),
}


@pytest.fixture(scope="module", params=sorted(PRESETS))
def detectors(request):
    """(preset, port detector, JAX detector) on the preset's rings."""
    port_params, jax_params = (f() for f in PRESETS[request.param])
    port = SecretKeyPack(
        port_params, rng=5, ctx=OmrContext(port_params, "cpu")).generate_detector()
    jax_det = JaxDetector(JaxDetectionKey(*([None] * 7)),
                          JaxPack(jax_params, rng=5).ctx)
    return request.param, port, jax_det


def test_golden_digests_reproduced():
    golden = np.load(GOLDEN_PATH)
    params = OmrParameters.tiny(noise_free=True)
    detector = SecretKeyPack(
        params, rng=GOLDEN_SEED, ctx=OmrContext(params, "cpu")).generate_detector()
    rp = RetrievalParams.for_params(params, 4, 2)
    pert = golden["detect_tiny"]
    idx = detector.encode_pertinent_indices(
        rp, pert, np.random.default_rng(GOLDEN_SEED + 3))
    assert np.array_equal(idx.numpy(), golden["digest_idx_tiny"])
    payloads = random_payloads(np.random.default_rng(GOLDEN_SEED + 4), 4,
                               rp.payload_length)
    pay = detector.encode_pertinent_payloads(rp, pert, payloads, GOLDEN_SEED + 5)
    assert np.array_equal(pay.numpy(), golden["digest_pay_tiny"])


# (preset, D, pertinent, chunk): a scan plus a ragged tail, D < chunk, and
# the default rings with the D = 65536 digest layout
CASES = {
    "tiny": [(40, 8, 16), (10, 4, 16)],
    "default": [(300, 50, 128)],
}


def test_encoders_match_jax(detectors):
    preset, port, jax_det = detectors
    params = port.ctx.params
    for total, pertinent, chunk in CASES[preset]:
        rp = RetrievalParams.for_params(params, total, pertinent)
        jrp = JaxRetrievalParams(**rp.__dict__)
        if preset == "default":
            assert (rp.index_slots_per_bucket, rp.segment_per_cipher,
                    rp.max_encode_indices_cipher_count, rp.combination_count,
                    rp.cmb_cipher_count) == (2, 5, 5, 55, 28)
        rng = np.random.default_rng(total)
        pert = rng.integers(0, params.q2, size=(total, 2, params.n2), dtype=np.int64)
        payloads = random_payloads(rng, total, rp.payload_length)

        want = np.asarray(jax.block_until_ready(jax_det.encode_pertinent_indices(
            jrp, pert, np.random.default_rng(1), chunk=chunk)))
        got = port.encode_pertinent_indices(rp, torch.as_tensor(pert),
                                            np.random.default_rng(1), chunk=chunk)
        assert got.shape == (2, params.n2)
        assert np.array_equal(got.numpy(), want), (preset, total, chunk)

        want = np.asarray(jax.block_until_ready(jax_det.encode_pertinent_payloads(
            jrp, pert, payloads, 77, chunk=chunk)))
        got = port.encode_pertinent_payloads(rp, pert, payloads, 77, chunk=chunk)
        assert got.shape == (rp.cmb_cipher_count, 2, params.n2)
        assert np.array_equal(got.numpy(), want), (preset, total, chunk)
        # plain=True runs the same plain NTT on the CPU
        assert torch.equal(got, port.encode_pertinent_payloads(
            rp, pert, payloads, 77, chunk=chunk, plain=True))


def test_device_builders_match_host_builders(detectors):
    """The port's scatter-built plaintexts equal the JAX package's host
    builders' on the same bucket draws and weights, and the port's encoders
    equal a chunked sum of those plaintexts through ``_encode_chunk``."""
    _preset, port, jax_det = detectors
    params = port.ctx.params
    q2 = params.q2
    count, chunk = 24, 16
    rp = RetrievalParams.for_params(params, count, 4)
    jrp = JaxRetrievalParams(**rp.__dict__)
    rng = np.random.default_rng(22)
    pert = torch.as_tensor(
        rng.integers(0, q2, size=(count, 2, params.n2), dtype=np.int64))

    host = jax_det.build_index_plaintexts(jrp, count, np.random.default_rng(7))
    buckets = np.random.default_rng(7).integers(
        0, rp.bucket_count_per_segment, size=(count, rp.segment_per_cipher),
        dtype=np.int64)
    base = (np.arange(rp.segment_per_cipher)[None, :] * rp.slots_per_segment
            + buckets * rp.slots_per_bucket)
    dev = index_poly_device(torch.as_tensor(base), torch.arange(count),
                            rp.index_slots_per_bucket, rp.polynomial_size,
                            rp.index_modulus, q2)
    assert np.array_equal(dev.numpy(), host)

    digest = port.encode_pertinent_indices(rp, pert, np.random.default_rng(7),
                                           chunk=chunk)
    rng_b = np.random.default_rng(7)
    acc = torch.zeros_like(digest)
    for s in range(0, count, chunk):
        c = min(chunk, count - s)
        rows = jax_det.build_index_plaintexts(jrp, c, rng_b, start_index=s)
        acc = port._encode_chunk(pert[s:s + c], torch.as_tensor(rows)[None],
                                 acc[None], False)[0]
    assert torch.equal(digest, acc)

    payloads = random_payloads(rng, count, rp.payload_length)
    seed = 12345
    digests = port.encode_pertinent_payloads(rp, pert, payloads, seed, chunk=chunk)
    w_all = sample_weights(rp, seed).reshape(
        rp.cmb_cipher_count, rp.cmb_count_per_cipher, -1)
    dev = payload_plain_device(torch.as_tensor(payloads), torch.as_tensor(w_all),
                               rp.polynomial_size, rp.index_modulus, q2)
    assert dev.shape == (rp.cmb_cipher_count, count, rp.polynomial_size)
    for k in range(rp.cmb_cipher_count):
        host = np.asarray(jax_det.build_payload_plaintexts(jrp, payloads, w_all[k]))
        assert np.array_equal(dev[k].numpy(), host), k
        acc = torch.zeros_like(digests[k])
        for s in range(0, count, chunk):
            rows = torch.as_tensor(host[s:s + chunk])
            acc = port._encode_chunk(pert[s:s + chunk], rows[None], acc[None], False)[0]
        assert torch.equal(digests[k], acc), k
    # every digest of a chunk at once: the same sums
    acc = torch.zeros_like(digests)
    for s in range(0, count, chunk):
        acc = port._encode_chunk(pert[s:s + chunk], dev[:, s:s + chunk], acc, False)
    assert torch.equal(digests, acc)


def test_every_chunk_passes_through_encode_chunk(detectors, monkeypatch):
    """With ``Detector._encode_chunk`` returning its ``acc`` unchanged both
    encoders give all-zero digests: no digest word is summed anywhere
    else (the seam a benchmark control breaks)."""
    _preset, port, _jax_det = detectors
    params = port.ctx.params
    count, chunk = 24, 16
    rp = RetrievalParams.for_params(params, count, 4)
    rng = np.random.default_rng(23)
    pert = torch.as_tensor(
        rng.integers(0, params.q2, size=(count, 2, params.n2), dtype=np.int64))
    payloads = random_payloads(rng, count, rp.payload_length)
    idx = port.encode_pertinent_indices(rp, pert, np.random.default_rng(8), chunk=chunk)
    pay = port.encode_pertinent_payloads(rp, pert, payloads, 9, chunk=chunk)
    assert bool(idx.any()) and bool(pay.any())
    monkeypatch.setattr(Detector, "_encode_chunk",
                        lambda self, pert, rows, acc, plain: acc)
    idx = port.encode_pertinent_indices(rp, pert, np.random.default_rng(8), chunk=chunk)
    pay = port.encode_pertinent_payloads(rp, pert, payloads, 9, chunk=chunk)
    assert idx.shape == (2, params.n2) and not bool(idx.any())
    assert pay.shape == (rp.cmb_cipher_count, 2, params.n2) and not bool(pay.any())


@pytest.mark.parametrize("preset", ["tiny", "default"])
@pytest.mark.parametrize("total,pertinent", [(1, 1), (48, 6), (65536, 50)])
def test_sample_weights_match_jax(preset, total, pertinent):
    params = getattr(OmrParameters, preset)()
    rp = RetrievalParams.for_params(params, total, pertinent)
    want = jax_sample_weights(JaxRetrievalParams(**rp.__dict__), 2**62 + 3)
    got = sample_weights(rp, 2**62 + 3)
    assert got.dtype == want.dtype and np.array_equal(got, want)
