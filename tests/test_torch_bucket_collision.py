"""Forced bucket collision on the port: the accumulation across index digests.

The port's twin of tests/test_bucket_collision.py, with the same seeds: with
many pertinent messages and few buckets, two messages that draw the same
bucket in a segment wipe each other's flag slot, so one index digest does
not recover every index and the Retriever accumulates across the redundant
digests (``Retriever.decode_digest``); too few digests raise
``IndexDecodeError``. The pertinency ciphertexts are noise-free RLWE
encryptions built directly (a = 0, b = Delta * bit in every NTT slot), so
no bootstrapping runs. Imports no jax.
"""

import numpy as np
import pytest
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.errors import IndexDecodeError
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
from tfhe_omr_tpu_torch.core.params import OmrParameters, RetrievalParams
from tfhe_omr_tpu_torch.core.payload import random_payloads

torch.set_num_threads(1)

# the seed of the JAX test: its first index digest recovers 23 of 24
# indices (a collision in every segment for one message), the second
# completes the set; the assertions below fail on a seed without one
SEED = 1
COUNT, PERTINENT = 64, 24


@pytest.fixture(scope="module")
def keys():
    params = OmrParameters.tiny(noise_free=True)
    skp = SecretKeyPack(params, rng=3, ctx=OmrContext(params, "cpu"))
    return skp, skp.generate_detector()


@pytest.fixture
def board(keys):
    skp, det = keys
    params = skp.params
    q2 = skp.ctx.f2.q
    p = params.output_plain_modulus
    delta = (2 * q2 + p) // (2 * p)
    rp = RetrievalParams.for_params(params, COUNT, PERTINENT)
    rng = np.random.default_rng(SEED)
    pert = np.zeros(COUNT, dtype=bool)
    pert[:PERTINENT] = True
    rng.shuffle(pert)
    b = torch.as_tensor(np.repeat((delta * pert.astype(np.int64))[:, None],
                                  rp.polynomial_size, 1))
    pert_cts = torch.stack([torch.zeros_like(b), b], dim=1)  # (B, 2, N2)
    index_cts = [det.encode_pertinent_indices(rp, pert_cts, rng)
                 for _ in range(rp.max_encode_indices_cipher_count)]
    return skp, det, rp, pert_cts, index_cts, sorted(np.nonzero(pert)[0].tolist()), rng


def test_first_ciphertext_insufficient_second_completes(board):
    skp, _det, _rp, _pert, index_cts, true_idx, _rng = board
    retr = skp.generate_retriever(COUNT, PERTINENT)
    assert not retr.decode_pertinent_indices(index_cts[0])
    assert len(retr.pertinent_indices_set) < PERTINENT
    assert retr.decode_pertinent_indices(index_cts[1])
    assert sorted(retr.pertinent_indices_set) == true_idx


def test_decode_digest_accumulates_across_ciphertexts(board):
    skp, det, rp, pert_cts, index_cts, true_idx, rng = board
    payloads = random_payloads(rng, COUNT, rp.payload_length)
    payload_cts = det.encode_pertinent_payloads(rp, pert_cts, payloads, 987)
    retr = skp.generate_retriever(COUNT, PERTINENT)
    indices, solved = retr.decode_digest(index_cts, payload_cts, 987)
    assert indices == true_idx
    np.testing.assert_array_equal(solved, payloads[true_idx])


def test_insufficient_digests_raise_index_decode_error(board):
    skp, det, rp, pert_cts, index_cts, _true_idx, rng = board
    payloads = random_payloads(rng, COUNT, rp.payload_length)
    payload_cts = det.encode_pertinent_payloads(rp, pert_cts, payloads, 5)
    retr = skp.generate_retriever(COUNT, PERTINENT)
    with pytest.raises(IndexDecodeError, match=f"/{PERTINENT} indices"):
        retr.decode_digest(index_cts[:1], payload_cts, 5)
