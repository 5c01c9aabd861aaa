"""The benchmark's plain reference is bit-equal to the program at the small
parameter set: the keys it makes drive the program's detector, and
detect, both digest encoders and the recipient's NTT agree word for word;
the program's decode recovers what the reference's inputs hold."""

import numpy as np
import pytest
import torch

from omr_benchmark import inputs, reference
from omr_benchmark.program import ClueBatch, Server, params_of
from omr_benchmark.tests.helpers import SEED, TINY


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    omr = reference.Omr(reference.Params(TINY), "cpu", SEED)
    key = omr.detection_key()
    server = Server(TINY, key, omr.z2_ntt, [torch.device("cpu")])
    mask = np.array([True, False, True, False, False, True])
    return omr, key, server, mask, inputs.clues(omr, mask)


def test_params_are_the_programs_small_preset():
    from tfhe_omr_tpu_torch.core.params import OmrParameters

    assert params_of(TINY) == OmrParameters.tiny()


def test_ntt_is_the_programs(world):
    omr, _key, server, _mask, _clues = world
    gen = torch.Generator().manual_seed(3)
    for ours, theirs in ((omr.ntt1, server.ctx.ntt1), (omr.ntt2, server.ctx.ntt2)):
        x = torch.randint(0, ours.field.q, (5, ours.n), generator=gen)
        assert torch.equal(ours.fwd_last(x), theirs.fwd_last_plain(x))
        assert torch.equal(ours.inv_last(x), theirs.inv_last_plain(x))


def test_detect_bit_equal(world):
    omr, key, server, mask, clues = world
    n0 = TINY["clue"]["dimension"]
    got = server.detector.detect(ClueBatch(clues[:, :n0], clues[:, n0:]))
    assert torch.equal(got, omr.detect(clues, key))
    # the clues decrypt as the mask says under the recipient's key
    assert [bool((omr.decrypt_clue(r) == 0).all()) for r in clues] == mask.tolist()


def test_encoders_bit_equal_and_decode(world):
    omr, key, server, mask, clues = world
    n0 = TINY["clue"]["dimension"]
    total, k = len(mask), int(mask.sum())
    pv = server.detector.detect(ClueBatch(clues[:, :n0], clues[:, n0:]))
    rp = server.layout(total, k)
    lay = reference.Layout(omr.params, total, k)
    assert (lay.index_cts, lay.payload_cts, lay.combinations, lay.digits) == (
        rp.max_encode_indices_cipher_count, rp.cmb_cipher_count, rp.combination_count,
        rp.index_slots_per_bucket)
    rng, ref_rng = np.random.default_rng(5), np.random.default_rng(5)
    payloads = np.random.default_rng(6).integers(0, 256, (total, TINY["payload_length"]))
    for _ in range(lay.index_cts):
        got = server.detector.encode_pertinent_indices(rp, pv, rng)
        addr = torch.as_tensor(reference.bucket_draws(lay, ref_rng))
        assert torch.equal(got, omr.index_digest(lay, pv, addr, chunk=4))
    got = server.detector.encode_pertinent_payloads(rp, pv, payloads, 9)
    want = omr.payload_digests(lay, pv, torch.as_tensor(payloads),
                               torch.as_tensor(reference.payload_weights(lay, 9)), chunk=4)
    assert torch.equal(got, want)
    index_cts = [omr.index_digest(lay, pv, torch.as_tensor(reference.bucket_draws(lay, ref_rng)))
                 for _ in range(lay.index_cts)]
    indices, solved = server.retriever(rp).decode_digest(index_cts, want, 9)
    assert set(np.nonzero(mask)[0]) <= set(indices)
    assert np.array_equal(solved, payloads[indices])
