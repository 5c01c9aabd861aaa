"""The detector of many recipients (``RecipientsDetector``) at the tiny
preset, three recipients of distinct secrets, against each recipient's own
``Detector`` and against the benchmark's plain reference of many
recipients (``omr_benchmark/reference_recipients.py``): detect, both
digest encoders and each recipient's decode, bit for bit; and the whole
detect through the host build of the kernels, where the first level's
blocks of four samples straddle the recipients' runs of seven.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from omr_benchmark import inputs, reference, reference_recipients
from omr_benchmark.program import params_of
from omr_benchmark.tests.helpers import TINY
from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.detector import (
    Detector,
    RecipientsDetector,
    weight_seed,
)
from tfhe_omr_tpu_torch.core.errors import IndexDecodeError
from tfhe_omr_tpu_torch.core.keygen import DetectionKey
from tfhe_omr_tpu_torch.core.params import RetrievalParams
from tfhe_omr_tpu_torch.core.retriever import Retriever
from tfhe_omr_tpu_torch.core.sender import ClueBatch
from tfhe_omr_tpu_torch.utils import build

torch.set_num_threads(1)

SEED = 2**31 + 17
RECIPIENTS = 3


def _program_key(key: dict) -> DetectionKey:
    return DetectionKey(key["bsk1"], key["bsk1_sh"], key["ksk"], key["bsk2"], key["bsk2_sh"],
                        key["trace_k"], key["trace_k_sh"])


@pytest.fixture(scope="module")
def world():
    """Three recipients' references and keys, and clues of four messages:
    one to each recipient, then one to none of them."""
    base = reference.Omr(reference.Params(TINY), "cpu", SEED)
    omrs = [reference_recipients.recipient(base, SEED, r) for r in range(RECIPIENTS)]
    keys = [o.detection_key() for o in omrs]
    clues = torch.cat([inputs.clues(o, np.ones(1, dtype=bool)) for o in omrs]
                      + [inputs.clues(base, np.zeros(1, dtype=bool))])
    n0 = TINY["clue"]["dimension"]
    batch = ClueBatch(clues[:, :n0].contiguous(), clues[:, n0:].contiguous())
    ctx = OmrContext(params_of(TINY), "cpu")
    det = RecipientsDetector((_program_key(k) for k in keys), ctx, RECIPIENTS)
    return {"omrs": omrs, "keys": keys, "clues": clues, "batch": batch, "ctx": ctx,
            "det": det, "pv": det.detect(batch)}


def test_recipients_reference_is_a_fresh_omr_of_its_seed():
    """The reference's recipient shares its base's tables but draws its own
    secrets and keys, as ``Omr`` of its seed would."""
    base = reference.Omr(reference.Params(TINY), "cpu", SEED)
    r2 = reference_recipients.recipient(base, SEED, 2)
    fresh = reference.Omr(reference.Params(TINY), "cpu",
                          reference_recipients.recipient_seed(SEED, 2))
    assert reference_recipients.recipient(base, SEED, 0) is base
    for name in ("clue_sk", "inter_sk", "z1", "z2"):
        assert torch.equal(getattr(r2, name), getattr(fresh, name))
        assert not torch.equal(getattr(r2, name), getattr(base, name))
    assert torch.equal(r2.detection_key()["bsk1"], fresh.detection_key()["bsk1"])


def test_detect_equals_each_recipients_detector_and_the_reference(world):
    pv = world["pv"]
    assert pv.shape == (RECIPIENTS, 4, 2, TINY["second_level_br"]["dimension"])
    for r, (omr, key) in enumerate(zip(world["omrs"], world["keys"])):
        single = Detector(_program_key(key), world["ctx"])
        assert torch.equal(pv[r], single.detect(world["batch"]))
        assert torch.equal(pv[r], omr.detect(world["clues"], key))
    assert not torch.equal(pv[0], pv[1])


def test_plain_path_equals_the_default_path(world):
    assert torch.equal(world["det"].detect(world["batch"], plain=True), world["pv"])


def test_digests_and_decode_agree_with_the_reference(world):
    """A board of the four messages: every recipient's index and payload
    digests equal the reference's over the same draws, and each recipient
    decodes its own message and its payload from them."""
    det, pv, ctx = world["det"], world["pv"], world["ctx"]
    rp = RetrievalParams.for_params(ctx.params, 4, 1)
    lay = reference.Layout(reference.Params(TINY), 4, 1)
    payloads = np.random.default_rng(3).integers(0, 256, (4, rp.payload_length), dtype=np.int64)
    rng = np.random.default_rng([SEED, 2])
    index = det.encode_pertinent_indices(rp, pv, rng)
    seed = int(rng.integers(0, 2**63))
    payload = det.encode_pertinent_payloads(rp, pv, payloads, seed)
    assert index.shape == (RECIPIENTS, rp.max_encode_indices_cipher_count, 2, rp.polynomial_size)
    assert payload.shape == (RECIPIENTS, rp.cmb_cipher_count, 2, rp.polynomial_size)
    drng = np.random.default_rng([SEED, 2])
    base_addr = reference_recipients.bucket_draws(lay, RECIPIENTS, drng)
    assert int(drng.integers(0, 2**63)) == seed
    weights = reference_recipients.payload_weights(lay, seed, RECIPIENTS)
    for r, omr in enumerate(world["omrs"]):
        want_index, want_payload = reference_recipients.digests(
            omr, lay, pv[r], base_addr, torch.as_tensor(payloads), weights, r)
        assert torch.equal(index[r], want_index)
        assert torch.equal(payload[r], want_payload)
        indices, solved = Retriever(rp, ctx, omr.z2_ntt).decode_digest(
            index[r], payload[r], weight_seed(seed, r, RECIPIENTS))
        assert indices == [r] and np.array_equal(solved, payloads[[r]])
    # the same digests on the plain path
    assert torch.equal(det.encode_pertinent_indices(rp, pv, np.random.default_rng([SEED, 2]),
                                                    plain=True), index)


def test_weights_of_every_recipient_come_from_one_draw(world):
    """The detector's weights of R recipients are one draw of the shared
    stream; recipient r's ``weight_seed`` gives it its own share again, and
    a plain seed still gives the one-recipient stream."""
    from tfhe_omr_tpu_torch.core.detector import (
        payload_weights,
        recipient_weights,
        sample_weights,
    )

    rp = RetrievalParams.for_params(world["ctx"].params, 4, 1)
    lay = reference.Layout(reference.Params(TINY), 4, 1)
    every = recipient_weights(rp, 5, RECIPIENTS, 4)
    assert np.array_equal(every, reference_recipients.payload_weights(lay, 5, RECIPIENTS))
    for r in range(RECIPIENTS):
        own = sample_weights(rp, weight_seed(5, r, RECIPIENTS))
        assert np.array_equal(own.reshape(every[r].shape), every[r])
    assert not np.array_equal(every[0], every[1])
    assert np.array_equal(payload_weights(rp, 5, 4), reference.payload_weights(lay, 5))


def test_one_message_reaches_its_addressee_alone(world):
    """The benchmark's board: one message; the addressee decodes its
    payload, the others find no index."""
    det, ctx = world["det"], world["ctx"]
    rp = RetrievalParams.for_params(ctx.params, 1, 1)
    pv = world["pv"][:, 1:2].contiguous()  # recipient 1's message
    payload = np.arange(rp.payload_length, dtype=np.int64)[None] % 256
    index = det.encode_pertinent_indices(rp, pv, np.random.default_rng(8))
    pay = det.encode_pertinent_payloads(rp, pv, payload, 99)
    for r, omr in enumerate(world["omrs"]):
        retriever = Retriever(rp, ctx, omr.z2_ntt)
        if r == 1:
            indices, solved = retriever.decode_digest(index[r], pay[r],
                                                      weight_seed(99, r, RECIPIENTS))
            assert indices == [0] and np.array_equal(solved, payload)
        else:
            with pytest.raises(IndexDecodeError):
                retriever.decode_digest(index[r], pay[r], weight_seed(99, r, RECIPIENTS))


def test_keys_are_taken_one_at_a_time(world):
    """Announced, the recipients' keys come from an iterator, each made as
    it is asked for; a count that differs from the keys raises."""
    made = []

    def keys():
        for k in world["keys"]:
            made.append(1)
            yield _program_key(k)

    det = RecipientsDetector(keys(), world["ctx"], RECIPIENTS)
    assert len(made) == RECIPIENTS and det.recipients == RECIPIENTS
    assert det.br2.keys[0].shape[0] == RECIPIENTS
    with pytest.raises(ValueError):
        RecipientsDetector((_program_key(k) for k in world["keys"]), world["ctx"], 2)
    with pytest.raises(ValueError):
        RecipientsDetector((_program_key(k) for k in world["keys"]), world["ctx"], 4)


@pytest.fixture
def host(monkeypatch):
    """Route the kernel wrappers to the host build of the kernels (as
    ``tests/test_torch_host_kernels.py`` does)."""
    lib = build.host_library()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=2))
    before = dict(build.LAUNCHES)
    build.LAUNCHES.clear()
    yield lib
    build.LAUNCHES.clear()
    build.LAUNCHES.update(before)


def test_kernels_straddling_recipients_are_exact_on_host(host, world):
    """One message under three keys through the host build: K1's 7 samples
    a recipient take two blocks of four each (the second masked), K2 and
    K3 one block a recipient, each a single launch, and the pertinency
    ciphertexts are the plain path's."""
    ctx = OmrContext(params_of(TINY), "cpu")
    det = RecipientsDetector((_program_key(k) for k in world["keys"]), ctx, RECIPIENTS)
    assert det.br1.on_card and det.br1.keys[0].shape[0] == RECIPIENTS
    one = ClueBatch(world["batch"].a[1:2], world["batch"].b7[1:2])
    got = det.detect(one)
    assert build.LAUNCHES["blind_rotate1"] == build.LAUNCHES["blind_rotate2"] == 1
    assert build.LAUNCHES["trace"] == 1
    assert torch.equal(got, world["pv"][:, 1:2])
