"""The port's profiler spans (``tfhe_omr_tpu_torch/utils/spans.py``).

* With no profiler recording, ``span`` is one shared no-op and enters no
  ``record_function``, in the program's own calls too.
* Under ``torch.profiler.profile`` one tiny-preset board on the plain path
  (detect, both digest encoders, ``Retriever.decode_digest``) records every
  span of a board, each stage inside the call it belongs to.
* A two-device ``ShardedDetector`` on the CPU records each device's rows
  and one reduce inside each encoder call.
* A ``RecipientsDetector`` of two recipients records its recipients and
  the bytes of the keys it reads in ``detect.recipients/<R>/<bytes>`` and
  ``encode.recipients/<R>``, and nothing unprofiled.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.core.payload import random_payloads
from tfhe_omr_tpu_torch.core.sender import ClueBatch
from tfhe_omr_tpu_torch.parallel import ShardedDetector, make_data_mesh
from tfhe_omr_tpu_torch.utils import spans

# The suite runs in several xdist workers on one host: one torch thread each
# keeps their CPU thread pools from oversubscribing its cores.
torch.set_num_threads(1)

ALL, PERTINENT, SEED = 8, 2, 23
#: every span of one board on one device
BOARD = ["detect", "detect.stage1", "detect.stage2", "detect.stage3",
         "encode.index", "encode.payload", "encode.draws", "encode.rows/cpu",
         "decode", "decode.decrypt", "decode.round", "decode.scan",
         "decode.weights", "decode.solve"]
#: (span, the span it lies in)
NESTED = [("detect.stage1", "detect"), ("detect.stage2", "detect"),
          ("detect.stage3", "detect"), ("encode.draws", "encode.index"),
          ("encode.rows/cpu", "encode.index"), ("encode.draws", "encode.payload"),
          ("encode.rows/cpu", "encode.payload"), ("decode.decrypt", "decode"),
          ("decode.round", "decode"), ("decode.scan", "decode"),
          ("decode.weights", "decode"), ("decode.solve", "decode")]


def _program_spans(prof) -> list[tuple[str, int, int]]:
    """(name without the prefix, start ns, end ns) of the program's ranges,
    read from the raw events as the benchmark's trace reader reads them."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(spans.PREFIX):
            s = ev.start_ns()
            out.append((ev.name()[len(spans.PREFIX):], s, s + ev.duration_ns()))
    return sorted(out, key=lambda r: r[1])


def _within(rows, inner: str, outer: str) -> list[bool]:
    """For each ``inner`` span, whether an ``outer`` span holds it."""
    outers = [(s, e) for n, s, e in rows if n == outer]
    return [any(s0 <= s and e <= e0 for s0, e0 in outers)
            for n, s, e in rows if n == inner]


@pytest.fixture(scope="module")
def board():
    """A tiny board's detector, layout, stack and payloads, with the spans
    of one pass through the program under the profiler."""
    params = OmrParameters.tiny()
    ctx = OmrContext(params, "cpu")
    skp = SecretKeyPack(params, rng=SEED, ctx=ctx)
    other = SecretKeyPack(params, rng=SEED + 1, ctx=ctx)
    det = skp.generate_detector()
    rng = np.random.default_rng(SEED + 2)
    own = skp.generate_sender().gen_clues(PERTINENT, rng)
    rest = other.generate_sender().gen_clues(ALL - PERTINENT, rng)
    clues = ClueBatch(np.concatenate([own.a, rest.a]), np.concatenate([own.b7, rest.b7]))
    payloads = random_payloads(rng, ALL, params.payload_length)
    retriever = skp.generate_retriever(ALL, PERTINENT)
    rp = retriever.params
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pv = det.detect(clues)
        index_cts = [det.encode_pertinent_indices(rp, pv, rng)
                     for _ in range(rp.max_encode_indices_cipher_count)]
        payload_cts = det.encode_pertinent_payloads(rp, pv, payloads, SEED + 3)
        indices, solved = retriever.decode_digest(index_cts, payload_cts, SEED + 3)
    assert indices == list(range(PERTINENT))
    assert np.array_equal(solved, payloads[:PERTINENT])
    return dict(det=det, rp=rp, pv=pv, payloads=payloads, rows=_program_spans(prof))


@pytest.mark.parametrize("recording", [False, True])
def test_span_enters_record_function_only_while_recording(monkeypatch, recording):
    entered = []
    enter = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counting)
    params = OmrParameters.tiny()
    skp = SecretKeyPack(params, rng=SEED, ctx=OmrContext(params, "cpu"))
    retriever = skp.generate_retriever(ALL, PERTINENT)
    zero = np.zeros((2, params.n2), dtype=np.int64)
    with profile(activities=[ProfilerActivity.CPU]) if recording else contextlib.nullcontext():
        with spans.span("probe"):
            retriever.decode_pertinent_indices(zero)
    if recording:
        assert {"tfhe_omr:probe", "tfhe_omr:decode.decrypt", "tfhe_omr:decode.round",
                "tfhe_omr:decode.scan"} <= set(entered)
    else:
        assert entered == []
        assert spans.span("a") is spans.span("b")


@pytest.mark.parametrize("name", BOARD)
def test_board_records_span(board, name):
    assert name in {n for n, _s, _e in board["rows"]}


@pytest.mark.parametrize("inner,outer", NESTED)
def test_board_span_nests(board, inner, outer):
    held = _within(board["rows"], inner, outer)
    assert held and any(held), (inner, outer)
    if inner.startswith(("detect.", "decode.")):
        assert all(held), (inner, outer)


def test_board_records_one_detect_and_decode(board):
    names = [n for n, _s, _e in board["rows"]]
    rp = board["rp"]
    assert names.count("detect") == names.count("decode") == 1
    assert names.count("decode.solve") == 1
    assert names.count("encode.index") <= rp.max_encode_indices_cipher_count
    assert names.count("encode.payload") == 1


@pytest.mark.parametrize("encoder", ["encode.index", "encode.payload"])
def test_sharded_encoder_spans_a_device_and_one_reduce(board, encoder):
    det, rp, pv = board["det"], board["rp"], board["pv"]
    sharded = ShardedDetector(det, make_data_mesh(["cpu", "cpu"]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if encoder == "encode.index":
            got = sharded.encode_pertinent_indices(rp, pv, np.random.default_rng(5))
            want = det.encode_pertinent_indices(rp, pv, np.random.default_rng(5))
        else:
            got = sharded.encode_pertinent_payloads(rp, pv, board["payloads"], 9)
            want = det.encode_pertinent_payloads(rp, pv, board["payloads"], 9)
    assert torch.equal(got, want)
    rows = _program_spans(prof)
    first = min(s for n, s, _e in rows if n == encoder)
    calls = [(s, e) for n, s, e in rows if n == encoder and s == first]
    (s0, e0), = calls
    inside = [n for n, s, e in rows if s0 <= s and e <= e0 and (n, s) != (encoder, s0)]
    assert sorted(inside) == ["encode.draws", "encode.rows/cpu", "encode.rows/cpu",
                              "mesh.reduce"]



@pytest.fixture(scope="module")
def recipients():
    """A two-recipient detector, one message's clues, its layout and
    payload, and one pass of detect and both encoders, returned as a
    function of the profiler context to run it in."""
    from tfhe_omr_tpu_torch.core.detector import RecipientsDetector
    from tfhe_omr_tpu_torch.core.params import RetrievalParams

    params = OmrParameters.tiny()
    ctx = OmrContext(params, "cpu")
    packs = [SecretKeyPack(params, rng=SEED + 10 + r, ctx=ctx) for r in range(2)]
    det = RecipientsDetector((p.generate_detection_key() for p in packs), ctx, 2)
    clues = packs[1].generate_sender().gen_clues(1, np.random.default_rng(SEED))
    rp = RetrievalParams.for_params(params, 1, 1)
    payloads = random_payloads(np.random.default_rng(SEED), 1, params.payload_length)

    def one_pass(context):
        with context:
            pv = det.detect(clues)
            det.encode_pertinent_indices(rp, pv, np.random.default_rng(SEED))
            det.encode_pertinent_payloads(rp, pv, payloads, SEED)
        return pv

    return det, one_pass


def test_recipients_spans_name_the_recipients_and_key_bytes(recipients):
    """A two-recipient detector's detect runs in ``detect`` and
    ``detect.recipients/2/<bytes of every key it reads>``, each encoder in
    its own span and ``encode.recipients/2``."""
    det, one_pass = recipients
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert one_pass(contextlib.nullcontext()).shape[0] == 2
    rows = _program_spans(prof)
    names = [n for n, _s, _e in rows]
    key_bytes = det.detect_key_size()
    assert key_bytes == sum(k.nbytes() for k in (det.br1, det.br2, det.tr)) + \
        det.ksk_f64.numel() * 8
    key_span = f"detect.recipients/2/{key_bytes}"
    assert names.count(key_span) == 1 and names.count("encode.recipients/2") == 2
    assert all(_within(rows, key_span, "detect"))
    assert all(_within(rows, "detect.stage1", key_span))
    assert any(_within(rows, "encode.recipients/2", "encode.index"))
    assert any(_within(rows, "encode.recipients/2", "encode.payload"))


def test_recipients_spans_cost_nothing_unprofiled(monkeypatch, recipients):
    """With no profiler recording, a pass through the detector of many
    recipients enters no ``record_function``."""
    entered = []
    enter = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counting)
    _det, one_pass = recipients
    one_pass(contextlib.nullcontext())
    assert entered == []
