"""``correct`` can fail. The control (the reference in the program's place,
its key switch summed in float32) comes out not correct, and so does a run
of each cell with the timed path broken underneath in each way the cell
can break: an answer altered where it is produced, half of a batch left
out and the rest copied over it, a step that returns its state unchanged,
and the exchange between cards left out. On a board no larger than the
check's sample the reference encodes its own detect, not the program's."""

import pytest
import torch

from omr_benchmark import control, reference
from omr_benchmark.tests.helpers import SEED, TINY, run, small_cell
from tfhe_omr_tpu_torch.core.detector import Detector
from tfhe_omr_tpu_torch.parallel.mesh import ShardedDetector


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_control_reading_is_not_zero(seed):
    torch.set_num_threads(1)
    assert control.reading(TINY, 4, seed, "cpu") > 0


def test_control_in_the_programs_place_is_not_correct(monkeypatch):
    cell = small_cell("detect_b1024")
    omr = reference.Omr(reference.Params(cell.cfg), "cpu", SEED)
    key = omr.detection_key()

    def control_detect(self, clues, plain=False):
        rows = torch.cat([torch.as_tensor(clues.a), torch.as_tensor(clues.b7)], dim=1)
        return omr.detect(rows, key, control.CONTROL_DTYPE)

    monkeypatch.setattr(Detector, "detect", control_detect)
    res = run(cell)
    assert not res["correct"] and res["checks"]["detect_words_off"]["value"] > 0


def _altered(detect):
    def wrapped(self, clues, plain=False):
        out = detect(self, clues, plain).clone()
        out[:, 1, 0] = (out[:, 1, 0] + 1) % self.ctx.f2.q
        return out
    return wrapped


def _half_left_out(detect):
    def wrapped(self, clues, plain=False):
        n = clues.a.shape[0]
        half = max(1, n // 2)
        out = detect(self, type(clues)(clues.a[:half], clues.b7[:half]), plain)
        return torch.cat([out, out[: n - half]])
    return wrapped


def _unchanged(_encode_chunk):
    def wrapped(self, pert, plain, acc, fwd):
        return acc
    return wrapped


FAULTS = {
    "answer_altered": (Detector, "detect", _altered),
    "half_left_out": (Detector, "detect", _half_left_out),
    "state_unchanged": (Detector, "_encode_chunk", _unchanged),
}
CASES = [("detect_b1024", "answer_altered"), ("detect_b1024", "half_left_out"),
         ("board_d4096", "answer_altered"), ("board_d4096", "half_left_out"),
         ("board_d4096", "state_unchanged"), ("latency_d1", "answer_altered"),
         ("latency_d1", "state_unchanged"), ("board_d16384_x4", "half_left_out")]


@pytest.mark.parametrize("name,fault", CASES)
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    owner, attr, make = FAULTS[fault]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    res = run(small_cell(name))
    assert not res["correct"], res["checks"]


def test_exchange_left_out_is_not_correct(monkeypatch):
    reduce = ShardedDetector._reduce

    def first_card_only(self, partials, shape):
        return reduce(self, partials[:1], shape)

    monkeypatch.setattr(ShardedDetector, "_reduce", first_card_only)
    res = run(small_cell("board_d16384_x4"))
    assert not res["correct"]
    assert res["checks"]["digest_words_off"]["value"] > 0



@pytest.mark.parametrize("name,own_stack", [("latency_d1", True), ("board_d4096", False)])
def test_small_boards_digests_follow_the_references_detect(monkeypatch, name, own_stack):
    # a detect fault reaches the digests' check where the reference encodes
    # its own stack (D <= check_rows); on larger boards it encodes the
    # program's, and the detect sample alone catches the fault
    monkeypatch.setattr(Detector, "detect", _altered(Detector.detect))
    res = run(small_cell(name))
    assert not res["correct"] and res["checks"]["detect_words_off"]["value"] > 0
    assert (res["checks"]["digest_words_off"]["value"] > 0) == own_stack
