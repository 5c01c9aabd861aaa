"""The readers of the program's own spans (``omr_benchmark/program_spans.py``
and the four metrics on it), on hand-made traces: times in ms here, ns in
the trace."""

from types import SimpleNamespace

import numpy as np
import pytest

from omr_benchmark import harness, trace_read

MS = 10**6
NEW = ["encode_idle_ms.board", "decode_idle_ms.board", "solve_ms.board",
       "program_idle_ms.latency"]


def _reader(name: str):
    return harness._module(harness.ROOT / "omr_benchmark" / "metrics" / f"{name}.py").read


def _run(window, ops: dict, host: list, chips: int = 1, items: int = 1):
    """A traced run: ``ops`` card -> [(start, end)], ``host`` [(start, end,
    name)], all in ms."""
    ops = {d: [(s * MS, e * MS, "kernel") for s, e in rows] for d, rows in ops.items()}
    host = sorted((s * MS, e * MS, n) for s, e, n in host)
    trace = trace_read.Summary((window[0] * MS, window[1] * MS), ops, host, [], chips)
    return SimpleNamespace(trace=trace, record={"items": items})


def test_a_gap_counts_only_where_it_overlaps_the_span():
    # the card idles from 10 to 90 ms; the decode span holds 40 to 60 of it
    run = _run((0, 100), {0: [(0, 10), (90, 100)]},
               [(5, 35, "tfhe_omr:encode.index"), (40, 60, "tfhe_omr:decode"),
                (45, 55, "tfhe_omr:decode.solve"), (0, 100, "aten::copy_")])
    assert _reader("decode_idle_ms.board")(run) == pytest.approx(20.0)
    assert _reader("encode_idle_ms.board")(run) == pytest.approx(25.0)
    assert _reader("solve_ms.board")(run) == pytest.approx(10.0)
    assert _reader("program_idle_ms.latency")(run) == pytest.approx(45.0)


def test_spans_are_clipped_to_the_window_and_merged():
    # a solve that began before the window, two overlapping encoder spans
    run = _run((10, 100), {0: [(0, 100)]},
               [(0, 30, "tfhe_omr:decode.solve"), (50, 60, "tfhe_omr:decode.solve"),
                (20, 40, "tfhe_omr:encode.index"), (30, 50, "tfhe_omr:encode.payload")],
               items=2)
    assert _reader("solve_ms.board")(run) == pytest.approx((20 + 10) / 2)
    assert _reader("encode_idle_ms.board")(run) == 0.0


def test_four_cards_take_the_mean():
    # inside the encoders (0-40 ms): card 0 busy throughout, cards 1 and 2
    # idle 20 ms each, card 3 runs nothing at all
    run = _run((0, 50), {0: [(0, 50)], 1: [(0, 20)], 2: [(10, 20), (30, 40)]},
               [(0, 40, "tfhe_omr:encode.index"), (40, 50, "tfhe_omr:decode")],
               chips=4, items=2)
    assert _reader("encode_idle_ms.board")(run) == pytest.approx((0 + 20 + 20 + 40) / 4 / 2)
    assert _reader("decode_idle_ms.board")(run) == pytest.approx((0 + 10 + 10 + 10) / 4 / 2)


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("seed", range(4))
def test_encode_and_decode_idle_stay_within_the_window_idle(seed, chips):
    """Boards of detect, encode and decode spans one after the other, cards
    busy at random: the two idle readings never exceed the window's idle
    time a board (``idle_share.board`` x window / boards)."""
    rng = np.random.default_rng(seed)
    host, t, boards = [], 0.0, 5
    for _ in range(boards):
        for name in ["detect", "encode.index", "encode.payload", "decode"]:
            d = float(rng.uniform(1, 30))
            host.append((t, t + d, "tfhe_omr:" + name))
            t += d
    ops = {}
    for card in range(chips - (seed % 2 if chips > 1 else 0)):  # odd seeds leave a card idle
        edges = np.sort(rng.uniform(-5, t + 5, size=40))
        ops[card] = [(float(s), float(e)) for s, e in zip(edges[::2], edges[1::2])]
    run = _run((0, t), ops, host, chips=chips, items=boards)
    idle = _reader("idle_share.board")(run) / 100 * run.trace.window_s * 1e3 / boards
    enc, dec = _reader("encode_idle_ms.board")(run), _reader("decode_idle_ms.board")(run)
    assert enc > 0 and dec > 0
    assert enc + dec <= idle + 1e-9
    assert _reader("program_idle_ms.latency")(run) == pytest.approx(idle)


@pytest.mark.parametrize("name", NEW)
def test_a_trace_without_program_spans_reads_none(name):
    read = _reader(name)
    run = _run((0, 100), {0: [(0, 10)]}, [(0, 50, "aten::copy_"), (60, 70, "python_op")])
    run.trace.spans.append((0, 100 * MS, "omr:decode"))
    assert read(run) is None
    assert read(SimpleNamespace(trace=None, record={"items": 1})) is None
