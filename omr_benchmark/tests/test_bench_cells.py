"""Every cell's loop, at the small parameter set on CPU replicas, through
the program's plain path: the run is correct and reports the cell's
metrics."""

import pytest

from omr_benchmark.tests.helpers import SMALL, run, small_cell


@pytest.mark.parametrize("name", sorted(SMALL))
def test_cell_runs_correct(name):
    cell = small_cell(name)
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("name", ["detect_b1024", "latency_d1"])
def test_traced_run_reads_spans_and_window(name):
    cell = small_cell(name)
    res = run(cell, trace=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # device metrics read nothing on the CPU: no card operation is traced
    assert not any(m.startswith(("idle_share", "k1_", "k2_")) for m in res["metrics"])


def test_board_spans_read_per_board():
    res = run(small_cell("board_d4096"), trace=True)
    assert {"detect_ms.board", "encode_ms.board", "decode_ms.board"} <= set(res["metrics"])
