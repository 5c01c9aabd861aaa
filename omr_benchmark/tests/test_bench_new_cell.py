"""A cell, its configuration, its traffic and a per-layer metric are
added from new files and new entries alone: the harness finds them by
name in a copy of the benchmark, and every file the copy shares with the
benchmark is unchanged."""

import json
import shutil

from omr_benchmark import harness
from omr_benchmark.tests.helpers import TINY, run

NEW_METRIC = '''"""Boards run in the window (a count)."""


def read(run):
    return float(run.record["items"])
'''


def test_cell_from_files_alone(tmp_path):
    root = harness.ROOT
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "omr_benchmark", tmp_path / "omr_benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in tmp_path.rglob("*") if p.is_file()}

    bench_dir = tmp_path / "omr_benchmark"
    (bench_dir / "configs" / "tiny_board.json").write_text(
        json.dumps({**TINY, "name": "tiny_board", "board_messages": 6, "pertinent": 2}))
    (bench_dir / "traffic" / "tiny_boards.json").write_text(json.dumps(
        {"loop": "board", "distinct_boards": 2, "detect_batch": 4, "check_rows": 4,
         "check_digest_runs": 1}))
    (bench_dir / "metrics" / "boards_run.board.py").write_text(NEW_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_board", "source": "tests", "reduced": [],
                             "file": "omr_benchmark/configs/tiny_board.json", "why": "test"})
    bench["workloads"].append({"name": "tiny_boards", "config": "tiny_board",
                               "traffic": "tiny_boards", "chips": 1, "why": "test"})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]].index("board_s")][
        "workloads"].append("tiny_boards")
    bench["per_layer"].append({"name": "boards_run.board", "unit": "boards", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "board_s", "workloads": ["tiny_boards"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("tiny_boards", tmp_path)
    assert cell.cfg["board_messages"] == 6 and cell.traffic["detect_batch"] == 4
    res = run(cell)
    assert res["correct"] and set(res["metrics"]) == {"board_s", "setup_s"}
    traced = run(cell, trace=True)
    assert traced["metrics"]["boards_run.board"]["value"] == traced["attempted"]
    for rel, data in before.items():
        if rel.name != "BENCHMARK.json":
            assert (tmp_path / rel).read_bytes() == data, rel
