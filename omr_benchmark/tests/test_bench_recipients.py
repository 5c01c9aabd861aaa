"""The cell of many recipients (``latency_d1_r96``): it is added from new
files and new entries alone, runs on the CPU at the small parameter set
with three recipients and comes out correct; its reference copy loads
nothing of the program; and ``correct`` can fail: a detector that runs
every recipient's samples under recipient 0's key, or that encodes every
recipient's digests from recipient 0's ciphertexts, is not correct."""

import json
import shutil
from dataclasses import replace

import pytest
import torch

from omr_benchmark import harness
from omr_benchmark.tests.helpers import TINY, run
from omr_benchmark.tests.test_bench_imports import FORBIDDEN, _loaded_tops
from tfhe_omr_tpu_torch.core.detector import RecipientsDetector

CELL = "latency_d1_r96"
#: what the cell adds under omr_benchmark/, every one a new file
NEW_FILES = ["configs/instantomr_d1_r96.json", "traffic/latency_d1_r96.json",
             "loops/recipients.py", "program_recipients.py", "reference_recipients.py",
             "roofline_recipients.py", "metrics/k2_ms.recipients.py",
             "metrics/k2_roofline.recipients.py", "metrics/k1_roofline.recipients.py",
             "metrics/ks_roofline.recipients.py", "metrics/program_idle_ms.recipients.py",
             "metrics/launches.recipients.py"]


def small(cell: harness.Cell) -> harness.Cell:
    return replace(cell, cfg={**TINY, "board_messages": 1, "pertinent": 1, "recipients": 3},
                   traffic={**cell.traffic, "distinct_messages": 3})


def _without_cell(bench: dict) -> dict:
    """BENCHMARK.json with the cell's entries taken out."""
    out = json.loads(json.dumps(bench))
    out["configs"] = [c for c in out["configs"] if c["name"] != "instantomr_d1_r96"]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != CELL]
    out["per_layer"] = [m for m in out["per_layer"] if not m["name"].endswith(".recipients")]
    for m in out["end_to_end"] + out["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].remove(CELL)
    return out


def test_cell_from_new_files_alone(tmp_path):
    root = harness.ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    shutil.copytree(root / "omr_benchmark", tmp_path / "omr_benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel in NEW_FILES:
        (tmp_path / "omr_benchmark" / rel).unlink()
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(_without_cell(bench)))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in tmp_path.rglob("*") if p.is_file() and p.name != "BENCHMARK.json"}
    with pytest.raises(harness.BenchError):
        harness.load_cell(CELL, tmp_path)

    for rel in NEW_FILES:
        shutil.copy(root / "omr_benchmark" / rel, tmp_path / "omr_benchmark" / rel)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = small(harness.load_cell(CELL, tmp_path))
    assert cell.cfg["recipients"] == 3 and cell.traffic["loop"] == "recipients"
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"latency_ms_p95", "setup_s"}
    assert all(c["value"] == 0 for c in res["checks"].values())
    traced = run(cell, trace=True, seconds=0.2)
    assert traced["correct"] and traced["device"]["window_s"] > 0
    # the device metrics read nothing on the CPU: no card operation is traced
    assert not any(m.endswith(".recipients") for m in traced["metrics"])
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data, rel


def test_cell_entries_in_the_benchmark():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.cfg["recipients"] == 96
    assert {m["name"] for m in cell.end_to_end} == {"latency_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "k2_ms.recipients", "k2_roofline.recipients", "k1_roofline.recipients",
        "ks_roofline.recipients", "program_idle_ms.recipients", "launches.recipients",
        "idle_share.latency"}
    assert all(m["moves"] == "latency_ms_p95" for m in cell.per_layer)
    conf = {c["name"]: c for c in bench["configs"]}["instantomr_d1_r96"]
    assert conf["reduced"] == list(cell.cfg["reduced"]) == ["recipients"]
    one = json.loads((harness.ROOT / "omr_benchmark/configs/instantomr_d1.json").read_text())
    for k, v in one.items():
        if k not in ("name", "source", "deployment", "layout", "guarantees", "reduced"):
            assert cell.cfg[k] == v, k


def test_reference_copy_loads_nothing_of_the_program():
    tops = _loaded_tops("import omr_benchmark.reference_recipients, "
                        "omr_benchmark.roofline_recipients")
    assert not tops & {"tfhe_omr_tpu_torch", *FORBIDDEN}


def test_one_key_for_every_recipient_is_not_correct(monkeypatch):
    """Recipient r's samples under recipient 0's key: the detect check sees
    the key mix-up."""
    init = RecipientsDetector.__init__

    def first_key_for_all(self, keys, ctx, recipients=None, device=None):
        keys = list(keys)
        init(self, [keys[0]] * len(keys), ctx, recipients, device)

    monkeypatch.setattr(RecipientsDetector, "__init__", first_key_for_all)
    res = run(small(harness.load_cell(CELL)))
    assert not res["correct"]
    assert res["checks"]["detect_words_off"]["value"] > 0


def test_digests_of_one_recipient_for_all_are_not_correct(monkeypatch):
    """Every recipient's digests made from recipient 0's ciphertexts: the
    digest check and the recipients' decode see it."""
    for name in ("encode_pertinent_indices", "encode_pertinent_payloads"):
        encode = getattr(RecipientsDetector, name)

        def first_for_all(self, rp, pert, *args, _encode=encode, **kwargs):
            pert = torch.as_tensor(pert)
            return _encode(self, rp, pert[:1].expand_as(pert).contiguous(), *args, **kwargs)

        monkeypatch.setattr(RecipientsDetector, name, first_for_all)
    res = run(small(harness.load_cell(CELL)))
    assert not res["correct"]
    assert res["checks"]["digest_words_off"]["value"] > 0
