"""The port imports torch and numpy, never jax.

Runs in a subprocess because this suite's conftest imports jax. Imports
the package, every submodule (``parallel`` and ``entry`` among them), every
example and bench of the port, bench_torch.py and chip_smoke.py. Then one
smoke case for bench_torch.py and for each bench script at ``--tiny
--device cpu``: the first line of standard output parses as JSON and
carries the script's keys. Last, the port's test files that must run where
there is no jax run with jax (and the JAX package) unimportable.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import tfhe_omr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    tfhe_omr_tpu_torch.__path__, "tfhe_omr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, "examples")
import omd_torch
import omr_torch
import omr_time_analyze_torch
import bench_kernels_torch
import profile_detect_torch
import omr_time_analyze2_torch
sys.path.insert(0, "benches")
import two_level_bs_torch
import omr_bench_torch
import decode_bench_torch
import sharding_bench_torch
import sharding_worker_torch
import fp_margin_probe_torch
import fp_rate_probe_torch
import fp_criterion_probe_torch
import vpu_probe_torch
import vpu_peak_probe_torch
import mac_probe_torch
import mosaic_unsupported_probe_torch
import probe_sass_torch
import probe_step_torch
import encoder_probe_torch
import bench_torch
import chip_smoke
sys.path.insert(0, "tests")
import torch_distributed_worker
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tfhe_omr_tpu"))
assert not bad, bad
for name in ("core.matrix", "core.retriever", "native", "parallel",
             "parallel.mesh", "parallel.distributed", "ops.probes", "entry",
             "utils.golden"):
    assert "tfhe_omr_tpu_torch." + name in names, names
assert len(names) >= 26, names
print("imported", len(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout


PUBLIC = r"""
import sys, torch
from tfhe_omr_tpu_torch import (OmrParameters, RetrievalParams, PAYLOAD_LENGTH,
    random_payloads, KeyGen, SecretKeyPack, Sender, Detector, Retriever, OmrError,
    __version__)
import tfhe_omr_tpu_torch
from tfhe_omr_tpu_torch.utils import build
assert __version__ == "0.1.0" and len(tfhe_omr_tpu_torch.__all__) == 10
assert all(hasattr(tfhe_omr_tpu_torch, n) for n in tfhe_omr_tpu_torch.__all__)
assert build._library is None, "importing the package built the kernels"
assert not torch.cuda.is_initialized(), "importing the package initialised CUDA"
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tfhe_omr_tpu"))
assert not bad, bad
from tfhe_omr_tpu_torch.core.context import OmrContext
params = OmrParameters.tiny()
skp = KeyGen.generate_secret_key(params, rng=3, ctx=OmrContext(params, "cpu"))
assert isinstance(skp, SecretKeyPack) and skp.generate_sender().clue_key_size() > 0
print("public names ok")
"""


def test_package_exports_the_public_names():
    """``from tfhe_omr_tpu_torch import ...`` gives the JAX package's ten
    public names and its version without jax, a card or a kernel build."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", PUBLIC], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "public names ok" in proc.stdout


def _first_line_json(script, *args, env=None):
    """Run a script of the port at the small preset on the CPU; its first
    stdout line as JSON. jax must not be importable by accident: the
    script runs with the repo root alone on its path."""
    full_env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full_env.update(OMP_NUM_THREADS="1", **(env or {}))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, script), *args], cwd=ROOT,
        env=full_env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.splitlines()[0]), proc


def test_bench_torch_smoke_on_cpu():
    first, proc = _first_line_json("bench_torch.py", "--tiny", "--device", "cpu",
                                   env={"OMR_BENCH_REPS": "1"})
    assert first["metric"] == "detect_throughput_per_chip"
    assert first["unit"] == "msg/s" and first["value"] > 0
    assert first["vs_baseline"] == pytest.approx(first["value"] / 4.27, abs=1e-3)
    detail = json.loads(proc.stderr.splitlines()[-1])["detail"]
    assert detail["batch"] == 4 and detail["digest"]["digest_d"] == 64
    assert set(detail["stage_ms_per_message"]) == {"first_level", "second_level", "trace"}
    for key in ("batch_seconds_streaming", "keygen_seconds", "kernel_build_seconds",
                "first_call_seconds"):
        assert key in detail, key
    for key in ("encode_indices_total_s", "encode_payloads_s", "decode_s"):
        assert detail["digest"][key] > 0, key


BENCHES = {
    "two_level_bs": (["--batch", "2", "--reps", "1"],
                     {"first_level_blind_rotation_ms", "key_switch_ms",
                      "second_level_blind_rotation_ms", "trace_ms", "batch", "device"}),
    "omr_bench": (["--batch", "2", "--reps", "1"],
                  {"batch", "gen_clues_ms", "detect_ms", "detect_msgs_per_sec",
                   "stage_first_level_ms", "stage_second_level_ms", "stage_trace_ms",
                   "encode_indices_ms_per_ct", "decode_indices_ms_per_ct", "device"}),
    "decode_bench": (["--reps", "1"],
                     {"warm_setup_s", "index_decode_ms", "payload_decrypt_ms",
                      "solve_native_ms", "solve_numpy_ms", "ref_decode_ms",
                      "decode_total_ms", "device"}),
    "sharding_bench": (["--card", "--batch", "3", "--reps", "1"],
                       {"mode", "batch", "plain_s_per_batch", "sharded_s_per_batch",
                        "overhead_pct", "bit_exact", "device"}),
}


@pytest.mark.parametrize("bench", sorted(BENCHES))
def test_bench_script_smoke_on_cpu(bench):
    args, keys = BENCHES[bench]
    out, _proc = _first_line_json(f"benches/{bench}_torch.py", "--tiny",
                                  "--device", "cpu", *args)
    assert keys <= set(out), sorted(keys - set(out))
    assert out["device"] == "cpu"
    if bench == "sharding_bench":
        assert out["bit_exact"] is True and out["mode"] == "card_1dev_mesh"


@pytest.mark.parametrize("script", ["bench_torch.py", "benches/omr_bench_torch.py",
                                    "benches/sharding_bench_torch.py",
                                    "examples/omr_time_analyze2_torch.py",
                                    "benches/vpu_probe_torch.py",
                                    "benches/vpu_peak_probe_torch.py",
                                    "benches/mac_probe_torch.py",
                                    "benches/mosaic_unsupported_probe_torch.py"])
def test_scripts_refuse_to_run_on_the_host_unasked(script):
    """With no card and no ``--device cpu`` a script exits non-zero, names
    the flag and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    args = ["--card"] if "sharding" in script else []
    proc = subprocess.run([sys.executable, os.path.join(ROOT, script), "--tiny", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr, proc.stderr
    assert proc.stdout == ""


def test_fp_margin_probe_smoke_on_cpu():
    """Every pertinent message lands in chunk 2 * clue_count of the second
    level's input, no other message does."""
    env = dict(os.environ, OMP_NUM_THREADS="1")  # one core, as the other smoke cases
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benches", "fp_margin_probe_torch.py"),
         "--tiny", "--device", "cpu", "--batch", "6"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "OK" and "  chunk 14: 6/6" in lines


def test_fp_rate_probe_smoke_on_cpu():
    """The accept criterion on the port's device clues: own-key clues all
    accept, a wrong key's clues accept one time in t each."""
    out, proc = _first_line_json("benches/fp_rate_probe_torch.py", "--tiny", "--device",
                                 "cpu", "--messages", "40000", "--pairs", "2",
                                 "--chunk", "10000")
    assert out == {"own_key_accept_rate": 1.0, "own_key_messages": 10000}
    total = json.loads(proc.stdout.splitlines()[-1])
    assert total["messages"] == 40000 and total["key_pairs"] == 2
    assert all(abs(r - 0.125) < 0.01 for r in total["per_clue_accept_rate"])
    assert total["fp_count"] <= 2 and total["device"] == "cpu"


def test_fp_criterion_probe_smoke_on_cpu():
    """The analytic accept window equals the port's detector's decision at
    the window's boundaries of every clue position (noise-free keys)."""
    out, _proc = _first_line_json("benches/fp_criterion_probe_torch.py", "--tiny",
                                  "--device", "cpu", "--stride", "128")
    assert out["mismatch_count"] == 0 and out["cases"] == 52
    assert out["accept_window"] == [0, 31, 480, 511]


def test_step_and_encoder_probes_smoke_on_cpu():
    """probe_step_torch.py: a line per stage (no clocks on the CPU) and a
    record per level; encoder_probe_torch.py: a line per phase."""
    out, proc = _first_line_json("benches/probe_step_torch.py", "--tiny", "--device",
                                 "cpu", "--batch", "2", "--steps", "1")
    assert out["level"] == 1 and out["stage"] == "digits_fwd" and out["share"] is None
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["stage"] for r in lines if r.get("level") == 2 and "stage" in r] == [
        "digits_fwd", "staging", "mac", "monomial", "inv_acc", "barrier"]
    assert [r["checked_samples"] for r in lines if "checked_samples" in r] == [2, 2]
    assert lines[-1] == {"card": "cpu"}
    out, proc = _first_line_json("benches/encoder_probe_torch.py", "--tiny", "--device",
                                 "cpu", "--d", "40", "--reps", "1")
    phases = [json.loads(line)["phase"] for line in proc.stdout.splitlines()[:-1]]
    assert phases == ["warm_encoders", "idx_1ct", "idx_5ct_stream", "pay_host_prep",
                      "pay_upload", "pay_encode"]
    assert out["device"] == "cpu" and out["seconds"] >= 0


def test_entry_main_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    proc = subprocess.run([sys.executable, "-m", "tfhe_omr_tpu_torch.entry"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and 'device="cpu"' in proc.stderr
    assert proc.stdout == ""


#: the test files that hold the port without jax (on the card's machine too)
JAX_FREE_RUN = ["tests/test_torch_golden.py", "tests/test_torch_interchange.py",
                "tests/test_torch_bucket_collision.py"]
JAX_FREE_IMPORT = ["tests/test_torch_aux.py", "tests/test_torch_warm.py",
                   "tests/test_torch_entry.py"]


def test_new_test_files_need_no_jax(tmp_path):
    """With ``jax``, ``jaxlib`` and the JAX package unimportable, the
    golden, interchange and bucket-collision files pass (all but the case
    marked ``jax_reference``) and the aux, warm and entry files collect."""
    for name in ("jax", "jaxlib", "tfhe_omr_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} is unimportable in this test')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}", OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
            "-p", "no:randomly", "-m", "not jax_reference"]
    proc = subprocess.run([*base, *JAX_FREE_RUN], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert " passed" in proc.stdout and "failed" not in proc.stdout
    proc = subprocess.run([*base, "--collect-only", *JAX_FREE_IMPORT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
