"""What a run loads: nothing of JAX or of the JAX package (top-level
module names compared whole: the program's name begins with the JAX
package's), and the reference and the control load nothing of the
program. The entry refuses to run without a card, and without the
program beside it."""

import shutil
import subprocess
import sys
from dataclasses import replace

import pytest

from omr_benchmark import harness
from omr_benchmark.tests.helpers import run, small_cell

FORBIDDEN = ["jax", "jaxlib", "flax", "tfhe_omr_tpu"]


def _python(code: str, cwd=harness.ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=600)


def _loaded_tops(prelude: str) -> set:
    code = (f"import sys; sys.path.insert(0, {str(harness.ROOT)!r})\n{prelude}\n"
            "print(sorted({m.split('.')[0] for m in list(sys.modules)}))")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tops = _loaded_tops(
        "import torch; torch.set_num_threads(1)\n"
        "from omr_benchmark.tests.helpers import run, small_cell\n"
        "res = run(small_cell('latency_d1'), trace=True)\n"
        "assert res['correct']\n"
        "from omr_benchmark import harness; assert harness.forbidden_modules() == []")
    assert "tfhe_omr_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_reference_and_control_load_nothing_of_the_program():
    tops = _loaded_tops("import omr_benchmark.reference, omr_benchmark.control, "
                        "omr_benchmark.roofline, omr_benchmark.inputs, omr_benchmark.harness")
    assert not tops & {"tfhe_omr_tpu_torch", *FORBIDDEN}


def test_forbidden_names_compare_whole(monkeypatch):
    import omr_benchmark.program  # noqa: F401  (loads tfhe_omr_tpu_torch)

    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "tfhe_omr_tpu_torch" in {m.split(".")[0] for m in sys.modules}
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tfhe_omr_tpu.core", sys)
    assert harness.forbidden_modules() == ["tfhe_omr_tpu"]


LOADS_JAX = '''"""Loads a module named jax, as a reader that imported JAX would."""

import sys
import types


def read(run):
    sys.modules["jax"] = types.ModuleType("jax")
    return 1.0
'''


def test_a_reader_that_loads_jax_gives_no_result(tmp_path):
    # the check comes after every reader, not only after the window
    shutil.copytree(harness.ROOT / "omr_benchmark", tmp_path / "omr_benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "omr_benchmark" / "metrics" / "loads_jax.py").write_text(LOADS_JAX)
    cell = replace(small_cell("latency_d1"), root=tmp_path,
                   end_to_end=[{"name": "loads_jax", "unit": "s"}])
    assert "jax" not in sys.modules
    try:
        with pytest.raises(harness.BenchError, match="jax"):
            run(cell)
    finally:
        sys.modules.pop("jax", None)


def test_entry_refuses_without_a_card():
    out = subprocess.run([sys.executable, "omr_benchmark/run.py", "--workload", "detect_b1024",
                          "--seed", str(2**31 + 5), "--seconds", "1"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""


def test_entry_refuses_without_the_program(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "omr_benchmark", tmp_path / "omr_benchmark")
    out = subprocess.run([sys.executable, "omr_benchmark/run.py", "--workload", "detect_b1024",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""
    out = _python("import sys; sys.path.insert(0, '.'); import omr_benchmark.harness; "
                  "import omr_benchmark.program", cwd=tmp_path)
    assert out.returncode != 0 and "tfhe_omr_tpu_torch" in out.stderr
