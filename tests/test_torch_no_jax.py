"""The port imports torch and numpy, never jax.

Runs in a subprocess because this suite's conftest imports jax. Imports
the package, every submodule, every example of the port and chip_smoke.py.
"""

import os
import subprocess
import sys

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
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tfhe_omr_tpu"))
assert not bad, bad
for name in ("core.matrix", "core.retriever", "native"):
    assert "tfhe_omr_tpu_torch." + name in names, names
assert len(names) >= 21, names
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
