"""The instructions of the probe kernels' loops, as the card runs them.

Builds the port's kernels (utils/build.py), disassembles the library with
``cuobjdump -sass`` and prints, for every instantiation of the probe
kernels of ``csrc/probes.cu``, the opcodes of each loop (the instructions
from a backward branch's target to the branch): one JSON line per loop,
``{"function", "loop", "instructions", "opcodes"}``. With the stream count
and the unroll factor this reads as instructions an iteration, so a rate
per operation (as the JAX probes count) can be turned into a rate per
instruction.

Usage: python benches/probe_sass_torch.py [--filter probe_chain]

Needs the CUDA toolkit (nvcc, cuobjdump).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def _tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found")


def loops(sass: str):
    """(function, [(start, end, opcode Counter)]) for each function."""
    out = []
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.splitlines()[0].strip()
        insns, labels, pending = [], {}, []
        for line in chunk.splitlines()[1:]:
            m = _LABEL.match(line)
            if m:
                pending.append(m.group(1))
                continue
            m = _INSN.search(line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            for lbl in pending:
                labels[lbl] = addr
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
        found = []
        for addr, op, args in insns:
            if not op.startswith("BRA"):
                continue
            t = re.search(r"`\((\.L_x_\d+)\)|0x([0-9a-f]+)", args)
            if not t:
                continue
            target = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
            if target is not None and target <= addr:
                ops = Counter(o for a, o, _ in insns if target <= a <= addr)
                found.append((target, addr, ops))
        out.append((name, found))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filter", default="probe_", help="functions whose name holds this")
    args = ap.parse_args()

    from tfhe_omr_tpu_torch.utils import build

    so = build.library()._name
    sass = subprocess.run([_tool("cuobjdump"), "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    try:
        filt = _tool("cu++filt")
    except RuntimeError:
        filt = None
    for name, found in loops(sass):
        if args.filter not in name:
            continue
        if filt:
            name = subprocess.run([filt, name], capture_output=True, text=True).stdout.strip()
        for start, end, ops in found:
            print(json.dumps({"function": name, "loop": [hex(start), hex(end)],
                              "instructions": sum(ops.values()),
                              "opcodes": dict(ops.most_common())}), flush=True)


if __name__ == "__main__":
    main()
