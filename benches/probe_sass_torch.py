"""The instructions of the probe kernels' loops, as the card runs them.

Builds the port's kernels (utils/build.py), disassembles the library with
``cuobjdump -sass`` and prints, for every instantiation of the probe
kernels of ``csrc/probes.cu``, the opcodes of each loop (the instructions
from a backward branch's target to the branch): one JSON line per loop,
``{"function", "loop", "instructions", "opcodes"}``. With the stream count
and the unroll factor this reads as instructions an iteration, so a rate
per operation (as the JAX probes count) can be turned into a rate per
instruction.

With ``--products`` it compiles one modular product of each kind alone
(``csrc/field.cuh``'s Shoup product and lazily summed product, in the
27-bit field's 32-bit words and the 50-bit field's 64-bit ones, as K1-K5
use them) and prints each kernel's multiply instructions: one JSON line per
product, ``{"product", "opcodes"}``, the loads, stores and address
arithmetic of its one-thread frame left out. ``chip_smoke.py bound`` counts
K1-K5's multiply slots from these.

With ``--hash`` it prints instead, for every function whose name holds the
filter, the SHA-256 of its machine code (the instruction words as
cuobjdump prints them, which hold branch offsets relative to the function)
and its instruction count: one JSON line per function,
``{"function", "sass_sha256", "instructions"}``. Two builds whose lines
agree compiled that function to the same code.

Usage: python benches/probe_sass_torch.py [--filter probe_chain]
       python benches/probe_sass_torch.py --hash --filter blind_rotate_kernel
       python benches/probe_sass_torch.py --products

Needs the CUDA toolkit (nvcc, cuobjdump).
"""

from __future__ import annotations

import argparse
import hashlib
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
_WORD = re.compile(r"/\* (0x[0-9a-f]{16}) \*/")


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


def code_hashes(sass: str):
    """(function, SHA-256 of its instruction words, instructions) for each
    function of ``cuobjdump -sass`` output."""
    out = []
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.splitlines()[0].strip()
        words = _WORD.findall(chunk)
        out.append((name, hashlib.sha256(" ".join(words).encode()).hexdigest(),
                    len(words) // 2))
    return out


# one product a kernel, each thread's operands loaded and its result stored
PRODUCTS_CU = r"""
#include "field.cuh"
typedef WordField<u32, 134215681ull> F27;
typedef WordField<u64, 1125899906826241ull> F50;
extern "C" __global__ void shoup_27(const u32* x, const u32* w, const u32* s, u32* o) {
  const int t = threadIdx.x;
  o[t] = F27::mul_shoup_lazy(x[t], w[t], s[t]);
}
extern "C" __global__ void shoup_50(const u64* x, const u64* w, const u64* s, u64* o) {
  const int t = threadIdx.x;
  o[t] = F50::mul_shoup_lazy(x[t], w[t], s[t]);
}
extern "C" __global__ void summed_27(const u32* x, const u32* y, u64* o) {
  const int t = threadIdx.x;
  u64 a = o[t];
  WideAcc<F27>::mac(a, x[t], y[t]);
  o[t] = a;
}
extern "C" __global__ void summed_50(const u64* x, const u64* y, U128* o) {
  const int t = threadIdx.x;
  U128 a = o[t];
  WideAcc<F50>::mac(a, x[t], y[t]);
  o[t] = a;
}
"""


def product_opcodes() -> dict:
    """{product: Counter of its IMAD forms}: PRODUCTS_CU built with the
    library's nvcc flags. The frame's address arithmetic (an IMAD.WIDE a
    pointer, thread index x element size) is taken off."""
    import tempfile

    from tfhe_omr_tpu_torch.utils import build

    pointers = {"shoup": 4, "summed": 3}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = os.path.join(tmp, "products.cu"), os.path.join(tmp, "products.cubin")
        with open(src, "w") as fh:
            fh.write(PRODUCTS_CU)
        flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
        subprocess.run([_tool("nvcc"), *flags, "-cubin", "-I", str(build.CSRC_DIR), "-o", cubin,
                        src], check=True, capture_output=True, text=True)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.splitlines()[0].strip()
        ops = Counter(m.group(2) for m in _INSN.finditer(chunk) if m.group(2).startswith("IMAD"))
        ops["IMAD.WIDE"] -= pointers[name.split("_")[0]]
        out[name] = +ops
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filter", default="probe_", help="functions whose name holds this")
    ap.add_argument("--hash", action="store_true",
                    help="one hash of each function's machine code, not its loops")
    ap.add_argument("--products", action="store_true",
                    help="the multiply instructions of one modular product of each kind")
    args = ap.parse_args()

    if args.products:
        for name, ops in product_opcodes().items():
            print(json.dumps({"product": name, "opcodes": dict(ops.most_common())}), flush=True)
        return

    from tfhe_omr_tpu_torch.utils import build

    so = build.library()._name
    sass = subprocess.run([_tool("cuobjdump"), "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    try:
        filt = _tool("cu++filt")
    except RuntimeError:
        filt = None
    def readable(name):
        if not filt:
            return name
        return subprocess.run([filt, name], capture_output=True, text=True).stdout.strip()

    if args.hash:
        for name, digest, count in code_hashes(sass):
            if args.filter in readable(name):
                print(json.dumps({"function": readable(name), "sass_sha256": digest,
                                  "instructions": count}), flush=True)
        return
    for name, found in loops(sass):
        if args.filter not in name:
            continue
        name = readable(name)
        for start, end, ops in found:
            print(json.dumps({"function": name, "loop": [hex(start), hex(end)],
                              "instructions": sum(ops.values()),
                              "opcodes": dict(ops.most_common())}), flush=True)


if __name__ == "__main__":
    main()
