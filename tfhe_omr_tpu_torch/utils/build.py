"""Build, load and count the port's CUDA kernels.

The sources under ``tfhe_omr_tpu_torch/csrc/`` compile with ``nvcc`` (one
process per source, all started together, then one link) into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), loaded with ctypes. The library lands in ``build/kernels/``
beside the package, named by a hash of the sources, so a changed source
rebuilds and an unchanged one is reused by later processes. The build
happens at the first launch, never at import.

Every kernel wrapper adds one to its entry in :data:`LAUNCHES` where it
launches its kernel and nowhere else, so a run can show that the main path
went through the kernels.

Nothing here falls back: a failed build raises with nvcc's output, a
launch error raises with CUDA's error string, and a tensor on a device
other than the CPU or a CUDA card is refused. :func:`runs_plain` is the one
place where a wrapper chooses between its kernel and its plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

#: launches per kernel name since the last :func:`reset_launches`
LAUNCHES: Counter = Counter()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# (arguments of each C entry point, in order; see csrc/*.cu)
_U64 = ctypes.c_uint64
_NTT_ARGS = [_P, _P, _I64, _P, _P, _U64, _U64, _I32, _I64, _I32, _I32, _P]
_BR_ARGS = [_P, _P, _P, _I64, _I32, _P, _P, _P, _P, _P, _U64, _U64,
            _I32, _I64, _I32, _I32, _I32, _P, _I64]
_TRACE_ARGS = [_P, _P, _I64, _I32, _P, _P, _P, _P, _U64, _U64,
               _I32, _I64, _I32, _I32, _P, _I64]
_PROBE_CHAIN_ARGS = [_I32, _I32, _I32, _P, _P, _P, _I64, _I32, _I32, _P]
_PROBE_CHAIN_PLAN_ARGS = [_I64, _I32, _I32, _I32, _P]
_PROBE_MAC_ARGS = [_I32, _P, _P, _P, _I64, _I32, _P]
_PROBE_I8DOT_ARGS = [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P]
_PROBE_I8DOT_PLAN_ARGS = [_I64, _I32, _I32, _I32, _I32, _I32, _P]
_ENCODE_MAC_ARGS = [_P, _P, _P, _P, _I64, _I32, _I32, _I64, _P, _I32]
_ENCODE_PAYLOAD_ARGS = [_P, _P, _I64, _I64, _P, _I64, _I32, _I32, _I32, _I32, _I64, _I64,
                        _I32, _P]
_ENCODE_INDEX_ARGS = [_P, _I64, _P, _I64, _I32, _I32, _I32, _I64, _I64, _I32, _P, _I64]

_library = None
_host_library = None
#: seconds the last build took (0.0 when a cached library was loaded)
build_seconds = 0.0
#: nvcc's report (registers, shared memory, spills) of the last build
build_log = ""


def reset_launches() -> None:
    LAUNCHES.clear()


def device_kind(t: torch.Tensor) -> str:
    """"cpu" or "cuda" for a tensor; anything else is refused."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain path for device {t.device}")
    return kind


def runs_plain(t: torch.Tensor, plain: bool = False) -> bool:
    """Whether a wrapper given ``t`` runs its plain torch version, not its
    kernel: on a CPU tensor, or on a card with ``plain`` set (how the card
    holds each kernel against its plain version). Every wrapper that has
    both asks here; a tensor on any other device is refused."""
    return device_kind(t) == "cpu" or plain


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no card and no explicit ``device="cpu"`` this raises; it
    never falls back to the host. A card comes back with its index spelled
    out (``cuda`` is the card that is current now), so that what is built on
    it later lands on the same card whatever card is current then."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is false); "
            'pass device="cpu" (--device cpu) to run the plain torch path on '
            "the host")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def library() -> ctypes.CDLL:
    """The loaded kernel library; builds it on first use."""
    global _library, build_seconds, build_log
    if _library is not None:
        return _library
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so_path = BUILD_DIR / f"libomr_kernels_{digest.hexdigest()[:16]}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objects = [tmp.with_suffix(f".{src.stem}.o")
                   for src in sorted(CSRC_DIR.glob("*.cu"))]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for obj, src in zip(objects, sorted(CSRC_DIR.glob("*.cu")))]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        cmds.append([nvcc, "-shared", "-o", str(tmp), *[str(o) for o in objects]])
        logs = [proc.communicate()[0] for proc in procs]
        codes = [proc.returncode for proc in procs]
        if not any(codes):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            codes.append(link.returncode)
        for obj in objects:
            obj.unlink(missing_ok=True)
        build_seconds = time.perf_counter() - t0
        build_log = "".join(logs)
        if any(codes):
            failed = [" ".join(c) for c, rc in zip(cmds, codes) if rc]
            raise RuntimeError(
                f"nvcc failed ({codes}):\n" + "\n".join(failed) + f"\n{build_log}"
            )
        os.replace(tmp, so_path)
        so_path.with_suffix(".log").write_text(build_log)
    elif so_path.with_suffix(".log").exists():
        build_log = so_path.with_suffix(".log").read_text()
    _library = _bind(ctypes.CDLL(str(so_path)))
    return _library


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument types."""
    for name, args in (
        ("omr_ntt", _NTT_ARGS),
        ("omr_blind_rotate", _BR_ARGS),
        ("omr_blind_rotate_profiled", _BR_ARGS + [_P, _I32]),
        ("omr_blind_rotate_cluster", _BR_ARGS + [_I32]),
        ("omr_blind_rotate_cluster_fit", [_I32, _I64, _I32, _I32, _I32, _P]),
        ("omr_trace", _TRACE_ARGS),
        ("omr_probe_chain", _PROBE_CHAIN_ARGS),
        ("omr_probe_chain_plan", _PROBE_CHAIN_PLAN_ARGS),
        ("omr_probe_mac", _PROBE_MAC_ARGS),
        ("omr_probe_i8dot", _PROBE_I8DOT_ARGS),
        ("omr_probe_i8dot_plan", _PROBE_I8DOT_PLAN_ARGS),
        ("omr_encode_mac", _ENCODE_MAC_ARGS),
        ("omr_encode_mac_field", [_I64]),
        ("omr_encode_payload_plain", _ENCODE_PAYLOAD_ARGS),
        ("omr_encode_index_plain", _ENCODE_INDEX_ARGS),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    for fn in (lib.omr_blind_rotate_config, lib.omr_trace_config):
        fn.argtypes = [_I32, _I64, _I32, _I32, _P]
        fn.restype = ctypes.c_int
    lib.omr_blind_rotate_stages.argtypes = []
    lib.omr_blind_rotate_stages.restype = ctypes.c_int
    lib.omr_ntt_config.argtypes = [_I32, _I64, _P]
    lib.omr_ntt_config.restype = ctypes.c_int
    lib.omr_error_string.argtypes = [ctypes.c_int]
    lib.omr_error_string.restype = ctypes.c_char_p
    return lib


def host_library() -> ctypes.CDLL:
    """The same sources compiled for the host with g++ against the stand-in
    ``csrc/host/cuda_runtime.h``: a kernel runs one block after another, a
    block as one host thread per CUDA thread. For tests of the kernel
    templates where there is no card; no entry point of the port uses it."""
    global _host_library
    if _host_library is not None:
        return _host_library
    digest = hashlib.sha256()
    for src in [*_sources(), CSRC_DIR / "host" / "cuda_runtime.h"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so_path = BUILD_DIR / f"libomr_kernels_host_{digest.hexdigest()[:16]}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
               "-I", str(CSRC_DIR / "host"), "-o", str(tmp)]
        for src in sorted(CSRC_DIR.glob("*.cu")):
            cmd += ["-x", "c++", str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so_path)
    _host_library = _bind(ctypes.CDLL(str(so_path)))
    return _host_library


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.omr_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(what: str, *tensors: torch.Tensor,
                 dtypes=(torch.int64,)) -> None:
    """Every tensor a kernel reads must be a contiguous CUDA tensor on one
    card, int64 unless the kernel takes other words (``dtypes``)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: tensors on {t.device}, expected {dev} (cuda)")
        if t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f"{what}: needs contiguous {dtypes}, got {t.dtype}")
