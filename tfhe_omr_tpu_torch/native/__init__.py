"""C++ host runtime (ctypes): the client's decoder hot loops.

PyTorch-package counterpart of :mod:`tfhe_omr_tpu.native` (entry points
``omr_solve_matrix`` and ``omr_scan_buckets`` of ``omr_host.cpp``, a
verbatim copy of the JAX package's source). ``omr_host.cpp`` builds with g++
at the first use into ``build/native/`` beside the package, named by a hash
of the source and the flags, so a changed source rebuilds and an unchanged
one is reused. Each build writes a temporary file and renames it into
place, so several processes may build at once.

Nothing falls back: a failed build raises with g++'s output. The numpy
versions (:func:`tfhe_omr_tpu_torch.core.matrix.solve_matrix_numpy`,
:func:`tfhe_omr_tpu_torch.core.retriever.scan_buckets_numpy`) are the plain
references the tests hold this library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from tfhe_omr_tpu_torch.core.errors import InvertibleMatrixError

SOURCE = Path(__file__).resolve().parent / "omr_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# no -march=native: the checkout (and its build/) may move between hosts
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def get_lib() -> ctypes.CDLL:
    """The loaded library; builds it on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(SOURCE.read_bytes())
        digest.update(" ".join(GXX_FLAGS).encode())
        so_path = BUILD_DIR / f"libomr_host_{digest.hexdigest()[:16]}.so"
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.omr_solve_matrix.restype = ctypes.c_int
        lib.omr_solve_matrix.argtypes = [i64p, i64p, i64, i64, i64, i64, i64p]
        lib.omr_scan_buckets.restype = ctypes.c_int
        lib.omr_scan_buckets.argtypes = [i64p, i64, i64, i64, i64, i64, i64,
                                         i64p, i64]
        _lib = lib
        return lib


def solve_matrix_native(matrix: np.ndarray, rhs: np.ndarray, p: int) -> np.ndarray:
    """C++ Gaussian elimination mod p: x (cols, plen) with matrix @ x = rhs;
    raises :class:`InvertibleMatrixError` if the matrix is singular."""
    lib = get_lib()
    m = np.ascontiguousarray(np.mod(matrix, p), dtype=np.int64)
    r = np.ascontiguousarray(np.mod(rhs, p), dtype=np.int64)
    if m.ndim != 2 or r.ndim != 2 or r.shape[0] != m.shape[0]:
        raise ValueError(f"shapes {m.shape} and {r.shape} do not form a system")
    rows, cols = m.shape
    plen = r.shape[1]
    out = np.empty((cols, plen), dtype=np.int64)
    if lib.omr_solve_matrix(m, r, rows, cols, plen, p, out) != 0:
        raise InvertibleMatrixError("singular weight matrix (native)")
    return out


def scan_buckets_native(decoded: np.ndarray, n_seg: int, sps: int, spb: int,
                        n_buckets: int, p: int, max_index: int) -> np.ndarray:
    """C++ flag scan: the indices (< ``max_index``) of every bucket whose
    flag slot decodes to 1, segment-major, as int64."""
    lib = get_lib()
    d = np.ascontiguousarray(decoded, dtype=np.int64)
    if d.size < n_seg * sps or n_buckets * spb > sps:
        raise ValueError(f"{d.size} values do not hold {n_seg} segments of "
                         f"{n_buckets} x {spb} slots")
    cap = n_seg * n_buckets
    out = np.empty(cap, dtype=np.int64)
    n = lib.omr_scan_buckets(d, n_seg, sps, spb, n_buckets, p, max_index, out, cap)
    return out[:n]
