"""Linear-system solvers over Z_p for payload recovery.

PyTorch-package counterpart of :mod:`tfhe_omr_tpu.core.matrix` (reference
``omr_core/src/matrix.rs``: Gaussian elimination + back substitution on
payload-vector right-hand sides, ``solve_matrix`` ``:250-336``).
:func:`solve_matrix` runs the C++ library of :mod:`tfhe_omr_tpu_torch.native`;
:func:`solve_matrix_numpy` is its plain reference, which the tests hold the
library against.
"""

from __future__ import annotations

import numpy as np

from tfhe_omr_tpu_torch.core.errors import InvertibleMatrixError


def _inv_mod(v: int, p: int) -> int:
    g, x = _xgcd(v % p, p)
    if g != 1:
        raise InvertibleMatrixError(f"{v} not invertible mod {p}")
    return x % p


def _xgcd(a: int, b: int):
    x0, x1 = 1, 0
    while b:
        q, a, b = a // b, b, a % b
        x0, x1 = x1, x0 - q * x1
    return a, x0


def solve_matrix(matrix: np.ndarray, rhs: np.ndarray, p: int) -> np.ndarray:
    """Solve (an overdetermined) ``matrix @ x = rhs`` mod p with the native
    library; raises :class:`InvertibleMatrixError` when it is singular.

    matrix: (rows, cols) with rows >= cols; rhs: (rows, payload_len).
    Returns x: (cols, payload_len).
    """
    from tfhe_omr_tpu_torch.native import solve_matrix_native

    return solve_matrix_native(matrix, rhs, p)


def solve_matrix_numpy(matrix: np.ndarray, rhs: np.ndarray, p: int) -> np.ndarray:
    """Row-pivoted Gaussian elimination mod p in numpy, vectorised over the
    payload axis (the plain reference of :func:`solve_matrix`)."""
    m = np.mod(matrix.astype(np.int64), p).copy()
    r = np.mod(rhs.astype(np.int64), p).copy()
    rows, cols = m.shape
    if rows < cols:
        raise InvertibleMatrixError("underdetermined system")
    for c in range(cols):
        # pivot: first row >= c with invertible entry (mirrors the odd-entry
        # pivoting of ``solve_matrix_mod_256``; for prime p any nonzero works)
        piv = None
        for rr in range(c, rows):
            if np.gcd(int(m[rr, c]), p) == 1:
                piv = rr
                break
        if piv is None:
            raise InvertibleMatrixError(f"no pivot for column {c}")
        if piv != c:
            m[[c, piv]] = m[[piv, c]]
            r[[c, piv]] = r[[piv, c]]
        inv = _inv_mod(int(m[c, c]), p)
        m[c] = np.mod(m[c] * inv, p)
        r[c] = np.mod(r[c] * inv, p)
        below = np.arange(c + 1, rows)
        if len(below):
            f = m[below, c][:, None]
            m[below] = np.mod(m[below] - f * m[c][None, :], p)
            r[below] = np.mod(r[below] - f * r[c][None, :], p)
    # back substitution
    for c in range(cols - 1, -1, -1):
        above = np.arange(0, c)
        if len(above):
            f = m[above, c][:, None]
            m[above] = np.mod(m[above] - f * m[c][None, :], p)
            r[above] = np.mod(r[above] - f * r[c][None, :], p)
    return r[:cols]
