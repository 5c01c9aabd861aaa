"""Payload representation (counterpart of reference ``omr_core/src/payload.rs``).

The reference fixes ``PAYLOAD_LENGTH = 612`` u16 elements
(``payload.rs:8-10``); here payloads are rows of a ``(D, payload_length)``
int64 numpy array (batched, TPU-friendly), with the length a parameter
defaulting to the reference value. Payload bytes are sampled in [0, 256) and
all arithmetic happens mod the output plain modulus p (reference
``payload.rs:53-103`` implements add/sub/mul_scalar under a ``RingReduce``
modulus; :func:`payload_add` / :func:`payload_sub` / :func:`payload_mul_scalar`
are the batched counterparts).
"""

from __future__ import annotations

import numpy as np

#: Reference payload length (``omr_core/src/payload.rs:8``).
PAYLOAD_LENGTH = 612


def payload_add(a: np.ndarray, b: np.ndarray, modulus: int) -> np.ndarray:
    """Elementwise payload addition mod ``modulus``.

    Counterpart of ``Payload::add_reduce(_assign)`` (reference
    ``payload.rs:53-65``); operands broadcast, so it batches over leading
    axes. Inputs need not be reduced."""
    return np.mod(np.asarray(a) + np.asarray(b), modulus)


def payload_sub(a: np.ndarray, b: np.ndarray, modulus: int) -> np.ndarray:
    """Elementwise payload subtraction mod ``modulus``
    (counterpart of ``Payload::sub_reduce(_assign)``, ``payload.rs:67-79``)."""
    return np.mod(np.asarray(a) - np.asarray(b), modulus)


def payload_mul_scalar(a: np.ndarray, scalar: int, modulus: int) -> np.ndarray:
    """Payload-by-scalar multiplication mod ``modulus``
    (counterpart of ``Payload::mul_scalar_reduce(_assign)``,
    ``payload.rs:81-103``). ``scalar`` may also be an array broadcastable
    against ``a`` (e.g. per-message digest weights)."""
    return np.mod(np.asarray(a) * np.asarray(scalar), modulus)


def random_payloads(
    rng: np.random.Generator, count: int, length: int = PAYLOAD_LENGTH
) -> np.ndarray:
    """Random byte payloads, shape (count, length) int64 in [0, 256).

    Counterpart of ``Payload::random`` (reference ``payload.rs:26-38``), which
    fills from random *bytes* (hence [0,256) even when p = 257).
    """
    return rng.integers(0, 256, size=(count, length), dtype=np.int64)
