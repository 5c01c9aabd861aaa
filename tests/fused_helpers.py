"""A helper of the blind-rotation tests on the host build and on the card
(no jax and no fixture: the card's tests run without conftest.py)."""

import contextlib
from unittest import mock

from tfhe_omr_tpu_torch.ops import fused


@contextlib.contextmanager
def cluster_of(c: int):
    """Within it, every launch of a blind rotation that has cluster variants
    takes clusters of ``c`` CTAs a sample (1: the one-block kernel),
    whatever its shape and the card."""
    with mock.patch.object(fused, "cluster_size", lambda *args: c):
        yield
