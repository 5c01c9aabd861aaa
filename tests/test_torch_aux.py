"""The port's payload ring operations and its key-size accounting.

Twins of ``tests/test_aux.py::test_payload_ring_ops`` and
``::test_key_size_accounting`` (the other cases of that file have theirs
elsewhere in the port's tests). Imports no jax.
"""

import numpy as np
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.core.payload import (
    payload_add, payload_mul_scalar, payload_sub, random_payloads,
)

torch.set_num_threads(1)


def test_payload_ring_ops():
    """Payload add/sub/mul_scalar mod p (reference payload.rs:53-103)."""
    rng = np.random.default_rng(0)
    p = 257
    a = random_payloads(rng, 4)
    b = random_payloads(rng, 4)
    s = int(rng.integers(0, p))
    assert np.array_equal(payload_add(a, b, p), (a + b) % p)
    assert np.array_equal(payload_sub(a, b, p), (a - b) % p)
    assert np.array_equal(payload_mul_scalar(a, s, p), (a * s) % p)
    assert np.array_equal(payload_sub(payload_add(a, b, p), b, p), a % p)
    w = rng.integers(0, p, size=(4, 1))  # per-message scalars (digest weights)
    assert np.array_equal(payload_mul_scalar(a, w, p), (a * w) % p)


def test_detect_key_size():
    """The bytes of the detection key the detector holds: every tensor of
    its key objects and the float64 KSK, in the port's own layout (here
    the CPU's: the reference order beside the Shoup companions), which is
    the DetectionKey that keygen made, byte for byte."""
    params = OmrParameters.tiny()
    ctx = OmrContext(params, "cpu")
    det = SecretKeyPack(params, rng=5, ctx=ctx).generate_detector()
    held = [*det.br1.keys, *det.br2.keys, *det.tr.keys, det.ksk_f64]
    size = det.detect_key_size()
    assert len(held) == 7 and len({id(t) for t in held}) == 7
    assert size == sum(t.numel() * t.element_size() for t in held) > 0
    dkey = SecretKeyPack(params, rng=5, ctx=ctx).generate_detection_key()
    assert size == dkey.nbytes()
    sender = SecretKeyPack(params, rng=5, ctx=ctx).generate_sender()
    assert sender.clue_key_size() > 0
