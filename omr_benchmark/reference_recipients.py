"""The plain reference of a detector that holds many recipients' keys: one
``reference.Omr`` a recipient, each with secrets of its own, each detecting,
encoding and decoding with its own key. Plain PyTorch; it imports nothing of
the program under test and nothing of JAX.

Recipient 0 is ``reference.Omr(params, device, seed)``, the recipient the
harness makes; recipient r > 0 is the same configuration's ``Omr`` seeded by
:func:`recipient_seed` (seed, r). Each recipient's detection key is the first
thing drawn from its generator, so a key made again from the seed is the
key the run used.

The digests of a message are drawn the way a detector of many recipients
draws them: every recipient's index-digest buckets in one ``rng.integers``
call (:func:`bucket_draws`), then one shared seed whose stream gives every
recipient's payload weights in one call (:func:`payload_weights`), which
each recipient draws again to decode.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from omr_benchmark import reference


def recipient_seed(seed: int, r: int) -> int:
    """The seed of recipient ``r``'s secrets and keys: ``seed`` for recipient
    0 (the harness's), else a 63-bit word of the seed sequence (seed, r)."""
    if r == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), r]).generate_state(1, np.uint64)[0] >> 1)


def recipient(base: reference.Omr, seed: int, r: int) -> reference.Omr:
    """Recipient ``r``'s reference: ``base`` (``Omr(params, device, seed)``)
    for r = 0, else ``Omr(params, device, recipient_seed(seed, r))`` with its
    tables (fields, NTTs, lookup tables), which the seed does not move,
    shared with ``base``: its own generator, its own secrets."""
    if r == 0:
        return base
    other = copy.copy(base)
    other.gen = torch.Generator(device=base.device)
    other.gen.manual_seed(recipient_seed(seed, r) % (1 << 63))
    other.secrets()
    return other


def bucket_draws(lay: reference.Layout, recipients: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Every index digest's bucket draws of every recipient, (R, index_cts,
    D, segs) first slots, in one ``rng.integers`` call."""
    buckets = rng.integers(0, lay.buckets, size=(recipients, lay.index_cts, lay.total, lay.segs),
                           dtype=np.int64)
    return np.arange(lay.segs, dtype=np.int64) * lay.sps + buckets * lay.spb


def payload_weights(lay: reference.Layout, seed: int, recipients: int) -> np.ndarray:
    """Every recipient's payload weights (R, payload_cts, per_cipher, D) from
    one ``rng.integers`` call of the stream of ``seed``: each recipient's
    rows past the combinations are 0 (``reference.payload_weights`` of one
    recipient)."""
    rng = np.random.default_rng(seed)
    w = np.zeros((recipients, lay.payload_cts * lay.per_cipher, lay.total), dtype=np.int64)
    w[:, :lay.combinations] = rng.integers(0, lay.p, size=(recipients, lay.combinations,
                                                           lay.total), dtype=np.int64)
    return w.reshape(recipients, lay.payload_cts, lay.per_cipher, lay.total)


def digests(omr: reference.Omr, lay: reference.Layout, pert: torch.Tensor,
            base_addr: np.ndarray, payloads: torch.Tensor, weights: np.ndarray, r: int):
    """Recipient ``r``'s digests of its pertinency stack ``pert`` (D, 2, N2):
    (index digests (index_cts, 2, N2), payload digests (payload_cts, 2,
    N2)), ``base_addr`` the draws of :func:`bucket_draws` and ``weights``
    those of :func:`payload_weights`."""
    dev = omr.device
    index = torch.stack([omr.index_digest(lay, pert, torch.as_tensor(base_addr[r, k], device=dev))
                         for k in range(lay.index_cts)])
    return index, omr.payload_digests(lay, pert, payloads.to(dev),
                                      torch.as_tensor(weights[r], device=dev))
