"""Dry-run entry points of the port: one detect step, and a sharded detect
and both sharded encoders checked against one device.

Counterpart of the JAX package's ``__graft_entry__.py`` (``entry`` and
``dryrun_multichip``), with the same seeds. Both run on the card unless the
caller names other devices.

Usage: python -m tfhe_omr_tpu_torch.entry   # entry() once on the card
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.core.payload import random_payloads
from tfhe_omr_tpu_torch.parallel import ShardedDetector, make_data_mesh
from tfhe_omr_tpu_torch.utils.build import resolve_device
from tfhe_omr_tpu_torch.utils.timing import synchronize

BATCH = 8


def entry(device=None):
    """``(fn, example_args)``: ``fn(*example_args)`` is one detect of
    ``BATCH`` messages at the reference parameters, through the kernels on
    the card, returning the (8, 2, N2) pertinency ciphertexts."""
    params = OmrParameters.default()
    skp = SecretKeyPack(params, rng=0, ctx=OmrContext(params, device))
    detector = skp.generate_detector()
    sender = skp.generate_sender()
    clues = sender.gen_clues(BATCH, np.random.default_rng(1))
    return detector.detect, (clues,)


def dryrun_multichip(n_devices: int, default_params: bool = False,
                     devices=None) -> dict:
    """One sharded detect and both sharded digest encoders over
    ``n_devices`` devices, each held equal to the single-device programs;
    raises ``AssertionError`` where they differ.

    ``devices`` defaults to the first ``n_devices`` visible cards (with
    fewer cards, or none, this raises); ``devices=["cpu"] * n`` runs the
    plain path on the host. Tiny parameters unless ``default_params``.
    A batch of two messages a device. Returns what ran."""
    if devices is None:
        resolve_device(None)  # raises where there is no card
        count = torch.cuda.device_count()
        if count < n_devices:
            raise RuntimeError(f"dryrun_multichip: need {n_devices} cards, have {count}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = [resolve_device(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError(f"dryrun_multichip: {len(devices)} devices for {n_devices}")
    params = OmrParameters.default() if default_params else OmrParameters.tiny()
    skp = SecretKeyPack(params, rng=0, ctx=OmrContext(params, devices[0]))
    detector = skp.generate_detector()
    sender = skp.generate_sender()
    bsz = 2 * n_devices
    clues = sender.gen_clues(bsz, np.random.default_rng(1))
    sharded = ShardedDetector(detector, make_data_mesh(devices))

    pv = sharded.detect(clues)
    rp = skp.generate_retriever(bsz, 2).params
    idx_ct = sharded.encode_pertinent_indices(rp, pv, np.random.default_rng(3), chunk=bsz)
    payloads = random_payloads(np.random.default_rng(4), bsz, rp.payload_length)
    pay_cts = sharded.encode_pertinent_payloads(rp, pv, payloads, 5, chunk=bsz)
    sharded.synchronize()

    single = detector.detect(clues)
    s_idx = detector.encode_pertinent_indices(rp, single, np.random.default_rng(3),
                                              chunk=bsz)
    s_pay = detector.encode_pertinent_payloads(rp, single, payloads, 5, chunk=bsz)
    np.testing.assert_array_equal(sharded.gather(pv), single.cpu().numpy())
    np.testing.assert_array_equal(idx_ct.cpu().numpy(), s_idx.cpu().numpy())
    np.testing.assert_array_equal(pay_cts.cpu().numpy(), s_pay.cpu().numpy())
    return {"devices": [str(d) for d in devices], "batch": bsz,
            "params": "default" if default_params else "tiny",
            "payload_cts": int(pay_cts.shape[0])}


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    synchronize(out.device)
    print("entry() ok:", tuple(out.shape), out.device)
