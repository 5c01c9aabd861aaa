"""The port's dry-run entry (``tfhe_omr_tpu_torch/entry.py``) on the CPU.

``dryrun_multichip`` runs a sharded detect and both sharded encoders and
asserts them equal to one device's; with no card it runs only where the
caller names the CPU. Imports no jax.
"""

import pytest
import torch

from tfhe_omr_tpu_torch import entry

torch.set_num_threads(1)


def test_dryrun_multichip_over_three_cpu_devices():
    rec = entry.dryrun_multichip(3, devices=["cpu"] * 3)
    assert rec == {"devices": ["cpu"] * 3, "batch": 6, "params": "tiny",
                   "payload_cts": rec["payload_cts"]}
    assert rec["payload_cts"] >= 1


def test_dryrun_multichip_needs_cards_or_named_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="2 devices for 3"):
        entry.dryrun_multichip(3, devices=["cpu"] * 2)


def test_dryrun_multichip_needs_as_many_cards_as_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 4 cards, have 1"):
        entry.dryrun_multichip(4)
