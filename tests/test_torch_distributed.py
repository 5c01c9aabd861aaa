"""The port's multi-process sharding: two OS processes over gloo.

The twin of tests/test_distributed.py. tests/torch_distributed_worker.py
runs once per rank (2 CPU replicas each, 4 global shards, a ragged batch):
``distributed.init``, same-seed keys on every rank, sharded detect, both
digest encoders with the int64 all_reduce across the processes. The results
must equal a single-process run of the port with the same seeds, bit for
bit (and so the JAX package's, which tests/test_torch_parallel.py holds the
single-process port against). Then the whole pipeline through the CLI on
two ranks. Tolerance: none. Last, which card a rank of a group on cards
takes, with the calls to the cards and to the group stood in for.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.core.payload import random_payloads

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(commands, timeout):
    """Start one process per command, wait for all; their logs go into the
    assertion message."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for cmd in commands]
    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=timeout)
            logs.append(stdout.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)


def test_two_process_sharded_detect_and_digests(tmp_path):
    worker = os.path.join(ROOT, "tests", "torch_distributed_worker.py")
    out = tmp_path / "rank0.npz"
    coordinator = f"127.0.0.1:{_free_port()}"
    _run_ranks([[sys.executable, worker, coordinator, str(RANKS), str(rank), str(out)]
                for rank in range(RANKS)], timeout=600)
    got = np.load(out)

    # the single-process port with the same seeds
    params = OmrParameters.tiny()
    skp = SecretKeyPack(params, rng=21, ctx=OmrContext(params, "cpu"))
    detector = skp.generate_detector()
    count = got["pv"].shape[0]
    assert count == 11
    clues = skp.generate_sender().gen_clues(count, np.random.default_rng(22))
    pv = detector.detect(clues)
    rp = skp.generate_retriever(count, 2).params
    idx_ct = detector.encode_pertinent_indices(rp, pv, np.random.default_rng(7))
    payloads = random_payloads(np.random.default_rng(8), count, rp.payload_length)
    pay_cts = detector.encode_pertinent_payloads(rp, pv, payloads, 9)

    np.testing.assert_array_equal(got["pv"], pv.numpy())
    np.testing.assert_array_equal(got["idx_ct"], idx_ct.numpy())
    np.testing.assert_array_equal(got["pay_cts"], pay_cts.numpy())


def test_two_process_full_pipeline_through_the_cli(tmp_path):
    """Keygen, clues, sharded detect, both digest encoders with the
    cross-process reduce, decode and the byte-exact check on two ranks; only
    rank 0 writes the record."""
    omr = os.path.join(ROOT, "examples", "omr_torch.py")
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = [tmp_path / f"omr{rank}.json" for rank in range(RANKS)]
    _run_ranks([[sys.executable, omr, "--tiny", "--device", "cpu", "-p", "24",
                 "--batch", "24", "--seed", "77", "--coordinator", coordinator,
                 "--num-processes", str(RANKS), "--process-id", str(rank),
                 "--json", str(outs[rank])] for rank in range(RANKS)], timeout=900)
    assert not outs[1].exists()
    with open(outs[0]) as fh:
        art = json.load(fh)
    assert art["byte_exact"] is True
    assert art["true_subset_of_decoded"] is True
    assert art["device_count"] == 2 and art["process_group_backend"] == "gloo"
    assert art["payload_count"] == 24


def test_one_rank_group_runs_the_reduce_through_the_cli(tmp_path):
    """A process group of one rank: the digests still pass through the
    group's all_reduce (how a one-card machine drives the NCCL path), the
    board is detected in batches and needs no seed."""
    omr = os.path.join(ROOT, "examples", "omr_torch.py")
    out = tmp_path / "omr.json"
    _run_ranks([[sys.executable, omr, "--tiny", "--device", "cpu", "-p", "10",
                 "--batch", "4", "--coordinator", f"127.0.0.1:{_free_port()}",
                 "--num-processes", "1", "--process-id", "0", "--json", str(out)]],
               timeout=600)
    with open(out) as fh:
        art = json.load(fh)
    assert art["byte_exact"] is True and art["true_subset_of_decoded"] is True
    assert art["device_count"] == 1


def test_multi_process_run_needs_a_seed():
    """Without --seed the ranks would derive different keys: each exits
    non-zero and says so."""
    omr = os.path.join(ROOT, "examples", "omr_torch.py")
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, omr, "--tiny", "--device", "cpu", "-p", "4",
         "--coordinator", coordinator, "--num-processes", str(RANKS),
         "--process-id", str(rank)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(RANKS)]
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode != 0 and "--seed is required" in log, log


class _Cards:
    """Stand-ins for the calls ``distributed.init`` makes on a machine with
    ``count`` cards; records the card made current and the group's arguments."""

    def __init__(self, monkeypatch, count):
        self.current = 0
        self.group = None
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: self.current)
        monkeypatch.setattr(torch.cuda, "set_device", self._set_device)
        monkeypatch.setattr(torch.distributed, "init_process_group", self._init_group)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: self.group["world_size"])
        for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            monkeypatch.delenv(name, raising=False)

    def _set_device(self, device):
        self.current = torch.device(device).index

    def _init_group(self, **kwargs):
        self.group = kwargs


@pytest.fixture
def four_cards(monkeypatch):
    from tfhe_omr_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "_local_devices", None)
    return _Cards(monkeypatch, 4)


@pytest.mark.parametrize("device", [None, "cuda"])
@pytest.mark.parametrize("rank", [0, 1, 2, 3, 5])
def test_each_rank_takes_its_own_card(four_cards, rank, device):
    """Rank i of a group on cards binds card i modulo the visible cards,
    whatever card was current, and joins over nccl."""
    from tfhe_omr_tpu_torch.parallel import distributed

    assert distributed.init("127.0.0.1:1", 6, rank, device=device) == 6
    card = torch.device("cuda", rank % 4)
    assert distributed.local_devices() == [card]
    assert four_cards.current == card.index
    assert four_cards.group == dict(backend="nccl", init_method="tcp://127.0.0.1:1",
                                    world_size=6, rank=rank)


def test_rank_honours_local_rank_and_the_environment(four_cards, monkeypatch):
    """As torchrun starts it: the group from RANK / WORLD_SIZE / MASTER_ADDR,
    the card from LOCAL_RANK (rank 5 is the second process of its host)."""
    from tfhe_omr_tpu_torch.parallel import distributed

    for name, value in (("RANK", "5"), ("WORLD_SIZE", "8"), ("LOCAL_RANK", "1"),
                        ("MASTER_ADDR", "host0"), ("MASTER_PORT", "2900")):
        monkeypatch.setenv(name, value)
    assert distributed.init() == 8
    assert distributed.local_devices() == [torch.device("cuda", 1)]
    assert four_cards.current == 1
    assert four_cards.group["init_method"] == "tcp://host0:2900"
    assert four_cards.group["rank"] == 5


def test_rank_keeps_a_card_named_by_index(four_cards):
    from tfhe_omr_tpu_torch.parallel import distributed

    distributed.init("127.0.0.1:1", 2, 0, device="cuda:3")
    assert distributed.local_devices() == [torch.device("cuda", 3)]
    assert four_cards.current == 3


def test_cpu_ranks_join_over_gloo_and_touch_no_card(four_cards):
    from tfhe_omr_tpu_torch.parallel import distributed

    distributed.init("127.0.0.1:1", 2, 1, device="cpu")
    assert distributed.local_devices() == [torch.device("cpu")]
    assert four_cards.group["backend"] == "gloo" and four_cards.current == 0


def test_ranks_on_cards_raise_where_there_is_no_card(monkeypatch):
    from tfhe_omr_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        distributed.init("127.0.0.1:1", 2, 0)
    assert distributed.local_devices() is None
