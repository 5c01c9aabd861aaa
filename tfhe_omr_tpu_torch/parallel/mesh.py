"""Sharded detection + digest reduction over several devices.

PyTorch counterpart of :mod:`tfhe_omr_tpu.parallel.mesh`. Every message is
independent, so

* the clues of a batch are split over the shards: this process's devices
  and, when a ``torch.distributed`` process group is up, the other ranks'
  (global shards = ranks x local devices, rank-major). The pertinency
  stack stays where detection left it, each shard's rows on its device
  (:class:`RankRows`), from ``detect`` to the digest encoders;
* the detection key is replicated, one :class:`Detector` per local device
  (:meth:`Detector.to`: the keys are copied as they lie on the first);
* a digest is an exact modular sum over the messages: every shard runs the
  single-device chunk loop over its rows with the *global* message indices,
  draws and weights, and the partial sums (each below q2 < 2**50) are added
  as int64, on the first local device and by one ``all_reduce`` across
  ranks, then reduced mod q2 once. Up to 2**11 shards stay below 2**62.

The sum is exact, so sharded digests are bit-identical to single-device
ones at any shard count and any (uneven) split. Nothing is padded: the
kernels mask ragged batches, so a shard simply takes fewer rows.

The random streams do not depend on the split: all bucket draws of an index
digest come from one ``rng.integers`` call and the weight stream is drawn
once (:func:`draw_index_buckets`, :func:`payload_weights`) before any
slicing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from tfhe_omr_tpu_torch.core.detector import (
    Detector,
    draw_index_buckets,
    payload_weights,
    warm_detect,
    warm_encode,
)
from tfhe_omr_tpu_torch.core.sender import ClueBatch
from tfhe_omr_tpu_torch.parallel import distributed
from tfhe_omr_tpu_torch.utils.build import resolve_device
from tfhe_omr_tpu_torch.utils.timing import synchronize


def _group_is_up() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclass(frozen=True)
class DataMesh:
    """This process's devices and its place among the ranks. Every rank
    holds the same number of devices."""

    devices: tuple[torch.device, ...]
    rank: int = 0
    world: int = 1

    @property
    def n_dev(self) -> int:
        """Global shard count: ranks x local devices."""
        return self.world * len(self.devices)


def make_data_mesh(devices=None) -> DataMesh:
    """A 1-D mesh over this process's devices and, when a process group is
    up, over every rank's.

    ``devices`` defaults to the device :func:`distributed.init` gave this
    rank, else to every visible card (with no card this raises: name the
    CPU with ``devices=["cpu"] * n``).
    """
    if devices is None:
        devices = distributed.local_devices()
    if devices is None:
        resolve_device(None)  # raises where there is no card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(resolve_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if not _group_is_up():
        return DataMesh(devices)
    mesh = DataMesh(devices, dist.get_rank(), dist.get_world_size())
    # every rank must bring the same number of devices: the split of a
    # board is computed, not communicated
    n = torch.tensor([len(devices), -len(devices)], device=devices[0])
    dist.all_reduce(n, op=dist.ReduceOp.MAX)
    if int(n[0]) != -int(n[1]):
        raise ValueError(f"ranks hold between {-int(n[1])} and {int(n[0])} devices")
    return mesh


@dataclass
class RankRows:
    """This process's rows of a pertinency stack of ``total`` messages that
    lies sharded over the local devices and the ranks: ``parts[i]`` holds
    the rows of this process's i-th non-empty shard (``bounds`` of the
    :class:`ShardedDetector`) on that shard's replica's device, and ``lo``
    is the first row of the first part. Nothing stacks the parts but
    :meth:`ShardedDetector.gather`."""

    parts: list[torch.Tensor]
    lo: int
    total: int


class ShardedDetector:
    """Runs a Detector's detect and digest encoders over a data mesh."""

    def __init__(self, detector: Detector, mesh: DataMesh):
        self.detector = detector
        self.mesh = mesh
        self.n_dev = mesh.n_dev
        assert self.n_dev <= 1 << 11, "the int64 sum of the partials would overflow"
        #: one replica per local device (the detector itself on its own)
        self.replicas = [detector.to(dev) for dev in mesh.devices]
        self.device = self.replicas[0].device

    # --------------------------------------------------------------- split
    def bounds(self, total: int) -> list[int]:
        """Row bounds of the global shards of a board of ``total``
        messages: shard ``s`` holds rows ``bounds[s] .. bounds[s + 1]``,
        sizes differing by at most one."""
        return [total * s // self.n_dev for s in range(self.n_dev + 1)]

    def _local(self, total: int) -> list[tuple[Detector, int, int]]:
        """(replica, lo, hi) of this process's non-empty shards."""
        b = self.bounds(total)
        first = self.mesh.rank * len(self.replicas)
        return [(rep, b[first + i], b[first + i + 1])
                for i, rep in enumerate(self.replicas)
                if b[first + i] < b[first + i + 1]]

    def _rank_rows(self, pertinency) -> RankRows:
        """A whole stack (one process), sliced into the local shards' rows
        where it lies, or the RankRows that :meth:`detect` returned."""
        if isinstance(pertinency, RankRows):
            return pertinency
        if self.mesh.world > 1:
            raise ValueError("multi-process encoders need the RankRows that "
                             "ShardedDetector.detect returned")
        total = pertinency.shape[0]
        return RankRows([pertinency[lo:hi] for _rep, lo, hi in self._local(total)],
                        0, total)

    def _reduce(self, partials: list[torch.Tensor], shape) -> torch.Tensor:
        """Exact sum mod q2 of every shard's partial digest (each of
        ``shape``): int64 sums on the first local device, one all_reduce
        across ranks, one reduce."""
        f2 = self.detector.ctx.f2
        total = torch.zeros(shape, dtype=torch.int64, device=self.device)
        for p in partials:
            total = total + p.to(self.device)
        if _group_is_up():
            dist.all_reduce(total, op=dist.ReduceOp.SUM)
        return f2.reduce(total, f2.bits + self.n_dev.bit_length() + 1)

    # ----------------------------------------------------------------- api
    def detect(self, clues: ClueBatch, batch: int | None = None) -> RankRows:
        """Sharded batched detection: this process's rows of the pertinency
        cts (B, 2, N2) as :class:`RankRows`, one part per local shard on
        its replica's device, in one process as across ranks. Nothing
        copies rows between devices.

        Each replica detects its rows in calls of at most ``batch``
        messages (all at once by default), written into its part. Every
        replica's work is queued before anything waits, so the devices run
        side by side."""
        total = clues.a.shape[0]
        shards = self._local(total)
        step = batch or max(total, 1)
        calls = -(-max((hi - lo for _rep, lo, hi in shards), default=0) // step)
        parts = [None] * len(shards)
        for j in range(calls):  # call j of every replica, queued side by side
            for i, (rep, lo, hi) in enumerate(shards):
                a, e = lo + j * step, min(lo + (j + 1) * step, hi)
                if a >= e:
                    continue
                out = rep.detect(ClueBatch(clues.a[a:e], clues.b7[a:e]))
                if e - a == hi - lo:
                    parts[i] = out
                    continue
                if parts[i] is None:
                    parts[i] = out.new_empty((hi - lo,) + tuple(out.shape[1:]))
                parts[i][a - lo:e - lo] = out
        b = self.bounds(total)
        return RankRows(parts, b[self.mesh.rank * len(self.replicas)], total)

    def _sizes(self, total: int) -> list[int]:
        """This process's shard sizes of ``total`` messages, one per
        replica (0 for an empty shard)."""
        b = self.bounds(total)
        first = self.mesh.rank * len(self.replicas)
        return [b[first + i + 1] - b[first + i] for i in range(len(self.replicas))]

    def warm(self, batch: int) -> list[dict]:
        """:meth:`Detector.warm` on every local replica at its shard's size
        of a batch of ``batch`` messages (:meth:`bounds`): every replica's
        zero-clue detect is queued before anything waits, as in
        :meth:`detect`. One dict per local device, in the replicas' order;
        ``first_launch_s`` is from the first queued detect to that device's
        synchronisation (the devices run side by side)."""
        return warm_detect(self.replicas, self._sizes(batch))

    def warm_encoders(self, retrieval_params, total: int, chunk: int = 2048) -> list[dict]:
        """:meth:`Detector.warm_encoders` on every local replica at the
        chunk shape its shard of a board of ``total`` messages gives, every
        replica's work queued before anything waits. One dict per local
        device; draws nothing from any numpy stream."""
        return warm_encode(self.replicas, retrieval_params, self._sizes(total), chunk)

    def gather(self, pertinency) -> np.ndarray:
        """The whole stack on the host of every rank (a collective). For
        tests and small boards: at D = 65536 the stack is 2.1 GB."""
        rr = self._rank_rows(pertinency)
        mine = (np.concatenate([p.cpu().numpy() for p in rr.parts]) if rr.parts
                else np.zeros((0, 2, self.detector.ctx.params.n2), dtype=np.int64))
        if self.mesh.world == 1:
            return mine
        parts = [None] * self.mesh.world
        dist.all_gather_object(parts, mine)
        return np.concatenate(parts)

    def synchronize(self) -> None:
        """Wait for every local device's queued work."""
        for rep in self.replicas:
            synchronize(rep.device)

    def encode_chunk(self, pertinency, plain) -> torch.Tensor:
        """One digest chunk, sum over the messages of pert * NTT(plain)
        mod q2 -> (2, N2): pertinency (B, 2, N2), plaintext polys (B, N2)."""
        rr = self._rank_rows(pertinency)
        partials = []
        for (rep, lo, hi), part in zip(self._local(rr.total), rr.parts):
            zero = torch.zeros((2, plain.shape[1]), dtype=torch.int64, device=rep.device)
            partials.append(rep._encode_chunk(
                rep._on_device(part), rep._on_device(plain[lo:hi]), zero,
                rep._fwd(False)))
        return self._reduce(partials, (2, plain.shape[1]))

    def encode_pertinent_indices(self, retrieval_params, pertinency, rng,
                                 chunk: int = 2048):
        """Sharded twin of ``Detector.encode_pertinent_indices``: the same
        rng stream (every draw up front), each shard's rows through
        :meth:`Detector.encode_index_rows`, one exact reduce."""
        rp = retrieval_params
        rr = self._rank_rows(pertinency)
        base_addr = draw_index_buckets(rp, rr.total, rng)
        partials = [rep.encode_index_rows(rp, part, base_addr[lo:hi], lo, chunk)
                    for (rep, lo, hi), part in zip(self._local(rr.total), rr.parts)]
        return self._reduce(partials, (2, rp.polynomial_size))

    def encode_pertinent_payloads(self, retrieval_params, pertinency, payloads,
                                  seed, chunk: int = 2048):
        """Sharded twin of ``Detector.encode_pertinent_payloads``: the
        weight stream drawn once with its prefix slice, each shard's rows
        through :meth:`Detector.encode_payload_rows`, one exact reduce."""
        rp = retrieval_params
        rr = self._rank_rows(pertinency)
        weights = payload_weights(rp, seed, rr.total)
        payloads = np.asarray(payloads)
        partials = [rep.encode_payload_rows(rp, part, payloads[lo:hi],
                                            weights[:, :, lo:hi], chunk)
                    for (rep, lo, hi), part in zip(self._local(rr.total), rr.parts)]
        return self._reduce(partials, (rp.cmb_cipher_count, 2, rp.polynomial_size))
