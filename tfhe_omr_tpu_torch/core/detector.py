"""Detector: batched two-level bootstrapping + trace + digest encoders.

PyTorch counterpart of :mod:`tfhe_omr_tpu.core.detector`. Per message:

    stage1: extract the 7 clue samples, 7 paired first-level blind
            rotations (kernel), their sum, sample extraction, key switch
            z1 -> s2, mod switch q1 -> 4096, b += 7*Delta
    stage2: one paired second-level blind rotation (kernel)
    stage3: x N^-1, homomorphic trace (kernel), forward NTT (kernel) into
            the reference slot order

Between the stages the accumulators are message-major ``(B, 2, N)``, the
layout the kernels run in. The output is ``(B, 2, N2)`` as in the JAX
package. On a CUDA device every kernel of the path runs; ``plain=True``
runs the plain torch versions instead (on any device), which is how the
kernels are held against them on the card.

The digest encoders (``encode_pertinent_indices`` /
``encode_pertinent_payloads``, reference ``detector.rs:223-453``) read the
``(D, 2, N2)`` pertinency stack where it lies, on the detector's device, in
chunks of messages: per chunk the plaintext polynomials are built on the
device, taken to the NTT domain (the q2 NTT kernel on a card), multiplied
into the pertinency ciphertexts and summed over the messages mod q2. The
JAX package's ``lax.scan`` over whole chunks plus a ragged-tail call is
one Python loop here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.keygen import DetectionKey
from tfhe_omr_tpu_torch.core.params import RetrievalParams
from tfhe_omr_tpu_torch.core.sender import ClueBatch
from tfhe_omr_tpu_torch.ops.bootstrap import (
    extract_constant_lwe,
    init_accumulator,
    lwe_modulus_switch,
    make_lwe_keyswitch,
)
from tfhe_omr_tpu_torch.ops.fused import (
    BlindRotateKey,
    TraceKey,
    blind_rotate,
    blind_rotate_plain,
    trace,
    trace_plain,
)
from tfhe_omr_tpu_torch.utils import build
from tfhe_omr_tpu_torch.utils.build import resolve_device
from tfhe_omr_tpu_torch.utils.timing import StageTimer, synchronize


def _centre(v: torch.Tensor, idx_p: int, q2: int) -> torch.Tensor:
    """Residues mod p in [0, p) -> centred representatives mod q2."""
    return torch.where(v < (idx_p + 1) >> 1, v, q2 - idx_p + v)


def index_poly_device(base_addr: torch.Tensor, idx: torch.Tensor, nd: int,
                      n2v: int, idx_p: int, q2: int) -> torch.Tensor:
    """Index plaintext polys (B, N2), centred mod q, on ``idx``'s device.

    For each message: write the ``nd`` base-p digits of ``idx`` (LSB first)
    and a flag 1 into the drawn bucket's slots of every segment
    (``base_addr`` (B, segs) holds each bucket's first slot; counterpart
    of ``detector.rs:271-323``). The slots of one message never collide,
    so a scatter gives the integers of the JAX package's one-hot slot sums.
    """
    poly = torch.zeros((idx.shape[0], n2v), dtype=torch.int64, device=idx.device)
    segs = base_addr.shape[1]
    v = idx
    for k in range(nd + 1):
        if k < nd:
            val = _centre(v % idx_p, idx_p, q2)
            v = v // idx_p
        else:
            val = torch.ones_like(idx)  # flag slot
        poly.scatter_(1, base_addr + k, val[:, None].expand(-1, segs))
    return poly


def payload_plain_device(payloads: torch.Tensor, weights_k: torch.Tensor,
                         n2v: int, idx_p: int, q2: int) -> torch.Tensor:
    """Weighted-payload plaintext polys (B, N2), centred mod q, for ONE
    combination ciphertext: combination c fills slots
    [c*plen, (c+1)*plen) (``detector.rs:412-433``). payloads (B, plen),
    weights_k (cmb, B)."""
    cmb = weights_k.shape[0]
    bsz, plen = payloads.shape
    wp = (payloads[None, :, :] * weights_k[:, :, None]) % idx_p  # (cmb, B, plen)
    poly = torch.zeros((bsz, n2v), dtype=torch.int64, device=payloads.device)
    poly[:, : cmb * plen] = _centre(wp, idx_p, q2).permute(1, 0, 2).reshape(
        bsz, cmb * plen)
    return poly


@dataclass
class DetectStageTimes:
    """Per-stage seconds of one ``detect_with_time_info`` call."""

    detect_time: float = 0.0
    first_level_bootstrapping_time: float = 0.0
    second_level_bootstrapping_time: float = 0.0
    trace_time: float = 0.0


class Detector:
    """The server: holds the detection key, on ``device``, once."""

    def __init__(self, detection_key: DetectionKey, ctx: OmrContext,
                 device=None):
        device = resolve_device(device) if device is not None else ctx.device
        if device != ctx.device:
            ctx = OmrContext(ctx.params, device)
        key = DetectionKey(*(t.to(device) for t in detection_key))
        self._assemble(
            ctx,
            BlindRotateKey(key.bsk1, key.bsk1_sh, ctx.ntt1, ctx.gadget_br1,
                           "blind_rotate1"),
            BlindRotateKey(key.bsk2, key.bsk2_sh, ctx.ntt2, ctx.gadget_br2,
                           "blind_rotate2"),
            TraceKey(key.trace_k, key.trace_k_sh, ctx.ntt2, ctx.gadget_trace,
                     ctx.trace_autos),
            key.ksk.to(torch.float64))

    def _assemble(self, ctx: OmrContext, br1: BlindRotateKey,
                  br2: BlindRotateKey, tr: TraceKey,
                  ksk_f64: torch.Tensor) -> None:
        """Every attribute of a detector, from keys that lie on the
        context's device in the layouts they are held in: the one path by
        which ``__init__`` and ``to`` fill a detector."""
        self.br1, self.br2, self.tr, self.ksk_f64 = br1, br2, tr, ksk_f64
        self.ctx = ctx
        device = self.device = ctx.device
        p = ctx.params
        self._c = p.clue_count
        self._n0 = p.clue_params.dimension
        self.q0 = p.clue_params.cipher_modulus
        self.q_inter = p.intermediate_lwe.cipher_modulus
        assert self.q0 == 2 * p.n1, "clue modulus must equal 2*N1"
        assert self.q_inter == 2 * p.n2
        # b += clue_count * Delta_inter (reference ``detector.rs:580-594``)
        self.inter_offset = p.clue_count * (
            self.q_inter // p.intermediate_lwe.plain_modulus
        )
        ks = p.first_level_ks
        self.keyswitch = make_lwe_keyswitch(ctx.f1, ks.digits, ks.out_dimension)

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

        self.lut1 = dev(ctx.lut1_ext)
        self.lut2 = dev(ctx.lut2_ext)
        ex_idx, ex_neg = ctx.clue_extract_tables
        self.ex_idx = dev(ex_idx)
        self.ex_neg = dev(ex_neg).bool()
        self.n2_inv = ctx.f2.inv(p.n2)
        self.n2_inv_sh = int(ctx.f2.shoup(self.n2_inv))

    def to(self, device) -> "Detector":
        """A replica of this detector on another device of the same kind
        (itself when ``device`` is its own): the keys are copied as they
        lie, in the layouts they are held in (on a card the kernels'), the
        tables are made anew on ``device``."""
        device = resolve_device(device)
        if device == self.device:
            return self
        ctx = OmrContext(self.ctx.params, device)
        other = Detector.__new__(Detector)
        other._assemble(ctx, self.br1.to(ctx.ntt1), self.br2.to(ctx.ntt2),
                        self.tr.to(ctx.ntt2, ctx.trace_autos),
                        self.ksk_f64.to(device))
        return other

    # --------------------------------------------------------------- stages
    def stage1(self, clue_a: torch.Tensor, clue_b7: torch.Tensor,
               plain: bool = False):
        """Extract + first-level bootstrapping + key switch + mod switch
        (reference ``detector.rs:505-597``) -> (ms_a (B, n_int), ms_b (B,))."""
        f1 = self.ctx.f1
        n1 = self.ctx.params.n1
        q0 = self.q0
        bsz = clue_a.shape[0]
        vals = clue_a[:, self.ex_idx]  # (B, c, n0) extract_all index map
        a_ext = torch.where(self.ex_neg, (q0 - vals) % q0, vals)
        amounts1 = a_ext.reshape(bsz * self._c, self._n0).T.contiguous()
        b1 = clue_b7.reshape(bsz * self._c)
        acc = init_accumulator(self.lut1, b1, n1).permute(2, 1, 0)  # (M, 2, N1)
        br = blind_rotate_plain if plain else blind_rotate
        acc = br(acc, amounts1, self.br1)
        # sum the 7 per-clue results (``detector.rs:556``)
        acc = f1.mod_sum(acc.reshape(bsz, self._c, 2, n1), dim=1)
        a_vec, b0 = extract_constant_lwe(f1, acc.permute(2, 1, 0))
        ks_a, ks_b = self.keyswitch(a_vec.T, b0, self.ksk_f64)
        ms_a = lwe_modulus_switch(f1, ks_a, self.q_inter)
        ms_b = lwe_modulus_switch(f1, ks_b, self.q_inter)
        ms_b = (ms_b + self.inter_offset) & (self.q_inter - 1)
        return ms_a, ms_b

    def stage2(self, ms_a: torch.Tensor, ms_b: torch.Tensor,
               plain: bool = False) -> torch.Tensor:
        """Second-level blind rotation (``detector.rs:599-624``) -> acc2
        (B, 2, N2)."""
        acc2 = init_accumulator(self.lut2, ms_b, self.ctx.params.n2)
        acc2 = acc2.permute(2, 1, 0)  # (B, 2, N2)
        br = blind_rotate_plain if plain else blind_rotate
        return br(acc2, ms_a.T.contiguous(), self.br2)

    def stage3(self, acc2: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x N^-1, homomorphic trace, to the NTT domain
        (``detector.rs:626-639``) -> (B, 2, N2)."""
        f2 = self.ctx.f2
        acc2 = f2.mul_shoup(acc2, self.n2_inv, self.n2_inv_sh)
        if plain:
            return self.ctx.ntt2.fwd_last_plain(trace_plain(acc2, self.tr))
        return self.ctx.ntt2.fwd_last(trace(acc2, self.tr))

    # --------------------------------------------------------------- detect
    def _on_device(self, x) -> torch.Tensor:
        """A numpy array or a tensor as int64 on the detector's device."""
        return torch.as_tensor(x, dtype=torch.int64, device=self.device)

    def _clues(self, clues: ClueBatch):
        return self._on_device(clues.a), self._on_device(clues.b7)

    def detect(self, clues: ClueBatch, plain: bool = False) -> torch.Tensor:
        """Pertinency ciphertexts (B, 2, N2): NTT-domain RLWE cts, reference
        slot order, encrypting Delta2 * pertinency_bit in the constant slot.
        ``clues`` holds numpy arrays or tensors (e.g. device-resident clues
        from :meth:`Sender.gen_clues_device_resident`)."""
        ms_a, ms_b = self.stage1(*self._clues(clues), plain=plain)
        return self.stage3(self.stage2(ms_a, ms_b, plain=plain), plain=plain)

    def detect_with_time_info(self, clues: ClueBatch):
        """Per-stage timed detect; each stage ends in a device
        synchronisation."""
        a, b7 = self._clues(clues)
        synchronize(self.device)  # the clue upload stays out of stage1
        timer = StageTimer(self.device)
        ms_a, ms_b = timer.time("stage1", self.stage1, a, b7)
        acc2 = timer.time("stage2", self.stage2, ms_a, ms_b)
        out = timer.time("stage3", self.stage3, acc2)
        st = timer.stages
        return out, DetectStageTimes(
            detect_time=st["stage1"] + st["stage2"] + st["stage3"],
            first_level_bootstrapping_time=st["stage1"],
            second_level_bootstrapping_time=st["stage2"],
            trace_time=st["stage3"],
        )

    def detect_key_size(self) -> int:
        """Bytes the detector holds on its device for keys: one layout of
        each key (the kernels' on a card) and the float64 KSK."""
        return (
            self.br1.nbytes() + self.br2.nbytes() + self.tr.nbytes()
            + self.ksk_f64.numel() * self.ksk_f64.element_size()
        )

    # ----------------------------------------------------------------- warm
    def warm(self, batch: int) -> dict:
        """Pay before anything is timed what a first ``detect`` of ``batch``
        messages pays once: build or load the kernel library, then one
        detect of zero clues through K1, K2, K3 and K4, synchronised (the
        allocator's first blocks, the kernels' first launches and their
        shared-memory attributes). Counterpart of the JAX package's
        ``Detector.warm``, whose lowered-program cache has no counterpart.

        Returns ``{"device", "path", "build_s", "nvcc_s", "first_launch_s",
        "batch"}``: seconds of the build (0 when loaded; ``nvcc_s`` is this
        process's nvcc time) and of the warm detect. On the CPU the plain
        path runs (``path: "plain"``) and nothing is built."""
        return warm_detect([self], [batch])[0]

    def warm_encoders(self, retrieval_params: RetrievalParams, total: int,
                      chunk: int = 2048) -> dict:
        """One chunk of each digest encoder (:meth:`encode_index_rows`,
        :meth:`encode_payload_rows`) through K4 on zeros, at the chunk
        shape a board of ``total`` messages gives (``min(chunk, total)``
        rows), synchronised. Draws nothing from any numpy stream, so the
        digests after it are the ones without it. Counterpart of the JAX
        package's ``Detector.warm_encoders``.

        Returns ``{"device", "path", "build_s", "nvcc_s", "rows", "index_s",
        "payload_s"}``."""
        return warm_encode([self], retrieval_params, [total], chunk)[0]

    # ------------------------------------------------------- digest encoder
    def _encode_chunk(self, pert: torch.Tensor, plain: torch.Tensor,
                      acc: torch.Tensor, fwd) -> torch.Tensor:
        """acc + sum over the chunk's messages of pert * NTT(plain), mod q2.
        pert (B, 2, N2) NTT-domain pertinency cts; plain (B, N2) plaintext
        polys; acc (2, N2). Counterpart of ``encode_chunk``
        (``detector.rs:256-337``)."""
        f2 = self.ctx.f2
        pn = fwd(plain)  # (B, N2)
        return f2.add(acc, f2.mod_sum(f2.mul(pert, pn[:, None, :]), dim=0))

    def _fwd(self, plain: bool):
        ntt2 = self.ctx.ntt2
        return ntt2.fwd_last_plain if plain else ntt2.fwd_last

    def build_index_plaintexts(
        self,
        retrieval_params: RetrievalParams,
        count: int,
        rng: np.random.Generator,
        start_index: int = 0,
    ) -> np.ndarray:
        """Host: per-message index plaintext polys (count, N2), centred mod q
        (the host twin of :func:`index_poly_device`, same bucket draws).

        For each message and each segment in the ciphertext: pick a random
        bucket, write the base-p digits of the message index (LSB first) into
        the bucket's index slots and 1 into its flag slot
        (counterpart of ``detector.rs:271-323``).
        """
        rp = retrieval_params
        q = self.ctx.f2.q
        p = rp.index_modulus
        half_p = (p + 1) >> 1
        n2 = rp.polynomial_size
        spb = rp.slots_per_bucket
        sps = rp.slots_per_segment
        segs = rp.segment_per_cipher
        nd = rp.index_slots_per_bucket

        idx = np.arange(start_index, start_index + count, dtype=np.int64)
        buckets = rng.integers(
            0, rp.bucket_count_per_segment, size=(count, segs), dtype=np.int64
        )
        base_addr = np.arange(segs, dtype=np.int64)[None, :] * sps + buckets * spb
        polys = np.zeros((count, n2), dtype=np.int64)
        rows = np.arange(count)[:, None]
        v = idx.copy()
        digs = []
        for _ in range(nd):
            digs.append(v % p)
            v //= p
        for k in range(nd):
            dv = digs[k]
            centred = np.where(dv < half_p, dv, q - p + dv)
            polys[rows, base_addr + k] = centred[:, None]
        polys[rows, base_addr + nd] = 1  # flag slot
        return polys

    def encode_pertinent_indices(
        self,
        retrieval_params: RetrievalParams,
        pertinency,
        rng: np.random.Generator,
        chunk: int = 2048,
        plain: bool = False,
    ) -> torch.Tensor:
        """One index-digest ciphertext (2, N2) from the full pertinency stack
        (D, 2, N2), on the detector's device.

        Counterpart of ``Detector::encode_pertinent_indices``
        (``detector.rs:223-339``); call ``max_encode_indices_cipher_count``
        times for the redundant digests (``examples/omr.rs:180-183``). All
        bucket draws come first, in one ``rng.integers`` call, as in the JAX
        package, so one numpy stream gives both packages the same digest.
        ``plain=True`` runs the plain torch NTT instead of the kernel.
        """
        pert = self._on_device(pertinency)
        base_addr = draw_index_buckets(retrieval_params, pert.shape[0], rng)
        return self.encode_index_rows(retrieval_params, pert, base_addr, 0,
                                      chunk, plain)

    def encode_index_rows(self, retrieval_params: RetrievalParams, pert,
                          base_addr: np.ndarray, lo: int, chunk: int = 2048,
                          plain: bool = False) -> torch.Tensor:
        """The part of an index digest that the messages ``lo ..
        lo + len(pert)`` of a board contribute: ``pert`` holds their
        pertinency cts, ``base_addr`` their rows of
        :func:`draw_index_buckets`. The parts of disjoint row ranges add up
        (mod q2) to the digest of the whole board."""
        rp = retrieval_params
        pert = self._on_device(pert)
        rows = pert.shape[0]
        base_addr = self._on_device(base_addr)
        idx = torch.arange(lo, lo + rows, dtype=torch.int64, device=self.device)
        acc = torch.zeros((2, rp.polynomial_size), dtype=torch.int64,
                          device=self.device)
        fwd = self._fwd(plain)
        for s in range(0, rows, chunk):
            e = min(s + chunk, rows)
            poly = index_poly_device(
                base_addr[s:e], idx[s:e], rp.index_slots_per_bucket,
                rp.polynomial_size, rp.index_modulus, self.ctx.f2.q,
            )
            acc = self._encode_chunk(pert[s:e], poly, acc, fwd)
        return acc

    def build_payload_plaintexts(
        self,
        retrieval_params: RetrievalParams,
        payloads: np.ndarray,
        weights: np.ndarray,
    ) -> np.ndarray:
        """Host: weighted-payload plaintext polys (B, N2), centred mod q
        (the host twin of :func:`payload_plain_device`).

        payloads: (B, payload_length); weights: (cmb_count_per_cipher, B).
        Slot layout: combination c occupies slots
        [c*payload_length, (c+1)*payload_length) (``detector.rs:412-433``).
        """
        rp = retrieval_params
        q = self.ctx.f2.q
        p = rp.index_modulus
        half_p = (p + 1) >> 1
        n2 = rp.polynomial_size
        plen = rp.payload_length
        bsz = payloads.shape[0]
        polys = np.zeros((bsz, n2), dtype=np.int64)
        for c in range(weights.shape[0]):
            wp = np.mod(payloads * weights[c][:, None], p)
            polys[:, c * plen : (c + 1) * plen] = np.where(
                wp < half_p, wp, q - p + wp
            )
        return polys

    def encode_pertinent_payloads(
        self,
        retrieval_params: RetrievalParams,
        pertinency,
        payloads: np.ndarray,
        seed,
        chunk: int = 2048,
        plain: bool = False,
    ) -> torch.Tensor:
        """All combination-digest ciphertexts (cmb_cipher_count, 2, N2), on
        the detector's device.

        Counterpart of ``Detector::encode_pertinent_payloads``
        (``detector.rs:341-453``). ``seed`` drives the shared weight stream
        that the retriever regenerates (``examples/omr.rs:194-203``). The
        payloads and weights go to the device once; ``plain=True`` runs the
        plain torch NTT instead of the kernel.
        """
        pert = self._on_device(pertinency)
        weights = payload_weights(retrieval_params, seed, pert.shape[0])
        return self.encode_payload_rows(retrieval_params, pert, payloads,
                                        weights, chunk, plain)

    def encode_payload_rows(self, retrieval_params: RetrievalParams, pert,
                            payloads, weights, chunk: int = 2048,
                            plain: bool = False) -> torch.Tensor:
        """The part of the payload digests that some messages of a board
        contribute: ``pert`` (rows, 2, N2), ``payloads`` (rows, plen) and
        ``weights`` (kct, cmb, rows) hold those messages' pertinency cts,
        payloads and columns of :func:`payload_weights` (numpy arrays or
        tensors). The parts of disjoint row ranges add up (mod q2) to the
        whole board's digests."""
        rp = retrieval_params
        pert = self._on_device(pert)
        rows = pert.shape[0]
        weights = self._on_device(weights)
        pay = self._on_device(payloads)
        kct = rp.cmb_cipher_count
        accs = torch.zeros((kct, 2, rp.polynomial_size), dtype=torch.int64,
                           device=self.device)
        fwd = self._fwd(plain)
        for s in range(0, rows, chunk):
            e = min(s + chunk, rows)
            for k in range(kct):
                poly = payload_plain_device(
                    pay[s:e], weights[k, :, s:e], rp.polynomial_size,
                    rp.index_modulus, self.ctx.f2.q,
                )
                accs[k] = self._encode_chunk(pert[s:e], poly, accs[k], fwd)
        return accs


def _warm_status(det: Detector) -> dict:
    """Build or load the kernel library (a card only); the keys and the
    kernels' tables are in place since the detector was made."""
    t0 = time.perf_counter()
    on_card = det.device.type == "cuda"
    if on_card:
        build.library()
    return {"device": str(det.device), "path": "kernels" if on_card else "plain",
            "build_s": time.perf_counter() - t0, "nvcc_s": build.build_seconds}


def _sync_all(dets: list[Detector], status: list[dict], key: str, t0: float) -> None:
    """Wait for each detector's device in turn; ``status[i][key]`` is the
    seconds from ``t0`` to that device's synchronisation."""
    for st, det in zip(status, dets):
        synchronize(det.device)
        st[key] = time.perf_counter() - t0


def warm_detect(dets: list[Detector], sizes: list[int]) -> list[dict]:
    """:meth:`Detector.warm` of ``dets[i]`` at ``sizes[i]`` messages, every
    detector's zero-clue detect queued before anything waits, so that
    several devices warm side by side. One dict each, in ``dets``' order;
    a size of 0 launches nothing."""
    status = [_warm_status(det) for det in dets]
    t0 = time.perf_counter()
    for det, size in zip(dets, sizes):
        if size:
            p = det.ctx.params
            det.detect(ClueBatch(
                torch.zeros((size, det._n0), dtype=torch.int64, device=det.device),
                torch.zeros((size, p.clue_count), dtype=torch.int64, device=det.device)))
    _sync_all(dets, status, "first_launch_s", t0)
    for st, size in zip(status, sizes):
        st["batch"] = size
    return status


def warm_encode(dets: list[Detector], retrieval_params: RetrievalParams,
                totals: list[int], chunk: int = 2048) -> list[dict]:
    """:meth:`Detector.warm_encoders` of ``dets[i]`` for a board (or shard)
    of ``totals[i]`` messages: every detector's index chunk is queued
    before anything waits, then every payload chunk. One dict each."""
    rp = retrieval_params
    status = [_warm_status(det) for det in dets]
    rows = [min(chunk, total) for total in totals]
    perts = [torch.zeros((r, 2, rp.polynomial_size), dtype=torch.int64,
                         device=det.device) for det, r in zip(dets, rows)]
    t0 = time.perf_counter()
    for det, r, pert in zip(dets, rows, perts):
        if r:
            det.encode_index_rows(
                rp, pert, np.zeros((r, rp.segment_per_cipher), dtype=np.int64), 0, chunk)
    _sync_all(dets, status, "index_s", t0)
    t0 = time.perf_counter()
    for det, r, pert in zip(dets, rows, perts):
        if r:
            det.encode_payload_rows(
                rp, pert, np.zeros((r, rp.payload_length), dtype=np.int64),
                np.zeros((rp.cmb_cipher_count, rp.cmb_count_per_cipher, r),
                         dtype=np.int64), chunk)
    _sync_all(dets, status, "payload_s", t0)
    for st, r in zip(status, rows):
        st["rows"] = r
    return status


def draw_index_buckets(rp: RetrievalParams, total: int,
                       rng: np.random.Generator) -> np.ndarray:
    """One index digest's bucket draws for a board of ``total`` messages,
    all in one ``rng.integers`` call (the stream of the JAX package, whatever
    way the board is split afterwards) -> (total, segs) first slot of each
    message's bucket in every segment."""
    segs = rp.segment_per_cipher
    buckets = rng.integers(
        0, rp.bucket_count_per_segment, size=(total, segs), dtype=np.int64,
    )
    return (np.arange(segs, dtype=np.int64)[None, :] * rp.slots_per_segment
            + buckets * rp.slots_per_bucket)


def payload_weights(rp: RetrievalParams, seed, total: int) -> np.ndarray:
    """The shared weight stream, drawn once for the layout's whole board,
    as (cmb_cipher_count, cmb_count_per_cipher, total): a board shorter than
    the layout's uses the first ``total`` columns."""
    return sample_weights(rp, seed).reshape(
        rp.cmb_cipher_count, rp.cmb_count_per_cipher, -1)[:, :, :total]


def sample_weights(rp: RetrievalParams, seed) -> np.ndarray:
    """The shared detector/retriever weight stream.

    (combination_count_padded, all_payloads_count) uniform in [0, p); rows
    beyond combination_count are zero (the reference sizes the buffer by
    cmb_cipher_count * cmb_count_per_cipher but only fills
    combination_count * D entries — ``detector.rs:376-389``).
    """
    rng = np.random.default_rng(seed)
    padded = rp.cmb_cipher_count * rp.cmb_count_per_cipher
    w = np.zeros((padded, rp.all_payloads_count), dtype=np.int64)
    filled = rng.integers(
        0,
        rp.index_modulus,
        size=(rp.combination_count, rp.all_payloads_count),
        dtype=np.int64,
    )
    w[: rp.combination_count] = filled
    return w
