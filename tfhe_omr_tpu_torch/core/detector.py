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
chunks of messages: per chunk the plaintext polynomials of every digest the
call encodes (one index digest, or all payload digests) are built on the
device, taken to the NTT domain, multiplied into the pertinency ciphertexts
and summed over the messages mod q2; on a card that is three launches a
chunk whatever the number of digests (:mod:`tfhe_omr_tpu_torch.ops.encode`:
the build, the q2 NTT kernel, ``encode_mac``). The JAX package's
``lax.scan`` over whole chunks plus a ragged-tail call is one Python loop
here.

``detect``, its three stages, both encoders, their draws and each device's
rows run inside the profiler spans of :mod:`tfhe_omr_tpu_torch.utils.spans`
(``detect``, ``detect.stage1``-``3``, ``encode.index``, ``encode.payload``,
``encode.draws``, ``encode.rows/<device>``).

A detector holds its keys as stacks of R recipients' keys, each kind on a
leading axis, and every stage and encoder runs over them: a
:class:`Detector` holds one recipient's (R = 1) and gives that recipient's
results. :class:`RecipientsDetector` is the server of many recipients on
one device (the OMR detector holds every registered recipient's key and
tests each message under all of them): one detect of B messages under all
R keys in the launches of one detect (K1, K2, K3 read each sample's
recipient's key; the key switch is one batched product), its encoders every
recipient's digests in one chunk's launches, each result with a leading
recipient axis. Its calls run inside ``detect.recipients/<R>/<key bytes>``
and ``encode.recipients/<R>`` besides the spans above.
"""

from __future__ import annotations

import time
from collections.abc import Iterable
from dataclasses import dataclass
from typing import NamedTuple

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
from tfhe_omr_tpu_torch.ops.encode import (
    encode_mac,
    index_plaintexts,
    payload_plaintexts,
)
from tfhe_omr_tpu_torch.ops.fused import BlindRotateKey, TraceKey, blind_rotate, trace
from tfhe_omr_tpu_torch.utils import build
from tfhe_omr_tpu_torch.utils.build import resolve_device
from tfhe_omr_tpu_torch.utils.spans import span, spanned
from tfhe_omr_tpu_torch.utils.timing import StageTimer, synchronize


@dataclass
class DetectStageTimes:
    """Per-stage seconds of one ``detect_with_time_info`` call."""

    detect_time: float = 0.0
    first_level_bootstrapping_time: float = 0.0
    second_level_bootstrapping_time: float = 0.0
    trace_time: float = 0.0


def _context_on(ctx: OmrContext, device) -> OmrContext:
    """``ctx``, or the same parameters' context on ``device``."""
    device = resolve_device(device) if device is not None else ctx.device
    return ctx if device == ctx.device else OmrContext(ctx.params, device)


def _held_keys(detection_key: DetectionKey, ctx: OmrContext):
    """One recipient's keys on the context's device in the layouts a
    detector holds, each a stack of one: (BSK1, BSK2, trace key, float64
    KSK (1, digits*n_in, n_out+1))."""
    key = DetectionKey(*(t.to(ctx.device) for t in detection_key))
    return (BlindRotateKey(key.bsk1, key.bsk1_sh, ctx.ntt1, ctx.gadget_br1, "blind_rotate1"),
            BlindRotateKey(key.bsk2, key.bsk2_sh, ctx.ntt2, ctx.gadget_br2, "blind_rotate2"),
            TraceKey(key.trace_k, key.trace_k_sh, ctx.ntt2, ctx.gadget_trace,
                     ctx.trace_autos),
            key.ksk.to(torch.float64)[None])


def _stack_keys(detection_keys: Iterable[DetectionKey], ctx: OmrContext,
                recipients: int):
    """:func:`_held_keys` of ``recipients`` recipients, each kind stacked on
    its leading axis. The keys are taken one at a time, and each is laid
    out into the stacks and let go before the next is taken, so that one
    recipient's key at a time lies beside the stacks (603 MB on a card at
    the reference set); one recipient's keys are the stacks."""
    stacks, count = None, 0
    for r, detection_key in enumerate(detection_keys):
        if r >= recipients:
            raise ValueError(f"more than the {recipients} recipients' keys announced")
        held = _held_keys(detection_key, ctx)
        del detection_key
        if recipients == 1:
            stacks = held
        else:
            if stacks is None:
                stacks = (*(k.empty_stack(recipients) for k in held[:3]),
                          held[3].new_empty((recipients, *held[3].shape[1:])))
            for stack, key in zip(stacks[:3], held[:3]):
                stack.put(r, key)
            stacks[3][r:r + 1].copy_(held[3])
        del held
        count += 1
    if count != recipients or not count:
        raise ValueError(f"{count} recipients' keys, {recipients} announced")
    return stacks


class Detector:
    """The server: holds the detection key, on ``device``, once, as stacks
    of one recipient's keys."""

    def __init__(self, detection_key: DetectionKey, ctx: OmrContext,
                 device=None):
        ctx = _context_on(ctx, device)
        self._assemble(ctx, *_stack_keys([detection_key], ctx, 1))

    def _assemble(self, ctx: OmrContext, br1: BlindRotateKey,
                  br2: BlindRotateKey, tr: TraceKey,
                  ksk_f64: torch.Tensor) -> None:
        """Every attribute of a detector, from keys that lie on the
        context's device in the layouts they are held in: the one path by
        which ``__init__`` and ``to`` fill a detector. Stacks of R
        recipients' keys make a detector of R recipients."""
        self.br1, self.br2, self.tr, self.ksk_f64 = br1, br2, tr, ksk_f64
        self.recipients = br1.recipients
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
        self._chunk_words = None  # the encoders' buffers (_chunk_buffers)

    def to(self, device) -> "Detector":
        """A replica of this detector on another device of the same kind
        (itself when ``device`` is its own): the keys are copied as they
        lie, in the layouts they are held in (on a card the kernels'), the
        tables are made anew on ``device``."""
        device = resolve_device(device)
        if device == self.device:
            return self
        ctx = OmrContext(self.ctx.params, device)
        other = type(self).__new__(type(self))
        other._assemble(ctx, self.br1.to(ctx.ntt1), self.br2.to(ctx.ntt2),
                        self.tr.to(ctx.ntt2, ctx.trace_autos),
                        self.ksk_f64.to(device))
        return other

    # --------------------------------------------------------------- stages
    @spanned("detect.stage1")
    def stage1(self, clue_a: torch.Tensor, clue_b7: torch.Tensor,
               plain: bool = False):
        """Extract + first-level bootstrapping + key switch + mod switch
        (reference ``detector.rs:505-597``) -> (ms_a (R B, n_int), ms_b
        (R B,)): every message once a held recipient, recipient-major."""
        f1 = self.ctx.f1
        n1 = self.ctx.params.n1
        q0 = self.q0
        bsz = clue_a.shape[0]
        vals = clue_a[:, self.ex_idx]  # (B, c, n0) extract_all index map
        a_ext = torch.where(self.ex_neg, (q0 - vals) % q0, vals)
        # the same samples in every recipient's run: (n0, R M), (R M, 2, N1)
        amounts1 = a_ext.reshape(bsz * self._c, self._n0).T.repeat(1, self.recipients)
        b1 = clue_b7.reshape(bsz * self._c)
        acc = init_accumulator(self.lut1, b1, n1).permute(2, 1, 0).repeat(self.recipients, 1, 1)
        acc = blind_rotate(acc, amounts1, self.br1, plain=plain)
        # sum the 7 per-clue results (``detector.rs:556``)
        acc = f1.mod_sum(acc.reshape(self.recipients * bsz, self._c, 2, n1), dim=1)
        a_vec, b0 = extract_constant_lwe(f1, acc.permute(2, 1, 0))
        ks_a, ks_b = self.keyswitch(a_vec.T, b0, self.ksk_f64)
        ms_a = lwe_modulus_switch(f1, ks_a, self.q_inter)
        ms_b = lwe_modulus_switch(f1, ks_b, self.q_inter)
        ms_b = (ms_b + self.inter_offset) & (self.q_inter - 1)
        return ms_a, ms_b

    @spanned("detect.stage2")
    def stage2(self, ms_a: torch.Tensor, ms_b: torch.Tensor,
               plain: bool = False) -> torch.Tensor:
        """Second-level blind rotation (``detector.rs:599-624``) -> acc2
        (R B, 2, N2)."""
        acc2 = init_accumulator(self.lut2, ms_b, self.ctx.params.n2)
        acc2 = acc2.permute(2, 1, 0)  # (B, 2, N2)
        return blind_rotate(acc2, ms_a.T.contiguous(), self.br2, plain=plain)

    @spanned("detect.stage3")
    def stage3(self, acc2: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x N^-1, homomorphic trace, to the NTT domain
        (``detector.rs:626-639``) -> (R B, 2, N2)."""
        f2 = self.ctx.f2
        acc2 = f2.mul_shoup(acc2, self.n2_inv, self.n2_inv_sh)
        return self.ctx.ntt2.fwd_last(trace(acc2, self.tr, plain=plain), plain=plain)

    # --------------------------------------------------------------- detect
    def _on_device(self, x) -> torch.Tensor:
        """A numpy array or a tensor as int64 on the detector's device."""
        return torch.as_tensor(x, dtype=torch.int64, device=self.device)

    def _clues(self, clues: ClueBatch):
        return self._on_device(clues.a), self._on_device(clues.b7)

    def _given(self, out: torch.Tensor) -> torch.Tensor:
        """A result with a leading axis of the held recipients as the public
        methods give it: a :class:`Detector`'s one recipient's."""
        return out[0]

    @spanned("detect")
    def detect(self, clues: ClueBatch, plain: bool = False) -> torch.Tensor:
        """Pertinency ciphertexts (B, 2, N2): NTT-domain RLWE cts, reference
        slot order, encrypting Delta2 * pertinency_bit in the constant slot.
        ``clues`` holds numpy arrays or tensors (e.g. device-resident clues
        from :meth:`Sender.gen_clues_device_resident`)."""
        return self._given(self._detect(clues, plain))

    def _detect(self, clues: ClueBatch, plain: bool) -> torch.Tensor:
        """(R, B, 2, N2): every held recipient's pertinency ciphertexts of
        the messages, each under its own key."""
        ms_a, ms_b = self.stage1(*self._clues(clues), plain=plain)
        out = self.stage3(self.stage2(ms_a, ms_b, plain=plain), plain=plain)
        return out.reshape(self.recipients, -1, *out.shape[1:])

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
        return self._given(out.reshape(self.recipients, -1, *out.shape[1:])), DetectStageTimes(
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
    def _encode_chunk(self, pert: torch.Tensor, rows: torch.Tensor,
                      acc: torch.Tensor, plain: bool) -> torch.Tensor:
        """acc + sum over the chunk's messages of pert * NTT(rows), mod q2,
        for every digest of the chunk: pert (B, 2, N2) NTT-domain pertinency
        cts; rows (K, B, N2) the plaintext polys of K digests; acc (K, 2,
        N2); each with a leading axis of R recipients where the encoders
        run over several. With ``plain`` the plain NTT and
        multiply-accumulate run (on any device); on the kernel path on a
        card the NTT images go into the second of :meth:`_chunk_buffers`.
        Every chunk of both encoders passes through here. Counterpart of
        ``encode_chunk`` (``detector.rs:256-337``)."""
        out = None
        if not build.runs_plain(rows, plain):
            out = self._chunk_buffers(rows.numel())[1][:rows.numel()]
        pn = self.ctx.ntt2.fwd_last(rows, out=out, plain=plain)
        return encode_mac(self.ctx.f2, pert, pn, acc, plain=plain)

    def _chunk_buffers(self, words: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Two int64 buffers of at least ``words`` on the detector's card,
        for a chunk's plaintext rows and their NTT images (940 MB each at
        2048 rows of 28 digests). They are held from chunk to chunk and
        board to board, grown to the largest chunk asked for: were they
        freed, the allocator would hand their room to other tensors of a
        board and allocate them anew every board (cudaMalloc on the host's
        clock)."""
        if self._chunk_words is None or self._chunk_words[0].numel() < words:
            self._chunk_words = None  # the smaller pair goes before the larger comes
            self._chunk_words = tuple(torch.empty(words, dtype=torch.int64, device=self.device)
                                      for _ in range(2))
        return self._chunk_words

    def _encode_rows(self, pert, kct: int, chunk: int, plain: bool,
                     rows_of) -> torch.Tensor:
        """The one chunk loop of both encoders: ``pert`` (R, rows, 2, N2)
        -> (R, kct, 2, N2), each chunk's plaintext rows of every digest from
        ``rows_of(s, e, out)`` (the messages ``s .. e``, written into the
        front of ``out`` where it is a buffer) and summed by
        :meth:`_encode_chunk`. On the kernel path on a card the rows go into
        the first of :meth:`_chunk_buffers`; else they are made anew."""
        pert = self._on_device(pert).contiguous()
        recipients, rows, _, n2 = pert.shape
        acc = torch.zeros((recipients, kct, 2, n2), dtype=torch.int64, device=self.device)
        out = None
        if not build.runs_plain(pert, plain):
            out = self._chunk_buffers(recipients * kct * min(chunk, rows) * n2)[0]
        for s in range(0, rows, chunk):
            e = min(s + chunk, rows)
            acc = self._encode_chunk(pert[:, s:e].contiguous(),
                                     rows_of(s, e, out).view(recipients, kct, e - s, n2),
                                     acc, plain)
        return acc

    @spanned("encode.index")
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
        ``plain=True`` runs the plain versions instead of the kernels.
        """
        pert = self._on_device(pertinency)[None]
        return self._index_digests(retrieval_params, pert, rng, 1, chunk, plain)[0, 0]

    def _index_digests(self, rp: RetrievalParams, pert: torch.Tensor,
                       rng: np.random.Generator, digests: int, chunk: int,
                       plain: bool) -> torch.Tensor:
        """``digests`` index digests of every held recipient, (R, digests,
        2, N2), from the stacks (R, D, 2, N2): all bucket draws first, in one
        ``rng.integers`` call (:func:`draw_index_buckets`)."""
        with span("encode.draws"):
            base_addr = draw_index_buckets(rp, pert.shape[1], rng,
                                           (self.recipients, digests))
        return self._index_rows(rp, pert, base_addr, 0, chunk, plain)

    def encode_index_rows(self, retrieval_params: RetrievalParams, pert,
                          base_addr: np.ndarray, lo: int, chunk: int = 2048,
                          plain: bool = False) -> torch.Tensor:
        """The part of an index digest that the messages ``lo ..
        lo + len(pert)`` of a board contribute: ``pert`` holds their
        pertinency cts, ``base_addr`` their rows of
        :func:`draw_index_buckets`. The parts of disjoint row ranges add up
        (mod q2) to the digest of the whole board."""
        return self._index_rows(retrieval_params, self._on_device(pert)[None],
                                self._on_device(base_addr)[None, None], lo, chunk,
                                plain)[0, 0]

    def _index_rows(self, rp: RetrievalParams, pert, base_addr, lo: int,
                    chunk: int = 2048, plain: bool = False) -> torch.Tensor:
        """:meth:`encode_index_rows` of every held recipient and K digests
        each: ``pert`` (R, rows, 2, N2), ``base_addr`` (R, K, rows, segs)
        -> (R, K, 2, N2), every digest's rows built and summed in one
        chunk's launches."""
        with span(f"encode.rows/{self.device}"):
            base_addr = self._on_device(base_addr)

            def rows_of(s, e, out):
                return index_plaintexts(
                    base_addr[:, :, s:e].reshape(-1, base_addr.shape[3]).contiguous(), lo + s,
                    rp.index_slots_per_bucket, rp.polynomial_size, rp.index_modulus,
                    self.ctx.f2.q, plain, out, period=e - s)
            return self._encode_rows(pert, base_addr.shape[1], chunk, plain, rows_of)

    @spanned("encode.payload")
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
        plain versions instead of the kernels.
        """
        pert = self._on_device(pertinency)[None]
        return self._payload_digests(retrieval_params, pert, payloads, seed, chunk, plain)[0]

    def _payload_digests(self, rp: RetrievalParams, pert: torch.Tensor, payloads,
                         seed, chunk: int, plain: bool) -> torch.Tensor:
        """Every held recipient's payload digests, (R, cmb_cipher_count, 2,
        N2), from the stacks (R, D, 2, N2): every recipient's weights from
        one draw of the stream of ``seed`` (:func:`recipient_weights`)."""
        with span("encode.draws"):
            weights = recipient_weights(rp, seed, self.recipients, pert.shape[1])
        return self._payload_rows(rp, pert, payloads, weights, chunk, plain)

    def encode_payload_rows(self, retrieval_params: RetrievalParams, pert,
                            payloads, weights, chunk: int = 2048,
                            plain: bool = False) -> torch.Tensor:
        """The part of the payload digests that some messages of a board
        contribute: ``pert`` (rows, 2, N2), ``payloads`` (rows, plen) and
        ``weights`` (kct, cmb, rows) hold those messages' pertinency cts,
        payloads and columns of :func:`payload_weights` (numpy arrays or
        tensors). The parts of disjoint row ranges add up (mod q2) to the
        whole board's digests."""
        return self._payload_rows(retrieval_params, self._on_device(pert)[None], payloads,
                                  self._on_device(weights)[None], chunk, plain)[0]

    def _payload_rows(self, rp: RetrievalParams, pert, payloads, weights,
                      chunk: int = 2048, plain: bool = False) -> torch.Tensor:
        """:meth:`encode_payload_rows` of every held recipient: ``pert`` (R,
        rows, 2, N2), ``payloads`` (rows, plen), ``weights`` (R, kct, cmb,
        rows) -> (R, kct, 2, N2), every digest's rows built and summed in
        one chunk's launches."""
        with span(f"encode.rows/{self.device}"):
            weights = self._on_device(weights)
            flat = weights.flatten(0, 1)  # (R kct, cmb, rows)
            pay = self._on_device(payloads).contiguous()

            def rows_of(s, e, out):
                return payload_plaintexts(pay[s:e], flat[:, :, s:e], rp.polynomial_size,
                                          rp.index_modulus, self.ctx.f2.q, plain, out)
            return self._encode_rows(pert, weights.shape[1], chunk, plain, rows_of)


class RecipientsDetector(Detector):
    """The server of R recipients on one device: each recipient's detection
    key held once, the R keys of each kind stacked (``recipients``), and
    every message detected under all of them at once.

    ``detection_keys`` are the recipients' keys in order; with
    ``recipients`` given they may come from an iterator that makes each key
    as it is asked for: each is laid out into the stacks and let go before
    the next is taken (R keys of the reference set take 603 MB each on a
    card).

    :meth:`detect` returns (R, B, 2, N2), recipient r's pertinency
    ciphertexts of the B messages under its own key, from the launches of
    one detect; the encoders return every recipient's digests, (R, K, 2,
    N2), from one chunk's launches. The stages and encoders are
    :class:`Detector`'s.
    """

    def __init__(self, detection_keys: Iterable[DetectionKey], ctx: OmrContext,
                 recipients: int | None = None, device=None):
        if recipients is None:
            detection_keys = list(detection_keys)
            recipients = len(detection_keys)
        ctx = _context_on(ctx, device)
        self._assemble(ctx, *_stack_keys(detection_keys, ctx, recipients))

    def _assemble(self, ctx: OmrContext, *keys) -> None:
        super()._assemble(ctx, *keys)
        self._detect_span = f"detect.recipients/{self.recipients}/{self.detect_key_size()}"
        self._encode_span = f"encode.recipients/{self.recipients}"

    def _given(self, out: torch.Tensor) -> torch.Tensor:
        return out

    def detect(self, clues: ClueBatch, plain: bool = False) -> torch.Tensor:
        """(R, B, 2, N2): every recipient's pertinency ciphertexts of the B
        messages of ``clues``, each under its own key (:meth:`Detector.detect`
        once a recipient, bit for bit), in one detect's launches. Runs
        inside ``detect`` and ``detect.recipients/<R>/<key bytes>``, the
        bytes of every key the call reads."""
        with span("detect"), span(self._detect_span):
            return self._detect(clues, plain)

    def encode_pertinent_indices(self, retrieval_params: RetrievalParams, pertinency,
                                 rng: np.random.Generator, chunk: int = 2048,
                                 plain: bool = False) -> torch.Tensor:
        """Every index digest of every recipient, (R,
        max_encode_indices_cipher_count, 2, N2), from the stacks (R, D, 2,
        N2) of :meth:`detect`: all bucket draws in one ``rng.integers``
        call, then one chunk's launches for all of them."""
        with span("encode.index"), span(self._encode_span):
            return self._index_digests(retrieval_params, self._on_device(pertinency), rng,
                                       retrieval_params.max_encode_indices_cipher_count,
                                       chunk, plain)

    def encode_pertinent_payloads(self, retrieval_params: RetrievalParams, pertinency,
                                  payloads: np.ndarray, seed, chunk: int = 2048,
                                  plain: bool = False) -> torch.Tensor:
        """Every recipient's payload digests, (R, cmb_cipher_count, 2, N2),
        from the stacks (R, D, 2, N2) of :meth:`detect`; recipient r's
        ``Retriever.decode_digest`` regenerates its weights from
        ``weight_seed(seed, r, R)``."""
        with span("encode.payload"), span(self._encode_span):
            return self._payload_digests(retrieval_params, self._on_device(pertinency),
                                         payloads, seed, chunk, plain)


class RecipientSeed(NamedTuple):
    """Recipient ``recipient``'s share of the weight stream of ``seed``
    drawn for ``recipients`` recipients at once (:func:`sample_weights`):
    what a recipient of a :class:`RecipientsDetector` passes to
    ``Retriever.decode_digest``."""

    seed: int
    recipient: int
    recipients: int


def weight_seed(seed, recipient: int, recipients: int) -> RecipientSeed:
    """The seed of recipient ``recipient``'s payload weights among
    ``recipients`` in a :class:`RecipientsDetector`'s digests of the shared
    ``seed``."""
    return RecipientSeed(int(seed), int(recipient), int(recipients))


def recipient_weights(rp: RetrievalParams, seed, recipients: int, total: int) -> np.ndarray:
    """Every recipient's payload weights (R, cmb_cipher_count,
    cmb_count_per_cipher, total) from one draw of the stream of ``seed``:
    recipient r's are what :func:`weight_seed` (seed, r, R) gives it, one
    recipient's what :func:`payload_weights` gives."""
    return _draw_weights(rp, seed, recipients).reshape(
        recipients, rp.cmb_cipher_count, rp.cmb_count_per_cipher, -1)[..., :total]


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
    perts = [torch.zeros((det.recipients, r, 2, rp.polynomial_size), dtype=torch.int64,
                         device=det.device) for det, r in zip(dets, rows)]
    t0 = time.perf_counter()
    for det, r, pert in zip(dets, rows, perts):
        if r:
            det._index_rows(rp, pert, np.zeros((det.recipients, 1, r, rp.segment_per_cipher),
                                               dtype=np.int64), 0, chunk)
    _sync_all(dets, status, "index_s", t0)
    t0 = time.perf_counter()
    for det, r, pert in zip(dets, rows, perts):
        if r:
            det._payload_rows(
                rp, pert, np.zeros((r, rp.payload_length), dtype=np.int64),
                np.zeros((det.recipients, rp.cmb_cipher_count, rp.cmb_count_per_cipher, r),
                         dtype=np.int64), chunk)
    _sync_all(dets, status, "payload_s", t0)
    for st, r in zip(status, rows):
        st["rows"] = r
    return status


def draw_index_buckets(rp: RetrievalParams, total: int,
                       rng: np.random.Generator, lead: tuple = ()) -> np.ndarray:
    """One index digest's bucket draws for a board of ``total`` messages,
    all in one ``rng.integers`` call (the stream of the JAX package, whatever
    way the board is split afterwards) -> (total, segs) first slot of each
    message's bucket in every segment; with ``lead`` (R, K), those of K
    digests of each of R recipients from the same call, (R, K, total,
    segs), recipient r's digest k the ``r * K + k``-th one's draws."""
    segs = rp.segment_per_cipher
    buckets = rng.integers(
        0, rp.bucket_count_per_segment, size=(*lead, total, segs), dtype=np.int64,
    )
    return (np.arange(segs, dtype=np.int64) * rp.slots_per_segment
            + buckets * rp.slots_per_bucket)


def payload_weights(rp: RetrievalParams, seed, total: int) -> np.ndarray:
    """The shared weight stream, drawn once for the layout's whole board,
    as (cmb_cipher_count, cmb_count_per_cipher, total): a board shorter than
    the layout's uses the first ``total`` columns."""
    return recipient_weights(rp, seed, 1, total)[0]


def sample_weights(rp: RetrievalParams, seed) -> np.ndarray:
    """The shared detector/retriever weight stream.

    (combination_count_padded, all_payloads_count) uniform in [0, p); rows
    beyond combination_count are zero (the reference sizes the buffer by
    cmb_cipher_count * cmb_count_per_cipher but only fills
    combination_count * D entries — ``detector.rs:376-389``).

    A :class:`RecipientSeed` gives its recipient's share of the stream of
    its seed drawn for all its recipients in one call.
    """
    if not isinstance(seed, RecipientSeed):
        seed = RecipientSeed(seed, 0, 1)
    return _draw_weights(rp, seed.seed, seed.recipients)[seed.recipient]


def _draw_weights(rp: RetrievalParams, seed, recipients: int) -> np.ndarray:
    """:func:`sample_weights` of ``recipients`` recipients from one call of
    the stream of ``seed``: (R, padded, all_payloads_count)."""
    rng = np.random.default_rng(seed)
    padded = rp.cmb_cipher_count * rp.cmb_count_per_cipher
    w = np.zeros((recipients, padded, rp.all_payloads_count), dtype=np.int64)
    w[:, : rp.combination_count, :] = rng.integers(
        0,
        rp.index_modulus,
        size=(recipients, rp.combination_count, rp.all_payloads_count),
        dtype=np.int64,
    )
    return w
