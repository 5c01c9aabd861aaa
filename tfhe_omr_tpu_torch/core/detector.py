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
        device = torch.device(device) if device is not None else ctx.device
        if device != ctx.device:
            ctx = OmrContext(ctx.params, device)
        key = DetectionKey(*(t.to(device) for t in detection_key))
        self.ctx = ctx
        self.device = device
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

        self.br1 = BlindRotateKey(key.bsk1, key.bsk1_sh, ctx.ntt1,
                                  ctx.gadget_br1, "blind_rotate1")
        self.br2 = BlindRotateKey(key.bsk2, key.bsk2_sh, ctx.ntt2,
                                  ctx.gadget_br2, "blind_rotate2")
        self.tr = TraceKey(key.trace_k, key.trace_k_sh, ctx.ntt2,
                           ctx.gadget_trace, ctx.trace_autos)
        ks = p.first_level_ks
        self.keyswitch = make_lwe_keyswitch(ctx.f1, ks.digits, ks.out_dimension)
        self.ksk_f64 = key.ksk.to(torch.float64)

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

        self.lut1 = dev(ctx.lut1_ext)
        self.lut2 = dev(ctx.lut2_ext)
        ex_idx, ex_neg = ctx.clue_extract_tables
        self.ex_idx = dev(ex_idx)
        self.ex_neg = dev(ex_neg).bool()
        self.n2_inv = ctx.f2.inv(p.n2)
        self.n2_inv_sh = int(ctx.f2.shoup(self.n2_inv))

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
        rp = retrieval_params
        pert = self._on_device(pertinency)
        total = pert.shape[0]
        segs = rp.segment_per_cipher
        buckets = rng.integers(
            0, rp.bucket_count_per_segment, size=(total, segs), dtype=np.int64,
        )
        base_addr = self._on_device(
            np.arange(segs, dtype=np.int64)[None, :] * rp.slots_per_segment
            + buckets * rp.slots_per_bucket
        )
        idx = torch.arange(total, dtype=torch.int64, device=self.device)
        acc = torch.zeros((2, rp.polynomial_size), dtype=torch.int64,
                          device=self.device)
        fwd = self._fwd(plain)
        for s in range(0, total, chunk):
            e = min(s + chunk, total)
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
        rp = retrieval_params
        pert = self._on_device(pertinency)
        total = pert.shape[0]
        kct, cmb = rp.cmb_cipher_count, rp.cmb_count_per_cipher
        weights = self._on_device(sample_weights(rp, seed).reshape(kct, cmb, -1))
        pay = self._on_device(np.asarray(payloads, dtype=np.int64))
        accs = torch.zeros((kct, 2, rp.polynomial_size), dtype=torch.int64,
                           device=self.device)
        fwd = self._fwd(plain)
        for s in range(0, total, chunk):
            e = min(s + chunk, total)
            for k in range(kct):
                poly = payload_plain_device(
                    pay[s:e], weights[k, :, s:e], rp.polynomial_size,
                    rp.index_modulus, self.ctx.f2.q,
                )
                accs[k] = self._encode_chunk(pert[s:e], poly, accs[k], fwd)
        return accs


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
