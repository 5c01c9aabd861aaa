"""Detector: batched two-level bootstrapping + trace.

PyTorch counterpart of :mod:`tfhe_omr_tpu.core.detector` (``Detector.detect``
and ``detect_with_time_info``; the digest encoders are not ported yet). Per
message:

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
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.keygen import DetectionKey
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
    def _clues(self, clues: ClueBatch):
        a = torch.as_tensor(np.asarray(clues.a, dtype=np.int64), device=self.device)
        b7 = torch.as_tensor(np.asarray(clues.b7, dtype=np.int64), device=self.device)
        return a, b7

    def detect(self, clues: ClueBatch, plain: bool = False) -> torch.Tensor:
        """Pertinency ciphertexts (B, 2, N2): NTT-domain RLWE cts, reference
        slot order, encrypting Delta2 * pertinency_bit in the constant slot."""
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
