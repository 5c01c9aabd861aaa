"""The port's bootstrapping stages against the JAX package's XLA paths.

Full default rings (N1 = 1024 over q1, N2 = 2048 over q2) with reduced LWE
dimensions, as tests/test_fused_cmux.py does: 32 clue coefficients (16
paired L1 steps), 16 intermediate coefficients (8 paired L2 steps). The
keys are made by the JAX package and carried across with the port's
converter; inputs come from a numpy seed. Every comparison is exact. The
last test runs the whole ``Detector.detect`` of both packages on them.
"""

from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_omr_tpu.core.detector import Detector as JaxDetector
from tfhe_omr_tpu.core.keygen import DetectionKey as JaxDetectionKey
from tfhe_omr_tpu.core.keygen import SecretKeyPack as JaxPack
from tfhe_omr_tpu.core.params import KeySwitchParams as JaxKs
from tfhe_omr_tpu.core.params import LweParams as JaxLwe
from tfhe_omr_tpu.core.params import OmrParameters as JaxParams
from tfhe_omr_tpu.ops import bootstrap as jbs
from tfhe_omr_tpu.utils.devices import host_math
from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.detector import Detector
from tfhe_omr_tpu_torch.core.keygen import (
    detection_key_from_numpy,
    secret_key_pack_from_numpy,
)
from tfhe_omr_tpu_torch.core.params import KeySwitchParams, LweParams, OmrParameters
from tfhe_omr_tpu_torch.core.sender import ClueBatch
from tfhe_omr_tpu_torch.ops import bootstrap as tbs
from tfhe_omr_tpu_torch.ops.fused import (
    BlindRotateKey,
    TraceKey,
    blind_rotate,
    trace,
)

# The suite runs in several xdist workers on one host: one torch thread each
# keeps their CPU thread pools from oversubscribing its cores.
torch.set_num_threads(1)

N0, N_INT, B = 32, 16, 4


@pytest.fixture(scope="module")
def packs():
    """A JAX pack at the reduced default parameters, its keys, and the
    port's context with the keys converted."""
    jparams = replace(
        JaxParams.default(),
        clue_params=JaxLwe(N0, 8, 2048, "binary", 0.8293),
        first_level_ks=JaxKs(1024, N_INT, 27, 1, 10.0),
        intermediate_lwe=JaxLwe(N_INT, 32, 4096, "binary", 10.3260),
    )
    params = replace(
        OmrParameters.default(),
        clue_params=LweParams(N0, 8, 2048, "binary", 0.8293),
        first_level_ks=KeySwitchParams(1024, N_INT, 27, 1, 10.0),
        intermediate_lwe=LweParams(N_INT, 32, 4096, "binary", 10.3260),
    )
    skp = JaxPack(jparams, rng=3)
    jc = skp.ctx
    with host_math():
        bsk1, bsk1_sh = skp._gen_bsk(
            skp._pair_bits(skp.clue_sk), skp.z1_f, skp.z1_ntt, jc.f1, jc.ntt1,
            jc.gadget_br1, jparams.first_level_br.noise_std, skp.rng)
        ksk_limbs = skp._gen_ksk(skp.rng)
        bsk2, bsk2_sh = skp._gen_bsk(
            skp._pair_bits(skp.inter_sk), skp.z2_f, skp.z2_ntt, jc.f2, jc.ntt2,
            jc.gadget_br2, jparams.second_level_br.noise_std, skp.rng)
        trace_k, trace_k_sh = skp._gen_trace_key(skp.rng)[:2]
    jkeys = dict(bsk1=bsk1, bsk1_sh=bsk1_sh, ksk_limbs=ksk_limbs, bsk2=bsk2,
                 bsk2_sh=bsk2_sh, trace_k=trace_k, trace_k_sh=trace_k_sh)
    ctx = OmrContext(params, "cpu")
    key = detection_key_from_numpy(
        np.asarray(bsk1), np.asarray(ksk_limbs), np.asarray(bsk2),
        np.asarray(trace_k), ctx)
    return skp, jkeys, ctx, key


def test_converter_companions_match_jax(packs):
    _skp, jk, _ctx, key = packs
    for name in ("bsk1_sh", "bsk2_sh", "trace_k_sh"):
        assert np.array_equal(getattr(key, name).numpy(),
                              np.asarray(jk[name]).astype(np.int64)), name


@pytest.mark.parametrize("level", [1, 2])
def test_paired_blind_rotate_matches_jax(packs, level):
    skp, jk, ctx, key = packs
    jc = skp.ctx
    rng = np.random.default_rng(level)
    if level == 1:
        f, jf, ntt, jntt, g, jg = ctx.f1, jc.f1, ctx.ntt1, jc.ntt1, ctx.gadget_br1, jc.gadget_br1
        lut, n_lwe, bsk, bsk_sh = ctx.lut1_ext, N0, key.bsk1, key.bsk1_sh
        jbsk, jbsk_sh = jk["bsk1"], jk["bsk1_sh"]
    else:
        f, jf, ntt, jntt, g, jg = ctx.f2, jc.f2, ctx.ntt2, jc.ntt2, ctx.gadget_br2, jc.gadget_br2
        lut, n_lwe, bsk, bsk_sh = ctx.lut2_ext, N_INT, key.bsk2, key.bsk2_sh
        jbsk, jbsk_sh = jk["bsk2"], jk["bsk2_sh"]
    two_n = 2 * ntt.n
    amounts = rng.integers(0, two_n, size=(n_lwe, B), dtype=np.int64)
    bs = rng.integers(0, two_n, size=(B,), dtype=np.int64)

    jacc = jbs.init_accumulator(jf, jnp.asarray(lut), jnp.asarray(bs), ntt.n)
    with host_math():
        want = np.asarray(jbs.make_blind_rotate(jf, jntt, jg, paired=True)(
            jacc, jnp.asarray(amounts), jbsk, jbsk_sh)).astype(np.int64)

    acc = tbs.init_accumulator(torch.as_tensor(lut), torch.as_tensor(bs), ntt.n)
    assert np.array_equal(acc.numpy(), np.asarray(jacc).astype(np.int64))
    got = tbs.make_blind_rotate(f, ntt, g)(
        acc, torch.as_tensor(amounts), bsk, bsk_sh)
    assert np.array_equal(got.numpy(), want), int((got.numpy() != want).sum())

    # the kernel wrapper (message-major) runs the same plain path on the CPU
    rows = acc.permute(2, 1, 0)
    brk = BlindRotateKey(bsk, bsk_sh, ntt, g, f"blind_rotate{level}")
    out = blind_rotate(rows, torch.as_tensor(amounts), brk)
    assert torch.equal(out, got.permute(2, 1, 0))


def test_trace_matches_jax(packs):
    skp, jk, ctx, key = packs
    jc = skp.ctx
    f = ctx.f2
    acc = np.random.default_rng(9).integers(0, f.q, size=(ctx.params.n2, 2, B),
                                            dtype=np.int64)
    with host_math():
        want = np.asarray(jax.jit(jbs.make_trace(jc.f2, jc.ntt2, jc.gadget_trace, jc.trace_autos))(
            jnp.asarray(acc), jk["trace_k"], jk["trace_k_sh"]))
    got = tbs.make_trace(f, ctx.ntt2, ctx.gadget_trace, ctx.trace_autos)(
        torch.as_tensor(acc), key.trace_k, key.trace_k_sh)
    assert np.array_equal(got.numpy(), want), int((got.numpy() != want).sum())
    tk = TraceKey(key.trace_k, key.trace_k_sh, ctx.ntt2, ctx.gadget_trace,
                  ctx.trace_autos)
    out = trace(torch.as_tensor(acc).permute(2, 1, 0), tk)
    assert torch.equal(out, got.permute(2, 1, 0))


def test_extract_keyswitch_modswitch_match_jax(packs):
    skp, jk, ctx, key = packs
    jc = skp.ctx
    f, jf = ctx.f1, jc.f1
    rng = np.random.default_rng(21)
    acc = rng.integers(0, f.q, size=(ctx.params.n1, 2, 8), dtype=np.int64)
    acc[:, :, 0] = 0
    acc[:, :, 1] = f.q - 1
    ja, jb = jbs.extract_constant_lwe(jf, jnp.asarray(acc))
    ta, tb = tbs.extract_constant_lwe(f, torch.as_tensor(acc))
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tb.numpy(), np.asarray(jb))

    ks = ctx.params.first_level_ks
    with host_math():
        jks_a, jks_b = jbs.make_lwe_keyswitch(jf, ks.digits, ks.out_dimension)(
            ja.T, jb, jk["ksk_limbs"])
    ks_a, ks_b = tbs.make_lwe_keyswitch(f, ks.digits, ks.out_dimension)(
        ta.T.contiguous(), tb, key.ksk.to(torch.float64))
    assert np.array_equal(ks_a.numpy(), np.asarray(jks_a))
    assert np.array_equal(ks_b.numpy(), np.asarray(jks_b))

    q_inter = ctx.params.intermediate_lwe.cipher_modulus
    for t_x, j_x in ((ks_a, jks_a), (ks_b, jks_b)):
        got = tbs.lwe_modulus_switch(f, t_x, q_inter)
        want = jbs.lwe_modulus_switch(jf, j_x, q_inter)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_detect_matches_jax_at_default_rings(packs):
    """The whole detect of both packages on the same keys and clues (2
    pertinent, 2 uniformly random), then the port's decrypt and oracle."""
    skp, jk, ctx, key = packs
    detector = JaxDetector(JaxDetectionKey(**jk), skp.ctx)
    rng = np.random.default_rng(33)
    pert = skp.generate_sender().gen_clues(2, rng)
    q0 = ctx.params.clue_params.cipher_modulus
    clues = ClueBatch(
        a=np.concatenate([pert.a, rng.integers(0, q0, (2, N0), dtype=np.int64)]),
        b7=np.concatenate([pert.b7, rng.integers(0, q0, (2, 7), dtype=np.int64)]),
    )
    want = np.asarray(jax.block_until_ready(detector.detect(clues)))
    got = Detector(key, ctx).detect(clues)
    assert got.shape == want.shape == (4, 2, ctx.params.n2)
    assert np.array_equal(got.numpy(), want), int((got.numpy() != want).sum())
    port_skp = secret_key_pack_from_numpy(
        ctx.params, skp.clue_sk, skp.inter_sk, skp.z1, skp.z2, ctx)
    q, t = ctx.params.q2, ctx.params.output_plain_modulus
    dec = port_skp.decrypt_rlwe2_ntt(got)
    decoded = np.mod((dec * (2 * t) + q) // (2 * q), t)
    assert (decoded[:2, 0] == 1).all() and not decoded[:2, 1:].any()
    assert not decoded[2:].any()
