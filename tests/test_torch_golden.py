"""The port against the pinned golden vectors, without jax.

``tests/golden/golden_vectors.npz`` pins the exact outputs of every layer of
the ciphertext math (``tests/test_golden.py``). Sections 1-6 (field
products, gadget digits, both NTTs and inverses, one paired CMUX step at
each level, the LWE key switch, the homomorphic trace) are recomputed here
from the same numpy stream (``utils/golden.py golden_inputs``) through the
port's plain torch versions, and compared with ``np.array_equal``: no
tolerance. This file imports no jax, so it runs on a machine without it:

    python -m pytest tests/test_torch_golden.py --noconftest -q

Section 7 (``detect_tiny``) cannot be recomputed from the port's own keys:
their bootstrapping and trace key masks come from ``torch.Generator``, not
from the JAX package's threefry bits, so the ciphertext differs while it
decrypts the same. The one case marked ``jax_reference`` carries the JAX
package's keys across and holds the port's detect of the same clues to the
pin; it skips where jax is missing.
"""

import numpy as np
import pytest
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.keygen import ksk_from_planes
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.ops.bootstrap import make_blind_rotate, make_lwe_keyswitch, make_trace
from tfhe_omr_tpu_torch.utils import golden

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctx():
    return OmrContext(OmrParameters.default(), "cpu")


@pytest.fixture(scope="module")
def inputs(ctx):
    return golden.golden_inputs(ctx)


@pytest.fixture(scope="module")
def pinned():
    return golden.load()


def _t(a):
    return torch.as_tensor(a)


def _port_vector(ctx, inputs, name):
    """One pinned vector, recomputed through the port's plain versions."""
    p = ctx.params
    if name.startswith("mul_"):
        f = ctx.f1 if name == "mul_q1" else ctx.f2
        a, b = inputs[name]
        return f.mul(_t(a), _t(b))
    if name.startswith("dig_"):
        g = {"dig_g1": ctx.gadget_br1, "dig_g2": ctx.gadget_br2,
             "dig_gtr": ctx.gadget_trace}[name]
        return g.decompose(_t(inputs[name]), dim=0)
    if name.startswith("ntt"):
        ntt = ctx.ntt1 if name.startswith("ntt1") else ctx.ntt2
        x = _t(inputs[name[:4]])
        return ntt.fwd_plain(x) if name.endswith("_fwd") else ntt.inv_plain(x)
    if name.startswith("cmux"):
        f, ntt, g = ((ctx.f1, ctx.ntt1, ctx.gadget_br1) if name == "cmux1"
                     else (ctx.f2, ctx.ntt2, ctx.gadget_br2))
        acc, amounts, bsk = (_t(a) for a in inputs[name])
        return make_blind_rotate(f, ntt, g)(acc, amounts, bsk, f.shoup_t(bsk))
    if name.startswith("ks_"):
        ksk, a_vec, b = inputs["ks"]
        ksp = p.first_level_ks
        ks = make_lwe_keyswitch(ctx.f1, ksp.digits, ksp.out_dimension)
        ks_a, ks_b = ks(_t(a_vec), _t(b), _t(ksk_from_planes(ksk)).to(torch.float64))
        return ks_a if name == "ks_a" else ks_b
    assert name == "trace"
    tk, acc2 = (_t(a) for a in inputs["trace"])
    trace = make_trace(ctx.f2, ctx.ntt2, ctx.gadget_trace, ctx.trace_autos)
    return trace(acc2, tk, ctx.f2.shoup_t(tk))


@pytest.mark.parametrize("name", golden.SECTIONS)
def test_port_reproduces_pinned_vector(ctx, inputs, pinned, name):
    got = _port_vector(ctx, inputs, name).numpy()
    want = pinned[name]
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), (
        f"{name}: {int((got != want).sum())} of {want.size} elements differ")


def test_sections_cover_the_pinned_file(pinned):
    """Every pin but the three of the tiny-preset protocol is a section
    here; the digests are held by tests/test_torch_digest.py, detect_tiny
    by the jax_reference case below."""
    assert set(pinned) == set(golden.SECTIONS) | {
        "detect_tiny", "digest_idx_tiny", "digest_pay_tiny"}


@pytest.mark.jax_reference
def test_detect_tiny_through_keys_carried_across(pinned):
    """The port's detect of the pinned clues, with the JAX package's
    detection key carried across (``detection_key_from_numpy``), equals
    ``detect_tiny``; the port's own senders draw the same clues."""
    pytest.importorskip("jax")
    from tfhe_omr_tpu.core.keygen import SecretKeyPack as JaxPack

    from tfhe_omr_tpu_torch.core.detector import Detector
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack, detection_key_from_numpy
    from tfhe_omr_tpu_torch.core.sender import ClueBatch

    seed = golden.SEED
    params = OmrParameters.tiny(noise_free=True)
    tctx = OmrContext(params, "cpu")
    skp = SecretKeyPack(params, rng=seed, ctx=tctx)
    skp2 = SecretKeyPack(params, rng=seed + 1, ctx=tctx)
    crng = np.random.default_rng(seed + 2)
    clues = ClueBatch.concat([skp.generate_sender().gen_clues(2, crng),
                              skp2.generate_sender().gen_clues(2, crng)])

    from tfhe_omr_tpu.core.params import OmrParameters as JaxParams

    jskp = JaxPack(JaxParams.tiny(noise_free=True), rng=seed)
    jskp.generate_sender()  # the clue key's draws come before the detection key's
    jkey = jskp.generate_detector().key
    key = detection_key_from_numpy(*(np.asarray(a) for a in (
        jkey.bsk1, jkey.ksk_limbs, jkey.bsk2, jkey.trace_k)), tctx)
    got = Detector(key, tctx).detect(clues).numpy()
    assert np.array_equal(got, pinned["detect_tiny"])
