"""The port's whole slice against the JAX package, and its omd oracle.

* ``Detector.detect`` of the port, on keys made by the JAX package and
  carried across, equals JAX ``Detector.detect`` bit for bit at the tiny
  preset (noisy and noise-free) on a mixed pertinent / non-pertinent batch.
* One numpy seed gives identical secrets, clue key and KSK in both packages.
* The port's own key generation passes the omd oracle: detect, decrypt,
  ``[1, 0, ..., 0]`` for pertinent messages and zeros for the others.

The same whole-detect comparison at the default rings (reduced LWE
dimensions) is in tests/test_torch_bootstrap.py, which already holds the
JAX keys for them.
"""

import numpy as np
import jax
import pytest
import torch

from tfhe_omr_tpu.core.keygen import SecretKeyPack as JaxPack
from tfhe_omr_tpu.core.params import OmrParameters as JaxParams
from tfhe_omr_tpu.core.sender import ClueBatch as JaxClues
from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.detector import Detector
from tfhe_omr_tpu_torch.core.keygen import (
    SecretKeyPack,
    detection_key_from_numpy,
    secret_key_pack_from_numpy,
)
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.core.sender import ClueBatch

# The suite runs in several xdist workers on one host: one torch thread each
# keeps their CPU thread pools from oversubscribing its cores.
torch.set_num_threads(1)

SEED = 3


def _decode(params, dec):
    q, t = params.q2, params.output_plain_modulus
    return np.mod((dec * (2 * t) + q) // (2 * q), t)


def _assert_oracle(decoded, pertinent):
    for i in range(pertinent):
        assert decoded[i, 0] == 1, decoded[i, :8]
        assert not decoded[i, 1:].any()
    assert not decoded[pertinent:].any()


@pytest.fixture(scope="module", params=[False, True], ids=["noisy", "noise_free"])
def jax_run(request):
    """The JAX package's omd run at the tiny preset: packs, keys, clues
    (3 pertinent + 3 not) and its detect output."""
    jparams = JaxParams.tiny(noise_free=request.param)
    skp = JaxPack(jparams, rng=SEED)
    skp2 = JaxPack(jparams, rng=SEED + 1)
    sender, sender2 = skp.generate_sender(), skp2.generate_sender()
    dkey = skp.generate_detection_key()
    from tfhe_omr_tpu.core.detector import Detector as JaxDetector

    detector = JaxDetector(dkey, skp.ctx)
    rng = np.random.default_rng(SEED + 2)
    clues = JaxClues.concat([sender.gen_clues(3, rng), sender2.gen_clues(3, rng)])
    out = np.asarray(jax.block_until_ready(detector.detect(clues)))
    return request.param, skp, sender, dkey, clues, out


def test_detect_matches_jax_on_jax_keys(jax_run):
    noise_free, skp, _sender, dkey, clues, want = jax_run
    params = OmrParameters.tiny(noise_free=noise_free)
    ctx = OmrContext(params, "cpu")
    key = detection_key_from_numpy(
        np.asarray(dkey.bsk1), np.asarray(dkey.ksk_limbs),
        np.asarray(dkey.bsk2), np.asarray(dkey.trace_k), ctx)
    detector = Detector(key, ctx)
    batch = ClueBatch(a=np.asarray(clues.a), b7=np.asarray(clues.b7))
    got = detector.detect(batch)
    assert got.shape == want.shape == (6, 2, params.n2)
    assert np.array_equal(got.numpy(), want), int((got.numpy() != want).sum())
    timed, times = detector.detect_with_time_info(batch)
    assert torch.equal(timed, got) and times.detect_time > 0
    # the JAX secrets decrypt the port's output through the port's decrypt
    port_skp = secret_key_pack_from_numpy(
        params, skp.clue_sk, skp.inter_sk, skp.z1, skp.z2, ctx)
    dec = port_skp.decrypt_rlwe2_ntt(got)
    assert np.array_equal(dec, np.asarray(skp.decrypt_rlwe2_ntt(want)))
    _assert_oracle(_decode(params, dec), 3)


def test_same_seed_same_host_keys(jax_run):
    """Secrets, clue key, ring-key NTTs and KSK from one numpy seed."""
    noise_free, skp, sender, dkey, _clues, _out = jax_run
    params = OmrParameters.tiny(noise_free=noise_free)
    port = SecretKeyPack(params, rng=SEED, ctx=OmrContext(params, "cpu"))
    for name in ("clue_sk", "inter_sk", "z1", "z2"):
        assert np.array_equal(getattr(port, name), getattr(skp, name)), name
    assert np.array_equal(port.z1_ntt.numpy(), np.asarray(skp.z1_ntt).astype(np.int64))
    assert np.array_equal(port.z2_ntt.numpy(), np.asarray(skp.z2_ntt))
    ck = port.generate_clue_key()
    assert np.array_equal(ck.mat_a, sender.clue_key.mat_a)
    assert np.array_equal(ck.mat_b7, sender.clue_key.mat_b7)
    port_key = port.generate_detection_key()
    planes = np.asarray(dkey.ksk_limbs).astype(np.int64)
    ksk = sum(planes[k] << (7 * k) for k in range(planes.shape[0]))
    assert np.array_equal(port_key.ksk.numpy(), ksk)


@pytest.mark.parametrize("noise_free", [False, True], ids=["noisy", "noise_free"])
def test_port_keygen_passes_omd(noise_free):
    """Port keygen (torch.Generator masks and noise) + clues + detect +
    decrypt: the omd oracle, and the plain path equals the wrappers'."""
    params = OmrParameters.tiny(noise_free=noise_free)
    skp = SecretKeyPack(params, rng=SEED, ctx=OmrContext(params, "cpu"))
    skp2 = SecretKeyPack(params, rng=SEED + 1, ctx=OmrContext(params, "cpu"))
    sender, sender2 = skp.generate_sender(), skp2.generate_sender()
    detector = skp.generate_detector()
    rng = np.random.default_rng(SEED + 2)
    clues = ClueBatch.concat([sender.gen_clues(2, rng), sender2.gen_clues(3, rng)])
    out = detector.detect(clues)
    assert torch.equal(out, detector.detect(clues, plain=True))
    _assert_oracle(_decode(params, skp.decrypt_rlwe2_ntt(out)), 2)
    # and every clue of a pertinent message decrypts to 0 under the pack
    for i in range(2):
        assert not skp.decrypt_compact_clue(clues.a[i], clues.b7[i]).any()
