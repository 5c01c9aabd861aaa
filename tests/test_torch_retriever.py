"""The port's client: solver, native decoder, decrypt, and round trips.

* ``solve_matrix_numpy`` equals the JAX one mod 257 and mod 256; the native
  library equals numpy for the solve and the bucket scan; a singular matrix
  raises ``InvertibleMatrixError``; a failed g++ build raises; the copied
  ``omr_host.cpp`` is byte-identical to the JAX package's.
* ``Retriever.decrypt`` and ``noise_sigma_info`` equal the JAX Retriever's
  on the same secrets.
* Round-trip twins of tests/test_omr_roundtrip.py on the port's own keys at
  the tiny preset: a mixed board, an all-pertinent board, and a confirmed
  protocol false positive.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_omr_tpu.core.errors import InvertibleMatrixError as JaxInvertibleMatrixError
from tfhe_omr_tpu.core.keygen import SecretKeyPack as JaxPack
from tfhe_omr_tpu.core.matrix import solve_matrix_numpy as jax_solve_numpy
from tfhe_omr_tpu.core.params import OmrParameters as JaxParams
from tfhe_omr_tpu_torch import native
from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.errors import InvertibleMatrixError
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack, secret_key_pack_from_numpy
from tfhe_omr_tpu_torch.core.matrix import solve_matrix, solve_matrix_numpy
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.core.payload import random_payloads
from tfhe_omr_tpu_torch.core.retriever import scan_buckets_numpy
from tfhe_omr_tpu_torch.core.sender import ClueBatch

# The suite runs in several xdist workers on one host: one torch thread each
# keeps their CPU thread pools from oversubscribing its cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _system(rng, rows, cols, plen, p):
    x = rng.integers(0, p, size=(cols, plen), dtype=np.int64)
    m = rng.integers(0, p, size=(rows, cols), dtype=np.int64)
    return m, np.mod(m @ x, p), x


@pytest.mark.parametrize("p", [257, 256])
def test_solvers_match_jax_and_native(p):
    """numpy == JAX numpy == native on every draw; a draw that is singular
    mod 256 must raise in all three."""
    rng = np.random.default_rng(p)
    solved = 0
    for _ in range(6):
        m, rhs, x = _system(rng, 55, 50, 612, p)
        try:
            want = jax_solve_numpy(m.copy(), rhs.copy(), p)
        except JaxInvertibleMatrixError:
            with pytest.raises(InvertibleMatrixError):
                solve_matrix_numpy(m.copy(), rhs.copy(), p)
            with pytest.raises(InvertibleMatrixError):
                solve_matrix(m.copy(), rhs.copy(), p)
            continue
        got = solve_matrix_numpy(m.copy(), rhs.copy(), p)
        assert np.array_equal(got, want) and np.array_equal(got, x)
        assert np.array_equal(solve_matrix(m.copy(), rhs.copy(), p), x)
        solved += 1
    assert solved >= 3, solved


def test_singular_raises():
    m = np.zeros((5, 3), dtype=np.int64)
    m[:, 0] = 1
    rhs = np.zeros((5, 10), dtype=np.int64)
    with pytest.raises(InvertibleMatrixError):
        solve_matrix_numpy(m, rhs, 257)
    with pytest.raises(InvertibleMatrixError):
        solve_matrix(m, rhs, 257)


def test_scan_native_matches_numpy():
    p, spb, n_buckets, n_seg = 257, 3, 10, 4
    sps = spb * n_buckets + 2  # two unused slots after the buckets
    rng = np.random.default_rng(8)
    decoded = rng.integers(0, p, size=n_seg * sps + 5, dtype=np.int64)
    slot = np.arange(n_seg * sps) % sps
    flags = np.nonzero((slot < n_buckets * spb) & (slot % spb == spb - 1))[0]
    decoded[flags] = 0
    for seg, bkt, index in ((2, 7, 1234), (0, 0, 5), (3, 9, 66048), (1, 4, 9999)):
        base = seg * sps + bkt * spb
        decoded[base:base + 3] = [index % p, index // p, 1]
    decoded[1 * sps + 2 * spb + 2] = 2  # a flag of 2 is no hit
    want = scan_buckets_numpy(decoded, n_seg, sps, spb, n_buckets, p, 10_000)
    got = native.scan_buckets_native(decoded, n_seg, sps, spb, n_buckets, p, 10_000)
    assert got.tolist() == want.tolist() == [5, 9999, 1234]


def test_native_source_is_the_jax_packages():
    with open(os.path.join(ROOT, "tfhe_omr_tpu", "native", "omr_host.cpp"), "rb") as a, \
            open(os.path.join(ROOT, "tfhe_omr_tpu_torch", "native", "omr_host.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "omr_host.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()


@pytest.mark.parametrize("noise_free", [False, True])
def test_decrypt_and_noise_info_match_jax(noise_free):
    """The port's Retriever on a JAX pack's secrets decrypts random digest
    cts exactly as the JAX Retriever does."""
    params = OmrParameters.tiny(noise_free=noise_free)
    jskp = JaxPack(JaxParams.tiny(noise_free=noise_free), rng=4)
    port = secret_key_pack_from_numpy(params, jskp.clue_sk, jskp.inter_sk,
                                      jskp.z1, jskp.z2,
                                      OmrContext(params, "cpu"))
    jret = jskp.generate_retriever(40, 8)
    ret = port.generate_retriever(40, 8)
    rp = ret.params
    ct = np.random.default_rng(3).integers(
        0, params.q2, size=(rp.cmb_cipher_count, 2, params.n2), dtype=np.int64)
    want = np.asarray(jax.block_until_ready(jret._decrypt_jit(jnp.asarray(ct))))
    assert np.array_equal(ret.decrypt(ct), want)
    assert np.array_equal(ret.decrypt(torch.as_tensor(ct[0]), plain=True), want[0])
    assert ret.noise_sigma_info(ct, 2.0e7) == jret.noise_sigma_info(ct, 2.0e7)


# ------------------------------------------------------------ round trips
def _board(params, all_count, pertinent_count, seed, fp_row=None):
    """Packs, detector and host clues for a board: the recipient's clues on
    the pertinent rows (and on ``fp_row``, a clue collision), the second
    pack's elsewhere."""
    skp = SecretKeyPack(params, rng=seed, ctx=OmrContext(params, "cpu"))
    skp2 = SecretKeyPack(params, rng=seed + 1, ctx=OmrContext(params, "cpu"))
    rng = np.random.default_rng(seed + 2)
    sender, sender2 = skp.generate_sender(), skp2.generate_sender()
    detector = skp.generate_detector()
    pertinent = np.zeros(all_count, dtype=bool)
    pertinent[:pertinent_count] = True
    rng.shuffle(pertinent)
    own_rows = pertinent.copy()
    if fp_row is not None:
        fp_row = int(np.nonzero(~pertinent)[0][fp_row])
        own_rows[fp_row] = True
    own = sender.gen_clues(int(own_rows.sum()), rng)
    other = sender2.gen_clues(int((~own_rows).sum()), rng)
    a = np.zeros((all_count, own.a.shape[1]), dtype=np.int64)
    b7 = np.zeros((all_count, own.b7.shape[1]), dtype=np.int64)
    a[own_rows], b7[own_rows] = own.a, own.b7
    a[~own_rows], b7[~own_rows] = other.a, other.b7
    true_indices = sorted(np.nonzero(pertinent)[0].tolist())
    return skp, detector, rng, ClueBatch(a, b7), true_indices, fp_row, own_rows


def _round_trip(skp, detector, rng, clues, all_count, pertinent_count):
    params = skp.params
    payloads = random_payloads(rng, all_count, params.payload_length)
    pertinency = detector.detect(clues)
    retriever = skp.generate_retriever(all_count, pertinent_count)
    rp = retriever.params
    index_cts = [detector.encode_pertinent_indices(rp, pertinency, rng)
                 for _ in range(rp.max_encode_indices_cipher_count)]
    seed = int(rng.integers(0, 2**63))
    payload_cts = detector.encode_pertinent_payloads(rp, pertinency, payloads, seed)
    indices, solved = retriever.decode_digest(index_cts, payload_cts, seed)
    return indices, solved, payloads


@pytest.mark.parametrize("all_count,pertinent_count", [(48, 6), (8, 8)],
                         ids=["mixed", "all_pertinent"])
def test_roundtrip_tiny(all_count, pertinent_count):
    params = OmrParameters.tiny()
    skp, detector, rng, clues, true_indices, _fp, _own = _board(
        params, all_count, pertinent_count, 11)
    indices, solved, payloads = _round_trip(skp, detector, rng, clues,
                                            all_count, pertinent_count)
    assert indices == true_indices
    np.testing.assert_array_equal(solved, payloads[indices])


def test_roundtrip_with_protocol_false_positive():
    """A clue collision decodes as an extra index with a byte-exact payload;
    its clues all decrypt to 0 under the recipient's key, a genuine
    non-pertinent message's do not."""
    params = OmrParameters.tiny()
    all_count, pertinent_count = 48, 6
    skp, detector, rng, clues, true_indices, fp_index, own_rows = _board(
        params, all_count, pertinent_count, 31, fp_row=3)
    indices, solved, payloads = _round_trip(skp, detector, rng, clues,
                                            all_count, pertinent_count)
    assert set(true_indices) <= set(indices)
    assert [i for i in indices if i not in set(true_indices)] == [fp_index]
    np.testing.assert_array_equal(solved, payloads[indices])
    assert (skp.decrypt_compact_clue(clues.a[fp_index], clues.b7[fp_index]) == 0).all()
    genuine = int(np.nonzero(~own_rows)[0][0])
    assert (skp.decrypt_compact_clue(clues.a[genuine], clues.b7[genuine]) != 0).any()
