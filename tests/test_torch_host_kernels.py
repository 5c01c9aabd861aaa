"""The CUDA kernel templates, run on the host, against their plain versions.

``csrc/*.cu`` compile with g++ against a stand-in ``cuda_runtime.h``
(``utils/build.py host_library``): a block runs as one host thread per CUDA
thread, ``__syncthreads`` is a barrier. The wrappers of ``ops/fused.py`` and
``ops/ntt.py`` are pointed at that library and told their CPU tensors are on
a card, so what runs here is everything but the device: the key and table
layouts, the argument lists of the C entry points, and every index, mask and
barrier of the kernels. All comparisons are exact. What nvcc refuses, and
every time, shows only on a card (``tests/test_torch_cuda.py``).
"""

import contextlib
import re
import types

import numpy as np
import pytest
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.detector import draw_index_buckets, payload_weights
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
from tfhe_omr_tpu_torch.core.payload import random_payloads
from tfhe_omr_tpu_torch.core.params import OmrParameters, RetrievalParams
from tfhe_omr_tpu_torch.ops import encode, fused
from tfhe_omr_tpu_torch.ops.bootstrap import init_accumulator
from tfhe_omr_tpu_torch.ops.ntt import Ntt
from tfhe_omr_tpu_torch.utils import build

from fused_helpers import cluster_of

torch.set_num_threads(1)

PRESETS = ["default", "tiny"]
SMS = 2  # the stand-in card: a block of the row NTT walks over several groups


@pytest.fixture
def host(monkeypatch):
    """Route the kernel wrappers to the host build of the kernels."""
    lib = build.host_library()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=SMS))
    before = dict(build.LAUNCHES)
    yield lib
    build.LAUNCHES.clear()
    build.LAUNCHES.update(before)


def _ctx(preset):
    # a context of its own: the NTT caches its kernel tables
    return OmrContext(getattr(OmrParameters, preset)(), "cpu")


def _uniform(gen, q, shape):
    return torch.randint(0, q, shape, generator=gen)


@pytest.mark.parametrize("rows", [1, 2, 5, 37])
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_ntt_kernel_on_host_matches_plain(host, preset, level, rows):
    ctx = _ctx(preset)
    ntt = ctx.ntt1 if level == 1 else ctx.ntt2
    gen = torch.Generator().manual_seed(level)
    x = _uniform(gen, ntt.field.q, (rows, ntt.n))
    x[0, :3] = torch.tensor([0, ntt.field.q - 1, 1])
    lay = ntt.kernel_layout()
    assert lay.word_bits == (32 if level == 1 else 64)
    fwd = ntt.fwd_last(x)
    assert build.LAUNCHES[ntt.name] >= 1
    assert torch.equal(fwd, ntt.fwd_last_plain(x))
    assert torch.equal(ntt.inv_last(x), ntt.inv_last_plain(x))
    assert torch.equal(ntt.inv_last(fwd), x)


@pytest.mark.parametrize("rounds", ["one", "two", "all"])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("preset", PRESETS)
def test_trace_kernel_on_host_matches_plain(host, preset, m, rounds):
    """From the second round on acc_b is gathered from what the round before
    wrote: the automorphed b-part is parked before the update."""
    ctx = _ctx(preset)
    f, g = ctx.f2, ctx.gadget_trace
    autos = ctx.trace_autos[:{"one": 1, "two": 2, "all": None}[rounds]]
    gen = torch.Generator().manual_seed(5)
    tk = _uniform(gen, f.q, (len(autos), ctx.params.n2, g.d, 2))
    key = fused.TraceKey(tk, f.shoup_t(tk), ctx.ntt2, g, autos)
    assert key.on_card and len(key.keys) == 1
    acc = _uniform(gen, f.q, (m, 2, ctx.params.n2))
    acc[0, :, :3] = torch.tensor([0, f.q - 1, 1])
    assert torch.equal(fused.trace(acc, key), fused.trace_plain(acc, key))
    ref, ref_sh = key.reference()
    assert torch.equal(ref, tk) and torch.equal(ref_sh, f.shoup_t(tk))


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_blind_rotate_kernel_on_host_matches_plain(host, preset, level, m):
    ctx = _ctx(preset)
    f, ntt, g = (ctx.f1, ctx.ntt1, ctx.gadget_br1) if level == 1 else (
        ctx.f2, ctx.ntt2, ctx.gadget_br2)
    lut = ctx.lut1_ext if level == 1 else ctx.lut2_ext
    n_lwe = 4
    gen = torch.Generator().manual_seed(10 + level)
    bsk = _uniform(gen, f.q, (3 * n_lwe // 2, ntt.n, g.d, 2, 2))
    key = fused.BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, f"blind_rotate{level}")
    b = _uniform(gen, 2 * ntt.n, (m,))
    amounts = _uniform(gen, 2 * ntt.n, (n_lwe, m))
    amounts[:, 0] = 2 * ntt.n - 1
    acc = init_accumulator(torch.as_tensor(lut), b, ntt.n).permute(2, 1, 0).contiguous()
    acc[:, 0] = _uniform(gen, f.q, (m, ntt.n))
    assert torch.equal(fused.blind_rotate(acc, amounts, key),
                       fused.blind_rotate_plain(acc, amounts, key))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_blind_rotate_kernel_extreme_amounts_on_host(host, preset, level):
    """Every rotation 0 or 2N - 1, so that a0 + a1 wraps past 2N (the kernel
    masks where the plain version takes ``% 2N``), extreme coefficients:
    the monomial table read from shared memory (the default first level,
    both tiny levels) and through the cache (the default second level)."""
    ctx = _ctx(preset)
    f, ntt, g = (ctx.f1, ctx.ntt1, ctx.gadget_br1) if level == 1 else (
        ctx.f2, ctx.ntt2, ctx.gadget_br2)
    n_lwe, m = 6, 6
    gen = torch.Generator().manual_seed(40 + level)
    bsk = _uniform(gen, f.q, (3 * n_lwe // 2, ntt.n, g.d, 2, 2))
    key = fused.BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, f"blind_rotate{level}")
    assert key.layout.mono_shared == (preset == "tiny" or level == 1)
    two_n = 2 * ntt.n
    amounts = _uniform(gen, two_n, (n_lwe, m))
    amounts[:] = torch.where(amounts % 2 == 0, 0, two_n - 1)
    amounts[:, 0] = two_n - 1
    amounts[:, 1] = 0
    acc = _uniform(gen, f.q, (m, 2, ntt.n))
    acc[2] = f.q - 1
    acc[3] = 0
    assert torch.equal(fused.blind_rotate(acc, amounts, key),
                       fused.blind_rotate_plain(acc, amounts, key))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_blind_rotate_layout_reports_where_the_monomial_table_lives(host, preset, level):
    """The library reports the psi-power table in shared memory where the
    configuration has room for it beside the rest (K1: 209,920 + 8,192
    bytes of the 232,448 a block may have; the tiny presets), and read
    through the cache where it has not (K2: 202,752 + 32,768 bytes); the
    trace has no such table."""
    ctx = _ctx(preset)
    ntt, g = (ctx.ntt1, ctx.gadget_br1) if level == 1 else (ctx.ntt2, ctx.gadget_br2)
    assert fused.br_layout(ntt, g).mono_shared == (preset == "tiny" or level == 1)
    assert not fused.tr_layout(ctx.ntt2, ctx.gadget_trace).mono_shared


def _stack(keys):
    stack = keys[0].empty_stack(len(keys))
    for r, key in enumerate(keys):
        stack.put(r, key)
    return stack


# per-recipient keys: R recipients' runs of ``per`` samples in one launch;
# 5 and 7 samples a run fill no whole block of the first level's S = 4
# (each run's last block is masked as a ragged batch's), 1 a run is K2's
# one message a recipient
@pytest.mark.parametrize("per", [1, 7])
@pytest.mark.parametrize("recipients", [1, 2, 3])
@pytest.mark.parametrize("level", [1, 2])
def test_blind_rotate_kernel_per_recipient_keys_on_host(host, level, recipients, per):
    ctx = _ctx("tiny")
    f, ntt, g = (ctx.f1, ctx.ntt1, ctx.gadget_br1) if level == 1 else (
        ctx.f2, ctx.ntt2, ctx.gadget_br2)
    n_lwe, m = 4, recipients * per
    gen = torch.Generator().manual_seed(20 + level + recipients)
    keys = []
    for _ in range(recipients):
        bsk = _uniform(gen, f.q, (3 * n_lwe // 2, ntt.n, g.d, 2, 2))
        keys.append(fused.BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, f"blind_rotate{level}"))
    stack = _stack(keys)
    assert stack.recipients == recipients and stack.keys[0].shape[0] == recipients
    acc = _uniform(gen, f.q, (m, 2, ntt.n))
    amounts = _uniform(gen, 2 * ntt.n, (n_lwe, m))
    amounts[:, 0] = 2 * ntt.n - 1
    got = fused.blind_rotate(acc, amounts, stack)
    assert build.LAUNCHES[f"blind_rotate{level}"] == 1
    runs = [slice(r * per, (r + 1) * per) for r in range(recipients)]
    want = torch.cat([fused.blind_rotate_plain(acc[s], amounts[:, s], keys[r])
                      for r, s in enumerate(runs)])
    assert torch.equal(got, want)
    assert torch.equal(fused.blind_rotate_plain(acc, amounts, stack), want)
    # each run under its own key, not the first one's
    if recipients > 1:
        assert not torch.equal(got[runs[1]], fused.blind_rotate(
            acc[runs[1]], amounts[:, runs[1]], keys[0]))


# the cluster variant of K2: (blocks, SMs, {C: clusters of C the card holds
# at once} for the variants instantiated, the C chosen). The reference
# d = 6 has variants of 2, 3 and 6: with room for any number of clusters
# (the host build), on 132 SMs C = 6 up to 22 samples, 3 up to 44, 2 up to
# 66, the one-block kernel from 67 on; where the card holds 17 clusters of
# 6, 39 of 3 and 66 of 2 at once (an H100 SXM), 6 up to 17, 3 up to 39. The
# tiny preset's d = 7 has one of 7, a first level none.
ANY = 1 << 20
REF_ANY = {2: ANY, 3: ANY, 6: ANY}
REF_H100 = {2: 66, 3: 39, 6: 17}
TINY_ANY = {7: ANY}


@pytest.mark.parametrize("blocks,sms,fits,want", [
    (1, 132, REF_ANY, 6), (22, 132, REF_ANY, 6), (23, 132, REF_ANY, 3),
    (44, 132, REF_ANY, 3), (66, 132, REF_ANY, 2), (67, 132, REF_ANY, 1),
    (96, 132, REF_ANY, 1), (128, 132, REF_ANY, 1), (1024, 132, REF_ANY, 1),
    (1, 132, REF_H100, 6), (17, 132, REF_H100, 6), (22, 132, REF_H100, 3),
    (23, 132, REF_H100, 3), (39, 132, REF_H100, 3), (44, 132, REF_H100, 2),
    (66, 132, REF_H100, 2), (67, 132, REF_H100, 1), (96, 132, REF_H100, 1),
    (1024, 132, REF_H100, 1), (1, 132, TINY_ANY, 7), (18, 132, TINY_ANY, 7),
    (19, 132, TINY_ANY, 1), (1, 132, {}, 1), (1, 1, REF_ANY, 1), (1, 2, REF_ANY, 2),
    (1, 5, REF_ANY, 3), (0, 132, REF_ANY, 6),
])
def test_cluster_size(blocks, sms, fits, want):
    c = fused.cluster_size(blocks, sms, fits)
    assert c == want
    assert 1 <= c <= fused.CLUSTER_MAX
    assert c == 1 or (c in fits and blocks * c <= sms and blocks <= fits[c])


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_blind_rotate_layout_reports_its_cluster_variants(host, preset, level):
    """The second levels have a cluster variant for every C in 2..8 that
    splits their d digits (the reference d = 6: 2, 3, 6; the tiny d = 7:
    7), the first levels none."""
    ctx = _ctx(preset)
    ntt, g = (ctx.ntt1, ctx.gadget_br1) if level == 1 else (ctx.ntt2, ctx.gadget_br2)
    want = () if level == 1 else tuple(c for c in range(2, 9) if g.d % c == 0)
    assert fused.br_layout(ntt, g).clusters == want
    assert want != () or level == 1


def _cluster_case(preset, m, n_lwe=4, seed=50):
    ctx = _ctx(preset)
    f, ntt, g = ctx.f2, ctx.ntt2, ctx.gadget_br2
    gen = torch.Generator().manual_seed(seed)
    bsk = _uniform(gen, f.q, (3 * n_lwe // 2, ntt.n, g.d, 2, 2))
    key = fused.BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, "blind_rotate2")
    acc = _uniform(gen, f.q, (m, 2, ntt.n))
    amounts = _uniform(gen, 2 * ntt.n, (n_lwe, m))
    return key, acc, amounts


# (preset, samples, SMs of the stand-in card, the C that the launch takes)
@pytest.mark.parametrize("preset,m,sms,c", [
    ("default", 1, 2, 2), ("default", 1, 3, 3), ("default", 1, 6, 6),
    ("default", 2, 12, 6), ("default", 2, 11, 3), ("default", 3, 6, 2),
    ("default", 4, 6, 1), ("tiny", 1, 7, 7), ("tiny", 3, 132, 7), ("tiny", 2, 13, 1),
])
def test_blind_rotate_cluster_kernel_on_host_matches_plain(host, monkeypatch, preset, m,
                                                           sms, c):
    """A sample a cluster of C CTAs, each CTA d / C of the digits, the
    partial products summed over the cluster: equal to the plain version
    and to the one-block kernel, and counted under its own name."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=sms))
    key, acc, amounts = _cluster_case(preset, m)
    amounts[:, 0] = 2 * key.ntt.n - 1
    acc[0, 1] = key.ntt.field.q - 1
    build.LAUNCHES.clear()
    got = fused.blind_rotate(acc, amounts, key)
    path = "blind_rotate2_cluster" if c > 1 else "blind_rotate2"
    assert dict(build.LAUNCHES) == {path: 1}
    assert torch.equal(got, fused.blind_rotate_plain(acc, amounts, key))
    with cluster_of(1):
        assert torch.equal(got, fused.blind_rotate(acc, amounts, key))
    assert build.LAUNCHES["blind_rotate2"] == 1 + (c == 1)


@pytest.mark.parametrize("preset,sms", [("default", 6), ("tiny", 7)])
def test_blind_rotate_cluster_kernel_extreme_amounts_on_host(host, monkeypatch, preset, sms):
    """Every rotation 0 or 2N - 1 and extreme coefficients through the
    cluster of the largest C: the sums over the cluster at their largest."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=sms))
    key, acc, amounts = _cluster_case(preset, 1, n_lwe=6, seed=51)
    two_n = 2 * key.ntt.n
    amounts[:] = torch.where(amounts % 2 == 0, 0, two_n - 1)
    acc[0, 0] = key.ntt.field.q - 1
    build.LAUNCHES.clear()
    got = fused.blind_rotate(acc, amounts, key)
    assert dict(build.LAUNCHES) == {"blind_rotate2_cluster": 1}
    assert torch.equal(got, fused.blind_rotate_plain(acc, amounts, key))


# a cluster a sample under each sample's recipient's key
@pytest.mark.parametrize("recipients", [1, 2, 4])
def test_blind_rotate_cluster_kernel_per_recipient_keys_on_host(host, monkeypatch,
                                                                recipients):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    ctx = _ctx("tiny")
    f, ntt, g = ctx.f2, ctx.ntt2, ctx.gadget_br2
    n_lwe = 4
    gen = torch.Generator().manual_seed(60 + recipients)
    keys = []
    for _ in range(recipients):
        bsk = _uniform(gen, f.q, (3 * n_lwe // 2, ntt.n, g.d, 2, 2))
        keys.append(fused.BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, "blind_rotate2"))
    stack = _stack(keys)
    acc = _uniform(gen, f.q, (recipients, 2, ntt.n))
    amounts = _uniform(gen, 2 * ntt.n, (n_lwe, recipients))
    build.LAUNCHES.clear()
    got = fused.blind_rotate(acc, amounts, stack)
    assert dict(build.LAUNCHES) == {"blind_rotate2_cluster": 1}
    want = torch.cat([fused.blind_rotate_plain(acc[r:r + 1], amounts[:, r:r + 1], keys[r])
                      for r in range(recipients)])
    assert torch.equal(got, want)
    with cluster_of(1):
        assert torch.equal(got, fused.blind_rotate(acc, amounts, stack))


@pytest.mark.parametrize("per", [1, 2])
@pytest.mark.parametrize("recipients", [1, 2, 3])
def test_trace_kernel_per_recipient_keys_on_host(host, recipients, per):
    ctx = _ctx("tiny")
    f, g = ctx.f2, ctx.gadget_trace
    autos = ctx.trace_autos[:2]
    gen = torch.Generator().manual_seed(30 + recipients)
    keys = []
    for _ in range(recipients):
        tk = _uniform(gen, f.q, (len(autos), ctx.params.n2, g.d, 2))
        keys.append(fused.TraceKey(tk, f.shoup_t(tk), ctx.ntt2, g, autos))
    stack = _stack(keys)
    acc = _uniform(gen, f.q, (recipients * per, 2, ctx.params.n2))
    got = fused.trace(acc, stack)
    assert build.LAUNCHES["trace"] == 1
    want = torch.cat([fused.trace_plain(acc[r * per:(r + 1) * per], keys[r])
                      for r in range(recipients)])
    assert torch.equal(got, want)
    assert torch.equal(fused.trace_plain(acc, stack), want)


@pytest.mark.parametrize("recipients", [1, 2, 3])
def test_encode_kernels_over_recipients_on_host(host, recipients):
    """encode_mac over R sets in one launch == each set alone; the index
    plaintexts of several digests' rows of the same messages (``period``)
    == each digest's rows alone."""
    ctx = _ctx("tiny")
    f, n = ctx.f2, ctx.params.n2
    rp = RetrievalParams.for_params(ctx.params, *ENCODE_BOARD)
    gen = torch.Generator().manual_seed(50 + recipients)
    rows, kct = 3, 2
    pert = _uniform(gen, f.q, (recipients, rows, 2, n))
    pn = _uniform(gen, f.q, (recipients, kct, rows, n))
    acc = _uniform(gen, f.q, (recipients, kct, 2, n))
    got = encode.encode_mac(f, pert, pn, acc)
    assert build.LAUNCHES["encode_mac"] == 1
    want = torch.stack([encode.encode_mac_plain(f, pert[r], pn[r], acc[r])
                        for r in range(recipients)])
    assert torch.equal(got, want)
    assert torch.equal(encode.encode_mac(f, pert, pn, acc, plain=True), want)
    lo = 5
    args = (rp.index_slots_per_bucket, rp.polynomial_size, rp.index_modulus, ctx.params.q2)
    base = torch.as_tensor(draw_index_buckets(rp, recipients * kct * rows,
                                              np.random.default_rng(recipients)))
    got = encode.index_plaintexts(base, lo, *args, period=rows)
    want = torch.cat([encode.index_plaintexts(base[s:s + rows].contiguous(), lo, *args,
                                              plain=True)
                      for s in range(0, base.shape[0], rows)])
    assert torch.equal(got, want)
    assert torch.equal(encode.index_plaintexts(base, lo, *args, plain=True, period=rows), want)


# the board whose digest layout the encoders' tests take: 28 payload digests
ENCODE_BOARD = (4096, 50)


@pytest.mark.parametrize("digests", ["one", "all"])
@pytest.mark.parametrize("rows", [1, 2, 37])
@pytest.mark.parametrize("preset", PRESETS)
def test_encode_mac_on_host_matches_plain(host, preset, rows, digests):
    """All K digests of a chunk in one launch: K = 1 (an index digest, its
    rows split over the block's lanes) and the preset's 28 payload digests
    (14 groups of two), with residues at both ends of the field."""
    ctx = _ctx(preset)
    f, n = ctx.f2, ctx.params.n2
    rp = RetrievalParams.for_params(ctx.params, *ENCODE_BOARD)
    kct = 1 if digests == "one" else rp.cmb_cipher_count
    gen = torch.Generator().manual_seed(40 + rows)
    pert = _uniform(gen, f.q, (rows, 2, n))
    pn = _uniform(gen, f.q, (kct, rows, n))
    acc = _uniform(gen, f.q, (kct, 2, n))
    pert[:, :, :2] = f.q - 1
    pn[:, :, :2] = f.q - 1
    acc[:, 0, 0] = f.q - 1
    pert[0, :, 2] = 0
    got = encode.encode_mac(f, pert, pn, acc)
    assert build.LAUNCHES["encode_mac"] == 1
    assert torch.equal(got, encode.encode_mac_plain(f, pert, pn, acc))
    if preset == "tiny":  # no rows: the digests pass through
        assert torch.equal(acc, encode.encode_mac(f, pert[:0], pn[:, :0], acc))


@pytest.mark.parametrize("rows", [1, 2, 37])
@pytest.mark.parametrize("preset", PRESETS)
def test_plaintext_builds_on_host_match_plain(host, preset, rows):
    """The payload plaintexts of one digest and of every digest of a chunk,
    read from a column slice of the board's weights, and the index
    plaintexts of drawn buckets and of the warm's all-zero ones (every
    segment on the same slots), from a row past the board's first."""
    ctx = _ctx(preset)
    p = ctx.params
    rp = RetrievalParams.for_params(p, *ENCODE_BOARD)
    lo = 3
    args = (rp.polynomial_size, rp.index_modulus, p.q2)
    weights = torch.as_tensor(payload_weights(rp, 77, ENCODE_BOARD[0]))
    payloads = torch.randint(0, 256, (rows, rp.payload_length),
                             generator=torch.Generator().manual_seed(rows))
    for kct in (1, rp.cmb_cipher_count):
        w = weights[:kct, :, lo:lo + rows]
        got = encode.payload_plaintexts(payloads, w, *args)
        assert got.shape == (kct, rows, rp.polynomial_size)
        assert torch.equal(got, encode.payload_plain_device(payloads, w, *args))
    assert build.LAUNCHES["encode_payload_plain"] == 2
    drawn = torch.as_tensor(draw_index_buckets(rp, ENCODE_BOARD[0],
                                               np.random.default_rng(rows)))
    for base in (drawn[lo:lo + rows].contiguous(),
                 torch.zeros((rows, rp.segment_per_cipher), dtype=torch.int64)):
        got = encode.index_plaintexts(base, lo, rp.index_slots_per_bucket, *args)
        assert torch.equal(got, encode.index_plaintexts(
            base, lo, rp.index_slots_per_bucket, *args, plain=True))
    assert build.LAUNCHES["encode_index_plain"] == 2


@pytest.fixture(scope="module")
def tiny_detector():
    """A tiny-preset detector made on the CPU before any routing (its keys
    in the plain layout; the encoders read none of them)."""
    params = OmrParameters.tiny()
    return SecretKeyPack(params, rng=5, ctx=OmrContext(params, "cpu")).generate_detector()


def test_encoders_on_host_match_plain(host, tiny_detector):
    """Both encoders through the build, K4 and encode_mac of the host
    build equal plain=True, on a ragged board of 24 in chunks of 16: one
    launch of each a chunk, whatever the number of digests."""
    det = tiny_detector
    total, chunk = 24, 16
    rp = RetrievalParams.for_params(det.ctx.params, total, 8)
    rng = np.random.default_rng(41)
    pert = torch.as_tensor(
        rng.integers(0, det.ctx.f2.q, size=(total, 2, det.ctx.params.n2), dtype=np.int64))
    payloads = random_payloads(rng, total, rp.payload_length)
    idx = det.encode_pertinent_indices(rp, pert, np.random.default_rng(6), chunk=chunk)
    pay = det.encode_pertinent_payloads(rp, pert, payloads, 7, chunk=chunk)
    chunks = -(-total // chunk)
    assert build.LAUNCHES["encode_mac"] == 2 * chunks
    assert build.LAUNCHES["ntt2"] == 2 * chunks
    assert build.LAUNCHES["encode_index_plain"] == build.LAUNCHES["encode_payload_plain"] == chunks
    # the chunk's rows and their NTT images lie in two buffers the detector
    # holds, sized by the payload chunk and kept for what follows
    held = [t.data_ptr() for t in det._chunk_words]
    assert det._chunk_words[0].numel() >= rp.cmb_cipher_count * chunk * det.ctx.params.n2
    assert torch.equal(idx, det.encode_pertinent_indices(rp, pert, np.random.default_rng(6),
                                                         chunk=chunk))
    assert [t.data_ptr() for t in det._chunk_words] == held
    assert torch.equal(idx, det.encode_pertinent_indices(
        rp, pert, np.random.default_rng(6), chunk=chunk, plain=True))
    assert torch.equal(pay, det.encode_pertinent_payloads(
        rp, pert, payloads, 7, chunk=chunk, plain=True))
    assert build.LAUNCHES["encode_mac"] == 3 * chunks


def _wrapper_and_plain(wrapper):
    """(call(plain), the plain version's output) of one kernel wrapper at
    the tiny preset, its tensors and keys made while the wrappers see a
    card (the keys in the kernels' layout)."""
    ctx = _ctx("tiny")
    f, n = ctx.f2, ctx.params.n2
    gen = torch.Generator().manual_seed(60)
    if wrapper in ("fwd_last", "inv_last"):
        x = _uniform(gen, f.q, (3, n))
        return (lambda plain: getattr(ctx.ntt2, wrapper)(x, plain=plain),
                getattr(ctx.ntt2, f"{wrapper}_plain")(x))
    if wrapper == "blind_rotate":
        n_lwe, g = 4, ctx.gadget_br2
        bsk = _uniform(gen, f.q, (3 * n_lwe // 2, n, g.d, 2, 2))
        key = fused.BlindRotateKey(bsk, f.shoup_t(bsk), ctx.ntt2, g, "blind_rotate2")
        acc = _uniform(gen, f.q, (2, 2, n))
        amounts = _uniform(gen, 2 * n, (n_lwe, 2))
        assert key.on_card
        return (lambda plain: fused.blind_rotate(acc, amounts, key, plain=plain),
                fused.blind_rotate_plain(acc, amounts, key))
    if wrapper == "trace":
        g, autos = ctx.gadget_trace, ctx.trace_autos[:2]
        tk = _uniform(gen, f.q, (len(autos), n, g.d, 2))
        key = fused.TraceKey(tk, f.shoup_t(tk), ctx.ntt2, g, autos)
        acc = _uniform(gen, f.q, (2, 2, n))
        assert key.on_card
        return lambda plain: fused.trace(acc, key, plain=plain), fused.trace_plain(acc, key)
    if wrapper == "encode_mac":
        pert, pn, acc = (_uniform(gen, f.q, shape) for shape in ((3, 2, n), (2, 3, n), (2, 2, n)))
        return (lambda plain: encode.encode_mac(f, pert, pn, acc, plain=plain),
                encode.encode_mac_plain(f, pert, pn, acc))
    rp = RetrievalParams.for_params(ctx.params, *ENCODE_BOARD)
    args = (rp.polynomial_size, rp.index_modulus, ctx.params.q2)
    lo, rows = 3, 5
    if wrapper == "payload_plaintexts":
        weights = torch.as_tensor(payload_weights(rp, 77, ENCODE_BOARD[0]))[:, :, lo:lo + rows]
        payloads = torch.randint(0, 256, (rows, rp.payload_length), generator=gen)
        return (lambda plain: encode.payload_plaintexts(payloads, weights, *args, plain=plain),
                encode.payload_plain_device(payloads, weights, *args))
    assert wrapper == "index_plaintexts"
    base = torch.as_tensor(draw_index_buckets(rp, rows, np.random.default_rng(60)))
    nd = rp.index_slots_per_bucket
    return (lambda plain: encode.index_plaintexts(base, lo, nd, *args, plain=plain),
            encode.index_poly_device(base, torch.arange(rows) + lo, nd, *args))


@pytest.mark.parametrize("wrapper", ["fwd_last", "inv_last", "blind_rotate", "trace",
                                     "encode_mac", "payload_plaintexts", "index_plaintexts"])
def test_every_wrapper_takes_plain(host, wrapper):
    """On a card's tensors (the host build standing in for the card)
    ``plain=True`` gives the plain version's output bit for bit and
    launches nothing; ``plain=False`` launches the kernel once, to the same
    words: the flag alone chooses."""
    call, want = _wrapper_and_plain(wrapper)
    launched = sum(build.LAUNCHES.values())
    assert torch.equal(call(True), want)
    assert sum(build.LAUNCHES.values()) == launched
    assert torch.equal(call(False), want)
    assert sum(build.LAUNCHES.values()) == launched + 1


# what choosing between a kernel and its plain version anywhere but
# utils/build.py runs_plain looks like, and where it may not appear
CHOICE_PATTERNS = {
    "device_kind_is_cpu": (r'(device_kind\([^)]*\)|\bkind)\s*==\s*"cpu"',
                           lambda rel: rel != "utils/build.py"),
    "plain_version_if_plain": (r"_plain if plain", lambda rel: rel.startswith("core/")),
    "function_identity": (r"\bfwd\w* ==", lambda rel: True),
}


@pytest.mark.parametrize("rule", sorted(CHOICE_PATTERNS))
def test_kernel_or_plain_is_chosen_in_one_place(rule):
    """Every wrapper asks ``build.runs_plain``; no module of the package
    picks a plain function or compares functions to decide."""
    pattern, applies = CHOICE_PATTERNS[rule]
    found = []
    for path in sorted(build.PACKAGE_DIR.rglob("*.py")):
        rel = path.relative_to(build.PACKAGE_DIR).as_posix()
        if applies(rel):
            found += [f"{rel}:{i}" for i, line in enumerate(path.read_text().splitlines(), 1)
                      if re.search(pattern, line)]
    assert not found, found


@pytest.mark.parametrize("kernel", ["blind_rotate", "trace", "ntt", "encode_mac"])
def test_no_instantiation_for_other_parameters_raises(host, kernel):
    """The library is the only table of instantiations; a ring it does not
    have raises, naming the parameters."""
    ctx = _ctx("tiny")
    other = Ntt(ctx.f1, 128, "cpu")
    if kernel == "blind_rotate":
        with pytest.raises(ValueError, match=r"no blind-rotation kernel.*\(7, "):
            fused.br_layout(other, ctx.gadget_br1)
    elif kernel == "trace":
        with pytest.raises(ValueError, match=r"no trace kernel.*\(7, "):
            fused.tr_layout(other, ctx.gadget_trace)
    elif kernel == "ntt":
        with pytest.raises(ValueError, match=r"no NTT kernel.*\(7, "):
            other.fwd_last(torch.zeros((2, 128), dtype=torch.int64))
    else:  # the q1 field: encode_mac has the q2 fields alone
        zero = torch.zeros((1, 2, 128), dtype=torch.int64)
        with pytest.raises(ValueError, match=rf"no encode_mac kernel.*q = {ctx.f1.q}"):
            encode.encode_mac(ctx.f1, zero, zero[:, :1], zero)


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("level", [1, 2])
def test_profiled_blind_rotate_on_host_matches_plain(host, level, m):
    """The profiled instantiation of the reference rings gives the
    production output, and every stage of every block counts clocks (the
    host's clock64 stand-in ticks once a read)."""
    ctx = _ctx("default")
    f, ntt, g = (ctx.f1, ctx.ntt1, ctx.gadget_br1) if level == 1 else (
        ctx.f2, ctx.ntt2, ctx.gadget_br2)
    n_lwe = 4
    gen = torch.Generator().manual_seed(20 + level)
    bsk = _uniform(gen, f.q, (3 * n_lwe // 2, ntt.n, g.d, 2, 2))
    key = fused.BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, f"blind_rotate{level}")
    acc = _uniform(gen, f.q, (m, 2, ntt.n))
    amounts = _uniform(gen, 2 * ntt.n, (n_lwe, m))
    assert host.omr_blind_rotate_stages() == len(fused.BR_STAGES)
    clocks = torch.zeros((fused.n_blocks(m, key.layout.s), len(fused.BR_STAGES)),
                         dtype=torch.int64)
    got = fused.blind_rotate(acc, amounts, key, stage_clocks=clocks)
    assert build.LAUNCHES[f"blind_rotate{level}_profiled"] == 1
    assert torch.equal(got, fused.blind_rotate_plain(acc, amounts, key))
    assert torch.equal(got, fused.blind_rotate(acc, amounts, key))
    assert bool((clocks > 0).all()), clocks
    with pytest.raises(ValueError, match="stage clocks"):
        fused.blind_rotate(acc, amounts, key, stage_clocks=clocks[:, :3])


@pytest.mark.parametrize("level", [1, 2])
def test_profiled_blind_rotate_without_plane_stamps_matches_plain(host, level):
    """With ``plane_stamps=False`` the profiled instantiation still gives
    the production output; the key staging counts in "mac", so its own
    column stays 0 and every other stage counts clocks."""
    ctx = _ctx("default")
    f, ntt, g = (ctx.f1, ctx.ntt1, ctx.gadget_br1) if level == 1 else (
        ctx.f2, ctx.ntt2, ctx.gadget_br2)
    m = 5
    gen = torch.Generator().manual_seed(30 + level)
    bsk = _uniform(gen, f.q, (6, ntt.n, g.d, 2, 2))
    key = fused.BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, f"blind_rotate{level}")
    acc = _uniform(gen, f.q, (m, 2, ntt.n))
    amounts = _uniform(gen, 2 * ntt.n, (4, m))
    clocks = torch.zeros((fused.n_blocks(m, key.layout.s), len(fused.BR_STAGES)),
                         dtype=torch.int64)
    fine = torch.zeros_like(clocks)
    got = fused.blind_rotate(acc, amounts, key, stage_clocks=clocks, plane_stamps=False)
    assert torch.equal(got, fused.blind_rotate_plain(acc, amounts, key))
    fused.blind_rotate(acc, amounts, key, stage_clocks=fine)
    staging = fused.BR_STAGES.index("staging")
    assert bool((clocks[:, staging] == 0).all()), clocks
    others = [i for i in range(len(fused.BR_STAGES)) if i != staging]
    assert bool((clocks[:, others] > 0).all()), clocks
    # the host clock ticks once a read: fewer reads without the plane stamps
    assert int(clocks.sum()) < int(fine.sum())


def test_profiled_blind_rotate_has_no_tiny_instantiation(host):
    ctx = _ctx("tiny")
    f, ntt, g = ctx.f1, ctx.ntt1, ctx.gadget_br1
    bsk = torch.zeros((3, ntt.n, g.d, 2, 2), dtype=torch.int64)
    key = fused.BlindRotateKey(bsk, bsk, ntt, g, "blind_rotate1")
    acc = torch.zeros((1, 2, ntt.n), dtype=torch.int64)
    clocks = torch.zeros((1, len(fused.BR_STAGES)), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="launch failed"):
        fused.blind_rotate(acc, torch.zeros((2, 1), dtype=torch.int64), key,
                           stage_clocks=clocks)


def test_kernels_on_host_reproduce_the_golden_pins(host):
    """The pinned golden vectors that the kernels compute (one CMUX step
    each level, the trace, both NTTs and inverses), through the host build:
    what chip_smoke.py holds on the card."""
    from tfhe_omr_tpu_torch.utils import golden

    ctx = _ctx("default")
    got = golden.through_kernels(ctx, golden.golden_inputs(ctx))
    pinned = golden.load()
    assert set(got) == set(golden.KERNEL_PINS)
    for name, kernel in golden.KERNEL_PINS.items():
        assert build.LAUNCHES[kernel] >= 1, kernel
        assert np.array_equal(got[name], pinned[name]), name


def test_stage_clocks_on_the_plain_path_raise():
    """A CPU tensor runs the plain version, which has no clocks to give."""
    ctx = _ctx("tiny")
    f, ntt, g = ctx.f1, ctx.ntt1, ctx.gadget_br1
    bsk = torch.zeros((3, ntt.n, g.d, 2, 2), dtype=torch.int64)
    key = fused.BlindRotateKey(bsk, bsk, ntt, g, "blind_rotate1")
    with pytest.raises(ValueError, match="plain path has none"):
        fused.blind_rotate(torch.zeros((1, 2, ntt.n), dtype=torch.int64),
                           torch.zeros((2, 1), dtype=torch.int64), key,
                           stage_clocks=torch.zeros((1, len(fused.BR_STAGES)),
                                                    dtype=torch.int64))
