"""Each CUDA kernel of the port against its plain torch version, on a card.

Marked ``cuda``; each test skips (inside the ``cuda`` fixture) where no card
is present. Imports no jax, so on a machine with a card and no jax run it
without this suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Every comparison is exact. Inputs come from a seeded torch.Generator.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.detector import draw_index_buckets, payload_weights
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
from tfhe_omr_tpu_torch.core.params import LweParams, OmrParameters, RetrievalParams
from tfhe_omr_tpu_torch.core.payload import random_payloads
from tfhe_omr_tpu_torch.core.sender import ClueBatch
from tfhe_omr_tpu_torch.ops import encode
from tfhe_omr_tpu_torch.ops.bootstrap import init_accumulator
from tfhe_omr_tpu_torch.ops.fused import (
    BlindRotateKey,
    TraceKey,
    blind_rotate,
    blind_rotate_plain,
    br_layout,
    tr_layout,
    trace,
    trace_plain,
)
from tfhe_omr_tpu_torch.ops.ntt import Ntt
from tfhe_omr_tpu_torch.utils import build

from fused_helpers import cluster_of

pytestmark = pytest.mark.cuda

PRESETS = ["default", "tiny"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _ctx(preset, device, **overrides):
    params = getattr(OmrParameters, preset)()
    if overrides:
        params = replace(params, **overrides)
    return OmrContext(params, device)


def _uniform(gen, q, shape):
    return torch.randint(0, q, shape, generator=gen, device=gen.device)


# a row alone, one group of the first level's blocks half full, a count
# that fills no whole number of groups, and more rows than blocks stay
# resident (a block then walks over several)
@pytest.mark.parametrize("rows", [1, 2, 37, 2048])
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_ntt_kernel_matches_plain(cuda, preset, level, rows):
    ctx = _ctx(preset, cuda)
    ntt = ctx.ntt1 if level == 1 else ctx.ntt2
    gen = torch.Generator(device=cuda).manual_seed(level)
    x = _uniform(gen, ntt.field.q, (rows, ntt.n))
    x[0, :3] = torch.tensor([0, ntt.field.q - 1, 1], device=cuda)
    before = build.LAUNCHES[ntt.name]
    fwd = ntt.fwd_last(x)
    assert torch.equal(fwd, ntt.fwd_last_plain(x))
    assert torch.equal(ntt.inv_last(x), ntt.inv_last_plain(x))
    assert torch.equal(ntt.inv_last(fwd), x)
    assert build.LAUNCHES[ntt.name] == before + 3


def test_ntt_kernel_takes_any_leading_shape_and_alignment(cuda):
    """(..., N) inputs, and a view that starts 8 bytes off a 16-byte line."""
    ntt = _ctx("tiny", cuda).ntt2
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = _uniform(gen, ntt.field.q, (5, 2, ntt.n))
    assert torch.equal(ntt.fwd_last(x), ntt.fwd_last_plain(x))
    flat = _uniform(gen, ntt.field.q, (3 * ntt.n + 1,))
    off = flat[1:].view(3, ntt.n)
    assert off.data_ptr() % 16 == 8
    assert torch.equal(ntt.inv_last(off), ntt.inv_last_plain(off))


def _blind_rotate_case(cuda, preset, level, m, n_lwe=12):
    ctx = _ctx(preset, cuda)
    f, ntt, g = (ctx.f1, ctx.ntt1, ctx.gadget_br1) if level == 1 else (
        ctx.f2, ctx.ntt2, ctx.gadget_br2)
    lut = ctx.lut1_ext if level == 1 else ctx.lut2_ext
    gen = torch.Generator(device=cuda).manual_seed(10 + level)
    bsk = _uniform(gen, f.q, (3 * n_lwe // 2, ntt.n, g.d, 2, 2))
    key = BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, f"blind_rotate{level}")
    b = _uniform(gen, 2 * ntt.n, (m,))
    amounts = _uniform(gen, 2 * ntt.n, (n_lwe, m))
    acc = init_accumulator(torch.as_tensor(lut, device=cuda), b, ntt.n)
    acc = acc.permute(2, 1, 0).contiguous()
    acc[:, 0] = _uniform(gen, f.q, (m, ntt.n))
    return key, acc, amounts


# ragged batches: 1, S - 1, S + 1 for the first level's S = 4 samples per
# block, a size that fills no whole number of blocks at either level, and 33
# (the second level's small batches run on clusters: one launch of either)
@pytest.mark.parametrize("m", [1, 3, 5, 9, 33])
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_blind_rotate_kernel_matches_plain(cuda, preset, level, m):
    key, acc, amounts = _blind_rotate_case(cuda, preset, level, m)
    amounts[:, 0] = 0
    if m > 1:
        amounts[:, 1] = 2 * key.ntt.n - 1
    counters = (key.name, f"{key.name}_cluster")
    before = sum(build.LAUNCHES[c] for c in counters)
    got = blind_rotate(acc, amounts, key)
    assert sum(build.LAUNCHES[c] for c in counters) == before + 1
    assert torch.equal(got, blind_rotate_plain(acc, amounts, key))


# the second level on an emptier card: every C the reference d = 6 takes
# (on an H100 SXM, which holds 17 clusters of 6, 39 of 3 and 66 of 2 at
# once: 6 up to 17 samples, 3 up to 39, 2 up to 66) and the one-block
# kernel from 67 on; the tiny d = 7 takes 7 up to 18 samples. On either
# H100 (114 or 132 SMs) the reference runs clusters up to 45 samples at
# least and the tiny preset up to 7
@pytest.mark.parametrize("m", [1, 2, 7, 22, 23, 44, 45, 67])
@pytest.mark.parametrize("preset", PRESETS)
def test_blind_rotate_cluster_kernel_matches_plain_and_one_block(cuda, preset, m):
    key, acc, amounts = _blind_rotate_case(cuda, preset, 2, m)
    amounts[:, 0] = 2 * key.ntt.n - 1
    acc[0, 1] = key.ntt.field.q - 1
    cluster = m <= (45 if preset == "default" else 7)
    build.reset_launches()
    got = blind_rotate(acc, amounts, key)
    assert dict(build.LAUNCHES) == (
        {"blind_rotate2_cluster": 1} if cluster else {"blind_rotate2": 1})
    assert torch.equal(got, blind_rotate_plain(acc, amounts, key))
    with cluster_of(1):
        assert torch.equal(got, blind_rotate(acc, amounts, key))
    assert build.LAUNCHES["blind_rotate2"] == 1 + (not cluster)


# a sample a key: clusters of one key's sample each, under that key
@pytest.mark.parametrize("recipients", [1, 2, 4])
@pytest.mark.parametrize("preset", PRESETS)
def test_blind_rotate_cluster_kernel_per_recipient_keys(cuda, preset, recipients):
    ctx = _ctx(preset, cuda)
    f, ntt, g = ctx.f2, ctx.ntt2, ctx.gadget_br2
    n_lwe = 4
    gen = torch.Generator(device=cuda).manual_seed(70 + recipients)
    keys = []
    for _ in range(recipients):
        bsk = _uniform(gen, f.q, (3 * n_lwe // 2, ntt.n, g.d, 2, 2))
        keys.append(BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, "blind_rotate2"))
    stack = _stack(keys)
    acc = _uniform(gen, f.q, (recipients, 2, ntt.n))
    amounts = _uniform(gen, 2 * ntt.n, (n_lwe, recipients))
    build.reset_launches()
    got = blind_rotate(acc, amounts, stack)
    assert dict(build.LAUNCHES) == {"blind_rotate2_cluster": 1}
    want = torch.cat([blind_rotate_plain(acc[r:r + 1], amounts[:, r:r + 1], keys[r])
                      for r in range(recipients)])
    assert torch.equal(got, want)
    with cluster_of(1):
        assert torch.equal(got, blind_rotate(acc, amounts, stack))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_blind_rotate_kernel_extreme_amounts(cuda, preset, level):
    """Every rotation 0 or 2N - 1 (their sum wraps past 2N: the kernel
    masks where the plain version takes ``% 2N``), extreme coefficients;
    at the second level through the cluster variant and the one-block
    kernel both."""
    key, acc, amounts = _blind_rotate_case(cuda, preset, level, 6)
    two_n = 2 * key.ntt.n
    amounts[:] = torch.where(amounts % 2 == 0, 0, two_n - 1)
    amounts[:, 0] = two_n - 1
    amounts[:, 1] = 0
    acc[2] = key.ntt.field.q - 1
    acc[3] = 0
    plain = blind_rotate_plain(acc, amounts, key)
    assert torch.equal(blind_rotate(acc, amounts, key), plain)
    build.reset_launches()
    with cluster_of(1):
        assert torch.equal(blind_rotate(acc, amounts, key), plain)
    assert dict(build.LAUNCHES) == {key.name: 1}


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_blind_rotate_layout_matches_library(cuda, preset, level):
    """The key is laid out by the constants the library reports for its
    instantiation, in its word, and round-trips to the reference layout."""
    key, _acc, _amounts = _blind_rotate_case(cuda, preset, level, 1)
    ntt, g, lay = key.ntt, key.gadget, key.layout
    assert lay.word_bits == (32 if level == 1 else 64) and g.d % lay.dj == 0
    assert key.keys[0].dtype == lay.dtype
    # a stack of one recipient's key
    assert key.keys[0].shape == (1, key.n_steps, g.d // lay.dj, 3, lay.dj, 2, 2, ntt.n)
    assert (key.tw_fwd.numel(), key.tw_inv.numel()) == (2 * lay.tw_fwd, 2 * lay.tw_inv)
    bsk, bsk_sh = key.reference()
    assert bsk.dtype == torch.int64 and torch.equal(bsk_sh, ntt.field.shoup_t(bsk))


@pytest.mark.parametrize("kernel", ["blind_rotate", "trace", "ntt"])
def test_no_layout_for_other_parameters(cuda, kernel):
    """A ring, field or gadget with no instantiation raises, naming the
    parameters; nothing falls back to the plain version."""
    ctx = _ctx("tiny", cuda)
    other = Ntt(ctx.f1, 128, cuda)
    if kernel == "blind_rotate":
        with pytest.raises(ValueError, match="no blind-rotation kernel"):
            br_layout(other, ctx.gadget_br1)
    elif kernel == "trace":
        with pytest.raises(ValueError, match="no trace kernel"):
            tr_layout(other, ctx.gadget_trace)
        tk = torch.zeros((1, 128, ctx.gadget_trace.d, 2), dtype=torch.int64, device=cuda)
        with pytest.raises(ValueError, match=r"no trace kernel.*\(7, "):
            TraceKey(tk, tk, other, ctx.gadget_trace, ctx.trace_autos[:1])
    else:
        x = torch.zeros((2, 128), dtype=torch.int64, device=cuda)
        with pytest.raises(ValueError, match=r"no NTT kernel.*\(7, "):
            other.fwd_last(x)


# 1, 2, 3: around a block of two messages; 5 and 33 fill no whole number of
# blocks. One round alone, and all of them: from the second round on, acc_b
# is gathered from what the round before wrote.
@pytest.mark.parametrize("rounds", ["one", "all"])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 33])
@pytest.mark.parametrize("preset", PRESETS)
def test_trace_kernel_matches_plain(cuda, preset, m, rounds):
    ctx = _ctx(preset, cuda)
    f = ctx.f2
    autos = ctx.trace_autos[:1] if rounds == "one" else ctx.trace_autos
    gen = torch.Generator(device=cuda).manual_seed(5)
    tk = _uniform(gen, f.q, (len(autos), ctx.params.n2, ctx.gadget_trace.d, 2))
    key = TraceKey(tk, f.shoup_t(tk), ctx.ntt2, ctx.gadget_trace, autos)
    acc = _uniform(gen, f.q, (m, 2, ctx.params.n2))
    acc[0, :, :3] = torch.tensor([0, f.q - 1, 1], device=cuda)
    before = build.LAUNCHES[key.name]
    got = trace(acc, key)
    assert build.LAUNCHES[key.name] == before + 1
    assert torch.equal(got, trace_plain(acc, key))


def _stack(keys):
    stack = keys[0].empty_stack(len(keys))
    for r, key in enumerate(keys):
        stack.put(r, key)
    return stack


# per-recipient keys: R recipients' runs of ``per`` samples in one launch,
# each run's last block of the first level masked as a ragged batch's
@pytest.mark.parametrize("per", [1, 7])
@pytest.mark.parametrize("recipients", [1, 2, 3])
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_blind_rotate_kernel_per_recipient_keys(cuda, preset, level, recipients, per):
    ctx = _ctx(preset, cuda)
    f, ntt, g = (ctx.f1, ctx.ntt1, ctx.gadget_br1) if level == 1 else (
        ctx.f2, ctx.ntt2, ctx.gadget_br2)
    n_lwe, m = 4, recipients * per
    gen = torch.Generator(device=cuda).manual_seed(20 + level + recipients)
    keys = []
    for _ in range(recipients):
        bsk = _uniform(gen, f.q, (3 * n_lwe // 2, ntt.n, g.d, 2, 2))
        keys.append(BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, f"blind_rotate{level}"))
    stack = _stack(keys)
    acc = _uniform(gen, f.q, (m, 2, ntt.n))
    amounts = _uniform(gen, 2 * ntt.n, (n_lwe, m))
    amounts[:, 0] = 2 * ntt.n - 1
    counters = (stack.name, f"{stack.name}_cluster")
    before = sum(build.LAUNCHES[c] for c in counters)
    got = blind_rotate(acc, amounts, stack)
    assert sum(build.LAUNCHES[c] for c in counters) == before + 1
    want = torch.cat([blind_rotate(acc[r * per:(r + 1) * per],
                                   amounts[:, r * per:(r + 1) * per], keys[r])
                      for r in range(recipients)])
    assert torch.equal(got, want)
    assert torch.equal(got, blind_rotate_plain(acc, amounts, stack))


@pytest.mark.parametrize("per", [1, 2])
@pytest.mark.parametrize("recipients", [1, 2, 3])
@pytest.mark.parametrize("preset", PRESETS)
def test_trace_kernel_per_recipient_keys(cuda, preset, recipients, per):
    ctx = _ctx(preset, cuda)
    f, g = ctx.f2, ctx.gadget_trace
    gen = torch.Generator(device=cuda).manual_seed(30 + recipients)
    keys = []
    for _ in range(recipients):
        tk = _uniform(gen, f.q, (len(ctx.trace_autos), ctx.params.n2, g.d, 2))
        keys.append(TraceKey(tk, f.shoup_t(tk), ctx.ntt2, g, ctx.trace_autos))
    stack = _stack(keys)
    acc = _uniform(gen, f.q, (recipients * per, 2, ctx.params.n2))
    got = trace(acc, stack)
    assert torch.equal(got, torch.cat([trace(acc[r * per:(r + 1) * per], keys[r])
                                       for r in range(recipients)]))
    assert torch.equal(got, trace_plain(acc, stack))


@pytest.mark.parametrize("recipients", [1, 3, 96])
def test_encode_kernels_over_recipients(cuda, recipients):
    ctx = _ctx("default", cuda)
    f, n = ctx.f2, ctx.params.n2
    rp = RetrievalParams.for_params(ctx.params, 1, 1)
    gen = torch.Generator(device=cuda).manual_seed(50 + recipients)
    rows, kct = 1, rp.cmb_cipher_count
    pert = _uniform(gen, f.q, (recipients, rows, 2, n))
    pn = _uniform(gen, f.q, (recipients, kct, rows, n))
    acc = _uniform(gen, f.q, (recipients, kct, 2, n))
    got = encode.encode_mac(f, pert, pn, acc)
    assert torch.equal(got, encode.encode_mac(f, pert, pn, acc, plain=True))
    args = (rp.index_slots_per_bucket, rp.polynomial_size, rp.index_modulus, ctx.params.q2)
    base = torch.as_tensor(draw_index_buckets(rp, recipients * kct * rows,
                                              np.random.default_rng(recipients)), device=cuda)
    assert torch.equal(encode.index_plaintexts(base, 0, *args, period=rows),
                       encode.index_plaintexts(base, 0, *args, plain=True, period=rows))


def test_recipients_detector_on_card_matches_each_detector(cuda):
    """Three recipients at the tiny preset: one detect and both encoders on
    the card equal each recipient's own Detector and the plain path."""
    from tfhe_omr_tpu_torch.core.detector import Detector, RecipientsDetector

    params = OmrParameters.tiny()
    ctx = OmrContext(params, cuda)
    packs = [SecretKeyPack(params, rng=60 + r, ctx=ctx) for r in range(3)]
    keys = [p.generate_detection_key() for p in packs]
    det = RecipientsDetector(iter(keys), ctx, recipients=3)
    clues = ClueBatch.concat([SecretKeyPack(params, rng=70, ctx=ctx).generate_sender()
                              .gen_clues(2, np.random.default_rng(1))])
    pv = det.detect(clues)
    for r, key in enumerate(keys):
        assert torch.equal(pv[r], Detector(key, ctx).detect(clues))
    assert torch.equal(pv, det.detect(clues, plain=True))
    rp = RetrievalParams.for_params(params, 2, 1)
    payloads = random_payloads(np.random.default_rng(2), 2, rp.payload_length)
    idx = det.encode_pertinent_indices(rp, pv, np.random.default_rng(3))
    assert torch.equal(idx, det.encode_pertinent_indices(rp, pv, np.random.default_rng(3),
                                                         plain=True))
    pay = det.encode_pertinent_payloads(rp, pv, payloads, 4)
    assert torch.equal(pay, det.encode_pertinent_payloads(rp, pv, payloads, 4, plain=True))


@pytest.mark.parametrize("preset", PRESETS)
def test_trace_key_on_card_holds_one_tensor(cuda, preset):
    """On a card the trace key is the kernel's layout alone, without
    companions, and gives the reference pair back."""
    ctx = _ctx(preset, cuda)
    f, g = ctx.f2, ctx.gadget_trace
    gen = torch.Generator(device=cuda).manual_seed(6)
    tk = _uniform(gen, f.q, (len(ctx.trace_autos), ctx.params.n2, g.d, 2))
    key = TraceKey(tk, f.shoup_t(tk), ctx.ntt2, g, ctx.trace_autos)
    assert len(key.keys) == 1 and key.nbytes() == tk.numel() * 8
    # a stack of one recipient's key
    assert key.keys[0].shape == (1, len(ctx.trace_autos), g.d, 2, ctx.params.n2)
    lay = key.layout
    assert (key.tw_fwd.numel(), key.tw_inv.numel()) == (2 * lay.tw_fwd, 2 * lay.tw_inv)
    ref, ref_sh = key.reference()
    assert torch.equal(ref, tk) and torch.equal(ref_sh, f.shoup_t(tk))


def test_detect_kernels_match_plain_and_pass_omd(cuda):
    """Keygen on the card, detect through every kernel, plain detect on the
    card, decrypt: equal outputs and the omd oracle."""
    params = OmrParameters.tiny()
    ctx = OmrContext(params, cuda)
    skp = SecretKeyPack(params, rng=7, ctx=ctx)
    skp2 = SecretKeyPack(params, rng=8, ctx=ctx)
    sender, sender2 = skp.generate_sender(), skp2.generate_sender()
    detector = skp.generate_detector()
    rng = np.random.default_rng(9)
    clues = ClueBatch.concat([sender.gen_clues(3, rng), sender2.gen_clues(5, rng)])
    build.reset_launches()
    out = detector.detect(clues)
    # 8 messages: the second level on clusters (ops/fused.py cluster_size)
    assert all(build.LAUNCHES[k] > 0 for k in
               ("blind_rotate1", "blind_rotate2_cluster", "trace", "ntt2"))
    assert torch.equal(out, detector.detect(clues, plain=True))
    q, t = params.q2, params.output_plain_modulus
    dec = skp.decrypt_rlwe2_ntt(out)
    decoded = np.mod((dec * (2 * t) + q) // (2 * q), t)
    assert (decoded[:3, 0] == 1).all() and not decoded[:3, 1:].any()
    assert not decoded[3:].any()


def test_default_ring_detect_kernels_match_plain(cuda):
    """The whole kernel path at the default rings with reduced LWE
    dimensions (16 L1 and 8 L2 steps)."""
    params = replace(
        OmrParameters.default(),
        clue_params=LweParams(32, 8, 2048, "binary", 0.8293),
        first_level_ks=replace(OmrParameters.default().first_level_ks, out_dimension=16),
        intermediate_lwe=LweParams(16, 32, 4096, "binary", 10.3260),
    )
    ctx = OmrContext(params, cuda)
    skp = SecretKeyPack(params, rng=1, ctx=ctx)
    detector = skp.generate_detector()
    clues = skp.generate_sender().gen_clues(6, np.random.default_rng(2))
    assert torch.equal(detector.detect(clues), detector.detect(clues, plain=True))


def test_detect_takes_the_cluster_path_only_on_an_empty_card(cuda):
    """At the default rings (reduced LWE dimensions): a one-message detect
    runs K2 on a cluster, once, and never the one-block kernel; a detect of
    1024 the reverse. Both equal the plain detect."""
    params = replace(
        OmrParameters.default(),
        clue_params=LweParams(32, 8, 2048, "binary", 0.8293),
        first_level_ks=replace(OmrParameters.default().first_level_ks, out_dimension=16),
        intermediate_lwe=LweParams(16, 32, 4096, "binary", 10.3260),
    )
    ctx = OmrContext(params, cuda)
    skp = SecretKeyPack(params, rng=3, ctx=ctx)
    detector = skp.generate_detector()
    clues = skp.generate_sender().gen_clues(1024, np.random.default_rng(4))
    one = ClueBatch(clues.a[:1], clues.b7[:1])
    for batch, path, other in ((one, "blind_rotate2_cluster", "blind_rotate2"),
                               (clues, "blind_rotate2", "blind_rotate2_cluster")):
        build.reset_launches()
        got = detector.detect(batch)
        assert build.LAUNCHES[path] == 1 and build.LAUNCHES[other] == 0
        assert build.LAUNCHES["blind_rotate1"] == 1
        sub = ClueBatch(batch.a[:8], batch.b7[:8])
        assert torch.equal(got[:8], detector.detect(sub, plain=True))


@pytest.mark.parametrize("preset,total,chunk", [("tiny", 40, 16),
                                                ("default", 300, 128)])
def test_encoders_kernel_match_plain(cuda, preset, total, chunk):
    """Both digest encoders through their kernels (plaintext build, the q2
    NTT, encode_mac: one launch of each a chunk, whatever the number of
    digests) equal plain=True on a random pertinency stack on the card (a
    ragged tail included)."""
    params = getattr(OmrParameters, preset)()
    ctx = OmrContext(params, cuda)
    detector = SecretKeyPack(params, rng=3, ctx=ctx).generate_detector()
    rp = RetrievalParams.for_params(params, total, min(total, 50))
    gen = torch.Generator(device=cuda).manual_seed(4)
    pert = _uniform(gen, params.q2, (total, 2, params.n2))
    payloads = random_payloads(np.random.default_rng(5), total, rp.payload_length)
    n_chunks = -(-total // chunk)
    names = ("ntt2", "encode_mac", "encode_index_plain", "encode_payload_plain")
    before = {c: build.LAUNCHES[c] for c in names}
    idx = detector.encode_pertinent_indices(rp, pert, np.random.default_rng(6),
                                            chunk=chunk)
    assert [build.LAUNCHES[c] - before[c] for c in names] == [n_chunks] * 3 + [0]
    pay = detector.encode_pertinent_payloads(rp, pert, payloads, 7, chunk=chunk)
    assert [build.LAUNCHES[c] - before[c] for c in names] == [2 * n_chunks] * 2 + [n_chunks] * 2
    assert torch.equal(idx, detector.encode_pertinent_indices(
        rp, pert, np.random.default_rng(6), chunk=chunk, plain=True))
    assert torch.equal(pay, detector.encode_pertinent_payloads(
        rp, pert, payloads, 7, chunk=chunk, plain=True))


def test_encode_kernels_match_plain_at_the_main_path_shape(cuda):
    """A payload chunk of the reference ring, 2048 rows of 28 digests at N2
    = 2048, and an index chunk (one digest) of the same rows: encode_mac
    and both plaintext builds equal their plain versions."""
    ctx = _ctx("default", cuda)
    f, n, rows = ctx.f2, ctx.params.n2, 2048
    rp = RetrievalParams.for_params(ctx.params, 4096, 50)
    gen = torch.Generator(device=cuda).manual_seed(12)
    pert = _uniform(gen, f.q, (rows, 2, n))
    for kct in (rp.cmb_cipher_count, 1):
        pn = _uniform(gen, f.q, (kct, rows, n))
        acc = _uniform(gen, f.q, (kct, 2, n))
        before = build.LAUNCHES["encode_mac"]
        got = encode.encode_mac(f, pert, pn, acc)
        assert build.LAUNCHES["encode_mac"] == before + 1
        assert torch.equal(got, encode.encode_mac_plain(f, pert, pn, acc)), kct
        del pn
    args = (rp.polynomial_size, rp.index_modulus, f.q)
    weights = torch.as_tensor(payload_weights(rp, 13, 4096), device=cuda)[:, :, rows:]
    payloads = torch.randint(0, 256, (rows, rp.payload_length), generator=gen, device=cuda)
    assert torch.equal(encode.payload_plaintexts(payloads, weights, *args),
                       encode.payload_plaintexts(payloads, weights, *args, plain=True))
    base = torch.as_tensor(draw_index_buckets(rp, 4096, np.random.default_rng(14)),
                           device=cuda)[rows:].contiguous()
    nd = rp.index_slots_per_bucket
    assert torch.equal(encode.index_plaintexts(base, rows, nd, *args),
                       encode.index_plaintexts(base, rows, nd, *args, plain=True))


def test_retriever_decrypt_kernel_matches_plain(cuda):
    params = OmrParameters.default()
    skp = SecretKeyPack(params, rng=8, ctx=OmrContext(params, cuda))
    retriever = skp.generate_retriever(65536, 50)
    gen = torch.Generator(device=cuda).manual_seed(9)
    for shape in ((2, params.n2), (retriever.params.cmb_cipher_count, 2, params.n2)):
        ct = _uniform(gen, params.q2, shape)
        before = build.LAUNCHES["ntt2"]
        got = retriever.decrypt(ct)
        assert build.LAUNCHES["ntt2"] == before + 1
        assert np.array_equal(got, retriever.decrypt(ct, plain=True))


def test_device_clues_decrypt_to_zero_on_card(cuda):
    params = OmrParameters.default()
    ctx = OmrContext(params, cuda)
    skp = SecretKeyPack(params, rng=10, ctx=ctx)
    clues = skp.generate_sender().gen_clues_device(64, seed=11)
    for i in range(64):
        assert not skp.decrypt_compact_clue(clues.a[i], clues.b7[i]).any(), i


@pytest.mark.parametrize("preset", PRESETS)
def test_kernels_launch_on_their_tensors_card_whatever_is_current(cuda, preset):
    """K1-K5 == plain with every tensor on the LAST visible card while the
    current device stays 0: the wrappers select the tensors' card for the
    launch (kernel attributes, occupancy and the launch itself go to the
    calling thread's current card otherwise). On a machine with one card the
    last card is card 0, the guard is a no-op and the test still passes."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    ctx = _ctx(preset, last)
    gen = torch.Generator(device=last).manual_seed(21)
    for ntt in (ctx.ntt1, ctx.ntt2):  # K5, K4
        x = _uniform(gen, ntt.field.q, (37, ntt.n))
        assert x.device == last
        assert torch.equal(ntt.fwd_last(x), ntt.fwd_last_plain(x))
        assert torch.equal(ntt.inv_last(x), ntt.inv_last_plain(x))
    for level in (1, 2):  # K1, K2
        key, acc, amounts = _blind_rotate_case(last, preset, level, 5)
        got = blind_rotate(acc, amounts, key)
        assert got.device == last
        assert torch.equal(got, blind_rotate_plain(acc, amounts, key))
    f = ctx.f2  # K3
    tk = _uniform(gen, f.q, (len(ctx.trace_autos), ctx.params.n2, ctx.gadget_trace.d, 2))
    key = TraceKey(tk, f.shoup_t(tk), ctx.ntt2, ctx.gadget_trace, ctx.trace_autos)
    acc = _uniform(gen, f.q, (3, 2, ctx.params.n2))
    assert torch.equal(trace(acc, key), trace_plain(acc, key))
    assert torch.cuda.current_device() == 0


def test_sharded_detector_on_the_cards_matches_single(cuda):
    """Detect (ragged) and both digests through a ShardedDetector over every
    visible card plus card 0 once more (so that a one-card machine still
    splits the batch over two shards) equal the single Detector's; a replica
    on another card holds the kernels' key layout, copied as it lies, and
    each shard's rows stay on its replica's card."""
    from tfhe_omr_tpu_torch.parallel import ShardedDetector, make_data_mesh

    params = OmrParameters.tiny()
    skp = SecretKeyPack(params, rng=7, ctx=OmrContext(params, cuda))
    detector = skp.generate_detector()
    clues = skp.generate_sender().gen_clues(11, np.random.default_rng(9))
    devices = [*make_data_mesh().devices, torch.device("cuda", 0)]
    sharded = ShardedDetector(detector, make_data_mesh(devices))
    assert sharded.n_dev == torch.cuda.device_count() + 1
    for rep in sharded.replicas:
        assert rep.br1.on_card and rep.detect_key_size() == detector.detect_key_size()
    single = detector.detect(clues)
    build.reset_launches()
    got = sharded.detect(clues)
    # shards of at most 6 messages: the second level on clusters
    assert build.LAUNCHES["blind_rotate2_cluster"] == sharded.n_dev
    assert build.LAUNCHES["blind_rotate2"] == 0
    assert [p.device for p in got.parts] == [rep.device for rep in sharded.replicas]
    np.testing.assert_array_equal(sharded.gather(got), single.cpu().numpy())
    rp = RetrievalParams.for_params(params, 11, 4)
    payloads = random_payloads(np.random.default_rng(5), 11, rp.payload_length)
    assert torch.equal(
        sharded.encode_pertinent_indices(rp, got, np.random.default_rng(6), chunk=4),
        detector.encode_pertinent_indices(rp, single, np.random.default_rng(6), chunk=4))
    assert torch.equal(
        sharded.encode_pertinent_payloads(rp, got, payloads, 7, chunk=4),
        detector.encode_pertinent_payloads(rp, single, payloads, 7, chunk=4))


@pytest.mark.parametrize("streams", [1, 4, 16])
def test_probe_chain_and_mac_kernels_match_plain(cuda, streams):
    """C1 for every op and type, C2; the chains at 70 iterations (one 64-step
    turn of C1's unrolled loop and some of its rest; the float32 FMA chain
    has overflowed to +inf by then, so it also runs 5, where at S = 16 a
    4-step turn of the loop runs at finite values)."""
    from tfhe_omr_tpu_torch.ops import probes

    gen = torch.Generator(device=cuda).manual_seed(streams)
    x = torch.randint(1, 1 << 20, (64, 513), generator=gen, device=cuda, dtype=torch.int32)
    y = torch.randint(1, 1 << 10, (64, 513), generator=gen, device=cuda, dtype=torch.int32)
    xf = torch.rand((64, 513), generator=gen, device=cuda) * 0.5 + 0.5
    yf = torch.rand((64, 513), generator=gen, device=cuda) * 0.2 + 0.9
    cases = [(x, y, op, 70) for op in probes.CHAIN_DTYPES[torch.int32]]
    cases += [(x.long(), y.long(), "mul_add", 70), (xf, yf, "fma", 70), (xf, yf, "fma", 5)]
    for a, b, op, iters in cases:
        got = probes.probe_chain(a, b, op, iters, streams)
        assert torch.equal(got, probes.probe_chain_plain(a, b, op, iters, streams)), op
    assert torch.equal(probes.probe_mac(x, y, 9, streams),
                       probes.probe_mac_plain(x, y, 9, streams))


@pytest.mark.parametrize("shape,rounds", [
    ((1, 2048, 2048, 256), 1), ((1, 128, 12, 256), 3), ((2048, 48, 12, 128), 2),
    ((256, 384, 96, 128), 2), ((128, 768, 192, 128), 1), ((1, 20, 200, 72), 2),
    ((1, 384, 768, 128), 8192),  # positive operands: every int32 sum wraps
    ((2, 256, 1024, 192), 5),  # 8 tiles: k split 8 ways and rounds 2, n ragged
    ((1, 100, 300, 42), 5),  # split, TMA adds into C's rows padded to 44 words
    ((200, 20, 40, 70), 1),  # 200 whole tiles, TMA stores into rows padded to 72
    ((1, 768, 192, 128), 16384),  # P7: rounds split 11 ways, 5 left over
])
def test_probe_i8dot_kernel_matches_plain(cuda, shape, rounds):
    """C3 on the tensor cores at the probes' shapes, int32 sums that wrap,
    and a product whose tiles share out their k atoms and rounds."""
    from tfhe_omr_tpu_torch.ops import probes

    g, m, k, n = shape
    lo = 64 if rounds == 8192 else -128
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    a = torch.randint(lo, 128, (g, m, k), generator=gen, device=cuda).to(torch.int8)
    b = torch.randint(lo, 128, (g, k, n), generator=gen, device=cuda).to(torch.int8)
    build.reset_launches()
    got = probes.probe_i8dot(a, b, rounds)
    assert build.LAUNCHES["probe_i8dot"] == 1
    assert torch.equal(got, probes.probe_i8dot_plain(a, b, rounds))


def test_product_slots_are_the_products_sass(cuda):
    """chip_smoke.py PRODUCT_SLOTS, the multiply slots of one Shoup and one
    lazily summed modular product in 32- and 64-bit words, are those of the
    products compiled alone (benches/probe_sass_torch.py --products) at
    utils/rates.py's costs."""
    import os
    import sys

    from tfhe_omr_tpu_torch.utils import rates

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "benches")]
    import chip_smoke
    import probe_sass_torch

    ops = probe_sass_torch.product_opcodes()
    got = {bits: (rates.imad_slots(ops[f"shoup_{field}"]), rates.imad_slots(ops[f"summed_{field}"]))
           for bits, field in ((32, 27), (64, 50))}
    assert got == chip_smoke.PRODUCT_SLOTS, ops


def test_bench_kernels_times_c3_at_the_dot_probes(cuda, capsys):
    """``examples/bench_kernels_torch.py --only c3``: C3 held against plain,
    timed and its time split at each TPU dot probe."""
    import os
    import sys

    from tfhe_omr_tpu_torch.utils import rates

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
    import bench_kernels_torch

    bench_kernels_torch.bench_c3(torch.Generator(device=cuda).manual_seed(5), 1, "gpu")
    out = capsys.readouterr().out.splitlines()
    assert sum("bit-equal to plain" in ln for ln in out) == len(rates.DOT_PROBES)
    timed = [ln for ln in out if "reached" in ln]
    assert [ln.split()[1] for ln in timed] == list(rates.DOT_PROBES)
    assert all("host" in ln and "device us a call" in ln for ln in timed)


_RANK_ON_ITS_CARD = """
import sys, torch, torch.distributed as dist
from tfhe_omr_tpu_torch.parallel import distributed, make_data_mesh
rank = int(sys.argv[2])
assert distributed.init(sys.argv[1], 2, rank) == 2
(dev,) = distributed.local_devices()
assert torch.cuda.current_device() == dev.index
mesh = make_data_mesh()
assert (mesh.rank, mesh.world, mesh.n_dev) == (rank, 2, 2), mesh
cards = torch.zeros(2, dtype=torch.int64, device=dev)
cards[rank] = dev.index + 1
dist.all_reduce(cards)  # int64 over NCCL between the two cards
print("cards", *(cards - 1).tolist())
distributed.shutdown()
"""


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: one rank a card over NCCL")


def test_two_ranks_take_two_cards_and_reduce_over_nccl(two_cards):
    """Two processes given only a coordinator and their ranks: each binds a
    card of its own, the mesh counts both, and an int64 all_reduce passes
    between the cards."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_ON_ITS_CARD, coordinator, str(rank)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0 and "cards 0 1" in log, "\n".join(logs)
