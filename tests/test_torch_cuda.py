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
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
from tfhe_omr_tpu_torch.core.params import LweParams, OmrParameters, RetrievalParams
from tfhe_omr_tpu_torch.core.payload import random_payloads
from tfhe_omr_tpu_torch.core.sender import ClueBatch
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
@pytest.mark.parametrize("m", [1, 3, 5, 9, 33])
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_blind_rotate_kernel_matches_plain(cuda, preset, level, m):
    key, acc, amounts = _blind_rotate_case(cuda, preset, level, m)
    amounts[:, 0] = 0
    if m > 1:
        amounts[:, 1] = 2 * key.ntt.n - 1
    before = build.LAUNCHES[key.name]
    got = blind_rotate(acc, amounts, key)
    assert build.LAUNCHES[key.name] == before + 1
    assert torch.equal(got, blind_rotate_plain(acc, amounts, key))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_blind_rotate_kernel_extreme_amounts(cuda, preset, level):
    """Every rotation 0 or 2N - 1 (their sum wraps past 2N: the kernel
    masks where the plain version takes ``% 2N``), extreme coefficients."""
    key, acc, amounts = _blind_rotate_case(cuda, preset, level, 6)
    two_n = 2 * key.ntt.n
    amounts[:] = torch.where(amounts % 2 == 0, 0, two_n - 1)
    amounts[:, 0] = two_n - 1
    amounts[:, 1] = 0
    acc[2] = key.ntt.field.q - 1
    acc[3] = 0
    assert torch.equal(blind_rotate(acc, amounts, key),
                       blind_rotate_plain(acc, amounts, key))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_blind_rotate_layout_matches_library(cuda, preset, level):
    """The key is laid out by the constants the library reports for its
    instantiation, in its word, and round-trips to the reference layout."""
    key, _acc, _amounts = _blind_rotate_case(cuda, preset, level, 1)
    ntt, g, lay = key.ntt, key.gadget, key.layout
    assert lay.word_bits == (32 if level == 1 else 64) and g.d % lay.dj == 0
    assert key.keys[0].dtype == lay.dtype
    assert key.keys[0].shape == (key.n_steps, g.d // lay.dj, 3, lay.dj, 2, 2, ntt.n)
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
    assert key.keys[0].shape == (len(ctx.trace_autos), g.d, 2, ctx.params.n2)
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
    assert all(build.LAUNCHES[k] > 0 for k in
               ("blind_rotate1", "blind_rotate2", "trace", "ntt2"))
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


@pytest.mark.parametrize("preset,total,chunk", [("tiny", 40, 16),
                                                ("default", 300, 128)])
def test_encoders_kernel_match_plain(cuda, preset, total, chunk):
    """Both digest encoders through the q2 NTT kernel equal plain=True on a
    random pertinency stack on the card (a ragged tail included)."""
    params = getattr(OmrParameters, preset)()
    ctx = OmrContext(params, cuda)
    detector = SecretKeyPack(params, rng=3, ctx=ctx).generate_detector()
    rp = RetrievalParams.for_params(params, total, min(total, 50))
    gen = torch.Generator(device=cuda).manual_seed(4)
    pert = _uniform(gen, params.q2, (total, 2, params.n2))
    payloads = random_payloads(np.random.default_rng(5), total, rp.payload_length)
    before = build.LAUNCHES["ntt2"]
    idx = detector.encode_pertinent_indices(rp, pert, np.random.default_rng(6),
                                            chunk=chunk)
    pay = detector.encode_pertinent_payloads(rp, pert, payloads, 7, chunk=chunk)
    n_chunks = -(-total // chunk)
    assert build.LAUNCHES["ntt2"] == before + n_chunks * (1 + rp.cmb_cipher_count)
    assert torch.equal(idx, detector.encode_pertinent_indices(
        rp, pert, np.random.default_rng(6), chunk=chunk, plain=True))
    assert torch.equal(pay, detector.encode_pertinent_payloads(
        rp, pert, payloads, 7, chunk=chunk, plain=True))


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
    on another card holds the kernels' key layout, copied as it lies."""
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
    assert build.LAUNCHES["blind_rotate2"] == sharded.n_dev
    assert torch.equal(got, single)
    rp = RetrievalParams.for_params(params, 11, 4)
    payloads = random_payloads(np.random.default_rng(5), 11, rp.payload_length)
    assert torch.equal(
        sharded.encode_pertinent_indices(rp, got, np.random.default_rng(6), chunk=4),
        detector.encode_pertinent_indices(rp, single, np.random.default_rng(6), chunk=4))
    assert torch.equal(
        sharded.encode_pertinent_payloads(rp, got, payloads, 7, chunk=4),
        detector.encode_pertinent_payloads(rp, single, payloads, 7, chunk=4))


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
