"""The host side of the blind-rotation kernels, on the CPU.

What surrounds ``csrc/blind_rotate.cu`` is plain Python and tensors: the
key layout, the word-size Shoup companions, the per-pass twiddle tables,
the digit rule, the block count for ragged batches, and the default
device of the port's entry points. All comparisons are exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.core.sender import Sender
from tfhe_omr_tpu_torch.ops import fused
from tfhe_omr_tpu_torch.ops.ntt import Ntt
from tfhe_omr_tpu_torch.utils import build
from tfhe_omr_tpu_torch.utils.timing import StageTimer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

torch.set_num_threads(1)

PRESETS = ["default", "tiny"]
_CTX = {}
# The layout constants come from the built library on a card (fused.br_layout);
# the layout functions are pure, so here they are held over a few values of
# the word size, the digits per pass and the stages per pass.
WORD_BITS = {1: 32, 2: 64}


def _level(preset, level):
    if preset not in _CTX:
        _CTX[preset] = OmrContext(getattr(OmrParameters, preset)(), "cpu")
    ctx = _CTX[preset]
    return (ctx.f1, ctx.ntt1, ctx.gadget_br1) if level == 1 else (
        ctx.f2, ctx.ntt2, ctx.gadget_br2)


@pytest.mark.parametrize("digits", ["all", "one"])
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_kernel_key_layout_round_trips(preset, level, digits):
    """Reference -> kernel layout -> reference, bit for bit, in the
    kernel's word (int32 at the first level), and the kernel layout is the
    order (step, digit pass, row, digit, in, out, slot)."""
    f, ntt, g = _level(preset, level)
    lay = fused.BrLayout(WORD_BITS[level], 1, g.d if digits == "all" else 1, 4, 0, 0)
    assert lay.dtype == (torch.int32 if level == 1 else torch.int64)
    n_steps = 3
    gen = torch.Generator().manual_seed(level)
    bsk = torch.randint(0, f.q, (3 * n_steps, ntt.n, g.d, 2, 2), generator=gen)
    k = fused.kernel_key_layout(bsk, n_steps, ntt.n, g.d, lay.dj, ntt.perm_inv,
                                lay.dtype)
    assert k.dtype == lay.dtype and k.is_contiguous()
    assert k.shape == (n_steps, g.d // lay.dj, 3, lay.dj, 2, 2, ntt.n)
    back = fused.reference_key_layout(k, ntt.perm)
    assert back.dtype == torch.int64 and torch.equal(back, bsk)
    # one entry by hand: step 1, row 2, digit j, in 1, out 0, base slot 5
    j = g.d - 1
    ref_slot = int(ntt.perm_inv[5])
    assert int(k[1, j // lay.dj, 2, j % lay.dj, 1, 0, 5]) == int(
        bsk[3 * 1 + 2, ref_slot, j, 1, 0])


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_word_shoup_companions_give_canonical_residue(preset, level):
    """Companions at the word's shift (32 / 64): the Shoup product with
    them, corrected once, is the residue ``PrimeField.mul_shoup`` gives
    with the package's own companions, for any word-sized x."""
    f, ntt, g = _level(preset, level)
    wb = WORD_BITS[level]
    rng = np.random.default_rng(level)
    w = rng.integers(0, f.q, size=64, dtype=np.int64)
    w[:3] = (0, 1, f.q - 1)
    w_sh = fused.shoup_companion(w, f.q, wb)
    assert w_sh.dtype == np.uint64 and all(int(v) < (1 << wb) for v in w_sh)
    xs = rng.integers(0, f.q, size=64, dtype=np.int64)
    xs[:2] = (0, f.q - 1)
    want = f.mul_shoup(torch.as_tensor(xs), torch.as_tensor(w),
                       torch.as_tensor(f.shoup(w))).numpy()
    for x, wi, si, expect in zip(xs, w, w_sh, want):
        for xx in (int(x), (1 << wb) - 1):  # a residue, and the largest word
            r = xx * int(wi) - ((xx * int(si)) >> wb) * f.q
            assert 0 <= r < 2 * f.q
            assert (r - f.q if r >= f.q else r) == xx * int(wi) % f.q
        assert int(expect) == int(x) * int(wi) % f.q
    # the bits survive the signed dtype torch holds them in
    words = fused.as_words(w_sh, wb)
    assert words.dtype == (np.int32 if wb == 32 else np.int64)
    assert np.array_equal(words.view(np.uint32 if wb == 32 else np.uint64), w_sh)


def _passes_forward(x, tw, q, log_n, rlog):
    """The kernel's forward passes in Python ints, reading the regrouped
    table exactly as ``fwd_pass`` indexes it."""
    n = 1 << log_n
    x = list(x)
    off = 0
    s0 = 0
    for r in fused.pass_stages(log_n, rlog):
        low = log_n - s0 - r
        for b in range(n >> r):
            lo, h = b & ((1 << low) - 1), b >> low
            base = (h << (log_n - s0)) + lo
            pts = [x[base + (i << low)] for i in range(1 << r)]
            for k in range(r):
                half = 1 << (r - 1 - k)
                for i in range(1 << r):
                    if i & half:
                        continue
                    t = ((1 << k) - 1 + (i >> (r - k))) * (1 << s0) + h
                    y = pts[i + half] * int(tw[off + t]) % q
                    u = pts[i]
                    pts[i], pts[i + half] = (u + y) % q, (u - y) % q
            for i in range(1 << r):
                x[base + (i << low)] = pts[i]
        off += ((1 << r) - 1) << s0
        s0 += r
    return x, off


def _passes_inverse(x, tw, q, log_n, rlog, n_inv):
    n = 1 << log_n
    x = list(x)
    off = 0
    g0 = 0
    for r in fused.pass_stages(log_n, rlog):
        hi = n >> (g0 + r)
        for b in range(n >> r):
            lo, h = b & ((1 << g0) - 1), b >> g0
            base = (h << (g0 + r)) + lo
            pts = [x[base + (i << g0)] for i in range(1 << r)]
            for k in range(r):
                step = 1 << k
                for i in range(1 << r):
                    if i & step:
                        continue
                    t = ((1 << r) - (1 << (r - k)) + (i >> (k + 1))) * hi + h
                    u, v = pts[i], pts[i + step]
                    s = (u + v) % q
                    if g0 + k == log_n - 1:
                        s = s * n_inv % q
                    pts[i + step] = (u - v) * int(tw[off + t]) % q
                    pts[i] = s
            for i in range(1 << r):
                x[base + (i << g0)] = pts[i]
        off += ((1 << r) - 1) * hi
        g0 += r
    return x, off


@pytest.mark.parametrize("preset,level,rlog", [
    ("tiny", 1, 3), ("tiny", 1, 4), ("tiny", 2, 3), ("tiny", 2, 4), ("tiny", 2, 5),
    ("default", 1, 5), ("default", 2, 4)])
def test_pass_twiddles_drive_the_same_transform(preset, level, rlog):
    """Passes of ``rlog`` stages over the regrouped tables compute the
    radix-2 transform of ``Ntt`` (forward into the base order, inverse
    back, 1/N included)."""
    f, ntt, g = _level(preset, level)
    x = torch.randint(0, f.q, (ntt.n,), generator=torch.Generator().manual_seed(3))
    tw_f = fused.pass_twiddles(ntt.fwd_tw.numpy(), ntt.log_n, rlog, False)
    tw_i = fused.pass_twiddles(ntt.inv_tw.numpy(), ntt.log_n, rlog, True)
    got, used = _passes_forward(x.tolist(), tw_f, f.q, ntt.log_n, rlog)
    assert used == len(tw_f)
    want = ntt._fwd_base(x[:, None], ntt.fwd_tw, ntt.fwd_tw_sh)[:, 0]
    assert got == want.tolist()
    back, used = _passes_inverse(got, tw_i, f.q, ntt.log_n, rlog, ntt.n_inv)
    assert used == len(tw_i)
    assert back == x.tolist()


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("level", [1, 2])
def test_offset_digits_equal_the_carry_chain(preset, level):
    """The kernel's digit rule: add H = sum_j (B/2) B^j to the rounded
    value, take plain base-B digits, subtract B/2. Equal to the balanced
    digits ``SignedGadget.decompose`` makes with its carry chain."""
    f, _ntt, g = _level(preset, level)
    gen = torch.Generator().manual_seed(7)
    x = torch.randint(0, f.q, (4096,), generator=gen)
    x[:4] = torch.tensor([0, 1, f.q - 1, f.q // 2])
    corr = ((x >> g.corr_pre) * f.eps) >> g.corr_post
    u = (x + corr + (1 << (g.shift - 1))) >> g.shift
    half_b = 1 << (g.log_b - 1)
    h = sum(half_b << (g.log_b * j) for j in range(g.d))
    uh = u + h
    digs = torch.stack([((uh >> (g.log_b * j)) & ((1 << g.log_b) - 1)) - half_b
                        for j in range(g.d)])
    assert torch.equal(digs, g.decompose(x, dim=0))


@pytest.mark.parametrize("m,s,blocks", [(1, 4, 1), (3, 4, 1), (4, 4, 1), (5, 4, 2),
                                        (33, 4, 9), (7168, 4, 1792), (1, 1, 1),
                                        (1024, 1, 1024)])
def test_blocks_cover_ragged_batches(m, s, blocks):
    """``s`` samples per block; the last block is masked in the kernel."""
    assert fused.n_blocks(m, s) == blocks
    assert (blocks - 1) * s < m <= blocks * s


@pytest.mark.parametrize("log_n,rlog,stages", [(10, 5, [5, 5]), (11, 4, [4, 4, 3]),
                                               (8, 4, [4, 4]), (9, 3, [3, 3, 3]),
                                               (11, 3, [3, 3, 3, 2])])
def test_pass_stages_cover_the_transform(log_n, rlog, stages):
    assert fused.pass_stages(log_n, rlog) == stages
    tw = np.arange(1 << log_n)
    for inverse in (False, True):
        # every stage's 2**stage twiddles once: N - 1 entries
        t = fused.pass_twiddles(tw, log_n, rlog, inverse)
        assert sorted(t.tolist()) == list(range(1, 1 << log_n))


def test_cpu_key_keeps_the_reference_layout():
    f, ntt, g = _level("tiny", 1)
    bsk = torch.randint(0, f.q, (6, ntt.n, g.d, 2, 2),
                        generator=torch.Generator().manual_seed(1))
    sh = f.shoup_t(bsk)
    key = fused.BlindRotateKey(bsk, sh, ntt, g, "blind_rotate1")
    ref, ref_sh = key.reference()
    # the given tensors themselves, as a stack of one (views, nothing copied)
    assert not key.on_card and ref._base is bsk and ref_sh._base is sh
    assert torch.equal(ref, bsk) and torch.equal(ref_sh, sh) and key.recipients == 1
    assert key.nbytes() == 2 * bsk.numel() * 8


# ------------------------------------------------------------ default device
def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")


def _raises_for_cpu(fn):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        obj = fn()
        assert getattr(obj, "device", None) != torch.device("cpu"), "fell back"


@pytest.mark.parametrize("entry", ["context", "ntt", "sender", "timer", "pack",
                                   "resolve"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry):
    _no_card()
    params = OmrParameters.tiny()
    f1 = _level("tiny", 1)[0]
    clue_key = SecretKeyPack(params, rng=1, ctx=_CTX["tiny"]).generate_clue_key()
    calls = {
        "context": lambda: OmrContext(params),
        "ntt": lambda: Ntt(f1, 256),
        "sender": lambda: Sender(clue_key, params),
        "timer": lambda: StageTimer(),
        "pack": lambda: SecretKeyPack(params, rng=1),
        "resolve": lambda: build.resolve_device(None),
    }
    _raises_for_cpu(calls[entry])


@pytest.mark.parametrize("example", ["run_omd", "make_keys"])
def test_examples_default_to_the_card_and_raise_without_one(example):
    _no_card()
    from omd_torch import run_omd
    from omr_torch import make_keys

    params = OmrParameters.tiny()
    fn = {"run_omd": lambda: run_omd(params),
          "make_keys": lambda: make_keys(params, seed=1)}[example]
    _raises_for_cpu(fn)


def test_explicit_cpu_is_honoured():
    assert build.resolve_device("cpu") == torch.device("cpu")
    assert OmrContext(OmrParameters.tiny(), "cpu").device == torch.device("cpu")
    assert StageTimer("cpu").device == torch.device("cpu")
