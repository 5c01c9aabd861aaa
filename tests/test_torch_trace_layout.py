"""The host side of the trace and row-NTT kernels, on the CPU.

What surrounds ``csrc/trace.cu`` and ``csrc/ntt.cu`` is plain Python and
tensors: the trace key's layout, the automorphism as one multiply, the exact
digits of a negated coefficient, the first butterfly stage as a select, the
bound of the lazy sums, and the per-pass twiddle tables beside their
companions. All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.ops import fused
from tfhe_omr_tpu_torch.ops.ntt import pass_stages, pass_twiddles, shoup_companion

torch.set_num_threads(1)

PRESETS = ["default", "tiny"]
_CTX = {}
# (preset, level, word bits, stages per pass) of the four NttConfig
# instantiations of csrc/ntt.cu
NTT_RINGS = [("default", 1, 32, 5), ("default", 2, 64, 4),
             ("tiny", 1, 32, 4), ("tiny", 2, 64, 3)]


def _ctx(preset):
    if preset not in _CTX:
        _CTX[preset] = OmrContext(getattr(OmrParameters, preset)(), "cpu")
    return _CTX[preset]


@pytest.mark.parametrize("preset", PRESETS)
def test_trace_key_layout_round_trips(preset):
    """Reference -> kernel layout -> reference, bit for bit; the kernel
    layout is (round, digit, out, slot) in the radix-2 slot order and
    carries no companions: ``reference()`` recomputes them."""
    ctx = _ctx(preset)
    f, ntt, g = ctx.f2, ctx.ntt2, ctx.gadget_trace
    rounds = 3
    tk = torch.randint(0, f.q, (rounds, ntt.n, g.d, 2),
                       generator=torch.Generator().manual_seed(2))
    k = fused.trace_key_layout(tk, ntt.perm_inv)
    assert k.shape == (rounds, g.d, 2, ntt.n) and k.is_contiguous()
    back = fused.trace_reference_layout(k, ntt.perm)
    assert torch.equal(back, tk)
    assert torch.equal(f.shoup_t(back), f.shoup_t(tk))
    # one entry by hand: round 2, digit j, out 1, base slot 7
    j = g.d - 1
    assert int(k[2, j, 1, 7]) == int(tk[2, int(ntt.perm_inv[7]), j, 1])


def test_cpu_trace_key_keeps_the_reference_layout():
    ctx = _ctx("tiny")
    f, g = ctx.f2, ctx.gadget_trace
    tk = torch.randint(0, f.q, (len(ctx.trace_autos), ctx.params.n2, g.d, 2),
                       generator=torch.Generator().manual_seed(1))
    sh = f.shoup_t(tk)
    key = fused.TraceKey(tk, sh, ctx.ntt2, g, ctx.trace_autos)
    ref, ref_sh = key.reference()
    # the given tensors themselves, as a stack of one (views, nothing copied)
    assert not key.on_card and ref._base is tk and ref_sh._base is sh
    assert torch.equal(ref, tk) and torch.equal(ref_sh, sh) and key.recipients == 1
    assert key.nbytes() == 2 * tk.numel() * 8


@pytest.mark.parametrize("preset,rnd", [("default", r) for r in range(11)]
                         + [("tiny", r) for r in range(9)])
def test_packed_automorphism_reproduces_trace_autos(preset, rnd):
    """``(g**-1 * k) mod 2N``: the low bits are ``gidx[k]``, the bit above
    them the sign, for every round of EvalTr."""
    ctx = _ctx(preset)
    n = ctx.params.n2
    assert len(ctx.trace_autos) == n.bit_length() - 1
    g, gidx, gsign = ctx.trace_autos[rnd]
    ginv = fused.auto_multipliers(ctx.trace_autos, n)[rnd]
    assert 0 < ginv < 2 * n and ginv * int(g) % (2 * n) == 1
    packed = (ginv * np.arange(n, dtype=np.int64)) % (2 * n)
    assert np.array_equal(packed & (n - 1), gidx)
    assert np.array_equal(np.where(packed >> (n.bit_length() - 1), -1, 1), gsign)
    # the product the kernel forms stays inside 32 bits
    assert ginv * (n - 1) < 2**31


@pytest.mark.parametrize("preset", PRESETS)
def test_exact_digits_of_a_negated_coefficient(preset):
    """The kernel negates a coefficient where the automorphism's sign says
    so and takes ``(x >> 2j) & 3``: the digits ``SignedGadget.decompose``
    gives for the negated value, and they rebuild it."""
    ctx = _ctx(preset)
    f, g = ctx.f2, ctx.gadget_trace
    assert g.exact and g.log_b == 2 and g.d * g.log_b >= f.bits
    x = torch.randint(0, f.q, (4096,), generator=torch.Generator().manual_seed(3))
    x[:4] = torch.tensor([0, 1, f.q - 1, f.q // 2])
    negated = torch.where(x == 0, x, f.q - x)
    assert torch.equal(negated, f.neg(x))
    digs = torch.stack([(negated >> (2 * j)) & 3 for j in range(g.d)])
    assert torch.equal(digs, g.decompose(f.neg(x), dim=0))
    assert torch.equal(digs, g.decompose_to_field(f.neg(x), dim=0))
    rebuilt = sum(digs[j] << (2 * j) for j in range(g.d))
    assert torch.equal(rebuilt, negated)


@pytest.mark.parametrize("preset", PRESETS)
def test_first_stage_select_equals_the_twiddle_product(preset):
    """A digit below 4 times the one twiddle w of stage 0 is a select among
    the multiples of w: (d & 1 ? w : 0) + (d & 2 ? 2w mod q : 0), below 2q."""
    ctx = _ctx(preset)
    f, ntt = ctx.f2, ctx.ntt2
    rlog = 4 if preset == "default" else 3
    w1 = int(pass_twiddles(ntt.fwd_tw.numpy(), ntt.log_n, rlog, False)[0])
    assert w1 == int(ntt.fwd_tw[1])  # stage 0 has one twiddle
    w2 = 2 * w1 % f.q
    for d in range(4):
        y = (w1 if d & 1 else 0) + (w2 if d & 2 else 0)
        assert y < 2 * f.q and y % f.q == d * w1 % f.q


@pytest.mark.parametrize("preset", PRESETS)
def test_lazy_sums_of_a_round_fit_128_bits(preset):
    """A forward transform without reductions stays below (2 log N + 1) q;
    d such values times key words below q are summed before one reduction,
    and the three-limb reduction needs the term count and eps^2 inside one
    limb (``WideAcc`` in csrc/field.cuh)."""
    ctx = _ctx(preset)
    f, ntt, g = ctx.f2, ctx.ntt2, ctx.gadget_trace
    growth = 2 * ntt.log_n + 1
    assert growth * f.q < 2**64
    assert g.d * growth * f.q * f.q < 2**128
    term_bits = (g.d * growth - 1).bit_length()
    assert 2 * f.bits + term_bits <= 128 and 2 * f.bits >= 64
    assert term_bits + 2 * f.eps.bit_length() <= f.bits


@pytest.mark.parametrize("preset,level,word_bits,rlog", NTT_RINGS)
def test_operand_tables_of_the_ntt_kernel(preset, level, word_bits, rlog):
    """``Ntt.operand_table``: the regrouped twiddles of both directions, each
    followed by its companion at the word's shift, N - 1 pairs, in the
    word's dtype; a Shoup product with a pair gives the residue."""
    ctx = _ctx(preset)
    ntt = ctx.ntt1 if level == 1 else ctx.ntt2
    q = ntt.field.q
    assert sum(pass_stages(ntt.log_n, rlog)) == ntt.log_n
    assert len(pass_stages(ntt.log_n, rlog)) >= 2  # the kernel stages behind pass 0
    for inverse in (False, True):
        t = ntt.operand_table(rlog, word_bits, inverse)
        assert t.dtype == (torch.int32 if word_bits == 32 else torch.int64)
        assert t.numel() == 2 * (ntt.n - 1)
        mask = (1 << word_bits) - 1
        pairs = [(int(w) & mask, int(sh) & mask) for w, sh in t.reshape(-1, 2).tolist()]
        tw = (ntt.inv_tw if inverse else ntt.fwd_tw).numpy()
        want = pass_twiddles(tw, ntt.log_n, rlog, inverse)
        assert [w for w, _ in pairs] == want.tolist()
        assert [sh for _, sh in pairs] == shoup_companion(want, q, word_bits).tolist()
        x = mask  # the largest word: the lazy butterflies hand in any word
        for w, sh in pairs[:: max(1, len(pairs) // 64)]:
            r = x * w - ((x * sh) >> word_bits) * q
            assert 0 <= r < 2 * q and r % q == x * w % q


@pytest.mark.parametrize("preset,level", [(p, lv) for p in PRESETS for lv in (1, 2)])
def test_permutation_tables_fit_16_bits_and_invert(preset, level):
    """The row NTT holds its permutation as 16-bit words: forward gathers
    base slot perm[k] into reference slot k, the inverse reads reference
    slot perm_inv[p] for base slot p."""
    ctx = _ctx(preset)
    ntt = ctx.ntt1 if level == 1 else ctx.ntt2
    p16 = ntt.perm.to(torch.int16)
    assert torch.equal(p16.to(torch.int64), ntt.perm) and ntt.n <= 2**15
    assert torch.equal(ntt.perm[ntt.perm_inv], torch.arange(ntt.n))
    x = torch.randint(0, ntt.field.q, (ntt.n,), generator=torch.Generator().manual_seed(4))
    base = ntt._fwd_base(x[:, None], ntt.fwd_tw, ntt.fwd_tw_sh)[:, 0]
    ref = ntt.fwd_plain(x[:, None])[:, 0]
    assert torch.equal(base[ntt.perm], ref) and torch.equal(ref[ntt.perm_inv], base)
