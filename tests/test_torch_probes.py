"""The unit-rate probes of the port (ops/probes.py, csrc/probes.cu) against
the Pallas probes of benches/.

Each Pallas probe runs on the CPU in interpret mode: ``pl.pallas_call`` is
wrapped to drop the TPU ``compiler_params`` and set ``interpret=True``; the
bench modules themselves are not edited. The same numpy inputs go through
the port's plain version. Integer results are held bit-equal (int32 and
int64 wrap, ``>>`` is arithmetic, the compare of sel_add signed, the dot
sums wrap mod 2^32).

float32 FMA: the port's plain version rounds each product-and-sum once (as
the kernel's fmaf does), while the interpreted JAX probe may round the
product and the sum apart. At 3 iterations each of its 6 operations differs
by at most half an ulp and the coupled chain compounds that at most as a
Fibonacci sequence, so the two are held within a relative 2^-17 (64 ulps).
The kernel against the plain version is bit-equal at any length: the plain
version rounds the float64 sum to odd before its cast to float32, which is
fmaf's one rounding (held here against the exact rational sum).

The kernels run here through the host build of csrc/ (build.host_library,
g++ against the stand-in cuda_runtime.h): probe_chain and probe_mac as they
are; probe_i8dot with csrc/hopper.cuh's stand-ins (a TMA box copied into
the same swizzled offsets, each thread's wgmma fragment by the PTX ISA's
layout, TMA stores and reduce-adds as copies and sums), so the pre-pass,
the tiling, the splits of k and of the rounds, the ring, the masks and the
fragment-to-C map are exercised; the descriptors only on a card.
The four bench twins and benches/chain_plan_torch.py run at ``--tiny
--device cpu``.
"""

import contextlib
import importlib
import json
import math
import os
import subprocess
import sys
import types
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tfhe_omr_tpu_torch.ops import probes
from tfhe_omr_tpu_torch.utils import build, rates
from tfhe_omr_tpu_torch.utils.timing import median_ms

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benches"))

SHAPE = (8, 128)
ITERS = 3
CHAIN_ITERS = 70
F32_RTOL = 2.0 ** -17
SMS = 8  # the stand-in card's SMs: a product of fewer tiles splits them


@pytest.fixture
def interpret(monkeypatch):
    """Pallas calls of the bench modules run interpreted on the CPU."""
    real = pl.pallas_call

    def pallas_call(kernel, *, compiler_params=None, **kw):
        return real(kernel, interpret=True, **kw)

    monkeypatch.setattr(pl, "pallas_call", pallas_call)


@pytest.fixture
def host(monkeypatch):
    """Route the probe wrappers to the host build of the kernels."""
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


def _ints(seed, shape=SHAPE, dtype=np.int32):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 1 << 20, size=shape).astype(dtype),
            rng.integers(1, 1 << 10, size=shape).astype(dtype))


def _floats(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.0, size=shape).astype(np.float32),
            rng.uniform(0.9, 1.1, size=shape).astype(np.float32))


def _i8(seed, *shapes, lo=-64, hi=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, hi, size=s, dtype=np.int8) for s in shapes]


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


# ------------------------------------------------------ P1-P9 == plain (CPU)
@pytest.mark.parametrize("streams", [1, 4])
@pytest.mark.parametrize("op", ["add", "mul", "mul_add", "sub_add", "shift_add",
                                "mask_add", "sel_add"])
def test_vpu_probe_chain_matches_plain(interpret, op, streams):
    """P1: vpu_probe.make_probe."""
    vpu_probe = importlib.import_module("vpu_probe")
    x, y = _ints(1)
    fn, ope = vpu_probe.make_probe(op, SHAPE, ITERS, streams)
    assert ope == 2 * ITERS * streams
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(y)))
    got = probes.probe_chain_plain(*_t(x, y), op, ITERS, streams)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n,rounds", [(16, 12, 24, 3), (16, 40, 8, 2)])
def test_vpu_probe_dot_matches_plain(interpret, m, k, n, rounds):
    """P2: vpu_probe.make_dot_probe."""
    vpu_probe = importlib.import_module("vpu_probe")
    a, b = _i8(2, (m, k), (k, n))
    want = np.asarray(vpu_probe.make_dot_probe(m, k, n, rounds)(a, b))
    np.testing.assert_array_equal(probes.probe_i8dot_plain(*_t(a, b), rounds).numpy(), want)


@pytest.mark.parametrize("streams", [1, 16])
@pytest.mark.parametrize("op", ["mul", "add"])
def test_vpu_peak_chain_matches_plain(interpret, op, streams):
    """P3: vpu_peak_probe.make_chain_probe (its mul chain is mul_add)."""
    vpu_peak = importlib.import_module("vpu_peak_probe")
    x, y = _ints(3)
    fn, _ = vpu_peak.make_chain_probe(op, SHAPE, ITERS, streams)
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(y)))
    got = probes.probe_chain_plain(*_t(x, y), "mul_add" if op == "mul" else "add",
                                   ITERS, streams)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("streams", [1, 4])
def test_vpu_peak_mac_matches_plain(interpret, streams):
    """P4: vpu_peak_probe.make_mac_probe (wrapping int32 products)."""
    vpu_peak = importlib.import_module("vpu_peak_probe")
    x, y = _ints(4)
    fn, ope = vpu_peak.make_mac_probe(SHAPE, 5, streams)
    assert ope == 3 * 5 * streams
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(probes.probe_mac_plain(*_t(x, y), 5, streams).numpy(), want)


@pytest.mark.parametrize("g,m,k,n,rounds", [(3, 48, 12, 16, 2), (2, 16, 40, 8, 3)])
def test_mac_probe_batched_dot_matches_plain(interpret, g, m, k, n, rounds):
    """P5: mac_probe.kernel_batched_dot."""
    mac_probe = importlib.import_module("mac_probe")
    a, b = _i8(5, (g, m, k), (g, k, n))
    want = np.asarray(mac_probe.kernel_batched_dot(g, m, k, n, rounds)(a, b))
    np.testing.assert_array_equal(probes.probe_i8dot_plain(*_t(a, b), rounds).numpy(), want)


@pytest.mark.parametrize("streams", [1, 4])
def test_mac_probe_f32_fma_within_ulps_of_plain(interpret, streams):
    """P6: mac_probe.f32_fma_probe, within the bound of the module
    docstring (fused against possibly unfused rounding)."""
    mac_probe = importlib.import_module("mac_probe")
    x, y = _floats(6)
    fn, fmas = mac_probe.f32_fma_probe(SHAPE, ITERS, streams)
    assert fmas == 2 * ITERS * streams
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(y)))
    got = probes.probe_chain_plain(*_t(x, y), "fma", ITERS, streams).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=0)


@pytest.mark.parametrize("m,k,n,rounds,lo,hi", [
    (16, 24, 8, 4, -64, 64),
    (16, 768, 8, 300, 100, 127),  # 300 x 768 x 100^2 > 2^31: the sum wraps
])
def test_mac_probe_dot2d_matches_plain(interpret, m, k, n, rounds, lo, hi):
    """P7: mac_probe.kernel_dot2d, once with a wrapping int32 sum."""
    mac_probe = importlib.import_module("mac_probe")
    a, b = _i8(7, (m, k), (k, n), lo=lo, hi=hi)
    want = np.asarray(mac_probe.kernel_dot2d(m, k, n, rounds)(a, b))
    got = probes.probe_i8dot_plain(*_t(a, b), rounds)
    if lo > 0:
        exact = rounds * (a.astype(np.int64) @ b.astype(np.int64))
        assert np.abs(exact).max() >= 1 << 31
    np.testing.assert_array_equal(got.numpy(), want)


def test_mosaic_unsupported_probes_match_plain(interpret, monkeypatch):
    """P8 and P9: mosaic_unsupported_probe.main's int32, int64 and mulhi
    chains (chain_kernel at a small SHAPE and ITERS) and its batched int8
    dot, each attempt's output held against the port's plain version."""
    mod = importlib.import_module("mosaic_unsupported_probe")
    monkeypatch.setattr(mod, "SHAPE", SHAPE)
    monkeypatch.setattr(mod, "ITERS", ITERS)
    outs = {}

    def attempt(label, build_fn, args, work=None, unit="gops", reps=5):
        fn = build_fn()
        outs[label] = (args, np.asarray(fn(*args)))

    monkeypatch.setattr(mod, "attempt", attempt)
    mod.main()
    (x32, y32), _ = outs["mosaic_i32_mul_chain"]
    x32, y32 = np.asarray(x32), np.asarray(y32)
    cases = {
        "mosaic_i32_mul_chain": (x32, y32, "mul_add"),
        "mosaic_i64_mul_chain": (x32.astype(np.int64), y32.astype(np.int64), "mul_add"),
        "xla_i64_mul_chain": (x32.astype(np.int64), y32.astype(np.int64), "mul_add"),
        "mosaic_mulhi_via_i64": (x32, y32, "mulhi_add"),
    }
    for label, (x, y, op) in cases.items():
        got = probes.probe_chain_plain(*_t(x, y), op, ITERS, mod.STREAMS)
        np.testing.assert_array_equal(got.numpy(), outs[label][1], err_msg=label)
    # main draws the dot's operands from its rng after the chains' inputs
    rng = np.random.default_rng(0)
    rng.integers(1, 1 << 20, SHAPE)
    rng.integers(1, 1 << 10, SHAPE)
    a = rng.integers(-64, 64, (2048, 48, 12), dtype=np.int8)
    b = rng.integers(-64, 64, (2048, 12, 128), dtype=np.int8)
    want = outs["mosaic_batched_i8_dot"][1]
    assert want.shape == (2048, 48, 128)
    np.testing.assert_array_equal(probes.probe_i8dot_plain(*_t(a, b), 1).numpy(), want)


# ------------------------------------------- C1-C3 on the host == plain
CHAIN_CASES = ([(torch.int32, op) for op in probes.CHAIN_DTYPES[torch.int32]]
               + [(torch.int64, "mul_add"), (torch.float32, "fma")])


# on the stand-in card's 8 SMs (the plan splits below 1024 threads, 2048
# for int64): 200 elements split S = 4 over 4 threads and S = 16 over 8 of
# 2, the last block partial; 300 split S = 16 over 4 threads of 4 (int64:
# 8 of 2); 2200 fill it unsplit, one element a thread
CHAIN_SHAPES = [(2, 100), (3, 100), (20, 110)]


@pytest.mark.parametrize("dtype,op,streams,shape", [
    pytest.param(dtype, op, streams, shape, id=f"{str(dtype)[6:]}-{op}-{streams}" + (
        "" if shape == CHAIN_SHAPES[0] else f"-n{shape[0] * shape[1]}"))
    for shape in CHAIN_SHAPES for dtype, op in CHAIN_CASES for streams in probes.STREAMS])
def test_chain_kernel_on_host_matches_plain(host, dtype, op, streams, shape):
    """Every chain runs CHAIN_ITERS steps: one 64-step turn of the kernel's
    unrolled loop (its parity-dependent pipes included) and some of its
    rest. (The fma chain has overflowed to +inf within 6 steps by then:
    test_chain_kernel_on_host_runs_the_fma_loop_at_finite_values holds its
    loop at finite values.)"""
    iters = CHAIN_ITERS
    if dtype == torch.float32:
        x, y = _t(*_floats(8, shape))
    else:
        x, y = (t.to(dtype) for t in _t(*_ints(8, shape)))
        x[0, :3] = torch.tensor([-(1 << 30), 0, (1 << 31) - 1]).to(dtype)
    got = probes.probe_chain(x, y, op, iters, streams)
    assert build.LAUNCHES["probe_chain"] >= 1
    want = probes.probe_chain_plain(x, y, op, iters, streams)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("iters", [4, 5])
def test_chain_kernel_on_host_runs_the_fma_loop_at_finite_values(host, iters):
    """S = 16 unsplit (2200 elements fill the stand-in card): a turn of the
    unrolled loop is 4 steps of the 16 streams, which run before any value
    overflows; 5 iterations add one step of the rest. Bit-equal."""
    x, y = _t(*_floats(15, (20, 110)))
    assert probes.chain_plan(x.numel(), 16, SMS, torch.float32)["split"] == 1
    assert bool(probes.probe_chain_plain(x, y, "fma", 4, 16).isfinite().all())
    got = probes.probe_chain(x, y, "fma", iters, 16)
    assert torch.equal(got, probes.probe_chain_plain(x, y, "fma", iters, 16))


def test_chain_kernel_on_host_keeps_the_fma_sum_order(host):
    """S = 16 split over 8 threads of 2: the element's first thread adds
    a_0, b_0, ..., b_15 in that order, bit-equal to plain; summed the other
    way round the same values differ, so an order fault would show."""
    x, y = _t(*_floats(14, (2, 100)))
    assert probes.chain_plan(x.numel(), 16, SMS, torch.float32)["split"] == 8
    got = probes.probe_chain(x, y, "fma", ITERS, 16)
    assert torch.equal(got, probes.probe_chain_plain(x, y, "fma", ITERS, 16))
    st = [(x + float(s), y * torch.tensor(1 + 0.01 * s, dtype=torch.float32))
          for s in range(16)]
    for _ in range(ITERS):
        st = [probes._chain_step("fma", a, b) for a, b in st]
    backwards = st[15][1]
    for _a, b in reversed(st[:15]):
        backwards = backwards + b
    assert not torch.equal(got, backwards + st[0][0])


@pytest.mark.parametrize("n,streams,sms,dtype,want", [
    # P1, P3, P6: (256, 1024) on an H100's 132 SMs, one element a thread
    (262144, 4, 132, torch.int32, dict(per_thread=4, split=1, blocks=2048)),
    (262144, 16, 132, torch.int32, dict(per_thread=16, split=1, blocks=2048)),
    (262144, 1, 132, torch.int32, dict(per_thread=1, split=1, blocks=2048)),
    (262144, 4, 132, torch.float32, dict(per_thread=4, split=1, blocks=2048)),
    # P8: (64, 512), S = 4: int32 unsplit, int64 over two threads
    (32768, 4, 132, torch.int32, dict(per_thread=4, split=1, blocks=256)),
    (32768, 4, 132, torch.int64, dict(per_thread=2, split=2, blocks=512)),
    # P3's smallest shape, (8, 512)
    (4096, 16, 132, torch.int32, dict(per_thread=2, split=8, blocks=256)),
    (4096, 4, 132, torch.int32, dict(per_thread=1, split=4, blocks=128)),
    (200, 16, SMS, torch.int32, dict(per_thread=2, split=8, blocks=13)),
    (300, 16, SMS, torch.int64, dict(per_thread=2, split=8, blocks=19)),
])
def test_chain_plan_fills_the_card(host, n, streams, sms, dtype, want):
    """An element's streams are split over adjacent threads only where the
    elements alone give an SM fewer than 128 threads a 32-bit word of a
    stream, and over the fewest threads that reach that."""
    plan = probes.chain_plan(n, streams, sms, dtype)
    assert plan == want
    fill = 128 * sms * (8 if dtype == torch.int64 else 4) // 4
    assert plan["per_thread"] * plan["split"] == streams
    assert n * plan["split"] >= fill or plan["split"] == streams
    assert plan["split"] == 1 or n * plan["split"] // 2 < fill


@pytest.mark.parametrize("streams", probes.STREAMS)
def test_mac_kernel_on_host_matches_plain(host, streams):
    x, y = _t(*_ints(9, (3, 50)))
    got = probes.probe_mac(x, y, 7, streams)
    assert build.LAUNCHES["probe_mac"] >= 1
    assert torch.equal(got, probes.probe_mac_plain(x, y, 7, streams))


@pytest.mark.parametrize("shape,rounds", [
    ((2, 48, 12, 16), 2),   # k = 12 padded to 16, m beyond the tile's rows
    ((1, 20, 200, 72), 1),  # two k atoms (4 + 3 steps), n ragged in one tile
    ((None, 70, 96, 8), 2),  # 2-D, two m tiles
    ((1, 100, 300, 42), 5),  # 2 tiles on 8 SMs: k split over 3 blocks, TMA adds; C padded
    ((1, 64, 64, 64), 43),  # one tile: its 43 rounds split over 8 blocks (TMA adds)
    ((3, 48, 12, 128), 1),  # the P9 form: A packed, rows beyond m, TMA stores
    ((8, 20, 600, 70), 2),  # 5 atoms through a ring of 4: it wraps; C's rows padded to 72
])
def test_i8dot_kernel_on_host_matches_plain(host, shape, rounds):
    g, m, k, n = shape
    lead = () if g is None else (g,)
    a, b = _t(*_i8(10, lead + (m, k), lead + (k, n), lo=-128, hi=127))
    got = probes.probe_i8dot(a, b, rounds)
    assert build.LAUNCHES["probe_i8dot"] >= 1
    assert got.shape == lead + (m, n) and got.dtype == torch.int32
    assert torch.equal(got, probes.probe_i8dot_plain(a, b, rounds))


def test_i8dot_kernel_on_host_takes_a_misaligned_a(host):
    """A view of a whose rows do not start on 16 bytes (TMA reads aligned
    rows): the wrapper copies it first, and the sums are the plain ones."""
    a, b = _t(*_i8(13, (1 + 2 * 40 * 32,), (2, 32, 24), lo=-128, hi=127))
    a = a[1:].view(2, 40, 32)
    assert a.data_ptr() % 16
    assert torch.equal(probes.probe_i8dot(a, b, 3), probes.probe_i8dot_plain(a, b, 3))


@pytest.mark.parametrize("shape,want", [
    # (g, m, k, n, rounds) on an H100's 132 SMs: P2, P5, P7, P9
    ((1, 2048, 2048, 256, 8), dict(n_tile=256, split_k=4, split_r=1, stages=4, blocks=128)),
    ((256, 384, 96, 128, 512), dict(n_tile=128, split_k=1, split_r=1, stages=1, blocks=1536)),
    ((1, 768, 192, 128, 16384), dict(n_tile=128, split_k=1, split_r=11, stages=2, blocks=132)),
    ((2048, 48, 12, 128, 1), dict(n_tile=128, split_k=1, split_r=1, stages=1, blocks=2048)),
    ((1, 384, 768, 128, 8192), dict(n_tile=128, split_k=1, split_r=22, stages=4, blocks=132)),
])
def test_i8dot_plan_fills_the_card(host, shape, want):
    """The cut of the probes' products: tiles a block, k or the rounds split
    where the tiles are fewer than the SMs, and k padded to 16 bytes."""
    g, m, k, n, rounds = shape
    plan = probes.i8dot_plan(g, m, k, n, rounds, 132)
    assert {key: plan[key] for key in want} == want
    assert plan["kp"] == -(-k // 16) * 16 and plan["smem"] <= 232448
    assert plan["blocks"] <= 132 or plan["split_k"] * plan["split_r"] == 1


def test_wrappers_refuse_what_no_kernel_takes():
    x, y = _t(*_ints(11))
    with pytest.raises(ValueError, match="no fma chain"):
        probes.probe_chain(x, y, "fma", 1, 1)
    with pytest.raises(ValueError, match="streams"):
        probes.probe_mac(x, y, 1, 3)
    a, b = _t(*_i8(11, (4, 8), (5, 8)))
    with pytest.raises(ValueError, match="int8"):
        probes.probe_i8dot(a, b, 1)


def _fmaf_exact(a: float, b: float, c: float) -> float:
    """a x b + c, exact as a fraction, rounded once to the nearest float32
    (ties to even), subnormals and overflow to infinity included."""
    q = Fraction(a) * Fraction(b) + Fraction(c)
    if q == 0:
        return 0.0
    mag = abs(q)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    e -= Fraction(2) ** e > mag
    quantum = Fraction(2) ** (max(e, -126) - 23)
    n, rest = divmod(mag, quantum)
    n += rest > quantum / 2 or (rest == quantum / 2 and n % 2 == 1)
    near = n * quantum
    return math.copysign(math.inf if near >= 2 ** 128 else float(near), q)


@pytest.mark.parametrize("scale", [2.0 ** 30, 2.0 ** -40], ids=["large", "small"])
def test_fma_plain_refuses_a_sum_float64_cannot_hold(scale):
    """A large product and a small one whose sum with the addend float64
    cannot hold exactly (once refused): the plain version rounds it to odd
    first, and each step is the exact sum rounded once to float32."""
    wide = 1.0 + 2.0 ** -23
    x = torch.full((2, 3), wide * scale)
    y = torch.full((2, 3), wide * (scale if scale > 1 else 1.0))
    a = probes._fmaf(x, y, 1.5)
    assert float(a[0, 0]) == _fmaf_exact(float(x[0, 0]), float(y[0, 0]), 1.5)
    b = probes._fmaf(y, a, 0.5)
    assert float(b[0, 0]) == _fmaf_exact(float(y[0, 0]), float(a[0, 0]), 0.5)
    want = torch.full((2, 3), float(a[0, 0]) + float(b[0, 0]), dtype=torch.float32)
    assert torch.equal(probes.probe_chain_plain(x, y, "fma", 1, 1), want)


@pytest.mark.parametrize("seed", range(4))
def test_fmaf_emulation_rounds_once(seed):
    """The plain version's fmaf against the exact sum rounded once, over
    operands of 2^-70 to 2^70 (subnormal and infinite results included),
    and a sum just above a float32 midpoint that rounding twice (to float64,
    then to float32) would take down to the even neighbour."""
    rng = np.random.default_rng(seed)
    mags = lambda: rng.standard_normal(500) * np.exp2(rng.integers(-70, 70, 500))
    a, b, c = (mags().astype(np.float32) for _ in range(3))
    for cc in (0.0, float(c[0]), 1.5, 0.5):
        got = probes._fmaf(torch.tensor(a), torch.tensor(b), cc)
        assert got.tolist() == [_fmaf_exact(float(u), float(v), cc) for u, v in zip(a, b)]
    # -(1 + 2^-23) x 2^-24 (1 - 2^-23) + (1 + 2^-23) = 1 + 2^-24 + 2^-70
    x = torch.tensor([-(1 + 2.0 ** -23)])
    y = torch.tensor([2.0 ** -24 * (1 - 2.0 ** -23)])
    assert float(probes._fmaf(x, y, 1 + 2.0 ** -23)) == 1 + 2.0 ** -23
    assert float((x.double() * y.double() + (1 + 2.0 ** -23)).float()) == 1.0


SPEC = {"int32": 128.0, "int32_mul": 64.0, "f32_fma": 128.0, "int8_mma": 8192.0}


@pytest.mark.parametrize("dtype,op,unit,ms", [
    (torch.int32, "add", "int32", 2 / 128),        # two adds: both pipes
    (torch.int32, "mul", "int32_mul", 2 / 64),      # two multiplies: the FMA pipe
    (torch.int32, "shift_add", "int32", 1 / 128),   # a's shift folds into the add
    (torch.int64, "mul_add", "int32_mul", 4 / 64),  # IMAD.WIDE.U32 (two) and two IMADs
    (torch.float32, "fma", "f32_fma", 2 / 128),
    (torch.int32, "sel_add", "int32", 3 / 128),     # compare, subtract under it, add
    (torch.int32, "mulhi_add", "int32_mul", 2 / 64),  # IMAD.HI: two multiply slots
    (torch.int32, "sub_add", "int32", 1 / 128),     # b + (a - b) is a: the subtract
    (torch.int32, "mulwide_add", "int32_mul", 2 / 64),  # IMAD.WIDE: two slots
])
def test_bound_is_set_by_the_slowest_unit(dtype, op, unit, ms):
    """1000 steps at the rates of one SM-clock a millisecond (rates in
    operations a second x 1e-3): the bound is the unit whose work takes
    longest, never the counted operations over one pipe."""
    got = rates.bound(rates.step_work(dtype, op, 1000), {u: 1e3 * r for u, r in SPEC.items()},
                      0)
    assert got["bound_by"] == "operations" and got["bound_unit"] == unit
    assert got["bound_ms"] == pytest.approx(1000 * ms)
    by_bytes = rates.bound(rates.dot_work(1, 2, 32, 8, 1), {"int8_mma": 1e30}, 3350)
    assert by_bytes == {"bound_ms": pytest.approx(1e-6), "bound_by": "bytes",
                        "bound_unit": "bytes"}


def test_rate_record_and_timer_on_cpu():
    """A CPU record carries the rate alone; the timer calls fn once warm and
    then ``reps`` times; the library's dot sums equal the plain version's."""
    calls = []
    assert median_ms(lambda: calls.append(1), "cpu", reps=3) >= 0 and len(calls) == 4
    median_ms(lambda: calls.append(1), "cpu", reps=2, warm=False)
    assert len(calls) == 6
    rec = rates.rate_record("v", 4e6, 2.0, "gops", torch.device("cpu"))
    assert rec == {"variant": "v", "gops": 2.0, "ms": 2.0, "device": "cpu"}
    a, b = _t(*_i8(12, (3, 16, 12), (3, 12, 8)))
    np.testing.assert_array_equal(rates.library_i8dot(a.float(), b.float(), 3).numpy(),
                                  probes.probe_i8dot_plain(a, b, 3).numpy())


@pytest.mark.parametrize("shape", [
    (1, 2048, 2048, 256, 1),  # P2, 8 rounds on the card
    (256, 384, 96, 128, 1),  # P5, 512
    (1, 768, 192, 128, 2),  # P7, 16384
    (2048, 48, 12, 128, 1),  # P9: k 12 padded to 32
    (1, 48, 768, 128, 300),  # positive operands: the int32 sums wrap
])
def test_library_int_mm_equals_plain_at_the_probes_shapes(shape):
    """``torch._int_mm`` a round (a loop over the groups of a batched dot),
    k and m zero-padded where cuBLASLt needs it, sums what the probe
    kernel's plain version sums, int32 wrapping included, with b row- or
    column-major and through the graphed timer's callable (the loop on the
    CPU); an n it cannot take raises."""
    g, m, k, n, rounds = shape
    lo = 64 if rounds > 100 else -128
    gen = torch.Generator().manual_seed(m + k)
    a = torch.randint(lo, 128, (g, m, k), generator=gen).to(torch.int8)
    b = torch.randint(lo, 128, (g, k, n), generator=gen).to(torch.int8)
    if g == 1:
        a, b = a[0], b[0]
    want = probes.probe_i8dot_plain(a, b, rounds)
    if lo > 0:
        assert not torch.equal(want.long(), rounds * (a.long() @ b.long()))
    assert torch.equal(rates.library_int_mm(a, b, rounds), want)
    assert torch.equal(rates.library_int_mm(a, b, rounds, b_col_major=True), want)
    assert torch.equal(rates.library_int_mm_graphed(a, b, rounds, True)(), want)
    assert torch.equal(rates.dot_rounds(a, b, rounds), want)
    assert rates.int_mm_k(k) % 16 == 0 and rates.int_mm_k(k) > 16
    with pytest.raises(ValueError, match="_int_mm"):
        rates.library_int_mm(a, b[..., :8], 1)


# ------------------------------------------------------- the bench twins
@pytest.mark.parametrize("bench,key", [
    ("vpu_probe", "gops"), ("vpu_peak_probe", "gops"),
    ("mac_probe", "device"), ("mosaic_unsupported_probe", "int64"),
    ("chain_plan", "split"),
])
def test_probe_bench_twin_runs_tiny_on_cpu(bench, key):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benches", f"{bench}_torch.py"), "--tiny",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert key in lines[0]
    assert lines[-1]["card"] == "cpu"
    assert all(rec["device"] == "cpu" for rec in lines[:-1] if "variant" in rec)
