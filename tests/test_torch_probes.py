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
The kernel against the plain version is bit-equal: at 3 iterations every
float64 sum of a product and its addend is exact, where the float64
emulation of the fused operation is exact too (the plain version checks
that and raises otherwise).

The kernels run here through the host build of csrc/ (build.host_library,
g++ against the stand-in cuda_runtime.h): probe_chain and probe_mac as they
are; probe_i8dot with its mma.sync fragment step replaced by a scalar
definition that reads the warp's fragments by the PTX ISA's layout, so the
staging, the zero padding, the fragment loads and the stores are exercised.
The four bench twins run at ``--tiny --device cpu``.
"""

import contextlib
import importlib
import json
import os
import subprocess
import sys

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
F32_RTOL = 2.0 ** -17


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


@pytest.mark.parametrize("streams", probes.STREAMS)
@pytest.mark.parametrize("dtype,op", CHAIN_CASES, ids=lambda v: str(v).split(".")[-1])
def test_chain_kernel_on_host_matches_plain(host, dtype, op, streams):
    if dtype == torch.float32:
        x, y = _t(*_floats(8, (2, 100)))
    else:
        x, y = (t.to(dtype) for t in _t(*_ints(8, (2, 100))))
        x[0, :3] = torch.tensor([-(1 << 30), 0, (1 << 31) - 1]).to(dtype)
    got = probes.probe_chain(x, y, op, ITERS, streams)
    assert build.LAUNCHES["probe_chain"] >= 1
    want = probes.probe_chain_plain(x, y, op, ITERS, streams)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("streams", probes.STREAMS)
def test_mac_kernel_on_host_matches_plain(host, streams):
    x, y = _t(*_ints(9, (3, 50)))
    got = probes.probe_mac(x, y, 7, streams)
    assert build.LAUNCHES["probe_mac"] >= 1
    assert torch.equal(got, probes.probe_mac_plain(x, y, 7, streams))


@pytest.mark.parametrize("shape,rounds", [
    ((2, 48, 12, 16), 2),   # k = 12 padded to 32, m beyond the tile's rows
    ((1, 20, 200, 72), 1),  # two k chunks (4 + 3 steps), two n tiles, ragged
    ((None, 70, 96, 8), 2),  # 2-D, two m tiles
])
def test_i8dot_kernel_on_host_matches_plain(host, shape, rounds):
    g, m, k, n = shape
    lead = () if g is None else (g,)
    a, b = _t(*_i8(10, lead + (m, k), lead + (k, n), lo=-128, hi=127))
    got = probes.probe_i8dot(a, b, rounds)
    assert build.LAUNCHES["probe_i8dot"] >= 1
    assert got.shape == lead + (m, n) and got.dtype == torch.int32
    assert torch.equal(got, probes.probe_i8dot_plain(a, b, rounds))


def test_wrappers_refuse_what_no_kernel_takes():
    x, y = _t(*_ints(11))
    with pytest.raises(ValueError, match="no fma chain"):
        probes.probe_chain(x, y, "fma", 1, 1)
    with pytest.raises(ValueError, match="streams"):
        probes.probe_mac(x, y, 1, 3)
    a, b = _t(*_i8(11, (4, 8), (5, 8)))
    with pytest.raises(ValueError, match="int8"):
        probes.probe_i8dot(a, b, 1)


@pytest.mark.parametrize("scale", [2.0 ** 30, 2.0 ** -40], ids=["large", "small"])
def test_fma_plain_refuses_a_sum_float64_cannot_hold(scale):
    """The float64 emulation of fmaf is exact only while the product's bits
    and the addend's span at most 53: a large product and a small one both
    break that at the first step, and the plain version says so."""
    wide = 1.0 + 2.0 ** -23
    x = torch.full((2, 3), wide * scale)
    y = torch.full((2, 3), wide * (scale if scale > 1 else 1.0))
    with pytest.raises(ValueError, match="not exact"):
        probes.probe_chain_plain(x, y, "fma", 1, 1)


SPEC = {"int32": 128.0, "int32_mul": 64.0, "f32_fma": 128.0, "int8_mma": 8192.0}


@pytest.mark.parametrize("dtype,op,unit,ms", [
    (torch.int32, "add", "int32", 2 / 128),        # two adds: both pipes
    (torch.int32, "mul", "int32_mul", 2 / 64),      # two multiplies: the FMA pipe
    (torch.int32, "sub_add", "int32", 1 / 128),     # b + (a - b) is a: one op
    (torch.int64, "mul_add", "int32_mul", 3 / 64),  # three 32-bit multiplies
    (torch.float32, "fma", "f32_fma", 2 / 128),
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
    assert rates.int_mm_k(k) % 16 == 0 and rates.int_mm_k(k) > 16
    with pytest.raises(ValueError, match="_int_mm"):
        rates.library_int_mm(a, b[..., :8], 1)


# ------------------------------------------------------- the bench twins
@pytest.mark.parametrize("bench,key", [
    ("vpu_probe", "gops"), ("vpu_peak_probe", "gops"),
    ("mac_probe", "device"), ("mosaic_unsupported_probe", "int64"),
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
