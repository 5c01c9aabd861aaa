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

import types

import pytest
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.ops import fused
from tfhe_omr_tpu_torch.ops.bootstrap import init_accumulator
from tfhe_omr_tpu_torch.ops.ntt import Ntt
from tfhe_omr_tpu_torch.utils import build

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


@pytest.mark.parametrize("kernel", ["blind_rotate", "trace", "ntt"])
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
    else:
        with pytest.raises(ValueError, match=r"no NTT kernel.*\(7, "):
            other.fwd_last(torch.zeros((2, 128), dtype=torch.int64))
