"""The port's PrimeField and SignedGadget against the JAX package.

The same numpy-seeded inputs go through both; every comparison is exact
(the math is integer arithmetic mod q, so there is no tolerance).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_omr_tpu.core.context import OmrContext as JaxContext
from tfhe_omr_tpu.core.params import OmrParameters as JaxParams
from tfhe_omr_tpu.ops.modmath import PrimeField as JaxField
from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.ops.modmath import PrimeField

# The suite runs in several xdist workers on one host: one torch thread each
# keeps their CPU thread pools from oversubscribing its cores.
torch.set_num_threads(1)

Q1 = OmrParameters.default().q1
Q2 = OmrParameters.default().q2
QT1 = OmrParameters.tiny().q1
QT2 = OmrParameters.tiny().q2


def _operands(q, seed, n=4096):
    """Uniform draws plus the 0 / 1 / q-1 edges in every pairing."""
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, q - 1, q - 2, q // 2], dtype=np.int64)
    a = np.concatenate([rng.integers(0, q, n, dtype=np.int64), np.repeat(edges, 5)])
    b = np.concatenate([rng.integers(0, q, n, dtype=np.int64), np.tile(edges, 5)])
    return a, b


def _same(port_out, jax_out):
    got = port_out.numpy()
    want = np.asarray(jax_out).astype(np.int64)
    assert got.dtype == np.int64
    assert np.array_equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("q", [Q1, Q2, QT1, QT2])
def test_field_ops_match_jax(q):
    f, jf = PrimeField(q), JaxField(q)
    a, b = _operands(q, seed=q % 1000)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert f.shoup_shift == jf.shoup_shift and f.eps == jf.eps
    _same(f.add(ta, tb), jf.add(ja, jb))
    _same(f.sub(ta, tb), jf.sub(ja, jb))
    _same(f.neg(ta), jf.neg(ja))
    _same(f.mul(ta, tb), jf.mul(ja, jb))
    _same(f.to_field(ta - tb), jf.to_field(ja - jb))
    w_sh = f.shoup(b)
    assert np.array_equal(w_sh, jf.shoup(b))
    assert np.array_equal(f.shoup_t(tb).numpy(), w_sh)
    _same(f.mul_shoup(ta, tb, torch.as_tensor(w_sh)),
          jf.mul_shoup(ja, jb, jnp.asarray(w_sh)))
    # reduce from the widest bound mul uses, and the chunked modular sum
    wide = (a[:64, None] * 997 + b[None, :64]) % (1 << (f.bits + 9))
    _same(f.reduce(torch.as_tensor(wide), f.bits + 10),
          jf.reduce(jnp.asarray(wide), f.bits + 10))
    stack = np.stack([a, b, a, b, b])
    _same(f.mod_sum(torch.as_tensor(stack), 0), jf.mod_sum(jnp.asarray(stack), 0))
    # the exact value, independently of both packages
    want = (a.astype(object) * b.astype(object)) % q
    assert np.array_equal(f.mul(ta, tb).numpy(), want.astype(np.int64))


def test_torch_int64_semantics():
    """The int64 behaviour the algorithms rely on (as XLA's)."""
    x = torch.tensor([-7, 7], dtype=torch.int64)
    assert torch.equal(x >> 1, torch.tensor([-4, 3]))
    assert torch.equal(x // 2, torch.tensor([-4, 3]))
    big = torch.tensor([1 << 62], dtype=torch.int64)
    assert int((big * 4)[0]) == 0  # wraps modulo 2**64


@pytest.mark.parametrize("preset", ["default", "tiny"])
@pytest.mark.parametrize("name", ["gadget_br1", "gadget_br2", "gadget_trace",
                                  "gadget_ks"])
def test_gadget_digits_match_jax(preset, name):
    params = getattr(OmrParameters, preset)()
    jparams = getattr(JaxParams, preset)()
    g = getattr(OmrContext(params, "cpu"), name)
    jg = getattr(JaxContext(jparams), name)
    q = g.field.q
    assert g.exact == jg.exact and g.h == jg.h
    a, _ = _operands(q, seed=len(name))
    a = np.concatenate([a[-25:], a])  # the edges first
    x = a[:4116].reshape(-1, 2, 7)
    got = g.decompose_to_field(torch.as_tensor(x), dim=1)
    want = jg.decompose_to_field(jnp.asarray(x), axis=1)
    _same(got, want)
    _same(g.decompose(torch.as_tensor(x), dim=0), jg.decompose(jnp.asarray(x), axis=0))
    # the host-side recomposition the JAX tests use: the same sums mod q
    digs = np.asarray(jg.decompose(jnp.asarray(x[:, 0]), axis=0))
    np.testing.assert_array_equal(g.recompose_host(digs), jg.recompose_host(digs))


@pytest.mark.parametrize("q", [Q1, Q2, QT2])
def test_host_helpers_match_jax(q):
    """PrimeField.pow and .rand, as the JAX tests call them."""
    f, jf = PrimeField(q), JaxField(q)
    assert f.pow(3, q - 2) == jf.pow(3, q - 2) == f.inv(3)
    np.testing.assert_array_equal(f.rand(np.random.default_rng(5), (3, 4)),
                                  jf.rand(np.random.default_rng(5), (3, 4)))


def test_stage_timer_stage_adds_up():
    from tfhe_omr_tpu_torch.utils.timing import StageTimer

    t = StageTimer("cpu")
    with t.stage("a"):
        sum(range(1000))
    with t.stage("a"):
        pass
    assert t.stages["a"] >= 0 and set(t.stages) == {"a"}
