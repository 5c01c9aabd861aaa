"""The port's NTT against the JAX package's, in every reference slot order.

Forward and inverse of the same numpy-seeded polynomials through JAX
``ctx.ntt1`` / ``ctx.ntt2`` (default: ``PallasNtt`` / ``PallasNtt50`` on
their CPU paths; tiny: ``SmallFieldNtt`` / ``NegacyclicNtt``) and through
the port's plain torch transform. Exact comparisons.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_omr_tpu.core.context import OmrContext as JaxContext
from tfhe_omr_tpu.core.params import OmrParameters as JaxParams
from tfhe_omr_tpu.ops.pallas_ntt import PallasNtt, PallasNtt50
from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.params import OmrParameters

# The suite runs in several xdist workers on one host: one torch thread each
# keeps their CPU thread pools from oversubscribing its cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def contexts():
    """One port and one JAX context per preset (the JAX NTT tables take
    seconds to build)."""
    return {
        preset: (OmrContext(getattr(OmrParameters, preset)(), "cpu"),
                 JaxContext(getattr(JaxParams, preset)()))
        for preset in ("default", "tiny")
    }


def _jax_fn(jntt, name):
    """The JAX transform, jitted except PallasNtt's CPU path, which runs
    eagerly in a fraction of its compile time."""
    fn = getattr(jntt, name)
    return fn if isinstance(jntt, PallasNtt) else jax.jit(fn)


@pytest.mark.parametrize("preset", ["default", "tiny"])
@pytest.mark.parametrize("level", [1, 2])
def test_ntt_matches_jax(contexts, preset, level):
    ctx, jctx = contexts[preset]
    ntt = ctx.ntt1 if level == 1 else ctx.ntt2
    jntt = jctx.ntt1 if level == 1 else jctx.ntt2
    assert ntt.psi == jntt.psi
    assert np.array_equal(ntt.orders, np.asarray(jntt.orders))
    q = ntt.field.q
    rng = np.random.default_rng(level * 10 + len(preset))
    x = rng.integers(0, q, size=(ntt.n, 3), dtype=np.int64)
    x[:, 2] = 0
    x[0, 2] = q - 1
    fwd = ntt.fwd_plain(torch.as_tensor(x))
    assert np.array_equal(fwd.numpy(), np.asarray(_jax_fn(jntt, "fwd")(jnp.asarray(x))))
    y = rng.integers(0, q, size=(ntt.n, 2), dtype=np.int64)
    inv = ntt.inv_plain(torch.as_tensor(y))
    assert np.array_equal(inv.numpy(), np.asarray(_jax_fn(jntt, "inv")(jnp.asarray(y))))
    assert torch.equal(ntt.inv_plain(fwd), torch.as_tensor(x))
    # the last-axis forms are the kernel wrappers (plain torch on the CPU)
    assert torch.equal(ntt.fwd_last(torch.as_tensor(x.T.copy())), fwd.T)
    assert torch.equal(ntt.inv_last(torch.as_tensor(y.T.copy())), inv.T)


def test_wrappers_refuse_other_devices():
    """A wrapper runs plain torch only for a CPU tensor; other devices
    raise instead of falling back."""
    ntt = OmrContext(OmrParameters.tiny(), "cpu").ntt1
    x = torch.empty(3, ntt.n, dtype=torch.int64, device="meta")
    for fn in (ntt.fwd_last, ntt.inv_last):
        with pytest.raises(ValueError, match="no kernel"):
            fn(x)


def test_orders_equal_pallas_orders(contexts):
    """Default-ring orders are PallasNtt.orders and PallasNtt50.orders, and
    every slot k evaluates at psi**orders[k]."""
    ctx, jctx = contexts["default"]
    p1, p2 = jctx.ntt1, jctx.ntt2
    assert isinstance(p1, PallasNtt) and isinstance(p2, PallasNtt50)
    assert np.array_equal(ctx.ntt1.orders, p1.orders)
    assert np.array_equal(ctx.ntt2.orders, p2.orders)
    ntt = ctx.ntt2
    q = ntt.field.q
    coeffs = np.random.default_rng(1).integers(0, q, size=ntt.n, dtype=np.int64)
    out = ntt.fwd_last(torch.as_tensor(coeffs)).numpy()
    for k in (0, 1, 777, ntt.n - 1):
        r = pow(ntt.psi, int(ntt.orders[k]), q)
        acc = 0
        for c in coeffs[::-1]:
            acc = (acc * r + int(c)) % q
        assert acc == int(out[k])


def test_monomial_minus_one():
    """NTT(X^a) - 1 by table lookup equals the transform of X^a - 1."""
    ctx = OmrContext(OmrParameters.tiny(), "cpu")
    ntt = ctx.ntt1
    q, n = ntt.field.q, ntt.n
    amounts = torch.tensor([0, 1, 5, n, n + 3, 2 * n - 1])
    got = ntt.monomial_minus_one(amounts)
    for col, a in enumerate(amounts.tolist()):
        poly = np.zeros(n, dtype=np.int64)
        poly[0] = q - 1
        sign = 1 if a < n else -1
        poly[a % n] = (poly[a % n] + sign) % q
        want = ntt.fwd_plain(torch.as_tensor(poly))
        assert torch.equal(got[:, col], want)
