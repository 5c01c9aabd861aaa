"""The inputs of the pinned golden vectors, drawn as the JAX package draws them.

``tests/golden/golden_vectors.npz`` pins the outputs of every layer of the
ciphertext math for inputs drawn from one numpy stream (``SEED``) in the
order of ``tests/test_golden.py compute_vectors``; only the outputs are
stored. :func:`golden_inputs` draws the same inputs in the same order, so
the port can recompute sections 1-6 without jax: through its plain torch
versions (``tests/test_torch_golden.py``) and, by :func:`through_kernels`,
through its kernels (``chip_smoke.py``; the host build of the kernels in
``tests/test_torch_host_kernels.py``). Section 7 (the tiny-preset detect) depends on the JAX
package's key masks and is not drawn here.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SEED = 20250817
PATH = Path(__file__).resolve().parents[2] / "tests" / "golden" / "golden_vectors.npz"

#: the pinned vectors sections 1-6 produce, in their order
SECTIONS = ("mul_q1", "mul_q2", "dig_g1", "dig_g2", "dig_gtr", "ntt1_fwd", "ntt1_inv",
            "ntt2_fwd", "ntt2_inv", "cmux1", "cmux2", "ks_a", "ks_b", "trace")


def golden_inputs(ctx) -> dict:
    """Every input of sections 1-6 at the reference parameters, as numpy
    arrays, keyed by section: ``mul_q1`` (a, b), ``dig_g1`` x, ``ntt1`` x
    (N, 2), ``cmux1`` (acc (N, 2, 4), amounts (2, 4), bsk (3, N, d, 2, 2)),
    ``ks`` (ksk int8 7-bit planes, a_vec (4, n1), b (4,)), ``trace`` (trace
    key (rounds, N2, d, 2), acc (N2, 2, 4)). ``ctx`` is an ``OmrContext``
    at ``OmrParameters.default()``."""
    p = ctx.params
    f1, f2 = ctx.f1, ctx.f2
    rng = np.random.default_rng(SEED)
    out = {}
    for name, f in (("q1", f1), ("q2", f2)):
        a = rng.integers(0, f.q, size=256, dtype=np.int64)
        b = rng.integers(0, f.q, size=256, dtype=np.int64)
        out[f"mul_{name}"] = (a, b)
    for name, g in (("g1", ctx.gadget_br1), ("g2", ctx.gadget_br2),
                    ("gtr", ctx.gadget_trace)):
        out[f"dig_{name}"] = rng.integers(0, g.field.q, size=256, dtype=np.int64)
    for name, ntt, f in (("ntt1", ctx.ntt1, f1), ("ntt2", ctx.ntt2, f2)):
        out[name] = rng.integers(0, f.q, size=(ntt.n, 2), dtype=np.int64)
    for name, f, ntt, g in (("cmux1", f1, ctx.ntt1, ctx.gadget_br1),
                            ("cmux2", f2, ctx.ntt2, ctx.gadget_br2)):
        n = ntt.n
        acc = rng.integers(0, f.q, size=(n, 2, 4), dtype=np.int64)
        amounts = rng.integers(0, 2 * n, size=(2, 4), dtype=np.int64)
        bsk = rng.integers(0, f.q, size=(3, n, g.d, 2, 2), dtype=np.int64)
        out[name] = (acc, amounts, bsk)
    ksp = p.first_level_ks
    limbs = -(-f1.bits // 7)
    ksk = rng.integers(0, 128, size=(limbs, p.n1 * ksp.digits, ksp.out_dimension + 1),
                       dtype=np.int8)
    a_vec = rng.integers(0, f1.q, size=(4, p.n1), dtype=np.int64)
    b = rng.integers(0, f1.q, size=(4,), dtype=np.int64)
    out["ks"] = (ksk, a_vec, b)
    rounds = len(ctx.trace_autos)
    tk = rng.integers(0, f2.q, size=(rounds, p.n2, ctx.gadget_trace.d, 2), dtype=np.int64)
    acc2 = rng.integers(0, f2.q, size=(p.n2, 2, 4), dtype=np.int64)
    out["trace"] = (tk, acc2)
    return out


#: the pins that the kernels compute, and the kernel of each
KERNEL_PINS = {"cmux1": "blind_rotate1", "cmux2": "blind_rotate2", "trace": "trace",
               "ntt1_fwd": "ntt1", "ntt1_inv": "ntt1", "ntt2_fwd": "ntt2", "ntt2_inv": "ntt2"}


def through_kernels(ctx, inputs: dict) -> dict:
    """The pins of :data:`KERNEL_PINS` recomputed through the kernel
    wrappers on ``ctx``'s device (on a card K1, K2, K3 and the NTT kernels
    K5 (q1) and K4 (q2)), as numpy arrays in the pins' layouts. Each pin's
    shape is one the kernels take as it is: 4 samples of one CMUX step (one
    block of 4 at the first level, 4 blocks of 1 at the second, or on a
    card with room 4 clusters: ops/fused.py cluster_size), 4
    messages of the trace, 2 rows of each NTT."""
    import torch

    from tfhe_omr_tpu_torch.ops.fused import BlindRotateKey, TraceKey, blind_rotate, trace

    dev = ctx.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    out = {}
    for name, f, ntt, g in (("cmux1", ctx.f1, ctx.ntt1, ctx.gadget_br1),
                            ("cmux2", ctx.f2, ctx.ntt2, ctx.gadget_br2)):
        acc, amounts, bsk = (t(a) for a in inputs[name])
        key = BlindRotateKey(bsk, f.shoup_t(bsk), ntt, g, KERNEL_PINS[name])
        res = blind_rotate(acc.permute(2, 1, 0).contiguous(), amounts, key)
        out[name] = res.permute(2, 1, 0).cpu().numpy()
    tk, acc2 = (t(a) for a in inputs["trace"])
    key = TraceKey(tk, ctx.f2.shoup_t(tk), ctx.ntt2, ctx.gadget_trace, ctx.trace_autos)
    out["trace"] = trace(acc2.permute(2, 1, 0).contiguous(), key).permute(2, 1, 0).cpu().numpy()
    for name, ntt in (("ntt1", ctx.ntt1), ("ntt2", ctx.ntt2)):
        rows = t(inputs[name]).T.contiguous()  # (2, N): the pin's two columns
        out[f"{name}_fwd"] = ntt.fwd_last(rows).T.cpu().numpy()
        out[f"{name}_inv"] = ntt.inv_last(rows).T.cpu().numpy()
    return out


def load() -> dict:
    """The pinned vectors, as numpy arrays by name."""
    with np.load(PATH) as z:
        return {k: z[k] for k in z.files}
