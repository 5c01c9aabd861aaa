"""Bootstrapping primitives in plain torch: blind rotation, key switch, trace.

PyTorch counterpart of :mod:`tfhe_omr_tpu.ops.bootstrap` (its XLA paths:
``make_blind_rotate``, ``init_accumulator``, ``extract_constant_lwe``,
``make_lwe_keyswitch``, ``lwe_modulus_switch``, ``make_trace``). Same
shapes at every function — acc ``(N, 2, B)``, amounts ``(n_lwe, B)`` — and
bit-equal results.

These are the plain versions of the CUDA kernels in
:mod:`tfhe_omr_tpu_torch.ops.fused`: the CPU runs them, and the card
compares each kernel against them. They use the plain NTT
(:meth:`Ntt.fwd_plain`) so they never touch a kernel themselves.

What the TPU needed and the port drops: the monomial multiplier
``NTT(X^a) - 1`` is a lookup in the 2N-entry psi-power table
(:meth:`Ntt.monomial_minus_one`) instead of one-hot MXU dots over power
ladders, and the accumulator init is a plain gather.
"""

from __future__ import annotations

import torch

from tfhe_omr_tpu_torch.ops.decompose import SignedGadget
from tfhe_omr_tpu_torch.ops.modmath import PrimeField
from tfhe_omr_tpu_torch.ops.ntt import Ntt


def make_blind_rotate(field: PrimeField, ntt: Ntt, gadget: SignedGadget):
    """Returns the paired (BMMP) blind_rotate(acc, amounts, bsk, bsk_sh).

    acc:     (N, 2, B) int64 coefficient domain, the accumulator (a, b).
    amounts: (n_lwe, B) int64 rotation amounts in [0, 2N), n_lwe even.
    bsk:     (3*n_lwe/2, N, d, 2, 2) int64 NTT-domain RGSW keys of the pair
             messages [m10, m01, m11] (reference order), and their Shoup
             companions.

    Per step (secret-bit pair with rotations a0, a1):
    ACC <- ACC + sum_t (X^{a_t} - 1) * (ACC (x) RGSW(m_t)) with a_t in
    [a0, a1, a0 + a1].
    """
    two_n = 2 * ntt.n

    def blind_rotate(acc, amounts, bsk, bsk_sh):
        n_lwe = amounts.shape[0]
        if n_lwe % 2:
            raise ValueError("pairwise CMUX needs an even LWE dimension")
        a0, a1 = amounts[0::2], amounts[1::2]
        rot = torch.stack([a0, a1, (a0 + a1) % two_n], dim=1)  # (steps, 3, B)
        for i in range(n_lwe // 2):
            k_i = bsk[3 * i : 3 * (i + 1)]
            k_sh_i = bsk_sh[3 * i : 3 * (i + 1)]
            digs = gadget.decompose_to_field(acc, dim=1)  # (N, d, 2, B)
            dn = ntt.fwd_plain(digs)
            prod = field.mul_shoup(
                dn[None, :, :, :, None, :], k_i[..., None], k_sh_i[..., None]
            )  # (3, N, d, 2, 2, B)
            p = field.reduce(
                prod.sum(dim=(2, 3)),
                field.bits + (2 * gadget.d).bit_length() + 1,
            )  # (3, N, 2, B)
            mono = ntt.monomial_minus_one(rot[i])  # (N, 3, B)
            p = field.mul(p, mono.transpose(0, 1)[:, :, None, :])
            acc = field.add(acc, ntt.inv_plain(field.mod_sum(p, dim=0)))
        return acc

    return blind_rotate


def init_accumulator(ext_lut: torch.Tensor, b: torch.Tensor, n: int):
    """ACC init = X^{-b} * LUT: coefficient k is ext_lut[(k + b) mod 2N].

    ext_lut: (2N,) = [lut, -lut]. b: (B,) int64. Returns (N, 2, B) with the
    a-part zero.
    """
    ks = torch.arange(n, dtype=torch.int64, device=b.device)[:, None]
    acc_b = ext_lut[(ks + b[None, :]) % (2 * n)]  # (N, B)
    return torch.stack([torch.zeros_like(acc_b), acc_b], dim=1)


def extract_constant_lwe(field: PrimeField, acc):
    """Sample-extract the constant coefficient as an LWE ciphertext.

    acc: (N, 2, B). Returns (a_vec (N, B), b (B,)): a_vec[0] = A[0],
    a_vec[j] = -A[N-j].
    """
    a = acc[:, 0, :]
    a_perm = torch.cat([a[0:1], torch.flip(a[1:], dims=(0,))], dim=0)
    a_vec = torch.cat([a_perm[0:1], field.neg(a_perm[1:])], dim=0)
    return a_vec, acc[0, 1, :]


def make_lwe_keyswitch(field: PrimeField, digits: int, n_out: int):
    """Returns keyswitch(a_vec (B, n_in), b (B,), ksk_f64) -> (a, b).

    ``ksk_f64`` is the combined key matrix (digits*n_in, n_out+1) in
    DIGIT-MAJOR row order (row j*n_in + i), b-row last column, as float64.
    The product runs as a float64 matmul of the 0/1 bit matrix against the
    key: every partial sum is an integer below digits*n_in*q < 2**53, so it
    is exact in any summation order (cuBLAS has no int64 GEMM; the JAX
    package's int8 limb planes exist only for the TPU's MXU).

    A stack of R recipients' keys (R, digits*n_in, n_out+1) splits the B
    ciphertexts into R equal runs, run r switched under key r: one batched
    product, each run against its own key (one key is a stack of one).
    """

    def keyswitch(a_vec, b, ksk_f64):
        bsz, n_in = a_vec.shape
        shifts = torch.arange(digits, dtype=torch.int64, device=a_vec.device)
        bits = (a_vec[:, None, :] >> shifts[None, :, None]) & 1
        bits = bits.reshape(bsz, digits * n_in).to(torch.float64)
        ksk = ksk_f64.reshape(-1, *ksk_f64.shape[-2:])
        acc = torch.bmm(bits.reshape(ksk.shape[0], bsz // ksk.shape[0], -1), ksk)
        acc = acc.reshape(bsz, -1).to(torch.int64)
        acc = field.reduce(acc, (digits * n_in * field.q).bit_length() + 1)
        return field.neg(acc[:, :n_out]), field.sub(b, acc[:, n_out])

    return keyswitch


def lwe_modulus_switch(field: PrimeField, x, new_modulus: int):
    """y = round(x * q' / q) mod q' for a power-of-2 q'."""
    q = field.q
    y = (x * (2 * new_modulus) + q) // (2 * q)
    return y & (new_modulus - 1)


def make_trace(field: PrimeField, ntt: Ntt, gadget: SignedGadget, autos):
    """Returns trace(acc (N,2,B), trace_k, trace_k_sh) -> (N,2,B).

    EvalTr: log2(N) rounds of c <- c + KS(sigma_g(c)); the caller
    pre-multiplies by N^{-1}. ``autos`` is ``OmrContext.trace_autos``
    (host numpy (g, gidx, gsign) per round).
    """

    def trace(acc, trace_k, trace_k_sh):
        for r, (_g, gidx, gsign) in enumerate(autos):
            gi = torch.as_tensor(gidx, device=acc.device)
            gs = torch.as_tensor(gsign, device=acc.device)[:, None, None]
            auto = field.to_field(gs * acc[gi])  # (N, 2, B)
            digs = gadget.decompose_to_field(auto[:, 0, :], dim=1)  # (N,d,B)
            dn = ntt.fwd_plain(digs)
            prod = field.mul_shoup(
                dn[:, :, None, :], trace_k[r][..., None], trace_k_sh[r][..., None]
            )
            p = field.reduce(
                prod.sum(dim=1), field.bits + gadget.d.bit_length() + 1
            )  # (N, 2, B)
            pc = ntt.inv_plain(p)
            new_a = field.neg(pc[:, 0, :])
            new_b = field.sub(auto[:, 1, :], pc[:, 1, :])
            acc = field.add(acc, torch.stack([new_a, new_b], dim=1))
        return acc

    return trace
