"""Key generation: secrets, clue (public) key, detection key, trace key.

PyTorch counterpart of :mod:`tfhe_omr_tpu.core.keygen`.

* Every numpy draw of ``SecretKeyPack`` happens in the JAX package's order
  (secrets in ``__init__``, the clue key, then per detection key the seed
  ``rng.integers(0, 1 << 62)`` of BSK1, the KSK, the BSK2 seed and the trace
  seed), so one numpy seed gives bit-identical secrets, clue key and KSK in
  both packages.
* The masks and noise of the bootstrapping and trace keys come from a
  ``torch.Generator`` on the key's device seeded with the drawn seed. They
  cannot match the JAX package's threefry bits; decryption holds them.
* Keys stay in the JAX package's layouts and NTT slot orders (NTT domain,
  poly axis major, Shoup companions beside them), so keys made by either
  package drive either detector (:func:`detection_key_from_numpy`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.params import OmrParameters
from tfhe_omr_tpu_torch.ops.modmath import PrimeField
from tfhe_omr_tpu_torch.ops.ntt import Ntt


class DetectionKey(NamedTuple):
    """Device tensors for the detector, all int64, NTT-domain keys in the
    reference slot order (the JAX ``DetectionKey`` without the TPU's
    balanced planes)."""

    bsk1: torch.Tensor  # (3*n0/2, N1, d1, 2, 2) paired
    bsk1_sh: torch.Tensor
    ksk: torch.Tensor  # (ks_digits*N1, n_int+1) digit-major rows, b last col
    bsk2: torch.Tensor  # (3*n_int/2, N2, d2, 2, 2) paired
    bsk2_sh: torch.Tensor
    trace_k: torch.Tensor  # (rounds, N2, d_tr, 2)
    trace_k_sh: torch.Tensor

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


class ClueKey(NamedTuple):
    """Sender-facing LWE public key in RLWE mode: ``mat_a[i, k]`` is
    coefficient k of ``X^i * pk_a`` (negacyclic); ``mat_b7`` keeps the
    ``clue_count`` output coefficients of the compact ciphertext."""

    mat_a: np.ndarray  # (n0, n0) int64 mod q0
    mat_b7: np.ndarray  # (n0, clue_count) int64 mod q0
    q0: int
    noise_std: float
    clue_count: int


def _gen_secret(rng: np.random.Generator, kind: str, n: int) -> np.ndarray:
    if kind == "binary":
        return rng.integers(0, 2, size=n, dtype=np.int64)
    if kind == "ternary":
        return rng.integers(-1, 2, size=n, dtype=np.int64)
    raise ValueError(kind)


def _device_uniform(gen: torch.Generator, shape, q: int) -> torch.Tensor:
    """Uniform field elements on the generator's device."""
    return torch.randint(0, q, shape, generator=gen, device=gen.device,
                         dtype=torch.int64)


def _device_gaussian(gen: torch.Generator, shape, sigma: float, q: int):
    """Rounded Gaussian noise mapped into [0, q); sigma == 0 is noise-free."""
    if sigma == 0.0:
        return torch.zeros(shape, dtype=torch.int64, device=gen.device)
    e = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float64)
    return torch.remainder(torch.round(e * sigma).to(torch.int64), q)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _pair_bits(sk: np.ndarray) -> np.ndarray:
    """(n,) binary secret -> (3*n/2,) pair messages [m10, m01, m11]."""
    assert len(sk) % 2 == 0
    s0 = sk[0::2]
    s1 = sk[1::2]
    return np.stack([s0 * (1 - s1), s1 * (1 - s0), s0 * s1], axis=1).reshape(-1)


def _negacyclic_matrix(poly: np.ndarray, q: int) -> np.ndarray:
    """M[i, k] = coefficient k of X^i * poly mod (X^n + 1, q)."""
    n = len(poly)
    m = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        m[i, i:] = poly[: n - i]
        if i:
            m[i, :i] = np.mod(-poly[n - i :], q)
    return m


class SecretKeyPack:
    """All four secrets plus derivation of every public/evaluation key.

    ``ctx`` fixes the device: key generation runs there (the NTTs through
    the card's kernels when it is a CUDA device). With no ``ctx`` the pack
    builds ``OmrContext(params)``, which takes the card and raises where
    there is none.
    """

    def __init__(self, params: OmrParameters,
                 rng: np.random.Generator | int | None = None,
                 ctx: OmrContext | None = None):
        if rng is None or isinstance(rng, (int, np.integer)):
            rng = np.random.default_rng(rng)
        p = params
        clue_sk = _gen_secret(rng, p.clue_params.secret_type, p.clue_params.dimension)
        inter_sk = _gen_secret(
            rng, p.intermediate_lwe.secret_type, p.intermediate_lwe.dimension
        )
        z1 = _gen_secret(rng, p.first_level_br.secret_type, p.n1)
        z2 = _gen_secret(rng, p.second_level_br.secret_type, p.n2)
        self._set_secrets(params, ctx, rng, clue_sk, inter_sk, z1, z2)

    def _set_secrets(self, params, ctx, rng, clue_sk, inter_sk, z1, z2):
        self.params = params
        self.ctx = ctx if ctx is not None else OmrContext(params)
        self.device = self.ctx.device
        self.rng = rng
        c = self.ctx
        self.clue_sk = np.asarray(clue_sk, dtype=np.int64)
        self.inter_sk = np.asarray(inter_sk, dtype=np.int64)
        self.z1 = np.asarray(z1, dtype=np.int64)
        self.z2 = np.asarray(z2, dtype=np.int64)
        self.z1_f = np.mod(self.z1, c.f1.q).astype(np.int64)
        self.z2_f = np.mod(self.z2, c.f2.q).astype(np.int64)
        self.z1_ntt = c.ntt1.fwd_last(self._dev(self.z1_f))
        self.z2_ntt = c.ntt2.fwd_last(self._dev(self.z2_f))

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.device)

    # ------------------------------------------------------------- clue key
    def generate_clue_key(self) -> ClueKey:
        """LWE public key in RLWE mode (reference ``secret.rs:98-106``)."""
        p = self.params.clue_params
        n, q0 = p.dimension, p.cipher_modulus
        rng = self.rng
        pk_a = rng.integers(0, q0, size=n, dtype=np.int64)
        e = np.rint(rng.normal(0, p.noise_std, size=n)).astype(np.int64)
        conv = _negacyclic_matrix(pk_a, q0)
        pk_b = np.mod(self.clue_sk @ conv + e, q0)
        return ClueKey(
            mat_a=conv,
            mat_b7=_negacyclic_matrix(pk_b, q0)[:, : self.params.clue_count].copy(),
            q0=q0,
            noise_std=p.noise_std,
            clue_count=self.params.clue_count,
        )

    # -------------------------------------------------------- detection key
    def generate_detection_key(self) -> DetectionKey:
        """BSK1, KSK, BSK2 and trace key (reference ``secret.rs:118-178``)."""
        c = self.ctx
        p = self.params
        rng = self.rng
        bsk1, bsk1_sh = self._gen_bsk(
            _pair_bits(self.clue_sk), self.z1_f, self.z1_ntt, c.f1, c.ntt1,
            c.gadget_br1.gadget_values(), p.first_level_br.noise_std, rng,
        )
        ksk = self._dev(self._gen_ksk(rng))
        bsk2, bsk2_sh = self._gen_bsk(
            _pair_bits(self.inter_sk), self.z2_f, self.z2_ntt, c.f2, c.ntt2,
            c.gadget_br2.gadget_values(), p.second_level_br.noise_std, rng,
        )
        trace_k, trace_k_sh = self._gen_trace_key(rng)
        return DetectionKey(bsk1, bsk1_sh, ksk, bsk2, bsk2_sh, trace_k, trace_k_sh)

    def _gen_bsk(self, msgs, z_f, z_ntt, field: PrimeField, ntt: Ntt, h,
                 noise_std, rng):
        """RGSW encryptions of each pair message under the ring key, in
        layout (n, N, d, c, o): c=0 rows encrypt -h_j * z * m (paired with
        a-part digits), c=1 rows h_j * m (b-part digits). Counterpart of
        ``_BskPrograms.bsk_prog``."""
        f = field
        q = f.q
        seed = int(rng.integers(0, 1 << 62))
        gen = _generator(self.device, seed)
        n, d, big_n = len(msgs), len(h), ntt.n
        shape = (n, 2, d, big_n)
        a = _device_uniform(gen, shape, q)
        e = _device_gaussian(gen, shape, float(noise_std), q)
        hs = self._dev((h[None, :] * np.asarray(msgs)[:, None]) % q)  # (n, d)
        mu_c0 = f.mul(((q - hs) % q)[:, :, None], self._dev(z_f)[None, None, :])
        mu_c1 = torch.zeros_like(mu_c0)
        mu_c1[:, :, 0] = hs
        payload = ntt.fwd_last(f.add(torch.stack([mu_c0, mu_c1], dim=1), e))
        b = f.add(f.mul(a, z_ntt), payload)
        kst = torch.stack([a, b], dim=-1).permute(0, 3, 2, 1, 4).contiguous()
        return kst, f.shoup_t(kst)

    def _gen_ksk(self, rng) -> np.ndarray:
        """LWE key switch z1 -> s2 with binary digits (host numpy, the JAX
        package's draws). Returns the combined (digits*n_in, n_out+1) key
        matrix in DIGIT-MAJOR row order (row j*n_in + i), b-row last."""
        c = self.ctx
        ks = self.params.first_level_ks
        f = c.f1
        q = f.q
        n_in, n_out, digits = ks.in_dimension, ks.out_dimension, ks.digits
        assert ks.log_basis == 1, "key switch uses binary digits"
        s_in = np.mod(self.z1, q).astype(np.int64)
        s_out = self.inter_sk
        a = rng.integers(0, q, size=(n_in, digits, n_out), dtype=np.int64)
        e = f.gaussian(rng, ks.noise_std, (n_in, digits))
        h = (np.int64(1) << np.arange(digits, dtype=np.int64)) % q
        asum = np.mod(a.reshape(-1, n_out) @ s_out, q).reshape(n_in, digits)
        b = np.mod(asum + e + np.mod(h[None, :] * s_in[:, None], q), q)
        return np.concatenate(
            [
                a.transpose(1, 0, 2).reshape(digits * n_in, n_out),
                b.T.reshape(digits * n_in, 1),
            ],
            axis=1,
        )

    def _gen_trace_key(self, rng):
        """Automorphism key-switching keys for EvalTr: gadget RLWE
        encryptions of h_j * sigma_g(z2) under z2, layout (rounds, N, d, o)."""
        c = self.ctx
        f = c.f2
        q = f.q
        h = c.gadget_trace.gadget_values()
        sig = np.stack(
            [np.mod(gsign * self.z2_f[gidx], q) for _g, gidx, gsign in c.trace_autos]
        )
        seed = int(rng.integers(0, 1 << 62))
        gen = _generator(self.device, seed)
        shape = (sig.shape[0], len(h), c.params.n2)
        a = _device_uniform(gen, shape, q)
        e = _device_gaussian(gen, shape, float(self.params.trace.noise_std), q)
        mu = f.mul(self._dev(h)[None, :, None], self._dev(sig)[:, None, :])
        payload = c.ntt2.fwd_last(f.add(mu, e))
        b = f.add(f.mul(a, self.z2_ntt), payload)
        kst = torch.stack([a, b], dim=-1).permute(0, 2, 1, 3).contiguous()
        return kst, f.shoup_t(kst)

    # ------------------------------------------------------------ factories
    def generate_sender(self):
        from tfhe_omr_tpu_torch.core.sender import Sender

        return Sender(self.generate_clue_key(), self.params, self.device)

    def generate_detector(self):
        from tfhe_omr_tpu_torch.core.detector import Detector

        return Detector(self.generate_detection_key(), self.ctx)

    def generate_retriever(self, all_payloads_count: int, pertinent_count: int):
        """The recipient's decoder for a board of ``all_payloads_count``
        messages, ``pertinent_count`` of them its own; decrypts on the
        pack's device."""
        from tfhe_omr_tpu_torch.core.params import RetrievalParams
        from tfhe_omr_tpu_torch.core.retriever import Retriever

        rp = RetrievalParams.for_params(
            self.params, all_payloads_count, pertinent_count
        )
        return Retriever(rp, self.ctx, self.z2_ntt)

    def size_bytes(self) -> int:
        """Secret material byte count (counterpart of the ``Size`` impl,
        reference ``key_gen/secret.rs:279-289``: clue + z1 + s2 + z2)."""
        p = self.params
        return (
            p.clue_params.dimension * 2
            + p.n1 * 4
            + p.intermediate_lwe.dimension * 2
            + p.n2 * 8
        )

    def z2_size(self) -> int:
        """z2 key size in bytes (``secret.rs`` ``z2_size``)."""
        return self.params.n2 * 8

    # ---------------------------------------------------------- decryption
    def decrypt_clue(self, a_vec: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Decrypt extracted clue LWE ciphertext(s) to Z_t."""
        p = self.params.clue_params
        q0, t = p.cipher_modulus, p.plain_modulus
        phase = np.mod(b - a_vec @ self.clue_sk, q0)
        return np.mod((phase * t * 2 + q0) // (2 * q0), t)

    def decrypt_compact_clue(self, a_row: np.ndarray,
                             b7_row: np.ndarray) -> np.ndarray:
        """Extract + decrypt all ``clue_count`` LWE samples of ONE compact
        clue ciphertext; the detector flags a message iff every value
        returned here is 0."""
        idx, neg = self.ctx.clue_extract_tables
        q0 = self.params.clue_params.cipher_modulus
        a_row = np.asarray(a_row, dtype=np.int64)
        a_ext = np.mod(np.where(neg == 1, -a_row[idx], a_row[idx]), q0)
        return self.decrypt_clue(a_ext, np.asarray(b7_row, dtype=np.int64))

    def decrypt_rlwe2_ntt(self, ct) -> np.ndarray:
        """Decrypt NTT-domain second-level RLWE cts (B, 2, N2), reference
        slot order, -> plaintext coefficients mod q2 (numpy)."""
        c = self.ctx
        ct = torch.as_tensor(np.asarray(ct) if not torch.is_tensor(ct) else ct)
        ct = ct.to(device=self.device, dtype=torch.int64)
        phase = c.f2.sub(ct[..., 1, :], c.f2.mul(ct[..., 0, :], self.z2_ntt))
        return c.ntt2.inv_last(phase).cpu().numpy()


class KeyGen:
    """Entry point (counterpart of ``KeyGen``, reference ``key_gen/mod.rs``)."""

    @staticmethod
    def generate_secret_key(params: OmrParameters, rng=None,
                            ctx: OmrContext | None = None) -> SecretKeyPack:
        return SecretKeyPack(params, rng, ctx)


def secret_key_pack_from_numpy(params: OmrParameters, clue_sk, inter_sk, z1,
                               z2, ctx: OmrContext | None = None) -> SecretKeyPack:
    """A pack holding given secrets (e.g. a JAX ``SecretKeyPack``'s), for
    decrypting under keys made elsewhere."""
    skp = SecretKeyPack.__new__(SecretKeyPack)
    skp._set_secrets(params, ctx, np.random.default_rng(), clue_sk, inter_sk,
                     z1, z2)
    return skp


def detection_key_from_numpy(bsk1, ksk_limbs, bsk2, trace_k, ctx: OmrContext,
                             device=None) -> DetectionKey:
    """The port's DetectionKey from the JAX ``DetectionKey`` fields as numpy
    arrays: NTT-domain keys already in the reference orders, and the KSK as
    int8 7-bit planes, rebuilt here as sum_k planes[k] << 7k. Shoup
    companions are computed on ``device`` (default: the context's)."""
    dev = torch.device(device) if device is not None else ctx.device

    def t(a):
        return torch.as_tensor(np.asarray(a).astype(np.int64), device=dev)

    b1, b2, tk = t(bsk1), t(bsk2), t(trace_k)
    return DetectionKey(
        bsk1=b1, bsk1_sh=ctx.f1.shoup_t(b1), ksk=t(ksk_from_planes(ksk_limbs)),
        bsk2=b2, bsk2_sh=ctx.f2.shoup_t(b2),
        trace_k=tk, trace_k_sh=ctx.f2.shoup_t(tk),
    )


def ksk_from_planes(planes) -> np.ndarray:
    """The key-switching matrix of the JAX package's int8 7-bit limb planes
    (limbs, rows, cols): sum_k planes[k] << 7k, int64."""
    planes = np.asarray(planes).astype(np.int64)
    return sum(planes[k] << (7 * k) for k in range(planes.shape[0]))
