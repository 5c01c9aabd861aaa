"""Retriever: client-side decoding of digests into indices and payloads.

PyTorch-package counterpart of :mod:`tfhe_omr_tpu.core.retriever`
(reference ``omr_core/src/retriever.rs``):

* ``decrypt``: b - a*z2 in the NTT domain and the inverse q2 NTT, on the
  device of the recipient's key (the NTT kernel on a card); only the
  coefficient-domain result goes to the host.
* ``decode_pertinent_indices`` (``:63-130``): round each coefficient by
  p/q exactly, then scan the buckets whose flag slot decodes to 1
  (the native library; :func:`scan_buckets_numpy` is its plain reference).
* ``decode_digest`` (``:188-260``): index ciphertexts until every index
  decodes, the weight matrix regenerated from the shared seed, the combined
  payloads decrypted and the k x k system solved mod p (native library).
* ``noise_sigma_info`` (``:390-560``): decoded-noise telemetry.

The decode's steps run inside the profiler spans of
:mod:`tfhe_omr_tpu_torch.utils.spans`: ``decode``, ``decode.decrypt``,
``decode.round``, ``decode.scan``, ``decode.weights``, ``decode.solve``.
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.detector import sample_weights
from tfhe_omr_tpu_torch.core.errors import IndexDecodeError
from tfhe_omr_tpu_torch.core.matrix import solve_matrix
from tfhe_omr_tpu_torch.core.params import RetrievalParams
from tfhe_omr_tpu_torch.native import get_lib, scan_buckets_native
from tfhe_omr_tpu_torch.utils.spans import span, spanned


def scan_buckets_numpy(decoded: np.ndarray, n_seg: int, sps: int, spb: int,
                       n_buckets: int, p: int, max_index: int) -> np.ndarray:
    """Plain reference of :func:`scan_buckets_native`: the indices
    (< ``max_index``) of every bucket whose flag slot is 1, digits LSB
    first, segment-major (``retriever.rs:93-123``)."""
    usable = np.asarray(decoded[: n_seg * sps]).reshape(n_seg, sps)
    buckets = usable[:, : n_buckets * spb].reshape(n_seg, n_buckets, spb)
    found = []
    for s, b in zip(*np.nonzero(buckets[..., -1] == 1)):
        index = 0
        for d in buckets[s, b, :-1][::-1]:
            index = index * p + int(d)
        if index < max_index:
            found.append(index)
    return np.array(found, dtype=np.int64)


class Retriever:
    """The recipient's decoder; ``z2_ntt`` (N2,) is its ring key in the NTT
    domain, on the device where its decrypts run."""

    def __init__(self, params: RetrievalParams, ctx: OmrContext,
                 z2_ntt: torch.Tensor):
        self.params = params
        self.ctx = ctx
        self._z2_ntt = z2_ntt
        self.pertinent_indices_set: set[int] = set()

    def warm(self):
        """Build (or load) the native decoder library before a timed
        decode, as the reference's client is compiled ahead of time."""
        get_lib()
        return self

    # ------------------------------------------------------------- decoding
    @spanned("decode.decrypt")
    def decrypt(self, ct, plain: bool = False) -> np.ndarray:
        """NTT-domain cts (..., 2, N2) -> coefficient-domain phase b - a*z2
        mod q2 (numpy). Runs on the key's device; ``plain=True`` takes the
        plain torch inverse NTT instead of the kernel (``Ntt.inv_last``)."""
        f2, ntt2 = self.ctx.f2, self.ctx.ntt2
        if not torch.is_tensor(ct):
            ct = np.array(ct, dtype=np.int64)  # a writable host copy
        ct = torch.as_tensor(ct, dtype=torch.int64, device=self._z2_ntt.device)
        phase = f2.sub(ct[..., 1, :], f2.mul(ct[..., 0, :], self._z2_ntt))
        return ntt2.inv_last(phase, plain=plain).cpu().numpy()

    @spanned("decode.round")
    def _round_to_p(self, coeffs: np.ndarray) -> np.ndarray:
        """round_half_up(c * p / q) mod p, exactly (``retriever.rs:79-91``)."""
        q = self.ctx.f2.q
        p = int(self.params.index_modulus)
        t = (coeffs * (2 * p) + q) // (2 * q)
        return np.where(t >= p, t - p, t)

    def decode_pertinent_indices(self, ct) -> bool:
        """Accumulate indices from one index-digest ct; True when complete.

        Counterpart of ``decode_pertinent_indices`` (``retriever.rs:63-130``,
        with the flag==1 bucket scan at ``:93-123``).
        """
        rp = self.params
        decoded = self._round_to_p(self.decrypt(ct))
        sps = rp.slots_per_segment
        n_seg = rp.segment_per_cipher
        with span("decode.scan"):
            found = scan_buckets_native(
                decoded[: n_seg * sps], n_seg, sps, rp.slots_per_bucket,
                rp.bucket_count_per_segment, int(rp.index_modulus),
                rp.all_payloads_count,
            )
        self.pertinent_indices_set.update(int(i) for i in found)
        return len(self.pertinent_indices_set) == rp.pertinent_count

    def decode_combined_payloads(self, combination_cts) -> np.ndarray:
        """(cmb_cipher_count, 2, N) cts -> (combination_count, payload_len).

        Counterpart of ``decode_combined_payloads`` (``retriever.rs:318-362``).
        """
        rp = self.params
        vals = self._round_to_p(self.decrypt(combination_cts))  # (cc, N)
        plen = rp.payload_length
        per = rp.cmb_count_per_cipher
        out = np.zeros((rp.combination_count, plen), dtype=np.int64)
        for i in range(rp.combination_count):
            cipher, slot = divmod(i, per)
            out[i] = vals[cipher, slot * plen : (slot + 1) * plen]
        return out

    @spanned("decode")
    def decode_digest(self, index_cts, combination_cts, seed):
        """Full digest decode (counterpart of ``decode_digest``,
        ``retriever.rs:188-260``). Returns (sorted indices, payloads)."""
        rp = self.params
        for ct in index_cts:
            if self.decode_pertinent_indices(ct):
                break
        indices = sorted(self.pertinent_indices_set)
        if len(indices) < rp.pertinent_count:
            raise IndexDecodeError(
                f"recovered {len(indices)}/{rp.pertinent_count} indices"
            )
        with span("decode.weights"):
            weights = sample_weights(rp, seed)[: rp.combination_count]
        matrix = weights[:, indices]  # (combination_count, pertinent)
        combined = self.decode_combined_payloads(combination_cts)
        with span("decode.solve"):
            payloads = solve_matrix(matrix, combined, int(rp.index_modulus))
        return indices, payloads

    # ------------------------------------------------------------ telemetry
    def noise_sigma_info(self, combination_cts, expected_sigma: float):
        """Decoded-noise statistics (counterpart of ``NoiseSigmaInfo``,
        ``retriever.rs:390-560``): observed sigma + 1..6-sigma histogram of
        the payload digest's noise against ``expected_sigma``."""
        q = self.ctx.f2.q
        p = int(self.params.index_modulus)
        delta = (2 * q + p) // (2 * p)
        dec = self.decrypt(combination_cts)
        vals = self._round_to_p(dec)
        noise = np.mod(dec - vals * delta, q)
        signed = np.where(noise > q // 2, noise - q, noise).astype(np.float64)
        observed = float(np.sqrt(np.mean(signed**2)))
        hist = {
            k: float(np.mean(np.abs(signed) <= k * expected_sigma))
            for k in range(1, 7)
        }
        return {"expected_sigma": expected_sigma, "observed_sigma": observed,
                "sigma_hist": hist}
