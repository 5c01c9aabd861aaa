"""The digest encoders' chunk work: plaintext rows and multiply-accumulate.

For a chunk of B messages and K digests (the 28 payload digests at once, or
one index digest) the encoders build the (K, B, N2) plaintext rows, take
them to the NTT domain in one K4 launch (``Ntt.fwd_last``) and add
``sum_m pert[m] * NTT(plain[k, m]) mod q2`` into each digest. For R
recipients at once (``core/detector.py RecipientsDetector``) each of the
three is still one launch: the rows of every recipient's digests are built
and transformed together, and ``encode_mac`` sums each recipient's
pertinency against its own rows (``sets``).

Wrappers of ``csrc/encode.cu``: a CPU tensor runs the plain torch version,
a CUDA tensor launches the kernel or raises; ``plain=True`` runs the plain
version on any device (``build.runs_plain``). Each launch adds one to
``build.LAUNCHES["encode_mac"]``, ``["encode_payload_plain"]`` or
``["encode_index_plain"]``.

These kernels replace no TPU kernel: the JAX package leaves this product to
XLA (``Detector._encode_chunk_jit``). It is bound by bytes; ``encode_mac``
sums every digest of a chunk in one launch, keeps the sums in registers
and reads each pertinency word from device memory once a chunk, where the
plain version is some 35 elementwise int64 passes over (B, 2, N2) a digest.
"""

from __future__ import annotations

import math

import torch

from tfhe_omr_tpu_torch.ops.modmath import PrimeField
from tfhe_omr_tpu_torch.utils import build

#: blocks an SM takes of the plaintext builds (a block a row, grid-stride)
BUILD_BLOCKS_PER_SM = 8


def _centre(v: torch.Tensor, idx_p: int, q2: int) -> torch.Tensor:
    """Residues mod p in [0, p) -> centred representatives mod q2."""
    return torch.where(v < (idx_p + 1) >> 1, v, q2 - idx_p + v)


def index_poly_device(base_addr: torch.Tensor, idx: torch.Tensor, nd: int,
                      n2v: int, idx_p: int, q2: int) -> torch.Tensor:
    """Index plaintext polys (B, N2), centred mod q, on ``idx``'s device
    (the plain version of :func:`index_plaintexts`).

    For each message: write the ``nd`` base-p digits of ``idx`` (LSB first)
    and a flag 1 into the drawn bucket's slots of every segment
    (``base_addr`` (B, segs) holds each bucket's first slot; counterpart
    of ``detector.rs:271-323``). The slots of one message never collide,
    so a scatter gives the integers of the JAX package's one-hot slot sums.
    """
    poly = torch.zeros((idx.shape[0], n2v), dtype=torch.int64, device=idx.device)
    segs = base_addr.shape[1]
    v = idx
    for k in range(nd + 1):
        if k < nd:
            val = _centre(v % idx_p, idx_p, q2)
            v = v // idx_p
        else:
            val = torch.ones_like(idx)  # flag slot
        poly.scatter_(1, base_addr + k, val[:, None].expand(-1, segs))
    return poly


def payload_plain_device(payloads: torch.Tensor, weights: torch.Tensor,
                         n2v: int, idx_p: int, q2: int) -> torch.Tensor:
    """Weighted-payload plaintext polys (K, B, N2), centred mod q, of K
    combination ciphertexts (the plain version of
    :func:`payload_plaintexts`): in digest k combination c fills slots
    [c*plen, (c+1)*plen) (``detector.rs:412-433``). payloads (B, plen),
    weights (K, cmb, B)."""
    kct, cmb, bsz = weights.shape
    plen = payloads.shape[1]
    poly = torch.zeros((kct, bsz, n2v), dtype=torch.int64, device=payloads.device)
    for k in range(kct):
        wp = (payloads[None, :, :] * weights[k, :, :, None]) % idx_p  # (cmb, B, plen)
        poly[k, :, : cmb * plen] = _centre(wp, idx_p, q2).permute(1, 0, 2).reshape(
            bsz, cmb * plen)
    return poly


def encode_mac_plain(field: PrimeField, pert: torch.Tensor, pn: torch.Tensor,
                     acc: torch.Tensor) -> torch.Tensor:
    """acc[k] + sum over m of pert[m] * pn[k, m] mod q: pert (B, 2, N), pn
    (K, B, N) NTT-domain plaintexts, acc (K, 2, N); one digest at a time."""
    return torch.stack([
        field.add(acc[k], field.mod_sum(field.mul(pert, pn[k][:, None, :]), dim=0))
        for k in range(pn.shape[0])])


def _blocks(t: torch.Tensor, rows: int) -> int:
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return max(1, min(rows, BUILD_BLOCKS_PER_SM * sms))


def encode_mac(field: PrimeField, pert: torch.Tensor, pn: torch.Tensor,
               acc: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """:func:`encode_mac_plain` for all K digests of a chunk: the plain
    version on a CPU tensor or with ``plain=True``, else one launch of the
    ``csrc/encode.cu`` kernel instantiated for ``field.q`` (another q
    raises). With a leading axis of R sets on all three, pert (R, B, 2, N),
    pn (R, K, B, N), acc (R, K, 2, N), each set's digests take its own rows,
    still in one launch."""
    lead = tuple(pn.shape[:-3])  # (R,) with R sets, else ()
    if build.runs_plain(pert, plain):
        if lead:
            return torch.stack([encode_mac_plain(field, pert[r], pn[r], acc[r])
                                for r in range(lead[0])])
        return encode_mac_plain(field, pert, pn, acc)
    kct, rows, n = pn.shape[-3:]
    if (tuple(pert.shape) != (*lead, rows, 2, n) or tuple(acc.shape) != (*lead, kct, 2, n)
            or not (pert.is_contiguous() and pn.is_contiguous() and acc.is_contiguous())):
        raise ValueError(f"encode_mac: pert {tuple(pert.shape)}, pn {tuple(pn.shape)}, "
                         f"acc {tuple(acc.shape)}, each contiguous")
    lib = build.library()
    if lib.omr_encode_mac_field(field.q):
        raise ValueError(f"no encode_mac kernel is instantiated for q = {field.q}")
    build.require_cuda("encode_mac", pert, pn, acc)
    out = torch.empty_like(acc)
    with torch.cuda.device(pert.device):
        rc = lib.omr_encode_mac(build.ptr(pert), build.ptr(pn), build.ptr(acc),
                                build.ptr(out), rows, kct, n, field.q,
                                build.stream_of(pert), lead[0] if lead else 1)
    build.check(lib, rc, "encode_mac")
    build.LAUNCHES["encode_mac"] += 1
    return out


def _out(out, shape, like: torch.Tensor) -> torch.Tensor:
    """``out`` (a contiguous buffer of at least the words of ``shape``,
    held by the caller) viewed as ``shape``, or a new tensor."""
    numel = math.prod(shape)
    if out is None:
        return torch.empty(shape, dtype=torch.int64, device=like.device)
    if out.numel() < numel or not out.is_contiguous() or out.dtype != torch.int64:
        raise ValueError(f"out: {out.numel()} {out.dtype} words for {tuple(shape)}")
    return out.reshape(-1)[:numel].view(shape)


def payload_plaintexts(payloads: torch.Tensor, weights: torch.Tensor, n2: int,
                       idx_p: int, q2: int, plain: bool = False, out=None) -> torch.Tensor:
    """:func:`payload_plain_device` in one launch on a card: payloads (B,
    plen) contiguous, weights (K, cmb, B) with neighbouring messages
    neighbouring (a column slice of the board's weights); written into the
    front of ``out`` where one is given (on a card)."""
    if build.runs_plain(payloads, plain):
        return payload_plain_device(payloads, weights, n2, idx_p, q2)
    kct, cmb, rows = weights.shape
    if (payloads.shape[0] != rows or weights.device != payloads.device
            or weights.dtype != torch.int64 or weights.stride(2) != 1):
        raise ValueError(f"payload_plaintexts: payloads {tuple(payloads.shape)} on "
                         f"{payloads.device}, weights {tuple(weights.shape)} on "
                         f"{weights.device}, strides {weights.stride()}, {weights.dtype}")
    out = _out(out, (kct, rows, n2), payloads)
    build.require_cuda("encode_payload_plain", payloads, out)
    lib = build.library()
    with torch.cuda.device(payloads.device):
        rc = lib.omr_encode_payload_plain(
            build.ptr(payloads), build.ptr(weights), weights.stride(0), weights.stride(1),
            build.ptr(out), rows, kct, cmb, payloads.shape[1], n2, idx_p, q2,
            _blocks(payloads, kct * rows), build.stream_of(payloads))
    build.check(lib, rc, "encode_payload_plain")
    build.LAUNCHES["encode_payload_plain"] += 1
    return out


def index_plaintexts(base_addr: torch.Tensor, lo: int, nd: int, n2: int, idx_p: int,
                     q2: int, plain: bool = False, out=None,
                     period: int | None = None) -> torch.Tensor:
    """The index plaintext polys (B, N2) of the messages ``lo .. lo + B`` of
    a board (:func:`index_poly_device`), in one launch on a card:
    ``base_addr`` (B, segs) their rows of the bucket draws; written into the
    front of ``out`` where one is given (on a card). With ``period``, the
    rows are B / period digests' rows of the messages ``lo .. lo + period``
    one after another (row b is message ``lo + b % period``): every digest
    of several recipients in one launch."""
    rows = base_addr.shape[0]
    period = period or max(rows, 1)
    if build.runs_plain(base_addr, plain):
        idx = torch.arange(rows, dtype=torch.int64, device=base_addr.device) % period + lo
        return index_poly_device(base_addr, idx, nd, n2, idx_p, q2)
    out = _out(out, (rows, n2), base_addr)
    build.require_cuda("encode_index_plain", base_addr, out)
    lib = build.library()
    with torch.cuda.device(base_addr.device):
        rc = lib.omr_encode_index_plain(
            build.ptr(base_addr), lo, build.ptr(out), rows, base_addr.shape[1], nd, n2,
            idx_p, q2, _blocks(base_addr, rows), build.stream_of(base_addr), period)
    build.check(lib, rc, "encode_index_plain")
    build.LAUNCHES["encode_index_plain"] += 1
    return out
