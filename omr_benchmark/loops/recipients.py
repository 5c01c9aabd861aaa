"""A closed loop of one new message at a time, detected for every recipient
a card serves: each message runs from its clues on the card through the
program's ``RecipientsDetector`` (detect under all R recipients' keys, then
every recipient's index and payload digests), all R recipients' digests to
host memory, and the addressee's ``Retriever.decode_digest``; the next
message starts when it is done, until the window's seconds have passed.

The configuration's ``recipients`` recipients: recipient 0 is the harness's
(its key made before set-up), the others are made here from the seed
(``reference_recipients.py``), each key laid out by the program and let go
before the next is made. ``distinct_messages`` one-message boards are made
in set-up and cycled, each addressed to a recipient drawn uniformly by the
seed, with a random payload. Each message's digest draws come from a numpy
stream seeded by (seed, message run): every recipient's bucket draws in one
call, then the shared weight seed, whose stream gives every recipient's
weights in one call and which each recipient draws again to decode. The
digests reach host memory through two pinned buffers.

Traffic keys: ``distinct_messages``, ``check_pairs``, ``check_recipients``,
``check_messages``, ``check_digest_recipients``.

``correct``:
* ``detect_words_off``: words of ``check_pairs`` (message run, recipient)
  pertinency ciphertexts, over at least ``check_recipients`` distinct
  recipients (each sampled run's addressee and the last recipient among
  them), that differ from the reference's detect of the same clue under
  that recipient's key, made again from the seed;
* ``digest_words_off``: words of the digests of ``check_messages`` runs
  (kept by a reservoir drawn from the seed) for ``check_digest_recipients``
  recipients each (the addressee, the last recipient, others) that differ
  from the reference's encoders over its own detect, the same draws and
  weights;
* ``boards_wrong``: runs of the window whose addressee's decode raised or
  returned a payload off in a byte, and, for the ``check_messages`` runs,
  every recipient's decode: the addressee gets its message, any other
  recipient no index unless every clue of the message decrypts to 0 under
  its clue key (the protocol's false positive).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from omr_benchmark import inputs, reference, reference_recipients
from omr_benchmark.harness import sync
from omr_benchmark.program_recipients import DECODE_ERRORS, ClueBatch, Server, weight_seed


@dataclass
class Message:
    a: torch.Tensor
    b7: torch.Tensor
    clue: torch.Tensor
    payload: np.ndarray
    addressee: int


@dataclass
class State:
    ctx: object
    server: Server | None
    omrs: list
    messages: list
    z2: list
    host: tuple  # the host buffers of every recipient's index and payload digests


def setup(ctx) -> State:
    cell = ctx.cell
    cfg, tr = cell.cfg, cell.traffic
    count = cfg["recipients"]
    omrs = [reference_recipients.recipient(ctx.omr, ctx.seed, r) for r in range(count)]

    def keys():
        yield ctx.key
        for r in range(1, count):
            yield omrs[r].detection_key()

    server = Server(cfg, keys(), count, ctx.devices[0])
    rng = np.random.default_rng([ctx.seed, 1])
    n0 = cfg["clue"]["dimension"]
    messages = []
    for addressee in rng.integers(0, count, size=tr["distinct_messages"]):
        clue = inputs.clues(omrs[int(addressee)], np.ones(1, dtype=bool))
        payload = rng.integers(0, 256, size=(1, cfg["payload_length"]), dtype=np.int64)
        messages.append(Message(clue[:, :n0].contiguous(), clue[:, n0:].contiguous(), clue[0],
                                payload, int(addressee)))
    det = server.detector
    det.warm(1)
    rp = server.layout(1, cfg["pertinent"])
    det.warm_encoders(rp, 1)
    server.retriever(rp, omrs[0].z2_ntt).warm()
    pinned = ctx.devices[0].type == "cuda"
    host = tuple(torch.empty((count, k, 2, rp.polynomial_size), dtype=torch.int64,
                             pin_memory=pinned)
                 for k in (rp.max_encode_indices_cipher_count, rp.cmb_cipher_count))
    return State(ctx, server, omrs, messages, [o.z2_ntt for o in omrs], host)


def window(state: State, seconds: float, spans) -> dict:
    ctx, server = state.ctx, state.server
    det = server.detector
    rp = server.layout(1, ctx.cell.cfg["pertinent"])
    keep = ctx.cell.traffic["check_messages"]
    pick = np.random.default_rng([ctx.seed, 4])
    count = len(state.omrs)
    index_cts, payload_cts = state.host
    pvs, decoded_all, times, kept, failed = [], [], [], [], 0
    t0 = time.perf_counter()
    while True:
        n = len(pvs)
        msg = state.messages[n % len(state.messages)]
        b0 = time.perf_counter()
        with spans.span("detect"):
            pv = det.detect(ClueBatch(msg.a, msg.b7))
        rng = np.random.default_rng([ctx.seed, 2, n])
        with spans.span("encode"):
            index_cts.copy_(det.encode_pertinent_indices(rp, pv, rng), non_blocking=True)
            digest_seed = int(rng.integers(0, 2**63))
            payload_cts.copy_(det.encode_pertinent_payloads(rp, pv, msg.payload, digest_seed),
                              non_blocking=True)
            sync(ctx.devices)
        with spans.span("decode"):
            a = msg.addressee
            try:
                decoded = server.retriever(rp, state.z2[a]).decode_digest(
                    index_cts[a], payload_cts[a], weight_seed(digest_seed, a, count))
            except DECODE_ERRORS:
                decoded = None
                failed += 1
        t = time.perf_counter()
        times.append(t - b0)
        pvs.append(pv)
        decoded_all.append(decoded)
        # a reservoir of the runs whose digests the check reads
        slot = n if n < keep else int(pick.integers(0, n + 1))
        if slot < keep:
            run = (n, index_cts.clone(), payload_cts.clone(), digest_seed)
            if slot < len(kept):
                kept[slot] = run
            else:
                kept.append(run)
        if t - t0 >= seconds:
            break
    sync(ctx.devices)
    return {"window_s": time.perf_counter() - t0, "items": len(pvs), "messages": len(pvs),
            "item_s": times, "failed": failed, "pvs": pvs, "decoded": decoded_all,
            "kept": kept}


def _wrong(msg: Message, decoded) -> bool:
    if decoded is None:
        return True
    indices, solved = decoded
    return list(indices) != [0] or not np.array_equal(np.asarray(solved), msg.payload)


def _pairs(rng: np.random.Generator, state: State, runs: int, tr: dict) -> list:
    """(run, recipient) pairs of the detect check: each sampled run with its
    addressee and with the last recipient, then the rest over a set of at
    least ``check_recipients`` recipients, each of them in a pair."""
    count = len(state.omrs)
    nb = len(state.messages)
    total = tr["check_pairs"]
    sampled = [int(r) for r in rng.integers(0, runs, size=total // 4)]
    pairs = [(r, state.messages[r % nb].addressee) for r in sampled]
    pairs += [(r, count - 1) for r in sampled]
    chosen = sorted({p[1] for p in pairs})
    for r in rng.permutation(count):
        if len(chosen) >= min(tr["check_recipients"], count):
            break
        if int(r) not in chosen:
            chosen.append(int(r))
    extra = [r for r in chosen if r not in {p[1] for p in pairs}]
    while len(pairs) < total:
        who = extra.pop() if extra else chosen[int(rng.integers(len(chosen)))]
        pairs.append((sampled[int(rng.integers(len(sampled)))], who))
    return pairs


def _words_off(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    return int((got != want).sum())


def check(state: State, record: dict) -> dict:
    ctx = state.ctx
    tr = ctx.cell.traffic
    cfg = ctx.cell.cfg
    count = len(state.omrs)
    nb = len(state.messages)
    rp = state.server.layout(1, cfg["pertinent"])
    wrong = sum(_wrong(state.messages[n % nb], d) for n, d in enumerate(record["decoded"]))

    # every recipient decodes the kept runs' digests
    for n, index_cts, payload_cts, digest_seed in record["kept"]:
        msg = state.messages[n % nb]
        for r in range(count):
            try:
                decoded = state.server.retriever(rp, state.z2[r]).decode_digest(
                    index_cts[r], payload_cts[r], weight_seed(digest_seed, r, count))
            except DECODE_ERRORS:
                decoded = None
            if r == msg.addressee:
                wrong += _wrong(msg, decoded)
            elif decoded is not None:
                wrong += bool((state.omrs[r].decrypt_clue(msg.clue) != 0).any())

    rng = np.random.default_rng([ctx.seed, 3])
    pairs = _pairs(rng, state, record["items"], tr)
    dev = state.omrs[0].device
    got = {(n, r): record["pvs"][n][r, 0].to(dev) for n, r in pairs}
    digest_checks = []
    for n, index_cts, payload_cts, digest_seed in record["kept"]:
        a = state.messages[n % nb].addressee
        others = [r for r in sorted({r for _, r in pairs}) if r not in (a, count - 1)]
        picks = [a, count - 1] + [others[int(i)] for i in rng.permutation(len(others))]
        for r in list(dict.fromkeys(picks))[:tr["check_digest_recipients"]]:
            digest_checks.append((n, r, index_cts[r], payload_cts[r], digest_seed))
    record["pvs"] = record["kept"] = None
    state.server = None
    inputs.free_cards(ctx.devices)

    lay = reference.Layout(state.omrs[0].params, 1, cfg["pertinent"])
    detect_off = digest_off = 0
    for r in sorted({r for _, r in pairs} | {c[1] for c in digest_checks}):
        omr = state.omrs[r]
        key = ctx.key if r == 0 else reference_recipients.recipient(
            ctx.omr, ctx.seed, r).detection_key()
        runs = sorted({n for n, rr in pairs if rr == r} | {c[0] for c in digest_checks
                                                          if c[1] == r})
        want = omr.detect(torch.stack([state.messages[n % nb].clue for n in runs]), key)
        by_run = dict(zip(runs, want))
        del key
        for n, rr in pairs:
            if rr == r:
                detect_off += _words_off(got[(n, r)], by_run[n])
        for n, rr, index_cts, payload_cts, digest_seed in digest_checks:
            if rr != r:
                continue
            drng = np.random.default_rng([ctx.seed, 2, n])
            base_addr = reference_recipients.bucket_draws(lay, count, drng)
            weights = reference_recipients.payload_weights(lay, int(drng.integers(0, 2**63)),
                                                           count)
            payload = torch.as_tensor(state.messages[n % nb].payload)
            index, pay = reference_recipients.digests(omr, lay, by_run[n][None], base_addr,
                                                      payload, weights, r)
            digest_off += _words_off(index_cts.to(omr.device), index)
            digest_off += _words_off(payload_cts.to(omr.device), pay)
    return {"boards_wrong": (int(wrong), 0), "detect_words_off": (detect_off, 0),
            "digest_words_off": (digest_off, 0)}
