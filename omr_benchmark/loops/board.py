"""A closed loop of whole boards, one recipient: each board runs from its
clues on the card to decoded indices and payloads on the host (detect in
batches, every redundant index digest, the payload digests,
``Retriever.decode_digest``), and the next board starts when it is done,
until the window's seconds have passed. This is ``run_board`` of the
program's ``examples/omr_torch.py``, frozen here; its synchronisation
after every stage happens in the traced run only, inside the spans.

A board holds the configuration's ``board_messages`` a card (over
several cards, one ``ShardedDetector`` in one process splits it, detects
each card's rows there and reduces the partial digests exactly) with
``pertinent`` of them the recipient's, at random places, and random byte
payloads; ``distinct_boards`` of them are made in set-up and cycled. Each
board's digest draws come from a numpy stream seeded by (seed, board run).

Traffic keys: ``distinct_boards``, ``detect_batch``, ``check_rows``,
``check_digest_runs``.

``correct``:
* ``boards_wrong``: boards of the window whose decode raised, missed a
  true index, returned a payload that differs in a byte, or returned an
  extra index whose clues do not all decrypt to 0 under the recipient's
  key (an extra that does is the protocol's false positive);
* ``detect_words_off``: words of a sample of the window's pertinency
  ciphertexts (drawn from the seed, a quarter of them the recipient's)
  that differ from the reference's detect of the same clues;
* ``digest_words_off``: words of the index and payload digests of boards
  drawn from the seed that differ from the reference encoders' over the
  same draws and weights. Where a board holds no more messages than
  ``check_rows``, the reference detects each drawn board whole itself and
  encodes its own stack (the program's stack is then compared whole under
  ``detect_words_off``); on larger boards it encodes the program's stack,
  which the detect sample checks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from omr_benchmark import inputs, reference
from omr_benchmark.harness import sync
from omr_benchmark.program import DECODE_ERRORS, ClueBatch, Server


@dataclass
class Board:
    a: torch.Tensor
    b7: torch.Tensor
    clues: torch.Tensor
    payloads: np.ndarray
    truth: list


@dataclass
class State:
    ctx: object
    server: Server | None
    boards: list
    total: int
    pertinent: int


def setup(ctx) -> State:
    cell = ctx.cell
    cfg, tr = cell.cfg, cell.traffic
    total = cfg["board_messages"] * cell.chips
    k = cfg["pertinent"]
    rng = np.random.default_rng([ctx.seed, 1])
    n0 = cfg["clue"]["dimension"]
    boards = []
    for _ in range(tr["distinct_boards"]):
        mask = inputs.pertinent_mask(rng, total, k, total)
        clues = inputs.clues(ctx.omr, mask)
        payloads = rng.integers(0, 256, size=(total, cfg["payload_length"]), dtype=np.int64)
        boards.append(Board(clues[:, :n0].contiguous(), clues[:, n0:].contiguous(), clues,
                            payloads, np.nonzero(mask)[0].tolist()))
    server = Server(cfg, ctx.key, ctx.omr.z2_ntt, ctx.devices)
    batch = tr["detect_batch"]
    server.runner.warm(min(total, batch * len(ctx.devices)))
    rp = server.layout(total, k)
    server.runner.warm_encoders(rp, total)
    server.retriever(rp).warm()
    return State(ctx, server, boards, total, k)


def _detect(server: Server, board: Board, total: int, batch: int):
    if server.sharded:
        return server.runner.detect(ClueBatch(board.a, board.b7), batch)
    det = server.detector
    pv = torch.empty((total, 2, det.ctx.params.n2), dtype=torch.int64, device=det.device)
    for s in range(0, total, batch):
        e = min(s + batch, total)
        pv[s:e] = det.detect(ClueBatch(board.a[s:e], board.b7[s:e]))
    return pv


def window(state: State, seconds: float, spans) -> dict:
    ctx, server = state.ctx, state.server
    runner, batch = server.runner, ctx.cell.traffic["detect_batch"]
    rp = server.layout(state.total, state.pertinent)
    runs, times, failed = [], [], 0
    t0 = time.perf_counter()
    while True:
        n = len(runs)
        board = state.boards[n % len(state.boards)]
        b0 = time.perf_counter()
        with spans.span("detect"):
            pv = _detect(server, board, state.total, batch)
        rng = np.random.default_rng([ctx.seed, 2, n])
        with spans.span("encode"):
            index_cts = [runner.encode_pertinent_indices(rp, pv, rng)
                         for _ in range(rp.max_encode_indices_cipher_count)]
            digest_seed = int(rng.integers(0, 2**63))
            payload_cts = runner.encode_pertinent_payloads(rp, pv, board.payloads, digest_seed)
        with spans.span("decode"):
            try:
                decoded = server.retriever(rp).decode_digest(index_cts, payload_cts,
                                                             digest_seed)
            except DECODE_ERRORS:
                decoded = None
                failed += 1
        t = time.perf_counter()
        times.append(t - b0)
        runs.append((pv, index_cts, payload_cts, decoded))
        if t - t0 >= seconds:
            break
    sync(ctx.devices)
    return {"window_s": time.perf_counter() - t0, "items": len(runs),
            "messages": len(runs) * state.total, "item_s": times, "failed": failed,
            "runs": runs}


def _wrong(omr: reference.Omr, board: Board, decoded) -> bool:
    if decoded is None:
        return True
    indices, solved = decoded
    if set(board.truth) - set(indices):
        return True
    if not np.array_equal(np.asarray(solved), board.payloads[indices]):
        return True
    extras = sorted(set(indices) - set(board.truth))
    return any(bool((omr.decrypt_clue(board.clues[i]) != 0).any()) for i in extras)


def _row(pv, row: int) -> torch.Tensor:
    """Row ``row`` of a pertinency stack: a tensor, or the parts of a
    ``ShardedDetector``'s ``RankRows`` (each on its card)."""
    if torch.is_tensor(pv):
        return pv[row]
    lo = pv.lo
    for part in pv.parts:
        if row < lo + part.shape[0]:
            return part[row - lo]
        lo += part.shape[0]
    raise IndexError(row)


def _stack(pv, device) -> torch.Tensor:
    if torch.is_tensor(pv):
        return pv.to(device)
    return torch.cat([p.to(device) for p in pv.parts])


def _words_off(got: torch.Tensor, want: torch.Tensor) -> int:
    """Words of ``want`` that ``got`` misses: all of them where the shapes
    differ (a digest left out, or one too many)."""
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    return int((got != want).sum())


def check(state: State, record: dict) -> dict:
    ctx, omr = state.ctx, state.ctx.omr
    tr = ctx.cell.traffic
    dev = omr.device
    runs = record["runs"]
    nb = len(state.boards)
    wrong = sum(_wrong(omr, state.boards[n % nb], r[3]) for n, r in enumerate(runs))

    rng = np.random.default_rng([ctx.seed, 3])
    picks = inputs.sample_rows(rng, len(runs), state.total,
                               [state.boards[n % nb].truth for n in range(len(runs))],
                               tr["check_rows"])
    got = torch.stack([_row(runs[r][0], row).to(dev) for r, row in picks])
    clues = torch.stack([state.boards[r % nb].clues[row] for r, row in picks])
    chosen = sorted(int(r) for r in rng.choice(len(runs), min(len(runs), tr["check_digest_runs"]),
                                               replace=False))
    digests = {r: (_stack(runs[r][0], dev), torch.stack(runs[r][1]).to(dev),
                   runs[r][2].to(dev)) for r in chosen}
    record["runs"] = runs = None
    state.server = None
    inputs.free_cards(ctx.devices)

    key = ctx.key
    detect_off = int((got != omr.detect(clues, key)).sum())
    if state.total <= tr["check_rows"]:
        whole = omr.detect(torch.cat([state.boards[r % nb].clues for r in chosen]), key)
        for r, pv in zip(chosen, whole.split(state.total)):
            detect_off += _words_off(digests[r][0], pv)
            digests[r] = (pv, *digests[r][1:])
    lay = reference.Layout(omr.params, state.total, state.pertinent)
    digest_off = 0
    for r, (pv, index_cts, payload_cts) in digests.items():
        drng = np.random.default_rng([ctx.seed, 2, r])
        want = torch.stack([
            omr.index_digest(lay, pv, torch.as_tensor(reference.bucket_draws(lay, drng),
                                                      device=dev))
            for _ in range(lay.index_cts)])
        digest_off += _words_off(index_cts, want)
        weights = torch.as_tensor(reference.payload_weights(lay, int(drng.integers(0, 2**63))),
                                  device=dev)
        payloads = torch.as_tensor(state.boards[r % nb].payloads, device=dev)
        digest_off += _words_off(payload_cts, omr.payload_digests(lay, pv, payloads, weights))
    return {"boards_wrong": (int(wrong), 0), "detect_words_off": (detect_off, 0),
            "digest_words_off": (digest_off, 0)}
