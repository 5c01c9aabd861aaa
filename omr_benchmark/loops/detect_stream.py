"""Detection streamed: batches of a board's clues go back to back through
``Detector.detect``, the next batch queued while this one runs, until the
window's seconds have passed; one synchronisation closes the window.

Traffic keys: ``batch`` (messages a detect), ``distinct_batches`` (the
pool of distinct clues, cycled), ``pertinent`` of every ``per_messages``
clues the recipient's, ``check_rows`` (answers the reference works out
again).

``correct``: ``detect_words_off``, the words of a sample of the window's
pertinency ciphertexts (drawn from the seed, a quarter of them the
recipient's) that differ from the reference's detect of the same clues.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from omr_benchmark import inputs
from omr_benchmark.harness import sync
from omr_benchmark.program import ClueBatch, Server


@dataclass
class State:
    ctx: object
    server: Server | None
    pool: torch.Tensor
    mask: np.ndarray
    batches: list


def setup(ctx) -> State:
    tr, cfg = ctx.cell.traffic, ctx.cell.cfg
    if ctx.cell.chips != 1:
        raise ValueError("detect_stream runs one Detector on one card")
    batch = tr["batch"]
    total = batch * tr["distinct_batches"]
    mask = inputs.pertinent_mask(np.random.default_rng([ctx.seed, 1]), total,
                                 tr["pertinent"], tr["per_messages"])
    pool = inputs.clues(ctx.omr, mask)
    n0 = cfg["clue"]["dimension"]
    batches = [ClueBatch(pool[s:s + batch, :n0].contiguous(), pool[s:s + batch, n0:].contiguous())
               for s in range(0, total, batch)]
    server = Server(cfg, ctx.key, ctx.omr.z2_ntt, ctx.devices)
    server.detector.warm(batch)
    return State(ctx, server, pool, mask, batches)


def window(state: State, seconds: float, spans) -> dict:
    det = state.server.detector
    outs, prev = [], None
    t0 = time.perf_counter()
    while True:
        outs.append(det.detect(state.batches[len(outs) % len(state.batches)]))
        mark = inputs.Waiter(det.device)
        if prev is not None:
            prev.wait()
        prev = mark
        if time.perf_counter() - t0 >= seconds:
            break
    sync(state.ctx.devices)
    t1 = time.perf_counter()
    batch = state.ctx.cell.traffic["batch"]
    return {"window_s": t1 - t0, "items": len(outs), "messages": len(outs) * batch,
            "outs": outs}


def check(state: State, record: dict) -> dict:
    ctx = state.ctx
    tr = ctx.cell.traffic
    batch, nb = tr["batch"], tr["distinct_batches"]
    runs = record["items"]
    own = [np.nonzero(state.mask[(r % nb) * batch:(r % nb + 1) * batch])[0] for r in range(runs)]
    picks = inputs.sample_rows(np.random.default_rng([ctx.seed, 2]), runs, batch, own,
                               tr["check_rows"])
    got = torch.stack([record["outs"][r][row] for r, row in picks]).to(ctx.omr.device)
    clues = state.pool[[(r % nb) * batch + row for r, row in picks]]
    record["outs"] = None
    state.server = None
    inputs.free_cards(ctx.devices)
    want = ctx.omr.detect(clues, ctx.key)
    return {"detect_words_off": (int((got != want).sum()), 0)}
