"""Inputs the loops share, all made by the reference from the seed: clues
of the recipient's and of other recipients' messages, payloads, and the
sample of a window's answers that the reference works out again."""

from __future__ import annotations

import numpy as np
import torch

from omr_benchmark import reference


def clues(omr: reference.Omr, pertinent: np.ndarray) -> torch.Tensor:
    """(len(pertinent), n0 + clue_count) clues on the reference's device:
    the recipient's messages under its clue key, the others under another
    recipient's."""
    mask = torch.as_tensor(pertinent, device=omr.device)
    width = omr.params.n0 + omr.params.cfg["clue_count"]
    out = torch.empty((len(pertinent), width), dtype=torch.int64, device=omr.device)
    out[mask] = omr.clues(omr.clue_key(omr.clue_sk), int(pertinent.sum()))
    out[~mask] = omr.clues(omr.clue_key(omr.other_clue_sk()), int((~pertinent).sum()))
    return out


def pertinent_mask(rng: np.random.Generator, total: int, per: int, every: int) -> np.ndarray:
    """``per`` pertinent messages at random places in every ``every``."""
    mask = np.zeros(total, dtype=bool)
    for s in range(0, total, every):
        n = min(every, total - s)
        mask[s + rng.choice(n, min(per, n), replace=False)] = True
    return mask


def sample_rows(rng: np.random.Generator, runs: int, rows: int, pertinent: list,
                count: int) -> list[tuple[int, int]]:
    """``count`` (run, row) pairs: about a quarter of them rows that are the
    recipient's (``pertinent[run]`` lists a run's), the rest any row."""
    picks = []
    for k in range(count):
        r = int(rng.integers(runs))
        own = pertinent[r]
        if k < count // 4 and len(own):
            picks.append((r, int(own[rng.integers(len(own))])))
        else:
            picks.append((r, int(rng.integers(rows))))
    return picks


class Waiter:
    """Marks the work queued so far on a device, so the host can wait for
    one batch while the next one runs (nothing to wait for on the CPU)."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def free_cards(devices) -> None:
    """Give back the caching allocator's free blocks before the reference
    runs."""
    for d in devices:
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
