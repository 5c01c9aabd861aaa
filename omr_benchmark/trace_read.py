"""Reads a ``torch.profiler`` trace of a measured window: the device
operations (kernels, copies, sets) of each card, the window's bounds, the
busy time of each card as the union of its operations' intervals, and what
the host was doing while a card was idle.

The raw kineto events are read, not ``profile.events()``, whose tree of
Python objects takes minutes at the hundreds of thousands of events of a
window.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass

#: prefix of the benchmark's own profiler ranges
SPAN = "omr:"
WINDOW = SPAN + "window"
TOP = 10
LABELLED = 30000


def _is_device(ev) -> bool:
    return ev.device_type().name == "CUDA"


@dataclass
class Summary:
    window: tuple[int, int]  # ns, the host's window range
    ops: dict  # device index -> sorted [(start_ns, end_ns, name)]
    host: list  # sorted [(start_ns, end_ns, name)] of the host's ops
    spans: list  # sorted [(start_ns, end_ns, name)] of the benchmark's spans
    chips: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def intervals(self, dev: int) -> list[tuple[int, int]]:
        """The union of a card's operation intervals, clipped to the window."""
        lo, hi = self.window
        out = []
        for s, e, _n in self.ops.get(dev, []):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        """Seconds in which an operation ran, averaged over the chips."""
        total = sum(e - s for d in self.ops for s, e in self.intervals(d))
        return total * 1e-9 / self.chips

    def device_seconds(self, *parts: str) -> tuple[float, int]:
        """Seconds and count of the device operations whose names hold all
        of ``parts``."""
        ops = [op for d in self.ops for op in self.ops[d] if all(p in op[2] for p in parts)]
        return sum(e - s for s, e, _n in ops) * 1e-9, len(ops)

    @staticmethod
    def _innermost(rows: list, t: int, depth: int) -> str | None:
        """The name of the latest-starting of ``rows`` (sorted by start)
        that holds ``t``, among the ``depth`` that start last before it."""
        i = bisect.bisect_right(rows, (t, float("inf"), ""))
        for s, e, name in reversed(rows[max(0, i - depth):i]):
            if e > t:
                return name
        return None

    def breakdown(self) -> dict:
        """The device operations that took most time, and the cards' idle
        time by what the host was doing when each gap began (the benchmark's
        span and the host's innermost range; gaps past the ``LABELLED``
        longest are summed under one name)."""
        by_op = defaultdict(int)
        for d in self.ops:
            for s, e, name in self.ops[d]:
                by_op[name[:160]] += e - s
        lo, hi = self.window
        gaps = []
        for d in self.ops:
            t = lo
            for s, e in self.intervals(d) + [(hi, hi)]:
                if s > t:
                    gaps.append((s - t, t))
                t = max(t, e)
        gaps.sort(reverse=True)
        by_host = defaultdict(int)
        for n, (length, t) in enumerate(gaps):
            if n >= LABELLED:
                by_host["shorter gaps"] += length
                continue
            span = self._innermost(self.spans, t, 8)
            op = self._innermost(self.host, t, 256)
            by_host[f"{span[len(SPAN):] if span else 'loop'}/{op or 'python'}"] += length

        def top(acc):
            rows = sorted(acc.items(), key=lambda kv: -kv[1])[:TOP]
            return [[name, ns * 1e-9] for name, ns in rows]

        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def summarise(prof, devices) -> Summary:
    """The summary of a finished ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    indices = {d.index or 0 for d in devices if d.type == "cuda"}
    ops = defaultdict(list)
    host, spans = [], []
    window = None
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if _is_device(ev):
            if name.startswith(SPAN) or ev.is_user_annotation():
                continue
            if ev.device_index() in indices:
                ops[ev.device_index()].append((s, e, name))
        elif name == WINDOW:
            window = (s, e)
        elif name.startswith(SPAN):
            spans.append((s, e, name))
        else:
            host.append((s, e, name))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    for d in ops:
        ops[d].sort()
    host.sort()
    spans.sort()
    return Summary(window, dict(ops), host, spans, max(len(devices), 1))
