"""The program's own spans in a traced window: the ``tfhe_omr:`` ranges that
``tfhe_omr_tpu_torch/utils/spans.py`` records while a profiler runs. They
land in ``trace_read.Summary.host`` (the benchmark's ranges are ``omr:``).

Each reader here clips the card's idle time to the spans it names: a gap
counts only where it overlaps one of them, whatever the host was doing
when it began. A reader returns None where the trace holds none of the
spans it names, as in a program that records none.
"""

from __future__ import annotations

#: prefix of the program's ranges
PREFIX = "tfhe_omr:"


def _union(rows) -> list[tuple[int, int]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(rows):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap(a: list, b: list) -> int:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def spans(trace, names) -> list[tuple[int, int]]:
    """The union of the program's spans called one of ``names`` (without
    the prefix), clipped to the window."""
    want = {PREFIX + n for n in names}
    lo, hi = trace.window
    return _union((max(s, lo), min(e, hi)) for s, e, n in trace.host
                  if n in want and min(e, hi) > max(s, lo))


def idle_ms(run, names) -> float | None:
    """Card-idle ms a board inside the union of the spans ``names``: for
    each card, the spans' length less the part its operations cover, the
    mean over the cards, over the window's boards. None without a device
    trace or without such a span."""
    t = run.trace
    if t is None or not t.ops:
        return None
    u = spans(t, names)
    if not u:
        return None
    length = sum(e - s for s, e in u)
    idle = sum(length - _overlap(u, t.intervals(d)) for d in t.ops)
    idle += (t.chips - len(t.ops)) * length  # a card with no operation at all
    return 1e-6 * idle / t.chips / run.record["items"]


def host_ms(run, names) -> float | None:
    """Host ms a board inside the union of the spans ``names``; None where
    the trace holds none."""
    t = run.trace
    if t is None:
        return None
    u = spans(t, names)
    if not u:
        return None
    return 1e-6 * sum(e - s for s, e in u) / run.record["items"]
