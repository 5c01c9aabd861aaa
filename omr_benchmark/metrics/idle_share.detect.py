"""The share of the traced window in which no operation ran on the card,
averaged over the cards: 100 (1 - busy / window)."""


def read(run):
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
