"""Mean ms a board of the traced window spent in the benchmark's "decode"
span (ends in a synchronisation of every card)."""


def read(run):
    s = run.spans.get("decode")
    return 1e3 * sum(s) / len(s) if s else None
