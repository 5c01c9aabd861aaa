"""The window's wall over the whole boards it ran (host clock)."""


def read(run):
    rec = run.record
    return rec["window_s"] / rec["items"] if "item_s" in rec else None
