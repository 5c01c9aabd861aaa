"""Messages detected in the window over the window's wall (host clock)."""


def read(run):
    rec = run.record
    return rec["messages"] / rec["window_s"] if "messages" in rec else None
