"""K2's device ms a message under every recipient's key: the second-level
blind rotation kernels' time in the traced window (named by the second
level's modulus) over the messages."""


def read(run):
    if run.trace is None:
        return None
    q = run.cell.cfg["second_level_br"]["modulus"]
    seconds, launches = run.trace.device_seconds("blind_rotate", str(q))
    return 1e3 * seconds / run.record["items"] if launches else None
