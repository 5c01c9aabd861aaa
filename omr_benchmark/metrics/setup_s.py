"""Process start to the first timed board or batch (host clock)."""


def read(run):
    return run.setup_s
