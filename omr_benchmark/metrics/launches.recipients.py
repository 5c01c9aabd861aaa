"""Device operations a message (kernels, copies, sets) in the traced
window, over the cards: what the host queues for one message under every
recipient's key."""


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    return sum(len(ops) for ops in t.ops.values()) / run.record["items"]
