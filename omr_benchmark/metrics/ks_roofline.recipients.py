"""The key switch's share of its roofline under many recipients' keys:
every recipient's key-switching key bytes a message over the device
memory's peak, over the key switch's device time in the traced window,
in % (omr_benchmark/roofline_recipients.py)."""

from omr_benchmark import roofline_recipients


def read(run):
    return roofline_recipients.keyswitch_share(run)
