"""K2's share of its roofline under many recipients' keys: the least time
of every message and recipient of the traced window (the larger of the
multiply-slot time and the recipients' key bytes over the device memory's
peak; omr_benchmark/roofline_recipients.py) over the device time of the
second level's blind rotation kernels, in %."""

from omr_benchmark import roofline_recipients


def read(run):
    return roofline_recipients.kernel_share(run, 2)
