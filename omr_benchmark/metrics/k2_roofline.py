"""K2's share of its roofline: the least time of every message the
traced window detected (omr_benchmark/roofline.py) over the device time of
the second level's blind rotation kernels, in %."""

from omr_benchmark import roofline


def read(run):
    return roofline.kernel_share(run, 2)
