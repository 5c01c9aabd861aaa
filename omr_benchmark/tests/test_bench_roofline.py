"""The frozen count of K1 and K2 against a hand count at the small
parameter set, and the share read from a trace: the window's work over
the kernels' time, however many launches carry it."""

from types import SimpleNamespace

import pytest

from omr_benchmark import roofline, trace_read
from omr_benchmark.tests.helpers import TINY


def test_k1_hand_count():
    # N1 = 256 (8 stages), d = 5, q1 < 2**31, 64 // 2 = 32 steps, 7 samples a message
    shoup = (2 * 5 + 2) * 128 * 8  # 12288 butterflies
    summed = 12 * 5 * 256 + 6 * 256  # 16896 key and monomial products
    assert (shoup, summed) == (12288, 16896)
    w = roofline.level_work(TINY, 1, messages=3)
    samples, steps = 21, 32
    assert w["products"] == (12288 + 16896) * steps * samples
    assert w["slots"] == (12288 * 4 + 16896 * 2) * steps * samples
    assert w["bytes"] == 2 * samples * 2 * 256 * 8 + 2 * steps * samples * 8 + 3 * steps * 256 * 5 * 4 * 4


def test_k2_hand_count():
    # N2 = 512 (9 stages), d = 7, a 38-bit q2 in 64-bit words, 96 // 2 = 48 steps
    shoup = (2 * 7 + 2) * 256 * 9  # 36864
    summed = 12 * 7 * 512 + 6 * 512  # 46080
    w = roofline.level_work(TINY, 2, messages=3)
    assert w["slots"] == (shoup * 16 + summed * 8) * 48 * 3
    assert w["bytes"] == 2 * 3 * 2 * 512 * 8 + 2 * 48 * 3 * 8 + 3 * 48 * 512 * 7 * 4 * 8


def test_least_time_is_the_larger_bound():
    w = {"slots": 64 * 132 * 1980e6, "bytes": 0}
    assert roofline.least_seconds(w, 132, 1980.0) == 1.0
    w = {"slots": 0, "bytes": 3.35e12}
    assert roofline.least_seconds(w, 132, 1980.0) == 1.0


def _share(level: int, launch_ms: list, messages: int = 3):
    """The share of a fake traced run whose level-``level`` kernels ran
    for ``launch_ms``, one launch each, beside an unrelated kernel."""
    q = TINY["first_level_br" if level == 1 else "second_level_br"]["modulus"]
    ops, t = [(0, 10**6, "ntt_fwd_kernel")], 10**6
    for ms in launch_ms:
        ops.append((t, t + round(ms * 1e6), f"blind_rotate_kernel<{q}>"))
        t = ops[-1][1]
    run = SimpleNamespace(cell=SimpleNamespace(cfg=TINY), record={"messages": messages},
                          trace=trace_read.Summary((0, t), {0: ops}, [], [], 1),
                          clock={"sms": 132, "clock_mhz": 1980.0})
    return roofline.kernel_share(run, level)


@pytest.mark.parametrize("level", [1, 2])
def test_share_reads_the_same_work_however_many_launches(level):
    one = _share(level, [2.0])
    assert _share(level, [1.0, 1.0]) == pytest.approx(one)
    assert _share(level, [0.5, 0.25, 1.25]) == pytest.approx(one)
    assert _share(level, [2.0], messages=6) == pytest.approx(2 * one)
    least = roofline.least_seconds(roofline.level_work(TINY, level, 3), 132, 1980.0)
    assert one == pytest.approx(100 * least / 2e-3)


def test_share_reads_nothing_without_messages_or_kernels():
    assert _share(1, [2.0], messages=0) is None
    assert _share(2, []) is None
