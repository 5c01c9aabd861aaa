"""The least time of the kernels of a detect under many recipients' keys:
``roofline.py``'s operations bound of every recipient's samples (its count,
unchanged), against a bytes bound in which every recipient's key is read
from device memory once a message, which no cache shares between two
recipients.

Per message and recipient the bytes are ``roofline.blind_rotation``'s of
one recipient's samples (the accumulators in and out, the rotation amounts
and the key, once) for K1 and K2, and the float64 key-switching key for
the key switch, over 3.35 TB/s.
"""

from __future__ import annotations

from omr_benchmark import roofline


def level_work(cfg: dict, level: int, messages: int) -> dict:
    """K1's (``level`` 1) or K2's work of ``messages`` messages under each of
    the configuration's recipients: every recipient's samples' products and
    multiply slots, and every recipient's bytes."""
    one = roofline.level_work(cfg, level, 1)
    count = cfg["recipients"] * messages
    return {"products": one["products"] * count, "slots": one["slots"] * count,
            "bytes": one["bytes"] * count}


def ksk_bytes(cfg: dict) -> int:
    """Bytes of one recipient's key-switching key as the key switch reads it:
    float64 words, ks_digits x n_in rows of n_out + 1."""
    ks = cfg["first_level_ks"]
    digits = -(-ks["log_modulus"] // ks["log_basis"])
    return digits * ks["in_dimension"] * (ks["out_dimension"] + 1) * 8


def kernel_share(run, level: int) -> float | None:
    """K1's or K2's share of its roofline in a traced run of a cell of many
    recipients, in %: the least time of every message of the window under
    every recipient over the device time of that level's kernels. None
    where the trace holds none."""
    messages = run.record.get("messages")
    if run.trace is None or not run.clock or not messages:
        return None
    cfg = run.cell.cfg
    q = cfg["first_level_br" if level == 1 else "second_level_br"]["modulus"]
    seconds, launches = run.trace.device_seconds("blind_rotate", str(q))
    if not launches:
        return None
    least = roofline.least_seconds(level_work(cfg, level, messages), run.clock["sms"],
                                   run.clock["clock_mhz"])
    return 100.0 * least / seconds


#: parts of the names of the key switch's device operations: the float64
#: products of cuBLAS (a GEMM, or a GEMV where a recipient holds one row)
KEYSWITCH_NAMES = ("gemm", "gemv", "Gemm", "Gemv")


def keyswitch_seconds(trace) -> tuple[float, int]:
    """Device seconds and count of the key switch's operations."""
    ops = [op for d in trace.ops for op in trace.ops[d]
           if any(p in op[2] for p in KEYSWITCH_NAMES)]
    return sum(e - s for s, e, _n in ops) * 1e-9, len(ops)


def keyswitch_share(run) -> float | None:
    """The key switch's share of its roofline, in %: every recipient's KSK
    bytes a message over 3.35 TB/s, over the key switch's device time."""
    messages = run.record.get("messages")
    if run.trace is None or not messages:
        return None
    seconds, launches = keyswitch_seconds(run.trace)
    if not launches:
        return None
    least = messages * run.cell.cfg["recipients"] * ksk_bytes(run.cell.cfg) / roofline.HBM_BYTES_PER_S
    return 100.0 * least / seconds
