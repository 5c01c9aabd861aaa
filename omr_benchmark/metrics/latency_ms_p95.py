"""The 95th percentile of every board's time in the window, start to
decoded payloads, in ms (host clock; linear between ranks)."""

import numpy as np


def read(run):
    times = run.record.get("item_s")
    return float(np.percentile(times, 95)) * 1e3 if times else None
