"""The 95th percentile of time to first token over every row finished in
the window (a batch's rows share its prefill's time), host clock, ms."""
import numpy as np


def read(run):
    if not run.batches or run.traffic.get("decode_steps", 0):
        return None
    times = [1e3 * (b.t1 - b.t0) for b in run.batches for _ in range(b.rows)]
    return float(np.percentile(times, 95))
