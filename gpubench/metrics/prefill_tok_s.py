"""Prefill positions served in the window (patch positions included) over
the window's seconds, in a cell whose requests end at their first token."""


def read(run):
    if not run.batches or run.traffic.get("decode_steps", 0):
        return None
    return sum(b.rows * b.positions for b in run.batches) / run.window_s
