"""Share of the traced block with no kernel on the device, in a cell
that decodes (its prefills included), %."""


def read(run):
    if run.trace is None or not run.traffic.get("decode_steps", 0):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
