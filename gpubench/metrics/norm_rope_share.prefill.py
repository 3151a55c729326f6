"""Device time of the kernels launched under the program's ``norm`` and
``rope`` spans (every RMSNorm and the rotary positions, ``models/layers.py``)
over the traced block's busy time, in a cell that serves prefills, %."""


def read(run):
    if run.trace is None or run.traffic.get("decode_steps", 0) or not run.trace.busy_s:
        return None
    t = run.trace.range_device_s(("norm", "rope"))
    return 100.0 * t / run.trace.busy_s if t else None
