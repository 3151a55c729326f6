"""Device milliseconds of the kernels under the program's four MoE ranges
(``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``) inside
the harness's ``decode_step`` ranges, per decode step."""

RANGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def read(run):
    if run.trace is None:
        return None
    steps = run.trace.ranges("decode_step")
    t = run.trace.range_device_s(RANGES, inside="decode_step")
    return 1e3 * t / steps if steps and t else None
