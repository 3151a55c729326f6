"""Of the device's idle time inside the traced block's ``decode_step``
ranges, the share in gaps that begin while the host is inside one of the
program's four MoE spans (``moe.route``, ``moe.dispatch``, ``moe.experts``,
``moe.combine``), %.  A gap is named by where it begins, as the
breakdown's ``idle_gaps`` names it; the part of a gap outside the steps is
not counted."""
from gpubench.trace import _union, _within

SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def read(run):
    t = run.trace
    if t is None or not t.busy_s:
        return None
    steps = _union([(a, b) for a, b, n in t.annotations if n == "decode_step"])
    moe = _union([(a, b) for a, b, n in t.annotations if n in SPANS])
    if not steps or not moe:
        return None
    idle, at = [], t.w0
    for a, b in t.busy_intervals + [(t.w1, t.w1)]:
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    gaps, i = [], 0  # the idle intervals cut to the steps (both sorted and disjoint)
    for a, b in idle:
        while i < len(steps) and steps[i][1] <= a:
            i += 1
        j = i
        while j < len(steps) and steps[j][0] < b:
            gaps.append((max(a, steps[j][0]), min(b, steps[j][1])))
            j += 1
    total = sum(b - a for a, b in gaps)
    if not total:
        return None
    inside = _within(moe, [a for a, _ in gaps])
    return 100.0 * sum(b - a for (a, b), ok in zip(gaps, inside) if ok) / total
