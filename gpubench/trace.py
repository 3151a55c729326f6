"""What a traced run's profile says: the device's busy time in the window,
the device time of the kernels launched under a host range, the kernels by
name, and the idle gaps named by what the host was doing.

The profiler (``torch.profiler``, CPU and CUDA activities) runs over the
measured window alone, which the harness marks with its ``window`` range.
Its raw events are read (``kineto_results.events()``: no tree is built,
which for the hundreds of thousands of a window takes minutes).  A kernel
belongs to a host range when the host operation that launched it (its
linked correlation id) started inside the range.  A device event that is
a host range's annotation on the device timeline is not work and is left
out.  Times are the profiler's nanoseconds, turned into seconds here.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SPANS = ("window", "request", "prefill", "decode_step", "warmup", "reference")


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _is_annotation(e) -> bool:
    return bool(e.is_user_annotation())


class Trace:
    def __init__(self, events):
        host, ranges, kernels = [], [], []
        for e in events:
            a, n = e.start_ns(), e.name()
            if _is_device(e):
                if not _is_annotation(e):
                    kernels.append((a, a + e.duration_ns(), n, e.linked_correlation_id()))
            else:
                host.append((a, a + e.duration_ns(), n, e.correlation_id()))
                if _is_annotation(e):
                    ranges.append((a, a + e.duration_ns(), n))
        win = [r for r in ranges if r[2] == "window"]
        if not win:
            raise RuntimeError("the profile holds no 'window' range")
        self.w0, self.w1 = win[0][0], win[0][1]
        self.annotations = ranges
        host_names = {r[2] for r in ranges}
        launched = {corr: a for a, _, _, corr in host if corr}
        self.kernels = sorted((max(a, self.w0), min(b, self.w1), n, launched.get(corr))
                              for a, b, n, corr in kernels if n not in host_names and min(b, self.w1) > max(a, self.w0))
        self.host = host
        self.busy_intervals = _union([(a, b) for a, b, _, _ in self.kernels])
        self.busy_s = sum(b - a for a, b in self.busy_intervals) / 1e9
        self.window_s = (self.w1 - self.w0) / 1e9

    def range_device_s(self, names: Sequence[str], inside: Optional[str] = None) -> float:
        """Device seconds of the kernels launched under the host ranges
        ``names`` (under an ``inside`` range only, where given)."""
        iv = [(a, b) for a, b, n in self.annotations if n in names]
        if inside:
            outer = _union([(a, b) for a, b, n in self.annotations if n == inside])
            iv = [r for r, ok in zip(iv, _within(outer, [a for a, _ in iv])) if ok]
        launched = [k for k in self.kernels if k[3] is not None]
        hit = _within(_union(iv), [k[3] for k in launched])
        return sum(b - a for (a, b, _, _), ok in zip(launched, hit) if ok) / 1e9

    def ranges(self, name: str) -> int:
        return sum(1 for r in self.annotations if r[2] == name)

    def kernel_s(self, substrings: Sequence[str]) -> float:
        return sum(b - a for a, b, n, _ in self.kernels if any(s in n for s in substrings)) / 1e9

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for a, b, n, _ in self.kernels:
            by[n] = by.get(n, 0.0) + (b - a) / 1e9
        return [[n[:160], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The ``top`` longest spans of the window with nothing on the
        device, each named ``<harness range>/<innermost host operation>`` at
        the gap's start (``-`` where the host ran Python between
        operations)."""
        gaps, at = [], self.w0
        for a, b in self.busy_intervals:
            if a > at:
                gaps.append((a - at, at))
            at = max(at, b)
        if self.w1 > at:
            gaps.append((self.w1 - at, at))
        gaps.sort(reverse=True)
        starts = np.array([h[0] for h in self.host], dtype=np.int64)
        ends = np.array([h[1] for h in self.host], dtype=np.int64)
        is_span = np.array([h[2] in SPANS for h in self.host], dtype=bool)
        out = []
        for length, t in gaps[:top]:
            inside = (starts <= t) & (ends > t)
            out.append([f"{self._innermost(starts, ends, inside & is_span)}/"
                        f"{self._innermost(starts, ends, inside & ~is_span)}", length / 1e9])
        return out

    def _innermost(self, starts, ends, mask) -> str:
        idx = np.nonzero(mask)[0]
        if not len(idx):
            return "-"
        return self.host[int(idx[np.argmin(ends[idx] - starts[idx])])][2]


def _within(intervals: List[Tuple[int, int]], times: Sequence[int]) -> np.ndarray:
    """Whether each of ``times`` lies in one of the sorted, disjoint ``intervals``."""
    t = np.asarray(times, dtype=np.int64)
    if not intervals or not len(t):
        return np.zeros(len(t), dtype=bool)
    a = np.array([x for x, _ in intervals], dtype=np.int64)
    b = np.array([y for _, y in intervals], dtype=np.int64)
    i = np.searchsorted(a, t, side="right") - 1
    return (i >= 0) & (t < b[np.maximum(i, 0)])


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out
