"""Process-wide metrics registry — counters, gauges, and bounded
log-spaced latency histograms with a Prometheus-text exposition dump
(the port's own copy of ``repro/obs/metrics.py``, same family names).

  * ``Counter``   — monotone float, ``inc(n)``;
  * ``Gauge``     — last-write value, ``set`` / ``inc`` / ``dec``;
  * ``Histogram`` — FIXED-memory log-spaced buckets with quantile
    estimation (see the class docstring for the error bound);
  * ``MetricsRegistry`` — named families, optional Prometheus-style
    labels, and ``prometheus_text()`` exposition.

The default process registry lives at module level (``counter()`` /
``gauge()`` / ``histogram()`` register into it); per-instance views
(``EngineStats``, ``ShardVoteCache.stats()``) ALSO feed the process
families, so one ``dump()`` covers every engine.  All mutation is
lock-protected — serving dispatch threads and producer threads report
concurrently.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple


class Counter:
    """Monotonically increasing value (Prometheus ``counter``)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge:
    """Last-write value that may go up or down (Prometheus ``gauge``)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


# one edge table per (lo, hi, growth) — histograms of the same shape
# share it, so a fleet of per-engine histograms costs counts only
_EDGE_CACHE: Dict[tuple, tuple] = {}
_EDGE_LOCK = threading.Lock()


def _edges(lo: float, hi: float, growth: float) -> tuple:
    key = (lo, hi, growth)
    with _EDGE_LOCK:
        e = _EDGE_CACHE.get(key)
        if e is None:
            n = max(1, math.ceil(math.log(hi / lo) / math.log(growth)))
            e = tuple(lo * growth**i for i in range(n + 1))
            _EDGE_CACHE[key] = e
        return e


class Histogram:
    """Bounded log-spaced histogram with quantile estimation.

    Buckets are geometric: edges ``lo * growth**i`` spanning [lo, hi],
    plus one underflow and one overflow bucket — fixed memory (~200 int
    counts at the defaults) regardless of how many samples arrive.

    **Quantile error bound.**  A quantile query walks the cumulative
    counts to the target rank's bucket and reports the bucket's
    geometric midpoint, clamped to the observed [min, max].  The true
    rank value lies in the same bucket, whose edges are a factor
    ``growth`` apart, so the reported value is within a factor
    ``sqrt(growth)`` of a value whose rank error is at most the bucket's
    population — i.e. RELATIVE error ``<= sqrt(growth) - 1`` (~4.9% at
    the default ``growth=1.1``).  Samples under ``lo`` report ``min``,
    over ``hi`` report ``max`` (exact at the extremes).
    """

    __slots__ = (
        "name", "labels", "lo", "hi", "growth",
        "_edges", "_log_lo", "_log_growth",
        "_counts", "_under", "_over",
        "_count", "_sum", "_min", "_max", "_lock",
    )

    def __init__(
        self,
        name: str = "",
        labels: Tuple[Tuple[str, str], ...] = (),
        *,
        lo: float = 1e-6,
        hi: float = 100.0,
        growth: float = 1.1,
    ):
        if not (0 < lo < hi) or growth <= 1.0:
            raise ValueError(f"bad histogram shape lo={lo} hi={hi} growth={growth}")
        self.name = name
        self.labels = labels
        self.lo, self.hi, self.growth = float(lo), float(hi), float(growth)
        self._edges = _edges(self.lo, self.hi, self.growth)
        self._log_lo = math.log(self.lo)
        self._log_growth = math.log(self.growth)
        self._counts = [0] * (len(self._edges) - 1)
        self._under = 0
        self._over = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    # -- write side ---------------------------------------------------------
    def observe(self, x: float) -> None:
        x = float(x)
        with self._lock:
            self._count += 1
            self._sum += x
            if x < self._min:
                self._min = x
            if x > self._max:
                self._max = x
            if x < self.lo:
                self._under += 1
            elif x >= self._edges[-1]:
                self._over += 1
            else:
                i = int((math.log(x) - self._log_lo) / self._log_growth)
                # float log rounding can land one bucket off the edge
                i = min(max(i, 0), len(self._counts) - 1)
                if x < self._edges[i]:
                    i -= 1
                elif x >= self._edges[i + 1]:
                    i += 1
                self._counts[i] += 1

    append = observe  # deque-compat, as the JAX package's

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold another histogram of the same shape into this one (the
        cross-engine aggregation of a latency read-out)."""
        if (self.lo, self.hi, self.growth) != (other.lo, other.hi, other.growth):
            raise ValueError("cannot merge histograms with different bucket shapes")
        with other._lock:
            counts = list(other._counts)
            u, o = other._under, other._over
            c, s, mn, mx = other._count, other._sum, other._min, other._max
        with self._lock:
            for i, n in enumerate(counts):
                self._counts[i] += n
            self._under += u
            self._over += o
            self._count += c
            self._sum += s
            self._min = min(self._min, mn)
            self._max = max(self._max, mx)
        return self

    # -- read side ----------------------------------------------------------
    # Readers take the lock too: `observe` updates count/sum/min/max as
    # one transaction, and an unlocked reader could pair a fresh _sum
    # with a stale _count (a torn mean).
    def __len__(self) -> int:
        with self._lock:
            return self._count

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def min(self) -> float:
        with self._lock:
            return self._min

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else float("nan")

    def quantile(self, q: float) -> float:
        """Estimated q-quantile, q in [0, 1] (see class error bound)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            if self._count == 0:
                return float("nan")
            if q == 0.0:
                return self._min  # the extremes are tracked exactly
            if q == 1.0:
                return self._max
            rank = q * (self._count - 1) + 1  # 1-based target rank
            cum = self._under
            if cum >= rank:
                return self._min
            for i, n in enumerate(self._counts):
                cum += n
                if cum >= rank:
                    mid = math.sqrt(self._edges[i] * self._edges[i + 1])
                    return min(max(mid, self._min), self._max)
            return self._max

    def percentile(self, p: float) -> float:
        """np.percentile-style accessor (p in [0, 100])."""
        return self.quantile(p / 100.0)

    def buckets(self) -> List[Tuple[float, int]]:
        """(upper_edge, cumulative_count) pairs, Prometheus ``le`` style;
        only edges where the count advances, plus +inf."""
        with self._lock:
            out = []
            cum = self._under
            for i, n in enumerate(self._counts):
                if n:
                    cum += n
                    out.append((self._edges[i + 1], cum))
            out.append((math.inf, self._count))
            return out

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._under = self._over = 0
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf


class _Family:
    """One named metric family: unlabeled (a single child) or labeled
    (children keyed by label values, created on demand via ``labels``)."""

    def __init__(self, name: str, kind: type, help: str, label_names: Tuple[str, ...],
                 **hist_kw: Any):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = label_names
        self._hist_kw = hist_kw
        self._children: Dict[tuple, Any] = {}
        self._lock = threading.Lock()
        if not label_names:  # unlabeled: one eagerly created child
            self._children[()] = self._make(())

    def _make(self, values: tuple):
        pairs = tuple(zip(self.label_names, values))
        if self.kind is Histogram:
            return Histogram(self.name, pairs, **self._hist_kw)
        return self.kind(self.name, pairs)

    def labels(self, **kv: str):
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, got {sorted(kv)}"
            )
        values = tuple(str(kv[k]) for k in self.label_names)  # canonical order
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make(values)
            return child

    def children(self) -> List[Any]:
        with self._lock:
            return list(self._children.values())

    @property
    def solo(self):
        with self._lock:  # labels() mutates _children concurrently
            return self._children[()]


_KIND_NAMES = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class MetricsRegistry:
    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _register(self, name: str, kind: type, help: str,
                  labels: Iterable[str] = (), **hist_kw: Any):
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help, labels, **hist_kw)
            elif fam.kind is not kind or fam.label_names != labels:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{_KIND_NAMES[fam.kind]}{fam.label_names}"
                )
        return fam.solo if not labels else fam

    def counter(self, name: str, help: str = "", labels: Iterable[str] = ()):
        """Unlabeled: returns the Counter.  Labeled: returns the family
        (``.labels(k=v).inc()``).  Re-registration returns the existing
        metric, so modules declare at import time without coordination."""
        return self._register(name, Counter, help, labels)

    def gauge(self, name: str, help: str = "", labels: Iterable[str] = ()):
        return self._register(name, Gauge, help, labels)

    def histogram(self, name: str, help: str = "", labels: Iterable[str] = (),
                  *, lo: float = 1e-6, hi: float = 100.0, growth: float = 1.1):
        return self._register(name, Histogram, help, labels,
                              lo=lo, hi=hi, growth=growth)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # -- exposition ---------------------------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition format, one block per family.
        Histograms emit cumulative ``_bucket{le=...}`` lines (sparse:
        only edges where the count advances, plus +Inf), ``_sum`` and
        ``_count``."""
        out: List[str] = []
        for fam in self.families():
            out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {_KIND_NAMES[fam.kind]}")
            for child in fam.children():
                base = _label_str(child.labels)
                if fam.kind is Histogram:
                    for le, cum in child.buckets():
                        le_s = "+Inf" if le == math.inf else repr(le)
                        out.append(
                            f"{fam.name}_bucket{_label_str(child.labels + (('le', le_s),))} {cum}"
                        )
                    out.append(f"{fam.name}_sum{base} {child.sum}")
                    out.append(f"{fam.name}_count{base} {child.count}")
                else:
                    out.append(f"{fam.name}{base} {child.value}")
        return "\n".join(out) + "\n"

    def dump(self, path) -> None:
        from pathlib import Path

        Path(path).write_text(self.prometheus_text())

    def reset(self) -> None:
        """Zero every metric (tests, benches, repeated runs in one
        process); the families stay registered."""
        for fam in self.families():
            for child in fam.children():
                child._reset()


def _label_str(pairs: Tuple[Tuple[str, str], ...]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + inner + "}"


# -- the default process registry -------------------------------------------

REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "", labels: Iterable[str] = ()):
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Iterable[str] = ()):
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Iterable[str] = (), **kw: Any):
    return REGISTRY.histogram(name, help, labels, **kw)


def dump(path) -> None:
    REGISTRY.dump(path)


def reset() -> None:
    REGISTRY.reset()
