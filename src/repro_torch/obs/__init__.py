"""Observability: span tracing and process-wide metrics (answers to
``repro/obs/``, with the same span names and metric families — see
docs/ARCHITECTURE.md, "Observability").

  * ``repro_torch.obs.trace``   — spans exported as Chrome trace JSON, and
    ``torch.profiler`` ranges while a profiler records (the port's one
    span API);
  * ``repro_torch.obs.metrics`` — counters / gauges / bounded histograms
    with a Prometheus-text dump (a counter family may fold in counts its
    owner keeps on a device when it is read).
"""
from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import NOOP_SPAN, TRACER, Tracer, span

__all__ = [
    "metrics",
    "trace",
    "span",
    "Tracer",
    "TRACER",
    "NOOP_SPAN",
    "MetricsRegistry",
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
]
