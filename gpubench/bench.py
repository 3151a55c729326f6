"""One run of one cell: build the program's model around the benchmark's
weights, warm the cell's shapes, serve its traffic for the window, read
the metrics, and check the outputs against the plain reference.

A traced run (``--trace 1``) serves the window as an untraced run does,
then one more block of the mix under the profiler: the per-layer metrics
read from the host's clock or the CUDA events (a decode step's dispatch
and interval) read the untraced window, which the profiler's cost per
host operation would stretch; those read from the trace (ranges, kernels,
the device's busy time) read the traced block.

The program is ``repro_torch``: its model (``models/model.py``'s
``abstract_model``, whose parameters become the benchmark's weights), its
``prefill`` and its ``serve_step``, driven as ``launch/serve.py``'s
``generate`` drives them (greedy tokens by ``argmax`` on the device, the
next step enqueued without waiting for the last).  The harness opens its
own profiler ranges around each call into the program: ``warmup``,
``window``, ``request`` (a batch, from its inputs to its last token on the
host), ``prefill``, ``decode_step`` and ``reference``.  The mix's generator
(``generators/<name>.py``) decides what is sent when.

Clocks: a request's time to first token is the host's clock from sending
the batch to its first tokens on the host; the interval between two
decode steps is the device's, from CUDA events recorded after each step's
``argmax`` (a step takes some milliseconds, below what the host's clock
resolves well); the window is the host's, from its start to the last
token of the block of lengths in progress once ``seconds`` have passed.
The collector's generations are frozen over the window (``gc.freeze``):
a full collection over everything set-up made paused the host by tens of
milliseconds, and the decode loop is paced by the host.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gpubench import check, spec
from gpubench.trace import Trace
from gpubench.weights import Weights


class Batch(NamedTuple):
    index: int
    rows: int
    positions: int  # prefill positions a row
    t0: float  # host seconds: sent
    t1: float  # host seconds: its first tokens on the host (prefill) / its last (decode)
    served: List[List[int]]  # [row][token]
    logits: torch.Tensor  # [rows, V] the prefill's
    finite: torch.Tensor  # every logit finite (a device bool)
    dispatch_s: List[float]  # host seconds to enqueue each decode step
    intervals_s: List[float]  # seconds between consecutive tokens (the device's)


class Run(NamedTuple):
    """What a metric reader reads."""
    config: Dict
    traffic: Dict
    batches: List[Batch]  # the window's
    window_s: float
    setup_s: float
    traced: List[Batch]  # the traced block's (none in an untraced run)
    trace: Optional[Trace]  # the traced block's profile
    kind: str  # the device's name


def install(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Make each of ``model``'s parameters the benchmark's tensor of that
    name, refusing any name, shape or dtype that does not match."""
    params = dict(model.named_parameters())
    if set(params) != set(tensors):
        raise ValueError(f"weights and the program's parameters differ: program only "
                         f"{sorted(set(params) - set(tensors))}, benchmark only {sorted(set(tensors) - set(params))}")
    for name, p in params.items():
        t = tensors[name]
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: the benchmark's {tuple(t.shape)} {t.dtype}, the program's "
                             f"{tuple(p.shape)} {p.dtype}")
        mod, _, leaf = name.rpartition(".")
        model.get_submodule(mod)._parameters[leaf] = torch.nn.Parameter(t, requires_grad=False)
    if any(True for _ in model.buffers()):
        raise ValueError("the program's model holds buffers the benchmark does not draw")


def build(config: Dict, weights: Weights):
    """The program's model of ``config`` holding ``weights``."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.model import abstract_model

    model = abstract_model(ArchConfig(**spec.port_fields(config)))
    install(model, weights.tensors)
    return model


class _Clock:
    """Marks on the device's stream (CUDA events) or, on the CPU, the host's."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


def serve(M, model, inputs: Dict, P: int, steps: int, clock: _Clock, index: int = -1) -> Batch:
    """One request-batch of ``P`` prefill positions a row: prefill, then
    ``steps`` greedy steps.  Whether the logits were finite is read from
    the prefill's and the last step's (a non-finite value in the cache
    reaches the last step)."""
    with record_function("request"):
        t0 = time.perf_counter()
        with record_function("prefill"):
            logits, state = M.prefill(model, inputs, cache_len=P + steps)
        tok = torch.argmax(logits, dim=-1)
        finite = torch.isfinite(logits).all()
        dispatch, marks, toks = [], [clock.mark()], [tok]
        step_logits = logits
        for _ in range(steps):
            with record_function("decode_step"):
                h = time.perf_counter()
                step_logits, state = M.serve_step(model, state, tok[:, None])
                dispatch.append(time.perf_counter() - h)
            tok = torch.argmax(step_logits, dim=-1)
            toks.append(tok)
            marks.append(clock.mark())
        if steps:
            finite = finite & torch.isfinite(step_logits).all()
        served = torch.stack(toks, dim=1).tolist()  # waits for the last token
        t1 = time.perf_counter()
    del state
    intervals = [clock.seconds(a, b) for a, b in zip(marks, marks[1:])]
    return Batch(index, len(served), P, t0, t1, served, logits, finite, dispatch, intervals)


def traffic_of(cell: spec.Cell, seed: int, device):
    """The cell's mix as its generator reads it: (generator, traffic)."""
    gen = spec.generator(cell.traffic["generator"])
    return gen, gen.Traffic(cell.traffic, cell.config, seed, device)


def sender(M, model, traffic, clock: _Clock) -> Callable[[int], Batch]:
    """Serve batch ``i`` of the schedule."""
    return lambda i: serve(M, model, traffic.inputs(i), traffic.positions(i), traffic.steps, clock, i)


def warm(M, model, traffic, clock: _Clock) -> List[float]:
    """Every shape the mix sends, once: a batch of each text length with a
    few decode steps (the steps of a batch share their shapes)."""
    times = []
    with record_function("warmup"):
        for i, length in enumerate(traffic.shapes()):
            t = time.perf_counter()
            serve(M, model, traffic.inputs(i, length=length, tag="warmup"), traffic.positions(i, length),
                  min(traffic.steps, 4), clock)
            times.append(time.perf_counter() - t)
        clock.sync()
    return times


def measure(gen, traffic, send: Callable[[int], Batch], clock: _Clock, seconds: float, traced: bool):
    """The window and, where ``traced``, one block after it under the
    profiler.  Returns (window's batches, window seconds, traced block's
    batches, trace)."""
    batches, window_s = gen.window(traffic, send, clock.sync, seconds)
    if not traced:
        return batches, window_s, [], None
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if clock.cuda else [])
    with profile(activities=acts) as prof:
        block, _ = gen.window(traffic, send, clock.sync, 0, start=len(batches))
    return batches, window_s, block, Trace(prof.profiler.kineto_results.events())


def outputs_check(cell: spec.Cell, weights: Weights, traffic, batches: List[Batch], seed: int,
                  control: bool = False):
    """The check's readings of what ``batches`` served (with ``control``,
    also the control's readings on the same rows): (program readings,
    control readings or None, failed rows)."""
    ref = spec.reference(cell.config["reference"])
    finished, failed = [], 0
    for b in batches:
        ok = bool(b.finite)
        failed += 0 if ok else b.rows
        finished += [check.Served(b.index, r, b.positions, b.served[r], b.logits[r]) for r in range(b.rows)]
    rows = check.sample(finished, int(cell.traffic["check"]["rows"]), seed)
    if not rows:
        return {"gap_max": 0.0, "tokens_compared": 0}, None, failed
    changed = int(weights.fingerprint() != weights.drawn)
    with torch.no_grad(), record_function("reference"):
        ref_rows = check.rows_for(ref, rows, traffic.inputs)
        results, stats = ref.forward(cell.config, weights.tensors, ref_rows)
        readings = check.judge(results, [s.tokens for s in rows], [s.logits for s in rows])
        readings.update(rows_compared=len(rows), weights_changed=changed, **stats)
        ctrl = None
        if control:
            cres, _ = ref.forward(cell.config, weights.tensors, ref_rows, fp8=True)
            ctrl = check.judge(results, [[int(t) for t in c.logits.argmax(dim=-1)] for c in cres],
                               [c.logits[0] for c in cres])
    return readings, ctrl, failed


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device="cuda", t_start: Optional[float] = None):
    """One run of ``cell``: the result line's fields and the ``Run`` the
    metric readers read."""
    from repro_torch.models import model as M

    t_start = time.perf_counter() if t_start is None else t_start
    phases = {"imports": time.perf_counter() - t_start}
    dev = torch.device(device)
    clock = _Clock(dev)
    weights = Weights(cell.config, dev).draw(seed)
    clock.sync()
    phases["weights"] = time.perf_counter() - t_start
    model = build(cell.config, weights)
    gen, traffic = traffic_of(cell, seed, dev)
    phases["built"] = time.perf_counter() - t_start
    phases["warm_batches"] = warm(M, model, traffic, clock)
    gc.collect()
    gc.freeze()  # what set-up made is not scanned again by the collector inside the window
    setup_s = time.perf_counter() - t_start
    phases["warmup"] = setup_s
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    batches, window_s, block, trace = measure(gen, traffic, sender(M, model, traffic, clock), clock, seconds,
                                              traced)
    phases["traced_block"] = time.perf_counter() - t_window - window_s
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if clock.cuda else 0
    t_check = time.perf_counter()
    readings, _, failed = outputs_check(cell, weights, traffic, batches + block, seed)
    phases.update(window=window_s, check=time.perf_counter() - t_check)
    readings["phases_s"] = phases
    correct, checks = check.verdict(readings, cell.limits["limits"], failed)
    kind = torch.cuda.get_device_name(dev) if clock.cuda else "cpu"
    r = Run(cell.config, cell.traffic, batches, window_s, setup_s, block, trace, kind)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.metric_reader(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if clock.cuda else "cpu", "kind": kind, "count": 1, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": sum(b.rows for b in batches + block), "failed": failed,
            "metrics": metrics, "device": device_info}
    if trace is not None:
        device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    line["checks"] = checks
    return line, r, readings
