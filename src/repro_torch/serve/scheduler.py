"""Async deadline dispatch loop — continuous serving without ``flush``
(answers to ``repro/serve/scheduler.py``).

The engine's inline scheduler (``ServeEngine.submit``/``flush``) is
synchronous: a partial batch waits forever unless the caller remembers
to flush, which no open-ended request stream ever can.  This module
runs dispatch on its own thread under a LATENCY DEADLINE policy:

  * a request carries a deadline (``submit(..., deadline_s=...)``,
    default ``t_max_s``, itself ``EngineConfig.t_max_s`` by default) — the
    longest it may sit in the queue before its batch is dispatched;
  * a FULL static batch dispatches immediately, exactly like the
    synchronous path;
  * a PARTIAL batch dispatches on its own the moment the earliest queued
    deadline arrives, padded up to the static ``[B, d]`` shape —
    a lone request is answered within its deadline plus one batch time,
    no ``flush()`` anywhere.

Dispatch stays single-threaded (one worker owns every ``_run_batch``
call), so the engine's predict and counters see exactly the access
pattern of the synchronous path — which is why the answers are
bit-for-bit identical to ``ServeEngine.predict``: same pack, same pad,
same kernel, and every row's vote reduction is independent of its
batch-mates.  The worker makes the engine's device its current device,
so its launches go to the card the engine serves on.  Per-request
latency (submit → result available) lands in
``engine.stats.request_latencies``, so p50/p99 under the deadline
policy read out the same way as under the sync path.  ``drain()`` blocks until every submitted request is answered.

While a scheduler is attached, route all traffic through it — calling
``engine.predict``/``engine.submit`` concurrently from another thread
would interleave foreign batches into the engine's counters.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Deque, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics, trace
from repro_torch.serve.engine import _M_REQ_LATENCY, _M_REQUESTS

# Process-wide scheduler metric families.  ``trigger`` labels why a batch
# dispatched: "full" (static batch packed), "deadline" (earliest queued
# deadline arrived), "close" (drain on shutdown).
_M_DISPATCHES = obs_metrics.counter(
    "mafl_scheduler_dispatches_total",
    "Batches dispatched by the deadline scheduler, by trigger.",
    labels=("trigger",),
)
_M_QUEUE_DEPTH = obs_metrics.gauge(
    "mafl_scheduler_queue_depth",
    "Requests currently queued (most recently active scheduler).",
)
_M_QUEUE_WAIT = obs_metrics.histogram(
    "mafl_scheduler_queue_wait_seconds",
    "Per-request seconds from submit to dispatch start — the scheduler-"
    "wait share of request latency (dispatch+compute is the rest).",
)


class _Pending(NamedTuple):
    rid: int
    row: np.ndarray
    t_submit: float
    deadline: float  # absolute perf_counter time the request must dispatch by


class DeadlineScheduler:
    """Background micro-batch dispatcher with a latency deadline.

    Use as a context manager (``close`` drains the queue and joins the
    worker)::

        with engine.scheduler(t_max_s=0.002) as sched:
            ids = sched.submit(rows)          # no flush, ever
            answers = sched.results(ids)      # blocks until served
    """

    def __init__(self, engine, *, t_max_s: Optional[float] = None):
        self.engine = engine
        self.t_max_s = float(engine.config.t_max_s if t_max_s is None else t_max_s)
        if self.t_max_s <= 0:
            raise ValueError(f"t_max_s must be positive, got {self.t_max_s}")
        self._cv = threading.Condition()
        self._queue: Deque[_Pending] = collections.deque()
        self._results: Dict[int, Union[int, Exception]] = {}
        # per-request seconds from submit to dispatch start, this scheduler's
        # share of _M_QUEUE_WAIT
        self.queue_wait = obs_metrics.Histogram()
        self._next_id = 0
        self._inflight = False
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="serve-deadline-dispatch", daemon=True
        )
        self._thread.start()

    # -- request side -------------------------------------------------------
    def submit(self, X, *, deadline_s: Optional[float] = None) -> List[int]:
        """Queue rows; returns request ids.  Full batches dispatch at
        once; anything else dispatches by ``deadline_s`` (default
        ``t_max_s``) after this call."""
        rows = np.atleast_2d(np.asarray(X, np.float32))
        dl = self.t_max_s if deadline_s is None else float(deadline_s)
        now = time.perf_counter()
        with self._cv:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            ids = []
            for row in rows:
                self._queue.append(_Pending(self._next_id, row, now, now + dl))
                ids.append(self._next_id)
                self._next_id += 1
            self.engine.stats.requests += len(ids)
            _M_REQUESTS.inc(len(ids))
            _M_QUEUE_DEPTH.set(len(self._queue))
            self._cv.notify_all()
        return ids

    def result(self, rid: int, *, timeout_s: Optional[float] = None) -> int:
        """Block until request ``rid`` is answered, then pop its answer
        (the memory-bounded read, like ``ServeEngine.take``)."""
        limit = None if timeout_s is None else time.perf_counter() + timeout_s
        with self._cv:
            if not 0 <= rid < self._next_id:
                raise KeyError(f"request {rid} was never submitted")
            while rid not in self._results:
                # once closed and drained, every submitted answer is in
                # _results — an absent rid was already popped and will
                # never be notified again; raise instead of hanging
                if self._closed and not self._queue and not self._inflight:
                    raise KeyError(f"request {rid} already taken")
                wait = None if limit is None else limit - time.perf_counter()
                if wait is not None and wait <= 0:
                    raise TimeoutError(f"request {rid} not answered within {timeout_s}s")
                self._cv.wait(wait)
            out = self._results.pop(rid)
        if isinstance(out, Exception):
            raise out
        return out

    def results(self, ids: List[int], *, timeout_s: Optional[float] = None) -> np.ndarray:
        return np.array([self.result(r, timeout_s=timeout_s) for r in ids], np.int32)

    def drain(self) -> None:
        """Block until every submitted request has been dispatched and
        answered (the answers stay available to ``result``)."""
        with self._cv:
            while self._queue or self._inflight:
                self._cv.wait(0.1)

    def close(self) -> None:
        """Dispatch whatever is still queued, then stop the worker."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join()

    def __enter__(self) -> "DeadlineScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatch side (worker thread only) ---------------------------------
    def _loop(self) -> None:
        dev = self.engine.device
        # a new thread's current CUDA device is the default one: make the
        # engine's current here, so every launch of this thread goes there
        scope = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with scope:
            self._dispatch_loop()

    def _dispatch_loop(self) -> None:
        B = self.engine.batch_size
        while True:
            with self._cv:
                while True:
                    if self._queue and len(self._queue) >= B:
                        trigger = "full"  # static batch packed
                        break
                    if self._queue and self._closed:
                        trigger = "close"  # closing: run what's there
                        break
                    if self._closed:
                        return  # queue empty — done
                    if self._queue:
                        # partial batch: sleep until the earliest queued
                        # deadline (requests carry their own, so the head
                        # of the FIFO need not be the most urgent)
                        wait = min(p.deadline for p in self._queue) - time.perf_counter()
                        if wait <= 0:
                            trigger = "deadline"  # dispatch padded
                            break
                        self._cv.wait(wait)
                    else:
                        self._cv.wait()
                take = min(B, len(self._queue))
                batch = [self._queue.popleft() for _ in range(take)]
                self._inflight = True
                _M_QUEUE_DEPTH.set(len(self._queue))
            t_disp = time.perf_counter()
            for p in batch:
                self.queue_wait.observe(t_disp - p.t_submit)
                _M_QUEUE_WAIT.observe(t_disp - p.t_submit)
            _M_DISPATCHES.labels(trigger=trigger).inc()
            try:
                with trace.span("serve.dispatch", trigger=trigger, n=len(batch)):
                    rows = np.stack([p.row for p in batch])
                    preds = self.engine._run_batch(self.engine._pack(rows), len(batch))
                done = time.perf_counter()
                # one bulk conversion instead of a per-element int() round
                answers: List[Union[int, Exception]] = preds.tolist()
            except Exception as e:  # keep serving; surface at result()
                done = time.perf_counter()
                answers = [e] * len(batch)
            with self._cv:
                for p, a in zip(batch, answers):
                    self._results[p.rid] = a
                    self.engine.stats.request_latencies.observe(done - p.t_submit)
                    _M_REQ_LATENCY.observe(done - p.t_submit)
                self._inflight = False
                self._cv.notify_all()
