"""The MAFL round protocol as an interpreted task graph (answers to
``repro/core/protocol.py``, paper §4.1-4.2).

A federated round is a list of tasks from the six-word vocabulary
(``core/plan.py``).  The interpreter walks them, moving artifacts between
the collaborators and the aggregator through serialized buffers and
TensorDB entries, with a global ``synch`` barrier after every task (paper
§4.2: no two consecutive steps run before every collaborator has
finished the previous one).  Each task runs inside a ``task.<kind>`` span.

``Plan.optimizations.fused_round`` chooses between this interpreter (the
OpenFL-faithful path, whose overheads are what §5.1 optimises) and the
fused round of ``core/boosting.py``, for which the federation only logs.
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Any, Callable, Dict

from repro_torch.obs import trace

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.fl.federation import Federation

TaskFn = Callable[["Federation", int, Dict[str, Any]], None]
TASK_EXECUTORS: Dict[str, TaskFn] = {}


def task_executor(kind: str):
    def deco(fn: TaskFn) -> TaskFn:
        TASK_EXECUTORS[kind] = fn
        return fn

    return deco


class SynchBarrier:
    """The paper's general ``synch`` message.

    The polling mode sleeps in ``sleep_s`` quanta until every collaborator
    has reported its task done, as OpenFL does (and pays what OpenFL
    pays).  The structural mode returns at once: in one process the
    barrier is the program order itself."""

    def __init__(self, n_collaborators: int, sleep_s: float, structural: bool):
        self.n = n_collaborators
        self.sleep_s = sleep_s
        self.structural = structural
        self.waited_seconds = 0.0
        self._done = 0

    def report_done(self) -> None:
        self._done += 1

    def wait_all(self) -> None:
        if self.structural:
            self._done = 0
            return
        # The simulated collaborators finish before the barrier is polled,
        # so one poll finds them all done, but its sleep quantum is still
        # paid, as in OpenFL's implementation.
        t0 = time.perf_counter()
        time.sleep(self.sleep_s)
        self.waited_seconds += time.perf_counter() - t0
        self._done = 0


def run_round(fed: "Federation", round_idx: int) -> None:
    """One federated round: the plan's task list, a barrier after each."""
    for task in fed.plan.tasks:
        with trace.span("task." + task.kind, round=round_idx):
            TASK_EXECUTORS[task.kind](fed, round_idx, task.args)
        for _ in range(fed.n_collaborators):
            fed.barrier.report_done()
        fed.barrier.wait_all()
    fed.end_round_barrier(round_idx)
