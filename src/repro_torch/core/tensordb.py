"""TensorDB — the round-indexed model and metric store (answers to
``repro/core/tensordb.py``, paper §4.3).

OpenFL's TensorDB is a pandas frame keyed by (name, round, tags, origin)
whose query time grows linearly with the rounds; the paper's fix bounds it
to the last two rounds.  Both behaviours are here (``retention=None``
against ``retention=k``), so the §5.1 ablation can measure the gap, and a
value may be any artifact (a serialized model, a metric), not only a
tensor: the model-agnostic requirement.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TensorKey:
    name: str  # e.g. "weak_hypothesis", "adaboost_coeff", "metric/f1"
    origin: str  # "aggregator" | "collaborator_<i>"
    round: int
    tags: Tuple[str, ...] = ()


class TensorDB:
    def __init__(self, retention: Optional[int] = None):
        self._store: Dict[TensorKey, Any] = {}
        self.retention = retention
        self.query_seconds = 0.0  # host seconds spent in get / query
        self.peak_entries = 0

    def __len__(self) -> int:
        return len(self._store)

    def put(self, key: TensorKey, value: Any) -> None:
        self._store[key] = value
        self.peak_entries = max(self.peak_entries, len(self._store))
        if self.retention is not None:
            self.clean_up(key.round)

    def get(self, key: TensorKey) -> Any:
        t0 = time.perf_counter()
        try:
            return self._store[key]
        finally:
            self.query_seconds += time.perf_counter() - t0

    def query(
        self,
        name: Optional[str] = None,
        origin: Optional[str] = None,
        round: Optional[int] = None,
        tags: Optional[Tuple[str, ...]] = None,
    ) -> List[Tuple[TensorKey, Any]]:
        """A linear scan, as the pandas frame's, so that unbounded
        retention visibly slows every query."""
        t0 = time.perf_counter()
        out = []
        for k, v in self._store.items():
            if name is not None and k.name != name:
                continue
            if origin is not None and k.origin != origin:
                continue
            if round is not None and k.round != round:
                continue
            if tags is not None and k.tags != tags:
                continue
            out.append((k, v))
        self.query_seconds += time.perf_counter() - t0
        return out

    def clean_up(self, current_round: int) -> None:
        """Drop everything older than ``retention`` rounds (the paper's fix:
        keep only what the last two rounds need)."""
        if self.retention is None:
            return
        cutoff = current_round - self.retention + 1
        self._store = {k: v for k, v in self._store.items() if k.round >= cutoff}
