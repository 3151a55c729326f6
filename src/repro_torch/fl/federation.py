"""The MAFL federation runtime, fused homogeneous AdaBoost.F path
(answers to ``Federation`` in ``repro/fl/federation.py``).

A round is the composed fit / score / aggregate stages of
``core/boosting.py`` run eagerly on the federation's device; its three hot
spots launch the hand-written kernels on the card.  Nothing in the round
loop copies to the host: the round's metrics stay device tensors until an
evaluation row reads them, all in one transfer.  Communication
accounting, the interpreted (OpenFL-style) path, heterogeneous and
elastic federations are not ported yet.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core import boosting, scoring
from repro_torch.core.metrics import f1_macro
from repro_torch.core.plan import Plan
from repro_torch.device import resolve_device
from repro_torch.learners.base import LearnerSpec, get_learner

_METRIC_KEYS = ("epsilon", "alpha", "chosen")


class Federation:
    """C collaborators' shards plus a held-out test set, on one device."""

    def __init__(self, plan: Plan, Xs, ys, masks, X_test, y_test, spec: LearnerSpec,
                 *, device: str | torch.device = "cuda"):
        plan.validate()
        self.plan = plan
        self.device = resolve_device(device)
        self.spec = spec
        self.learner = get_learner(spec.name)
        dev = self.device
        self.Xs = torch.as_tensor(Xs, dtype=torch.float32).to(dev).contiguous()  # [C, n, d]
        self.ys = torch.as_tensor(ys, dtype=torch.int32).to(dev).contiguous()  # [C, n]
        self.masks = torch.as_tensor(masks, dtype=torch.float32).to(dev).contiguous()
        self.X_test = torch.as_tensor(X_test, dtype=torch.float32).to(dev).contiguous()
        self.y_test = torch.as_tensor(y_test, dtype=torch.int32).to(dev).contiguous()
        self.n_collaborators = self.Xs.shape[0]
        self._row_marker = (time.perf_counter(), 0)  # (wall time, round) at the last row
        self.history: List[Dict[str, float]] = []
        self.state: Optional[boosting.BoostState] = None
        self._round_metrics: List[Dict[str, torch.Tensor]] = []

    # -- main loop ---------------------------------------------------------
    def run(self, rounds: Optional[int] = None, eval_every: int = 1) -> List[Dict[str, float]]:
        """Run the federation; a history row every ``eval_every`` rounds
        and after the last."""
        return self._run_fused(rounds or self.plan.rounds, eval_every)

    def per_round(self) -> List[Dict[str, float]]:
        """epsilon / alpha / chosen of every round run so far, fetched from
        the device in one transfer."""
        if not self._round_metrics:
            return []
        table = torch.stack([
            torch.stack([m[k].to(torch.float32) for k in _METRIC_KEYS])
            for m in self._round_metrics
        ]).tolist()
        return [
            {"round": r, "epsilon": eps, "alpha": alpha, "chosen": round(chosen)}
            for r, (eps, alpha, chosen) in enumerate(table)
        ]

    def _history_extras(self, r: int) -> Dict[str, float]:
        """round_seconds since the previous history row (a per-round
        average when rows are sparser than rounds)."""
        now = time.perf_counter()
        t0, r0 = self._row_marker
        self._row_marker = (now, r + 1)
        return {"round_seconds": (now - t0) / max(r + 1 - r0, 1)}

    def _fused_loop(self, rounds: int, eval_every: int, state, round_fn: Callable,
                    evaluate: Callable) -> List[Dict[str, float]]:
        """The round loop.  Metrics reach the host only at an eval row:
        ``f1`` and the round's metrics go over in one ``tolist``."""
        self._row_marker = (time.perf_counter(), 0)
        for r in range(rounds):
            state, metrics = round_fn(state, self.Xs, self.ys, self.masks)
            self._round_metrics.append(metrics)
            if (r + 1) % eval_every == 0 or r == rounds - 1:
                f1 = evaluate(state)
                f1_, eps, alpha, chosen = torch.stack([f1.to(torch.float32)] + [
                    metrics[k].to(torch.float32) for k in _METRIC_KEYS
                ]).tolist()  # the one host sync of this eval
                self.history.append({
                    "round": r, "f1": f1_, "epsilon": eps, "alpha": alpha,
                    "chosen": round(chosen), **self._history_extras(r),
                })
        self.state = state
        return self.history

    def _run_fused(self, rounds: int, eval_every: int) -> List[Dict[str, float]]:
        learner, spec = self.learner, self.spec
        state = boosting.init_boost_state(learner, spec, rounds, self.masks, X=self.Xs)
        stages = boosting.adaboost_f_stages(learner, spec)

        def round_fn(s, X, y, m):
            return boosting.run_stages(stages, s, X, y, m)

        # incremental eval: each eval adds only the members appended since
        # the previous one
        tally = scoring.init_tally(self.X_test.shape[0], spec.n_classes, self.device)

        def evaluate(s):
            nonlocal tally
            tally = scoring.tally_new_votes(learner, spec, s.ensemble, tally, self.X_test)
            return f1_macro(self.y_test, scoring.tally_predict(tally), spec.n_classes)

        return self._fused_loop(rounds, eval_every, state, round_fn, evaluate)


def history_summary(fed: Federation) -> Dict[str, Any]:
    """JSON-ready record of a run: history rows and every round's metrics."""
    return {"history": fed.history, "rounds": fed.per_round(), "device": str(fed.device)}
