"""The run-time configuration of a ported federation (answers to
``repro/core/plan.py``).

Only what the fused homogeneous path reads is here: the round count and
the algorithm name.  The path has one way to run each stage, so none of
the JAX package's §5.1 toggles has a second value to choose here yet.
FedAvg (OpenFL's DNN workflow) is not ported: it comes with the
interpreted path, ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
from typing import Any

ALGORITHMS = ("adaboost_f", "distboost_f", "preweak_f", "bagging")
UNPORTED = {"fedavg": "ROADMAP Queue 1 item 11"}


@dataclasses.dataclass(frozen=True)
class Plan:
    rounds: int = 100
    algorithm: str = "adaboost_f"

    def validate(self) -> "Plan":
        if self.algorithm in UNPORTED:
            raise ValueError(
                f"algorithm {self.algorithm!r} is not ported yet ({UNPORTED[self.algorithm]})"
            )
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}; have {ALGORITHMS}")
        if self.rounds < 1:
            raise ValueError(f"rounds must be positive, got {self.rounds}")
        return self


def adaboost_plan(**over: Any) -> Plan:
    """The default MAFL model-agnostic plan (AdaBoost.F; ``algorithm=``
    picks DistBoost.F or PreWeak.F on the same task graph)."""
    return Plan(**over).validate()


def bagging_plan(**over: Any) -> Plan:
    """Federated bagging: the AdaBoost.F graph without ``adaboost_update``."""
    return Plan(algorithm="bagging", **over).validate()
