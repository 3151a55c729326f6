"""The run-time configuration of a ported federation (answers to
``repro/core/plan.py``).

Only what the fused, homogeneous AdaBoost.F path reads is here: the
round count and the algorithm name.  The path has one way to run each
stage, so none of the JAX package's §5.1 toggles has a second value to
choose here yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

ALGORITHMS = ("adaboost_f",)


@dataclasses.dataclass(frozen=True)
class Plan:
    rounds: int = 100
    algorithm: str = "adaboost_f"

    def validate(self) -> "Plan":
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"algorithm {self.algorithm!r} is not ported; have {ALGORITHMS}"
            )
        if self.rounds < 1:
            raise ValueError(f"rounds must be positive, got {self.rounds}")
        return self


def adaboost_plan(**over: Any) -> Plan:
    """The default MAFL model-agnostic plan (AdaBoost.F)."""
    return Plan(**over).validate()
