"""The run-time configuration of a ported federation (answers to
``repro/core/plan.py``).

Only what the fused path reads is here: the round count, the algorithm,
the learner groups of a heterogeneous federation and the split.  The path
has one way to run each stage, so none of the JAX package's §5.1 toggles
(``OptimizationFlags``) has a second value to choose here yet; they come
back with the interpreted path, ROADMAP Queue 1 item 11, as does FedAvg
(OpenFL's DNN workflow).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

ALGORITHMS = ("adaboost_f", "distboost_f", "preweak_f", "bagging")
UNPORTED = {"fedavg": "ROADMAP Queue 1 item 11"}
SPLITS = ("iid", "dirichlet")


@dataclasses.dataclass(frozen=True)
class LearnerPlan:
    name: str = "decision_tree"
    hparams: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class DataPlan:
    split: str = "iid"  # iid | dirichlet
    dirichlet_alpha: float = 0.5


@dataclasses.dataclass(frozen=True)
class Plan:
    rounds: int = 100
    algorithm: str = "adaboost_f"
    # a heterogeneous federation: collaborator i trains learners[i % len]
    # (an empty tuple: homogeneous, the Federation's LearnerSpec)
    learners: tuple = ()
    data: DataPlan = dataclasses.field(default_factory=DataPlan)

    def validate(self) -> "Plan":
        if self.learners and self.algorithm == "fedavg":
            raise ValueError(
                "heterogeneous learners require the model-agnostic workflow; "
                "fedavg averages parameters and cannot mix model families"
            )
        if self.algorithm in UNPORTED:
            raise ValueError(
                f"algorithm {self.algorithm!r} is not ported yet ({UNPORTED[self.algorithm]})"
            )
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}; have {ALGORITHMS}")
        if self.rounds < 1:
            raise ValueError(f"rounds must be positive, got {self.rounds}")
        if not all(isinstance(lp, LearnerPlan) for lp in self.learners):
            raise ValueError("Plan.learners holds LearnerPlan entries")
        if self.data.split not in SPLITS:
            raise ValueError(f"unknown split {self.data.split!r}; have {SPLITS}")
        if not self.data.dirichlet_alpha > 0:
            raise ValueError(f"dirichlet_alpha must be positive, got {self.data.dirichlet_alpha}")
        return self


def adaboost_plan(**over: Any) -> Plan:
    """The default MAFL model-agnostic plan (AdaBoost.F; ``algorithm=``
    picks DistBoost.F or PreWeak.F on the same task graph)."""
    return Plan(**over).validate()


def bagging_plan(**over: Any) -> Plan:
    """Federated bagging: the AdaBoost.F graph without ``adaboost_update``."""
    return Plan(algorithm="bagging", **over).validate()
