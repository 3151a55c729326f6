"""The Plan — a ported federation's run-time configuration (answers to
``repro/core/plan.py``, paper §4.1).

OpenFL's Plan is a YAML file naming the components, the number of rounds
and, after the MAFL extension, the task vocabulary that composes a
federated round.  Here the Plan is a typed dataclass tree, loadable from a
dict or YAML, and every field is honoured: ``validate`` refuses what the
run would otherwise silently override.

``OptimizationFlags`` are the paper's §5.1 toggles with the JAX package's
defaults.  The JAX package's kernel flag (``use_pallas``) and its tile
sizes (``tree_block_s``, ``tree_block_d``) have no counterpart: a kernel
wrapper dispatches on its tensors' device, and its tiles are planned from
the shapes (``kernels/*.py``).  :func:`plan_from_dict` still accepts those
three keys and ignores them, so a plan the JAX package saved loads here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

try:  # PyYAML is optional: the dict round-trip needs none of it
    import yaml
except ImportError:  # pragma: no cover
    yaml = None

ALGORITHMS = ("adaboost_f", "distboost_f", "preweak_f", "bagging", "fedavg")
SPLITS = ("iid", "dirichlet")

# The six tasks of the MAFL vocabulary (paper §4.1): OpenFL's original DNN
# workflow, then the MAFL extension.
STANDARD_TASKS = (
    "aggregated_model_validation",
    "train",
    "locally_tuned_model_validation",
)
MAFL_TASKS = (
    "weak_learners_validate",
    "adaboost_update",
    "adaboost_validate",
)
ALL_TASKS = STANDARD_TASKS + MAFL_TASKS
# keys of the JAX package's OptimizationFlags that the port has no use for
_JAX_ONLY_FLAGS = ("use_pallas", "tree_block_s", "tree_block_d")


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    kind: str  # one of ALL_TASKS
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class OptimizationFlags:
    """The paper's §5.1 optimisations, each a toggle.

    packed_serialization: one contiguous wire buffer per message, not a
        buffer per leaf (the gRPC buffer-resize fix).
    bounded_tensordb: keep only the last ``tensordb_retention`` rounds
        (the clean_up fix: constant memory and query time).
    fast_barrier: a structural barrier instead of sleep-polling (the
        sleep calibration fix).
    fused_round: run the round as the composed stages of
        ``core/boosting.py`` instead of the interpreted task graph.
    cache_predictions: predict once: PreWeak.F keeps its set-up
        ``[C, C*T, n]`` prediction cache, and evaluation keeps a running
        vote tally that scores only the members appended since the last
        evaluation (off: the space is predicted every round, and every
        evaluation predicts the whole ensemble).
    batched_fit: fit the C collaborators' trees as one tensor program
        (one ``tree_hist`` launch a level) instead of C fits over each
        collaborator's slice of the fit cache (C launches a level).
    """

    packed_serialization: bool = True
    bounded_tensordb: bool = True
    tensordb_retention: int = 2
    fast_barrier: bool = True
    fused_round: bool = True
    cache_predictions: bool = True
    batched_fit: bool = True


@dataclasses.dataclass(frozen=True)
class RolePlan:
    nn: bool = False  # False selects the model-agnostic workflow (§4.1)
    rounds: int = 100
    sleep_s: float = 0.01  # polling interval while fast_barrier is off


@dataclasses.dataclass(frozen=True)
class LearnerPlan:
    name: str = "decision_tree"
    hparams: Dict[str, Any] = dataclasses.field(default_factory=dict)


# ``Plan.learners`` (heterogeneous federations): a non-empty tuple of
# LearnerPlans is cycled over the collaborators, collaborator i training
# learners[i % len(learners)]; ``Plan.learner`` is then ignored.  FedAvg
# averages parameters and stays homogeneous.


@dataclasses.dataclass(frozen=True)
class DataPlan:
    dataset: str = "adult"
    n_collaborators: int = 8
    split: str = "iid"  # iid | dirichlet
    dirichlet_alpha: float = 0.5
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    aggregator: RolePlan = dataclasses.field(default_factory=RolePlan)
    collaborator: RolePlan = dataclasses.field(default_factory=RolePlan)
    tasks: List[TaskSpec] = dataclasses.field(default_factory=list)
    algorithm: str = "adaboost_f"  # one of ALGORITHMS
    learner: LearnerPlan = dataclasses.field(default_factory=LearnerPlan)
    learners: tuple = ()
    data: DataPlan = dataclasses.field(default_factory=DataPlan)
    optimizations: OptimizationFlags = dataclasses.field(default_factory=OptimizationFlags)

    def validate(self) -> "Plan":
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}; have {ALGORITHMS}")
        for t in self.tasks:
            if t.kind not in ALL_TASKS:
                raise ValueError(f"unknown task kind {t.kind!r}; vocabulary: {ALL_TASKS}")
        kinds = [t.kind for t in self.tasks]
        if self.algorithm in ("adaboost_f", "distboost_f", "preweak_f"):
            if "adaboost_update" not in kinds:
                raise ValueError(f"{self.algorithm} requires an adaboost_update task")
            if kinds.index("adaboost_update") < kinds.index("weak_learners_validate"):
                raise ValueError("adaboost_update must follow weak_learners_validate")
            if self.aggregator.nn or self.collaborator.nn:
                raise ValueError("model-agnostic workflow requires nn: False (paper §4.1)")
        if self.algorithm == "bagging" and "adaboost_update" in kinds:
            raise ValueError("bagging is obtained by OMITTING adaboost_update (paper §4.1)")
        if self.aggregator.rounds != self.collaborator.rounds:
            raise ValueError("aggregator and collaborator round counts must agree")
        if self.aggregator.rounds < 1:
            raise ValueError(f"rounds must be positive, got {self.aggregator.rounds}")
        if self.learners:
            if self.algorithm == "fedavg":
                raise ValueError(
                    "heterogeneous learners require the model-agnostic workflow; "
                    "fedavg averages parameters and cannot mix model families"
                )
            if not all(isinstance(lp, LearnerPlan) for lp in self.learners):
                raise ValueError("Plan.learners holds LearnerPlan entries")
            if not self.optimizations.fused_round:
                raise ValueError(
                    "heterogeneous learners require optimizations.fused_round: the "
                    "interpreted simulation stacks one hypothesis pytree per round"
                )
        if self.data.split not in SPLITS:
            raise ValueError(f"unknown split {self.data.split!r}; have {SPLITS}")
        if not self.data.dirichlet_alpha > 0:
            raise ValueError(f"dirichlet_alpha must be positive, got {self.data.dirichlet_alpha}")
        return self


ADABOOST_TASKS = ("train", "weak_learners_validate", "adaboost_update", "adaboost_validate")
BAGGING_TASKS = ("train", "weak_learners_validate", "adaboost_validate")


def adaboost_plan(**over: Any) -> Plan:
    """The default MAFL model-agnostic plan: the AdaBoost.F task graph
    (``algorithm=`` picks DistBoost.F or PreWeak.F on the same graph)."""
    return _build(ADABOOST_TASKS, algorithm=over.pop("algorithm", "adaboost_f"), **over)


def bagging_plan(**over: Any) -> Plan:
    """Federated bagging: the AdaBoost.F graph without ``adaboost_update``."""
    return _build(BAGGING_TASKS, algorithm="bagging", **over)


def fedavg_plan(**over: Any) -> Plan:
    """OpenFL's original three-task DNN workflow (the standard FL baseline)."""
    rounds = over.pop("rounds", 100)
    return Plan(
        aggregator=RolePlan(nn=True, rounds=rounds),
        collaborator=RolePlan(nn=True, rounds=rounds),
        tasks=[TaskSpec(k, k) for k in STANDARD_TASKS],
        algorithm="fedavg",
        **over,
    ).validate()


def _build(kinds, algorithm: str, rounds: int = 100, **over: Any) -> Plan:
    return Plan(
        aggregator=RolePlan(nn=False, rounds=rounds),
        collaborator=RolePlan(nn=False, rounds=rounds),
        tasks=[TaskSpec(k, k) for k in kinds],
        algorithm=algorithm,
        **over,
    ).validate()


# ---------------------------------------------------------------------------
# YAML / dict round-trip
# ---------------------------------------------------------------------------


def plan_from_dict(d: Dict[str, Any]) -> Plan:
    def role(key: str) -> RolePlan:
        return RolePlan(**d.get(key, {}))

    flags = {k: v for k, v in d.get("optimizations", {}).items() if k not in _JAX_ONLY_FLAGS}
    return Plan(
        aggregator=role("aggregator"),
        collaborator=role("collaborator"),
        tasks=[TaskSpec(**t) for t in d.get("tasks", [])],
        algorithm=d.get("algorithm", "adaboost_f"),
        learner=LearnerPlan(**d.get("learner", {})),
        learners=tuple(LearnerPlan(**lp) for lp in d.get("learners", [])),
        data=DataPlan(**d.get("data", {})),
        optimizations=OptimizationFlags(**flags),
    ).validate()


def plan_to_dict(p: Plan) -> Dict[str, Any]:
    d = dataclasses.asdict(p)
    d["learners"] = list(d.get("learners", ()))  # YAML has no tuple type
    return d


def load_plan(path: str) -> Plan:
    if yaml is None:  # pragma: no cover
        raise RuntimeError("PyYAML unavailable; use plan_from_dict")
    with open(path) as f:
        return plan_from_dict(yaml.safe_load(f))


def save_plan(p: Plan, path: str) -> None:
    if yaml is None:  # pragma: no cover
        raise RuntimeError("PyYAML unavailable; use plan_to_dict")
    with open(path, "w") as f:
        yaml.safe_dump(plan_to_dict(p), f)
