"""The port's protocol substrate (``core/tensordb.py``, ``core/plan.py``,
``core/protocol.py``) against ``tests/test_core.py``'s cases and the JAX
package's own objects: the same retention, the same validation rules, the
same barrier, and a plan the JAX package wrote loads here."""
import dataclasses

import pytest

from repro.core import plan as jplan
from repro.core.tensordb import TensorDB as JaxTensorDB
from repro.core.tensordb import TensorKey as JaxTensorKey
from repro_torch.core import protocol
from repro_torch.core.plan import (
    ALL_TASKS,
    MAFL_TASKS,
    STANDARD_TASKS,
    DataPlan,
    LearnerPlan,
    OptimizationFlags,
    Plan,
    RolePlan,
    TaskSpec,
    adaboost_plan,
    bagging_plan,
    fedavg_plan,
    load_plan,
    plan_from_dict,
    plan_to_dict,
    save_plan,
)
from repro_torch.core.protocol import SynchBarrier
from repro_torch.core.tensordb import TensorDB, TensorKey

# -- TensorDB ------------------------------------------------------------------


def test_tensordb_bounded_retention():
    db = TensorDB(retention=2)
    for r in range(10):
        db.put(TensorKey("weak_hypothesis", "collaborator_0", r), {"r": r})
    rounds = {k.round for k, _ in db.query(name="weak_hypothesis")}
    assert rounds == {8, 9}  # only the last two rounds survive (the paper's fix)
    assert db.peak_entries <= 3


def test_tensordb_unbounded_grows():
    db = TensorDB(retention=None)
    for r in range(10):
        db.put(TensorKey("m", "aggregator", r), r)
    assert len(db) == 10


def test_tensordb_query_filters():
    db = TensorDB()
    db.put(TensorKey("h", "collaborator_0", 1, ("trained",)), "a")
    db.put(TensorKey("h", "collaborator_1", 1, ("trained",)), "b")
    db.put(TensorKey("h", "collaborator_0", 2, ("trained",)), "c")
    assert len(db.query(name="h", round=1)) == 2
    assert db.query(origin="collaborator_1")[0][1] == "b"
    assert db.query(tags=("trained",), round=2)[0][1] == "c"
    assert db.get(TensorKey("h", "collaborator_0", 2, ("trained",))) == "c"
    assert db.query_seconds > 0.0


@pytest.mark.parametrize("retention", [None, 1, 2, 3])
def test_tensordb_sizes_match_jax(retention):
    """The same puts give the JAX package's sizes and peak, entry by entry."""
    ours, theirs = TensorDB(retention), JaxTensorDB(retention)
    for r in range(6):
        for name, origin in (("weak_hypothesis", "collaborator_0"), ("weak_hypothesis", "collaborator_1"),
                             ("error_matrix", "aggregator"), ("metric/f1", "aggregator")):
            ours.put(TensorKey(name, origin, r), r)
            theirs.put(JaxTensorKey(name, origin, r), r)
            assert len(ours) == len(theirs)
    assert ours.peak_entries == theirs.peak_entries
    assert sorted((k.name, k.origin, k.round) for k, _ in ours.query()) == sorted(
        (k.name, k.origin, k.round) for k, _ in theirs.query())


# -- Plan ------------------------------------------------------------------------


def test_task_vocabulary_is_the_jax_packages():
    assert STANDARD_TASKS == jplan.STANDARD_TASKS
    assert MAFL_TASKS == jplan.MAFL_TASKS
    assert ALL_TASKS == jplan.ALL_TASKS


def test_default_plans_validate():
    for p in (adaboost_plan(), bagging_plan(), fedavg_plan()):
        p.validate()
    assert [t.kind for t in adaboost_plan().tasks] == [t.kind for t in jplan.adaboost_plan().tasks]
    assert [t.kind for t in bagging_plan().tasks] == [t.kind for t in jplan.bagging_plan().tasks]
    assert [t.kind for t in fedavg_plan().tasks] == [t.kind for t in jplan.fedavg_plan().tasks]
    assert fedavg_plan(rounds=3).aggregator == RolePlan(nn=True, rounds=3)


def test_optimization_flags_keep_the_jax_defaults():
    ours, theirs = OptimizationFlags(), jplan.OptimizationFlags()
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert not hasattr(ours, "use_pallas")  # no kernel flag: dispatch is by device


def test_plan_rejects_bad_task_order():
    tasks = [
        TaskSpec("adaboost_update", "adaboost_update"),
        TaskSpec("weak_learners_validate", "weak_learners_validate"),
    ]
    with pytest.raises(ValueError, match="must follow"):
        Plan(RolePlan(), RolePlan(), tasks, "adaboost_f").validate()


def test_plan_rejects_unknown_task():
    with pytest.raises(ValueError, match="unknown task"):
        Plan(RolePlan(), RolePlan(), [TaskSpec("x", "not_a_task")], "adaboost_f").validate()


def test_plan_bagging_must_omit_update():
    tasks = [
        TaskSpec("train", "train"),
        TaskSpec("weak_learners_validate", "weak_learners_validate"),
        TaskSpec("adaboost_update", "adaboost_update"),
    ]
    with pytest.raises(ValueError, match="OMITTING"):
        Plan(RolePlan(), RolePlan(), tasks, "bagging").validate()


def test_plan_nn_flag_gates_workflows():
    p = adaboost_plan()
    bad = dataclasses.replace(p, aggregator=dataclasses.replace(p.aggregator, nn=True))
    with pytest.raises(ValueError, match="nn: False"):
        bad.validate()


def test_plan_requires_adaboost_update_and_matching_rounds():
    p = adaboost_plan()
    with pytest.raises(ValueError, match="requires an adaboost_update"):
        dataclasses.replace(p, tasks=p.tasks[:2]).validate()
    with pytest.raises(ValueError, match="round counts must agree"):
        dataclasses.replace(p, collaborator=RolePlan(rounds=3)).validate()


def test_plan_refuses_heterogeneous_learners_off_the_fused_path():
    mix = (LearnerPlan("decision_tree"), LearnerPlan("ridge"))
    assert adaboost_plan(learners=mix).learners == mix
    with pytest.raises(ValueError, match="fused_round"):
        adaboost_plan(learners=mix, optimizations=OptimizationFlags(fused_round=False))
    with pytest.raises(ValueError, match="cannot mix model families"):
        fedavg_plan(learners=mix)


def test_plan_dict_roundtrip():
    p = adaboost_plan(rounds=7, optimizations=OptimizationFlags(bounded_tensordb=False))
    p2 = plan_from_dict(plan_to_dict(p))
    assert p2 == p
    assert p2.aggregator.rounds == 7
    assert [t.kind for t in p2.tasks] == [t.kind for t in p.tasks]


@pytest.mark.parametrize("make", ["adaboost", "bagging", "fedavg", "faithful"])
def test_plan_the_jax_package_wrote_loads(make):
    """A dict ``repro.core.plan.plan_to_dict`` wrote loads into the port's
    Plan; its ``use_pallas`` and tile sizes are ignored, every other field
    kept."""
    jp = {
        "adaboost": lambda: jplan.adaboost_plan(rounds=5, algorithm="preweak_f"),
        "bagging": lambda: jplan.bagging_plan(rounds=4),
        "fedavg": lambda: jplan.fedavg_plan(rounds=3),
        "faithful": lambda: dataclasses.replace(
            jplan.adaboost_plan(rounds=2), optimizations=jplan.OptimizationFlags(
                False, False, 2, False, False, use_pallas=True, cache_predictions=False,
                tree_block_s=256)),
    }[make]()
    d = jplan.plan_to_dict(jp)
    assert "use_pallas" in d["optimizations"]
    p = plan_from_dict(d)
    assert p.algorithm == jp.algorithm
    assert p.aggregator.rounds == jp.aggregator.rounds and p.aggregator.nn == jp.aggregator.nn
    assert [(t.name, t.kind) for t in p.tasks] == [(t.name, t.kind) for t in jp.tasks]
    for f in dataclasses.fields(p.optimizations):
        assert getattr(p.optimizations, f.name) == getattr(jp.optimizations, f.name)
    assert dataclasses.asdict(p.data) == dataclasses.asdict(jp.data)


def test_plan_yaml_roundtrip(tmp_path):
    p = fedavg_plan(rounds=4, data=DataPlan(dataset="vehicle", n_collaborators=4))
    save_plan(p, str(tmp_path / "plan.yaml"))
    assert load_plan(str(tmp_path / "plan.yaml")) == p


# -- barrier ---------------------------------------------------------------------


def test_structural_barrier_is_free():
    b = SynchBarrier(8, sleep_s=10.0, structural=True)
    for _ in range(8):
        b.report_done()
    b.wait_all()
    assert b.waited_seconds == 0.0


def test_polling_barrier_pays_sleep():
    b = SynchBarrier(2, sleep_s=0.01, structural=False)
    for _ in range(2):
        b.report_done()
    b.wait_all()
    assert b.waited_seconds >= 0.01


def test_run_round_walks_the_tasks_with_a_barrier_after_each():
    """``run_round`` runs each task of the plan in order, reports every
    collaborator done after it, waits, and ends the round once."""
    calls = []

    class Fed:
        plan = bagging_plan(rounds=1)
        n_collaborators = 3
        barrier = SynchBarrier(3, sleep_s=0.0, structural=True)

        def end_round_barrier(self, r):
            calls.append(("end", r))

    saved = dict(protocol.TASK_EXECUTORS)
    try:
        for kind in ALL_TASKS:
            protocol.task_executor(kind)(lambda fed, r, args, kind=kind: calls.append((kind, r)))
        protocol.run_round(Fed(), 4)
    finally:
        protocol.TASK_EXECUTORS.clear()
        protocol.TASK_EXECUTORS.update(saved)
    assert calls == [("train", 4), ("weak_learners_validate", 4), ("adaboost_validate", 4),
                     ("end", 4)]
