"""The port's interpreted (OpenFL-style) round, FedAvg and the §5.1
``OptimizationFlags`` against the JAX package, on the CPU, from the same
numpy inputs (``tests/test_torch_boosting.py``'s vehicle-sized shards,
C = 4, depth 4, 16 bins).

Tolerances: alpha rtol 1e-4 (the errors' tolerance: the aggregator's
float64 arithmetic starts from float32 errors summed in other orders),
weights rtol 1e-5 (the weight update's), F1 within 1e-3 (the port's
fused-path contract), the aggregators rtol 1e-6; communication bytes and
TensorDB sizes exactly.  The port's interpreted and fused runs agree
within F1 1e-5, the JAX package's own contract
(``tests/test_fl_end2end.py``); the fused flags change no bit on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import scoring as jscoring
from repro.core.plan import OptimizationFlags as JaxFlags
from repro.core.plan import adaboost_plan as jax_adaboost_plan
from repro.core.plan import bagging_plan as jax_bagging_plan
from repro.core.plan import fedavg_plan as jax_fedavg_plan
from repro.fl.federation import Federation as JaxFederation
from repro.learners import LearnerSpec as JaxSpec
from repro.learners.mlp import MLPParams as JaxMLPParams
from repro_torch.core import aggregation, scoring
from repro_torch.core.metrics import f1_macro
from repro_torch.core.plan import (
    LearnerPlan, OptimizationFlags, adaboost_plan, bagging_plan, fedavg_plan,
)
from repro_torch.fl.federation import Federation
from repro_torch.learners import LearnerSpec
from repro_torch.learners.mlp import MLPParams
from test_torch_boosting import HP, _shards

ROUNDS = 8
SEED = 5


def _flags(cls, packed=True, bounded=True, fast=True, fused=False, **kw):
    return cls(packed_serialization=packed, bounded_tensordb=bounded, fast_barrier=fast,
               fused_round=fused, **kw)


@functools.lru_cache(maxsize=None)
def _data():
    return _shards(seed=SEED)


def _plans(algorithm, flags_kw, rounds):
    if algorithm == "bagging":
        return (jax_bagging_plan(rounds=rounds, optimizations=_flags(JaxFlags, **flags_kw)),
                bagging_plan(rounds=rounds, optimizations=_flags(OptimizationFlags, **flags_kw)))
    return (jax_adaboost_plan(rounds=rounds, algorithm=algorithm,
                              optimizations=_flags(JaxFlags, **flags_kw)),
            adaboost_plan(rounds=rounds, algorithm=algorithm,
                          optimizations=_flags(OptimizationFlags, **flags_kw)))


@functools.lru_cache(maxsize=None)
def _jax_run(algorithm="adaboost_f", packed=True, bounded=True):
    Xs, ys, masks, Xte, yte, K = _data()
    plan, _ = _plans(algorithm, dict(packed=packed, bounded=bounded), ROUNDS)
    fed = JaxFederation(plan, jnp.asarray(Xs), jnp.asarray(ys), jnp.asarray(masks),
                        jnp.asarray(Xte), jnp.asarray(yte), JaxSpec("decision_tree", Xs.shape[2], K, HP),
                        jax.random.PRNGKey(0))
    return fed, fed.run(eval_every=1)


def _port_run(algorithm="adaboost_f", rounds=ROUNDS, eval_every=1, **flags_kw):
    Xs, ys, masks, Xte, yte, K = _data()
    _, plan = _plans(algorithm, flags_kw, rounds)
    fed = Federation(plan, Xs, ys, masks, Xte, yte, LearnerSpec("decision_tree", Xs.shape[2], K, HP),
                     device="cpu")
    return fed, fed.run(eval_every=eval_every)


def _assert_members_match(tfed, jfed):
    tens, jens = tfed.aggregator.ensemble, jfed.aggregator.ensemble
    assert len(tens) == len(jens)
    for t, ((tp, ta), (jp, ja)) in enumerate(zip(tens, jens)):
        np.testing.assert_array_equal(tp.feature.numpy(), np.asarray(jp.feature), err_msg=f"round {t}")
        # each side bins its own shard: quantile edges agree to the last ulp
        np.testing.assert_allclose(tp.threshold.numpy(), np.asarray(jp.threshold), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tp.leaf_logits.numpy(), np.asarray(jp.leaf_logits), atol=1e-5)
        np.testing.assert_allclose(ta, ja, rtol=1e-4)


def _db_sizes(fed):
    dbs = [fed.aggregator.db] + [c.db for c in fed.collaborators]
    return [(len(db), db.peak_entries) for db in dbs]


# -- interpreted AdaBoost.F against the JAX package's -------------------------------------


@pytest.mark.parametrize("packed,bounded", [(True, True), (False, False), (False, True),
                                            (True, False)])
def test_interpreted_adaboost_matches_jax(packed, bounded):
    """The same chosen member every round (the same tree), alpha within
    rtol 1e-4, F1 within 1e-3 at every round, every collaborator's final
    weights within rtol 1e-5, the same wire bytes and TensorDB sizes."""
    jfed, jhist = _jax_run("adaboost_f", packed, bounded)
    tfed, thist = _port_run(packed=packed, bounded=bounded)
    _assert_members_match(tfed, jfed)
    assert [h["round"] for h in thist] == [h["round"] for h in jhist] == list(range(ROUNDS))
    for th, jh in zip(thist, jhist):
        assert abs(th["f1"] - jh["f1"]) < 1e-3
        np.testing.assert_allclose(th["alpha"], jh["alpha"], rtol=1e-4)
    for tc, jc in zip(tfed.collaborators, jfed.collaborators):
        np.testing.assert_allclose(tc.weights.numpy(), np.asarray(jc.weights), rtol=1e-5)
    assert tfed.comm_bytes == jfed.comm_bytes
    assert _db_sizes(tfed) == _db_sizes(jfed)
    # a round puts 7 entries (C = 4 hypotheses, the error matrix, alpha, F1);
    # bounded, the last two rounds are kept, plus the new round's first put
    assert tfed.aggregator.db.peak_entries == (2 * 7 + 1 if bounded else 7 * ROUNDS)


def test_interpreted_round_records_chosen_epsilon_and_alpha():
    """``per_round`` of an interpreted run: the host float64 argmin,
    epsilon and alpha, one entry a round, alpha the history rows' own."""
    tfed, thist = _port_run()
    rounds = tfed.per_round()
    assert [r["round"] for r in rounds] == list(range(ROUNDS))
    assert [r["alpha"] for r in rounds] == [h["alpha"] for h in thist]
    assert all(0 <= r["chosen"] < 4 and 0.0 <= r["epsilon"] <= 1.0 for r in rounds)
    errs, norms = tfed._round_scratch["errs"], tfed._round_scratch["norms"]
    assert errs.dtype == norms.dtype == np.float64 and errs.shape == (4, 4)
    last = rounds[-1]
    assert last["chosen"] == int(np.argmin(errs.sum(axis=0) / norms.sum()))


def test_interpreted_round_renormalizes_from_the_host_total():
    tfed, _ = _port_run(rounds=2)
    total = sum(float(torch.sum(c.weights)) for c in tfed.collaborators)
    assert abs(total - 1.0) < 1e-5
    assert all(float(torch.sum(c.weights * (1 - c.mask))) == 0.0 for c in tfed.collaborators)


def test_port_interpreted_equals_port_fused():
    """The §5.1 optimisations change no result: the interpreted and the
    fused port choose the same member every round, with F1 within 1e-5."""
    tint, ihist = _port_run()
    tfus, fhist = _port_run(fused=True)
    assert [r["chosen"] for r in tint.per_round()] == [r["chosen"] for r in tfus.per_round()]
    for a, b in zip(ihist, fhist):
        assert abs(a["f1"] - b["f1"]) < 1e-5
        np.testing.assert_allclose(a["alpha"], b["alpha"], rtol=1e-4)


@pytest.mark.parametrize("algorithm", ["distboost_f", "preweak_f"])
def test_interpreted_distboost_and_preweak_run_the_adaboost_graph(algorithm):
    """As in the JAX package, the interpreted task executors know no
    algorithm but FedAvg: DistBoost.F and PreWeak.F under
    ``fused_round=False`` run AdaBoost.F's task graph, member for member
    the JAX package's and the port's own AdaBoost.F run."""
    jfed, jhist = _jax_run(algorithm)
    tfed, thist = _port_run(algorithm)
    _assert_members_match(tfed, jfed)
    ada, ahist = _port_run("adaboost_f")
    assert [r["chosen"] for r in tfed.per_round()] == [r["chosen"] for r in ada.per_round()]
    assert [h["f1"] for h in thist] == [h["f1"] for h in ahist]
    for th, jh in zip(thist, jhist):
        assert abs(th["f1"] - jh["f1"]) < 1e-3
    assert tfed.comm_bytes == jfed.comm_bytes


def test_interpreted_bagging_appends_no_member():
    """The interpreted bagging graph has no ``adaboost_update``, and no
    other task appends: the ensemble stays empty on both sides, every
    evaluation predicts class 0, and the wire bytes are the uploads and the
    validation broadcast."""
    jfed, jhist = _jax_run("bagging")
    tfed, thist = _port_run("bagging")
    assert tfed.aggregator.ensemble == [] and jfed.aggregator.ensemble == []
    assert tfed.per_round() == []
    _, _, _, _, yte, K = _data()
    zero_f1 = float(f1_macro(torch.from_numpy(yte), torch.zeros(len(yte), dtype=torch.int32), K))
    for th, jh in zip(thist, jhist):
        assert th["alpha"] == jh["alpha"] == 0.0
        assert abs(th["f1"] - jh["f1"]) < 1e-6 and abs(th["f1"] - zero_f1) < 1e-6
    assert tfed.comm_bytes == jfed.comm_bytes
    assert _db_sizes(tfed) == _db_sizes(jfed)


def test_polling_barrier_and_end_of_round_sleep_are_paid():
    """With ``fast_barrier`` off every task's barrier sleeps ``sleep_s``
    and every round ends with ``max(10 * sleep_s, 0.1)`` more."""
    fed, _ = _port_run(rounds=2, fast=False)
    assert fed.end_round_sleep_s == 0.1
    assert fed.barrier.waited_seconds >= 2 * 4 * 0.01


# -- the fused path's flags ---------------------------------------------------------------


def _fused_record(fed, hist):
    ens = fed.state.ensemble
    return ([tuple(sorted(r.items())) for r in fed.per_round()],
            [(h["round"], h["f1"]) for h in hist], [x.clone() for x in ens.params], ens.alpha.clone())


def _same(a, b):
    assert a[0] == b[0] and a[1] == b[1]
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)
    assert torch.equal(a[3], b[3])


@pytest.mark.parametrize("flag", ["cache_predictions", "batched_fit"])
@pytest.mark.parametrize("algorithm", ["adaboost_f", "distboost_f", "preweak_f", "bagging"])
def test_fused_flags_change_no_bit(algorithm, flag):
    """``cache_predictions=False`` (PreWeak.F predicts its space every
    round; every evaluation predicts the whole ensemble) and
    ``batched_fit=False`` (a tree fit per collaborator over its slice of
    the fit cache) give the default run's rounds, F1 and ensemble bit for
    bit on the CPU."""
    base = _fused_record(*_port_run(algorithm, eval_every=2, fused=True))
    off = _fused_record(*_port_run(algorithm, eval_every=2, fused=True, **{flag: False}))
    _same(base, off)


@pytest.mark.parametrize("learners", [("extra_tree",), ("decision_tree", "extra_tree", "ridge")])
def test_batched_fit_off_draws_what_the_batched_fit_draws(learners):
    """``extra_tree`` draws all C collaborators' candidates in one call on
    either route, so a per-collaborator fit equals the batched one bit for
    bit, homogeneous or grouped in a mix."""
    Xs, ys, masks, Xte, yte, K = _data()
    runs = []
    for batched in (True, False):
        flags = OptimizationFlags(batched_fit=batched)
        plan = adaboost_plan(rounds=4, optimizations=flags,
                             learners=tuple(LearnerPlan(n, HP if "tree" in n else {})
                                            for n in learners) if len(learners) > 1 else ())
        spec = LearnerSpec(learners[0], Xs.shape[2], K, HP)
        fed = Federation(plan, Xs, ys, masks, Xte, yte, spec, device="cpu", seed=3)
        hist = fed.run(eval_every=2)
        runs.append((fed.per_round(), [h["f1"] for h in hist]))
    assert runs[0] == runs[1]


# -- scoring: the un-renormalised update and one shard's errors ---------------------------


@pytest.mark.parametrize("n", [1, 169, 4070])
def test_update_weights_product_matches_jax(n):
    rng = np.random.default_rng(n)
    w = (rng.random(n) / n).astype(np.float32)
    mis = (rng.random(n) < 0.3).astype(np.float32)
    mask = (rng.random(n) < 0.9).astype(np.float32)
    for alpha in (0.37, -2.0, 10.0):
        got = scoring.update_weights(torch.from_numpy(w), torch.from_numpy(mis),
                                     torch.from_numpy(mask), torch.tensor(alpha), renormalize=False)
        want = jscoring.update_weights(jnp.asarray(w), jnp.asarray(mis), jnp.asarray(mask),
                                       jnp.float32(alpha), renormalize=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        renorm = scoring.update_weights(torch.from_numpy(w), torch.from_numpy(mis),
                                        torch.from_numpy(mask), torch.tensor(alpha))
        np.testing.assert_allclose(renorm.numpy(), got.numpy() / max(float(got.sum()), 1e-30),
                                   rtol=1e-5)


def test_shard_errors_matches_jax():
    rng = np.random.default_rng(0)
    preds = rng.integers(0, 4, (6, 301)).astype(np.int32)
    y = rng.integers(0, 4, 301).astype(np.int32)
    w = rng.random(301).astype(np.float32)
    got = scoring.shard_errors(torch.from_numpy(preds), torch.from_numpy(y), torch.from_numpy(w))
    want = jscoring.shard_errors(jnp.asarray(preds), jnp.asarray(y), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_division_by_a_host_float_rounds_as_jnp():
    """The interpreted renormalisation divides float32 weights by a Python
    float: torch casts it to float32 first, as ``jnp``'s weak typing does,
    so the quotients are the same bits."""
    rng = np.random.default_rng(1)
    w = (rng.random(4096) * 1e-3).astype(np.float32)
    for total in (0.9999999999999, 1.0000000123, 3.7e-7, 123456.789):
        got = (torch.from_numpy(w) / max(total, 1e-30)).numpy()
        want = np.asarray(jnp.asarray(w) / max(total, 1e-30))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# -- aggregation ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fedavg", "fedavg_delta", "median", "trimmed_mean"])
@pytest.mark.parametrize("C", [4, 5])
def test_tensor_aggregators_match_jax(name, C):
    rng = np.random.default_rng(C)
    stacked = [rng.normal(size=(C, 7, 3)).astype(np.float32), rng.normal(size=(C, 3)).astype(np.float32),
               rng.normal(size=(C, 3, 2)).astype(np.float32), rng.normal(size=(C, 2)).astype(np.float32)]
    sizes = rng.integers(50, 200, C).astype(np.float32)
    tstack = MLPParams(*(torch.from_numpy(a) for a in stacked))
    jstack = JaxMLPParams(*(jnp.asarray(a) for a in stacked))
    targs, jargs = (tstack, torch.from_numpy(sizes)), (jstack, jnp.asarray(sizes))
    if name == "fedavg_delta":
        g = [a[0] * 0.5 for a in stacked]
        targs = (MLPParams(*(torch.from_numpy(a) for a in g)),) + targs
        jargs = (JaxMLPParams(*(jnp.asarray(a) for a in g)),) + jargs
    got = aggregation.get_tensor_aggregator(name)(*targs)
    want = jagg.get_tensor_aggregator(name)(*jargs)
    assert type(got) is MLPParams
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_aggregation_registry_is_the_jax_packages():
    assert sorted(aggregation.TENSOR_AGGREGATORS) == sorted(jagg.TENSOR_AGGREGATORS)
    assert aggregation.MODEL_AGNOSTIC_ALGORITHMS == jagg.MODEL_AGNOSTIC_ALGORITHMS
    with pytest.raises(KeyError, match="unknown aggregator"):
        aggregation.get_tensor_aggregator("krum")


# -- FedAvg --------------------------------------------------------------------------------


MLP_HP = {"hidden": 16, "steps": 20, "local_steps": 20}


def _fedavg_pair(rounds):
    """A JAX and a port FedAvg federation from the JAX package's initial
    parameters, injected on both sides."""
    Xs, ys, masks, Xte, yte, K = _data()
    d = Xs.shape[2]
    jspec = JaxSpec("mlp", d, K, MLP_HP)
    from repro.learners import get_learner as jax_learner

    init = [np.asarray(a) for a in jax_learner("mlp").init(jspec, jax.random.PRNGKey(11))]
    jfed = JaxFederation(jax_fedavg_plan(rounds=rounds), jnp.asarray(Xs), jnp.asarray(ys),
                         jnp.asarray(masks), jnp.asarray(Xte), jnp.asarray(yte), jspec,
                         jax.random.PRNGKey(0))
    jfed.aggregator.global_params = JaxMLPParams(*(jnp.asarray(a) for a in init))
    tfed = Federation(fedavg_plan(rounds=rounds), Xs, ys, masks, Xte, yte,
                      LearnerSpec("mlp", d, K, MLP_HP), device="cpu")
    tfed.aggregator.global_params = MLPParams(*(torch.from_numpy(a.copy()) for a in init))
    return jfed, jfed.run(), tfed, tfed.run()


def test_fedavg_one_round_matches_jax():
    """One round: each collaborator's 20 local Adam steps from the same
    global parameters, averaged by shard size, within atol 1e-5 (the MLP
    tests' tolerance at 20 steps); the same wire bytes."""
    jfed, jhist, tfed, thist = _fedavg_pair(1)
    # a round validates the model it starts from: here the injected one
    assert [h["round"] for h in thist] == [h["round"] for h in jhist] == [0]
    assert abs(thist[0]["f1"] - jhist[0]["f1"]) < 1e-6
    for a, b in zip(tfed.aggregator.global_params, jfed.aggregator.global_params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    for tc, jc in zip(tfed.collaborators, jfed.collaborators):
        for a, b in zip(tc.params, jc.params):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    assert tfed.comm_bytes == jfed.comm_bytes


def test_fedavg_history_matches_jax():
    """Three rounds: each validates the global model it starts from, F1
    within 1e-3 of the JAX package's; the collaborators' local F1 stored
    per round, the last two rounds kept (the bounded TensorDB)."""
    jfed, jhist, tfed, thist = _fedavg_pair(3)
    assert [h["round"] for h in thist] == [h["round"] for h in jhist] == [0, 1, 2]
    for th, jh in zip(thist, jhist):
        assert abs(th["f1"] - jh["f1"]) < 1e-3 and th["alpha"] == 0.0
    local = tfed.collaborators[0].db.query(name="metric/local_f1")
    assert [k.round for k, _ in local] == [1, 2] and all(0.0 < v <= 1.0 for _, v in local)
    assert tfed.comm_bytes == jfed.comm_bytes


def test_fedavg_draws_its_initial_parameters_from_the_generator():
    """Without injected parameters FedAvg's global model starts from the
    run's generator (normal weights, not ``init``'s zeros): two runs with
    one seed agree, and another seed differs.  Round 0 has no model to
    validate yet."""
    Xs, ys, masks, Xte, yte, K = _data()
    spec = LearnerSpec("mlp", Xs.shape[2], K, {"hidden": 8, "local_steps": 3})
    runs = [Federation(fedavg_plan(rounds=2), Xs, ys, masks, Xte, yte, spec, device="cpu", seed=s)
            for s in (1, 1, 2)]
    for fed in runs:
        assert [h["round"] for h in fed.run()] == [1]
    a, b, c = (fed.aggregator.global_params.W1 for fed in runs)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().sum()) > 0


@pytest.mark.parametrize("name", ["decision_tree", "ridge"])
def test_fedavg_refuses_a_learner_without_warm_fit(name):
    Xs, ys, masks, Xte, yte, K = _data()
    fed = Federation(fedavg_plan(rounds=1), Xs, ys, masks, Xte, yte,
                     LearnerSpec(name, Xs.shape[2], K, HP), device="cpu")
    with pytest.raises(ValueError, match=f"learner {name!r} has no warm_fit; FedAvg needs one"):
        fed.run()


# -- refusals and the command line ---------------------------------------------------------


def test_interpreted_path_refuses_what_it_cannot_run(tmp_path):
    Xs, ys, masks, Xte, yte, K = _data()
    spec = LearnerSpec("decision_tree", Xs.shape[2], K, HP)
    interpreted = adaboost_plan(rounds=1, optimizations=OptimizationFlags(fused_round=False))
    with pytest.raises(ValueError, match="publishing requires the fused round"):
        Federation(interpreted, Xs, ys, masks, Xte, yte, spec, device="cpu").run(
            publish_every=1, publish_dir=str(tmp_path))
    mixed = adaboost_plan(rounds=1, learners=(LearnerPlan("decision_tree", HP), LearnerPlan("ridge")))
    import dataclasses

    fed = Federation(mixed, Xs, ys, masks, Xte, yte, spec, device="cpu")
    fed.plan = dataclasses.replace(mixed, optimizations=OptimizationFlags(fused_round=False))
    with pytest.raises(ValueError, match="heterogeneous federations require the fused round"):
        fed.run()


def test_fl_run_faithful_on_the_cpu(tmp_path):
    import json

    from repro_torch.launch import fl_run

    out = tmp_path / "h.json"
    hist = fl_run.main(["--dataset", "vehicle", "--collaborators", "4", "--rounds", "2",
                        "--eval-every", "2", "--device", "cpu", "--faithful",
                        "--history-out", str(out)])
    assert [h["round"] for h in hist] == [1]
    rec = json.loads(out.read_text())
    assert rec["comm_bytes"] > 0 and rec["tensordb_peak_entries"] > 0
    assert rec["barrier_waited_seconds"] >= 2 * 4 * 0.01
    assert [r["round"] for r in rec["rounds"]] == [0, 1]
    fused = fl_run.main(["--dataset", "vehicle", "--collaborators", "4", "--rounds", "2",
                         "--eval-every", "2", "--device", "cpu"])
    assert abs(fused[-1]["f1"] - hist[-1]["f1"]) < 1e-5


def test_fl_run_refuses_learners_with_faithful(capsys):
    from repro_torch.launch import fl_run

    with pytest.raises(SystemExit):
        fl_run.main(["--learners", "decision_tree,ridge", "--faithful", "--device", "cpu"])
    assert "drop --faithful" in capsys.readouterr().err
