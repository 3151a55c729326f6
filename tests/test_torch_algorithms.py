"""The ported DistBoost.F, PreWeak.F, federated bagging and centralized
AdaBoost against the JAX package, on the CPU, from the same numpy inputs
(``tests/test_torch_boosting.py``'s vehicle-sized shards, C = 4).

``decision_tree`` draws nothing, so DistBoost.F and PreWeak.F runs are
deterministic on both sides and are compared round by round; bagging's
member pick is ``jax.random`` and is injected into the port from the JAX
run's own picks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as jboost
from repro.core.plan import adaboost_plan as jax_adaboost_plan
from repro.core.plan import bagging_plan as jax_bagging_plan
from repro.fl.federation import Federation as JaxFederation
from repro.learners import LearnerSpec as JaxSpec
from repro.learners import get_learner as jax_learner
from repro_torch import convert
from repro_torch.core import boosting as tboost
from repro_torch.core.metrics import f1_macro
from repro_torch.core.plan import ALGORITHMS, adaboost_plan, bagging_plan, fedavg_plan
from repro_torch.fl.federation import Federation
from repro_torch.learners import LearnerSpec, get_learner
from test_torch_boosting import HP, _shards

ROUNDS = 10


def _jax_fed(plan, Xs, ys, masks, Xte, yte, K):
    return JaxFederation(
        plan, jnp.asarray(Xs), jnp.asarray(ys), jnp.asarray(masks), jnp.asarray(Xte),
        jnp.asarray(yte), JaxSpec("decision_tree", Xs.shape[2], K, HP), jax.random.PRNGKey(0),
    )


def _assert_slots_equal(tens, jens, count):
    assert tens.count == int(jens.count) == count
    p, q = tens.params, jens.params
    np.testing.assert_array_equal(p.feature.numpy(), np.asarray(q.feature))
    # each side bins its own shards: quantile edges agree to the last ulp
    np.testing.assert_allclose(p.threshold.numpy(), np.asarray(q.threshold), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p.leaf_logits.numpy(), np.asarray(q.leaf_logits), atol=1e-5)
    np.testing.assert_allclose(tens.alpha.numpy(), np.asarray(jens.alpha), rtol=1e-5)


def _assert_rows_match(thist, jhist):
    assert [h["round"] for h in thist] == [h["round"] for h in jhist]
    for th, jh in zip(thist, jhist):
        assert th["chosen"] == round(jh["chosen"]), th["round"]
        np.testing.assert_allclose(th["epsilon"], jh["epsilon"], rtol=1e-5)
        np.testing.assert_allclose(th["alpha"], jh["alpha"], rtol=1e-5)
        assert abs(th["f1"] - jh["f1"]) < 1e-3


@pytest.mark.parametrize("algorithm", ["distboost_f", "preweak_f"])
def test_federation_matches_jax_round_by_round(algorithm):
    """10 rounds, a history row every round: the same chosen member,
    epsilon and alpha (rtol 1e-5) and F1 (within 1e-3) each round, the
    same ensemble slots and the same modelled wire bytes."""
    Xs, ys, masks, Xte, yte, K = _shards(seed=4)
    jfed = _jax_fed(jax_adaboost_plan(rounds=ROUNDS, algorithm=algorithm), Xs, ys, masks, Xte, yte, K)
    jhist = jfed.run(eval_every=1)
    tfed = Federation(adaboost_plan(rounds=ROUNDS, algorithm=algorithm), Xs, ys, masks, Xte, yte,
                      LearnerSpec("decision_tree", Xs.shape[2], K, HP), device="cpu")
    thist = tfed.run(eval_every=1)

    _assert_rows_match(thist, jhist)
    _assert_slots_equal(tfed.state.ensemble, jfed._fused_state.ensemble, ROUNDS)
    assert tfed.comm_bytes == jfed.comm_bytes
    if algorithm == "distboost_f":  # every slot is the whole committee
        assert tfed.state.ensemble.params.feature.shape[:2] == (ROUNDS, Xs.shape[0])
        assert all(r["chosen"] == 0 for r in tfed.per_round())


def test_preweak_space_and_prediction_cache_match_jax():
    """PreWeak.F's set-up: every collaborator's T local AdaBoost rounds give
    the same ``[C*T]`` hypothesis space (collaborator-major), and the
    setup-time prediction cache ``[C, C*T, n]`` is the same."""
    Xs, ys, masks, _, _, K = _shards(seed=5)
    C, n, d = Xs.shape
    T = 6
    jl, jspec = jax_learner("decision_tree"), JaxSpec("decision_tree", d, K, HP)
    jX, jy, jm = jnp.asarray(Xs), jnp.asarray(ys), jnp.asarray(masks)
    jstate = jboost.init_boost_state(jl, jspec, T, jm, jax.random.PRNGKey(0), X=jX)
    jspace, _ = jboost.preweak_f_setup(jl, jspec, jstate, jX, jy, jm, T)
    jcache = jboost.preweak_f_predictions(jl, jspec, jspace, jX)

    tl, tspec = get_learner("decision_tree"), LearnerSpec("decision_tree", d, K, HP)
    tX, ty, tm = torch.from_numpy(Xs), torch.from_numpy(ys), torch.from_numpy(masks)
    tstate = tboost.init_boost_state(tl, tspec, T, tm, X=tX)
    tspace, _ = tboost.preweak_f_setup(tl, tspec, tstate, tX, ty, tm, T)
    tcache = tboost.preweak_f_predictions(tl, tspec, tspace, tX)

    assert tspace.feature.shape == (C * T, HP["depth"])
    np.testing.assert_array_equal(tspace.feature.numpy(), np.asarray(jspace.feature))
    np.testing.assert_allclose(tspace.threshold.numpy(), np.asarray(jspace.threshold),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tspace.leaf_logits.numpy(), np.asarray(jspace.leaf_logits), atol=1e-5)
    assert tcache.shape == (C, C * T, n) and tcache.dtype == torch.int32
    np.testing.assert_array_equal(tcache.numpy(), np.asarray(jcache))


def test_distboost_round_from_carried_committee_state():
    """From the same DistBoost.F state after 2 JAX rounds (committee slots
    ``[T, C, ...]`` carried across by ``convert``), one port round gives
    the JAX round's epsilon, alpha and weights (rtol 1e-5) and committee."""
    Xs, ys, masks, _, _, K = _shards(seed=6)
    C, n, d = Xs.shape
    T = 4
    jl, jspec = jax_learner("decision_tree"), JaxSpec("decision_tree", d, K, HP)
    jround = jax.jit(lambda s, X, y, m: jboost.distboost_f_round(jl, jspec, s, X, y, m))
    jX, jy, jm = jnp.asarray(Xs), jnp.asarray(ys), jnp.asarray(masks)
    state = jboost.init_boost_state(jl, jspec, T, jm, jax.random.PRNGKey(0), committee_size=C, X=jX)
    for _ in range(2):
        state, _ = jround(state, jX, jy, jm)
    ens = state.ensemble
    carried = {"feature": np.asarray(ens.params.feature), "threshold": np.asarray(ens.params.threshold),
               "leaf_logits": np.asarray(ens.params.leaf_logits), "alpha": np.asarray(ens.alpha),
               "count": np.asarray(ens.count), "weights": np.asarray(state.weights),
               "edges": np.asarray(state.fit_cache.edges), "bin_idx": np.asarray(state.fit_cache.bin_idx)}
    tstate = convert.boost_state_from_numpy(carried, device="cpu")
    assert tstate.ensemble.params.feature.shape == (T, C, HP["depth"])
    tl, tspec = get_learner("decision_tree"), LearnerSpec("decision_tree", d, K, HP)
    tstate, tm = tboost.distboost_f_round(tl, tspec, tstate, torch.from_numpy(Xs),
                                          torch.from_numpy(ys), torch.from_numpy(masks))
    state, jm_ = jround(state, jX, jy, jm)
    np.testing.assert_allclose(float(tm["epsilon"]), float(jm_["epsilon"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["alpha"]), float(jm_["alpha"]), rtol=1e-5)
    np.testing.assert_allclose(tstate.weights.numpy(), np.asarray(state.weights), rtol=1e-5)
    np.testing.assert_array_equal(tstate.ensemble.params.feature[2].numpy(),
                                  np.asarray(state.ensemble.params.feature[2]))
    back = convert.ensemble_to_numpy(tstate.ensemble)
    assert back["feature"].shape == (T, C, HP["depth"]) and int(back["count"]) == 3


def test_bagging_on_jax_picks_matches_jax():
    """Bagging with the JAX run's own member picks injected, round by round:
    the same members (slot by slot), alpha 1 each, and the same F1."""
    Xs, ys, masks, Xte, yte, K = _shards(seed=7)
    C, n, d = Xs.shape
    jfed = _jax_fed(jax_bagging_plan(rounds=ROUNDS), Xs, ys, masks, Xte, yte, K)
    jhist = jfed.run(eval_every=1)
    picks = [round(h["chosen"]) for h in jhist]
    assert len(set(picks)) > 1  # the picks vary, so the injection is tested

    tl, tspec = get_learner("decision_tree"), LearnerSpec("decision_tree", d, K, HP)
    tX, ty, tm = torch.from_numpy(Xs), torch.from_numpy(ys), torch.from_numpy(masks)
    state = tboost.init_boost_state(tl, tspec, ROUNDS, tm, X=tX)
    for r, pick in enumerate(picks):
        state, metrics = tboost.bagging_round(tl, tspec, state, tX, ty, tm, pick=pick)
        assert int(metrics["chosen"]) == pick and float(metrics["alpha"]) == 1.0
    _assert_slots_equal(state.ensemble, jfed._fused_state.ensemble, ROUNDS)
    pred = tboost.strong_predict(tl, tspec, state.ensemble, torch.from_numpy(Xte))
    f1 = float(f1_macro(torch.from_numpy(yte), pred, K))
    assert abs(f1 - jhist[-1]["f1"]) < 1e-3


def test_bagging_federation_draws_from_its_seed():
    """The port's own picks come from the federation's generator: one seed
    gives one run, and every pick is a collaborator."""
    Xs, ys, masks, Xte, yte, K = _shards(seed=8)
    spec = LearnerSpec("decision_tree", Xs.shape[2], K, HP)
    runs = [Federation(bagging_plan(rounds=6), Xs, ys, masks, Xte, yte, spec, device="cpu", seed=s)
            for s in (3, 3)]
    for fed in runs:
        fed.run(eval_every=3)
    a, b = (fed.per_round() for fed in runs)
    assert a == b and all(0 <= r["chosen"] < Xs.shape[0] for r in a)
    assert all(r["alpha"] == 1.0 and r["epsilon"] == 0.0 for r in a)


def test_centralized_adaboost_matches_jax():
    """The SAMME oracle over the pooled shards: the same ensemble."""
    Xs, ys, _, _, _, K = _shards(seed=9, C=2)
    X, y = Xs.reshape(-1, Xs.shape[2]), ys.reshape(-1)
    T = 5
    jens = jboost.centralized_adaboost(jax_learner("decision_tree"), JaxSpec("decision_tree", X.shape[1], K, HP),
                                       jnp.asarray(X), jnp.asarray(y), T, jax.random.PRNGKey(0))
    tens = tboost.centralized_adaboost(get_learner("decision_tree"),
                                       LearnerSpec("decision_tree", X.shape[1], K, HP),
                                       torch.from_numpy(X), torch.from_numpy(y), T)
    _assert_slots_equal(tens, jens, T)


def test_plan_names_the_algorithms_and_refuses_fedavg():
    """``ALGORITHMS`` names FedAvg beside the four model-agnostic ones; its
    plan is OpenFL's three-task DNN workflow, and the AdaBoost.F graph
    still refuses an unknown algorithm."""
    assert ALGORITHMS == ("adaboost_f", "distboost_f", "preweak_f", "bagging", "fedavg")
    assert bagging_plan(rounds=3).algorithm == "bagging"
    for alg in ALGORITHMS[:3]:
        assert adaboost_plan(algorithm=alg).algorithm == alg
    fa = fedavg_plan(rounds=3)
    assert fa.algorithm == "fedavg" and fa.aggregator.nn and fa.collaborator.nn
    assert [t.kind for t in fa.tasks] == ["aggregated_model_validation", "train",
                                          "locally_tuned_model_validation"]
    with pytest.raises(ValueError, match="unknown algorithm"):
        adaboost_plan(algorithm="gradient_boost")


@pytest.mark.parametrize("argv,item", [(["--algorithm", "fedavg"], "'decision_tree' has no warm_fit"),
                                       (["--learner", "ridge", "--algorithm", "fedavg"],
                                        "'ridge' has no warm_fit"),
                                       (["--learner", "mlp", "--algorithm", "fedavg"], None)])
def test_fl_run_refuses_unported_choices_naming_the_item(argv, item, capsys):
    """FedAvg runs with the one learner that has ``warm_fit`` (the MLP);
    asked for with a tree or ridge, it is refused naming ``warm_fit``, as
    the JAX package refuses it."""
    from repro_torch.launch import fl_run

    if item is None:
        hist = fl_run.main(argv + ["--device", "cpu", "--dataset", "vehicle", "--collaborators", "4",
                                   "--rounds", "3", "--eval-every", "3"])
        assert [h["round"] for h in hist] == [1, 2] and 0.0 < hist[-1]["f1"] <= 1.0
        return
    with pytest.raises(SystemExit):
        fl_run.main(argv + ["--device", "cpu"])
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("algorithm", ALGORITHMS[:4])
def test_fl_run_cpu_rehearsal_of_each_algorithm(algorithm, tmp_path):
    import json

    from repro_torch.launch import fl_run

    out = tmp_path / "h.json"
    hist = fl_run.main(["--dataset", "vehicle", "--collaborators", "4", "--rounds", "4",
                        "--eval-every", "2", "--device", "cpu", "--algorithm", algorithm,
                        "--history-out", str(out)])
    assert [h["round"] for h in hist] == [1, 3] and 0.0 < hist[-1]["f1"] <= 1.0
    rounds = json.loads(out.read_text())["rounds"]
    assert len(rounds) == 4
    space = 4 * 4 if algorithm == "preweak_f" else 4  # PreWeak.F chooses from C*T
    assert all(0 <= r["chosen"] < space for r in rounds)
