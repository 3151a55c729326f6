"""The ported AdaBoost.F round and federation against the JAX package, on
the CPU, from the same numpy inputs.

One round starts both sides from the same carried-across state
(``repro_torch.convert``); the whole slice runs a port ``Federation`` and
a JAX ``Federation`` on the same shards and compares every ensemble slot
the two chose."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as jboost
from repro.core.plan import adaboost_plan as jax_plan
from repro.fl.federation import Federation as JaxFederation
from repro.learners import LearnerSpec as JaxSpec
from repro.learners import get_learner as jax_learner
from repro_torch import convert
from repro_torch.core import boosting as tboost
from repro_torch.core import scoring
from repro_torch.core.metrics import f1_macro
from repro_torch.core.plan import adaboost_plan
from repro_torch.fl.federation import Federation
from repro_torch.learners import LearnerSpec, get_learner

HP = {"depth": 4, "n_bins": 16}


def _shards(seed=0, C=4, n=169, d=18, K=4, n_test=169):
    """Vehicle-sized shards: labels follow a noisy linear score so trees
    have signal to find."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, K)).astype(np.float32)

    def draw(m):
        X = rng.normal(size=(m, d)).astype(np.float32)
        y = np.argmax(X @ W + 0.8 * rng.normal(size=(m, K)), axis=-1).astype(np.int32)
        return X, y

    X, y = draw(C * n)
    Xte, yte = draw(n_test)
    masks = np.ones((C, n), np.float32)
    masks[-1, -7:] = 0.0  # a padded tail on one shard
    return X.reshape(C, n, d), y.reshape(C, n), masks, Xte, yte, K


def _jax_state_numpy(state):
    ens = state.ensemble
    return {
        "feature": np.asarray(ens.params.feature),
        "threshold": np.asarray(ens.params.threshold),
        "leaf_logits": np.asarray(ens.params.leaf_logits),
        "alpha": np.asarray(ens.alpha),
        "count": np.asarray(ens.count),
        "weights": np.asarray(state.weights),
        "edges": np.asarray(state.fit_cache.edges),
        "bin_idx": np.asarray(state.fit_cache.bin_idx),
    }


@pytest.mark.parametrize("warm_rounds", [0, 3])
def test_one_round_from_carried_state(warm_rounds):
    """From the same state (after 0 or 3 JAX rounds), one port round and
    one JAX round choose the same collaborator, with epsilon, alpha and
    the new weights within rtol 1e-5."""
    Xs, ys, masks, _, _, K = _shards(seed=1)
    C, n, d = Xs.shape
    T = 6
    jl, jspec = jax_learner("decision_tree"), JaxSpec("decision_tree", d, K, HP)
    jround = jax.jit(lambda s, X, y, m: jboost.adaboost_f_round(jl, jspec, s, X, y, m))
    jX, jy, jm = jnp.asarray(Xs), jnp.asarray(ys), jnp.asarray(masks)
    state = jboost.init_boost_state(jl, jspec, T, jm, jax.random.PRNGKey(0), X=jX)
    for _ in range(warm_rounds):
        state, _ = jround(state, jX, jy, jm)

    tstate = convert.boost_state_from_numpy(_jax_state_numpy(state), device="cpu")
    tl, tspec = get_learner("decision_tree"), LearnerSpec("decision_tree", d, K, HP)
    tstate, tm = tboost.adaboost_f_round(
        tl, tspec, tstate, torch.from_numpy(Xs), torch.from_numpy(ys), torch.from_numpy(masks)
    )
    state, jm_ = jround(state, jX, jy, jm)

    assert int(tm["chosen"]) == int(jm_["chosen"])
    np.testing.assert_allclose(float(tm["epsilon"]), float(jm_["epsilon"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["alpha"]), float(jm_["alpha"]), rtol=1e-5)
    np.testing.assert_allclose(tstate.weights.numpy(), np.asarray(state.weights), rtol=1e-5)
    assert tstate.ensemble.count == int(state.ensemble.count) == warm_rounds + 1
    t = warm_rounds
    np.testing.assert_array_equal(
        tstate.ensemble.params.feature[t].numpy(), np.asarray(state.ensemble.params.feature[t])
    )
    np.testing.assert_array_equal(
        tstate.ensemble.params.threshold[t].numpy(), np.asarray(state.ensemble.params.threshold[t])
    )


def test_federation_matches_jax_federation():
    """The whole slice: C = 4 vehicle-sized shards, 10 rounds, eval every 5.
    The port chooses the same member every round as the JAX federation
    (slot by slot: the same tree and alpha), and F1 agrees within 1e-3."""
    Xs, ys, masks, Xte, yte, K = _shards(seed=2)
    C, n, d = Xs.shape
    rounds = 10
    jfed = JaxFederation(
        jax_plan(rounds=rounds), jnp.asarray(Xs), jnp.asarray(ys), jnp.asarray(masks),
        jnp.asarray(Xte), jnp.asarray(yte), JaxSpec("decision_tree", d, K, HP),
        jax.random.PRNGKey(0),
    )
    jhist = jfed.run(eval_every=5)
    tfed = Federation(adaboost_plan(rounds=rounds), Xs, ys, masks, Xte, yte,
                      LearnerSpec("decision_tree", d, K, HP), device="cpu")
    thist = tfed.run(eval_every=5)

    assert [h["round"] for h in thist] == [h["round"] for h in jhist] == [4, 9]
    for th, jh in zip(thist, jhist):
        assert th["chosen"] == jh["chosen"]
        assert abs(th["f1"] - jh["f1"]) < 1e-3
        np.testing.assert_allclose(th["epsilon"], jh["epsilon"], rtol=1e-5)
        np.testing.assert_allclose(th["alpha"], jh["alpha"], rtol=1e-5)

    jens, tens = jfed._fused_state.ensemble, tfed.state.ensemble
    assert tens.count == int(jens.count) == rounds
    np.testing.assert_array_equal(tens.params.feature.numpy(), np.asarray(jens.params.feature))
    # each side bins its own shards: quantile edges agree to the last ulp
    np.testing.assert_allclose(
        tens.params.threshold.numpy(), np.asarray(jens.params.threshold), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        tens.params.leaf_logits.numpy(), np.asarray(jens.params.leaf_logits), atol=1e-5
    )
    np.testing.assert_allclose(tens.alpha.numpy(), np.asarray(jens.alpha), rtol=1e-5)
    per_round = tfed.per_round()
    assert [r["round"] for r in per_round] == list(range(rounds))
    assert all(0 <= r["chosen"] < C for r in per_round)


def test_strong_predict_matches_tally():
    """The incremental vote tally the federation evaluates with, folded in
    two steps, predicts what a full-ensemble ``strong_predict`` does, and
    the federation's last F1 is that prediction's."""
    Xs, ys, masks, Xte, yte, K = _shards(seed=3)
    spec = LearnerSpec("decision_tree", Xs.shape[2], K, HP)
    fed = Federation(adaboost_plan(rounds=6), Xs, ys, masks, Xte, yte, spec, device="cpu")
    hist = fed.run(eval_every=3)
    ens, X_test = fed.state.ensemble, fed.X_test

    tally = scoring.init_tally(X_test.shape[0], K, X_test.device)
    tally = scoring.tally_new_votes(fed.learner, spec, ens._replace(count=3), tally, X_test)
    tally = scoring.tally_new_votes(fed.learner, spec, ens, tally, X_test)
    assert tally.counted == ens.count == 6
    full = tboost.strong_predict(fed.learner, spec, ens, X_test)
    torch.testing.assert_close(scoring.tally_predict(tally), full.to(torch.int32), rtol=0, atol=0)
    assert hist[-1]["f1"] == float(f1_macro(fed.y_test, full, K))


def test_federation_rejects_unported_algorithm():
    """Every algorithm is ported now; what the federation still refuses is
    a FedAvg plan that mixes learner families.  Built without validation
    (as a YAML plan would arrive), the federation validates it on entry."""
    Xs, ys, masks, Xte, yte, K = _shards(seed=3)
    with pytest.raises(ValueError, match="fedavg averages parameters and cannot mix model families"):
        Federation(_unvalidated_fedavg_plan(), Xs, ys, masks, Xte, yte,
                   LearnerSpec("mlp", Xs.shape[2], K, {"hidden": 8}), device="cpu")
    with pytest.raises(ValueError, match="unknown algorithm"):
        Federation(dataclasses.replace(_unvalidated_fedavg_plan(), learners=(), algorithm="krum"),
                   Xs, ys, masks, Xte, yte, LearnerSpec("mlp", Xs.shape[2], K, {}), device="cpu")


def _unvalidated_fedavg_plan():
    """A FedAvg plan over two learner families, built without validation."""
    from repro_torch.core.plan import LearnerPlan, Plan, RolePlan, TaskSpec

    return Plan(RolePlan(nn=True, rounds=2), RolePlan(nn=True, rounds=2),
                [TaskSpec("train", "train")], algorithm="fedavg",
                learners=(LearnerPlan("mlp"), LearnerPlan("ridge")))
