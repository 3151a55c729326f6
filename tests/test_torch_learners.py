"""The ported ridge, Gaussian naive Bayes, nearest-centroid and MLP
learners against the JAX package, on the CPU, from the same numpy inputs
(``tests/test_hetero.py``'s geometry: C = 6 shards of 40 rows, d = 6,
K = 3), each shard with zero-padded rows of weight 0 and log-normal
weights, as AdaBoost's are.

Tolerances, from the float32 sums in other orders: ridge's ``W`` atol 1e-6
(values ~0.1); naive Bayes' and the centroids' parameters rtol 1e-5; logits
rtol 1e-5 atol 1e-4; predictions equal.  The MLP starts from the JAX
package's initial parameters (``jax.random`` cannot be reproduced): after
20 Adam steps its parameters agree within atol 1e-5, and after the default
200 its predictions are equal.  The batched routes are held to the loop
of single fits and predicts within atol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.learners import LearnerSpec as JaxSpec
from repro.learners import get_learner as jax_learner
from repro.learners.mlp import warm_fit_mlp as jax_warm_fit
from repro_torch import convert
from repro_torch.core import boosting, scoring
from repro_torch.learners import LearnerSpec, available_learners, get_learner
from repro_torch.learners.mlp import MLPParams, draw_init

C, N, D, K = 6, 40, 6, 3
PAD = 5  # zero rows of weight 0 at each shard's tail
CLOSED_FORM = ["ridge", "gaussian_nb", "nearest_centroid"]
PARAM_TOL = {"ridge": dict(rtol=1e-5, atol=1e-6), "gaussian_nb": dict(rtol=1e-5, atol=1e-6),
             "nearest_centroid": dict(rtol=1e-5, atol=1e-6)}


def _shards(seed=0, pad=PAD):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(K, D)) * 2.0
    y = rng.integers(0, K, size=(C, N)).astype(np.int32)
    X = (centers[y] + rng.normal(size=(C, N, D))).astype(np.float32)
    w = np.exp(rng.normal(size=(C, N))).astype(np.float32)
    X[:, N - pad:], y[:, N - pad:], w[:, N - pad:] = 0.0, 0, 0.0
    w /= w.sum()
    Xte = (centers[rng.integers(0, K, size=50)] + rng.normal(size=(50, D))).astype(np.float32)
    return X, y, w, Xte


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_fit(name, hp, X, y, w, key=None):
    return jax_learner(name).fit(JaxSpec(name, D, K, hp), None, jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(w), key if key is not None else jax.random.PRNGKey(0))


def _jax_init_stack(hp, n):
    """The JAX package's MLP initial parameters for n fits, stacked."""
    spec = JaxSpec("mlp", D, K, hp)
    inits = [jax_learner("mlp").init(spec, jax.random.PRNGKey(100 + c)) for c in range(n)]
    return MLPParams(*(torch.from_numpy(np.stack([np.asarray(p[i]) for p in inits]))
                       for i in range(4)))


def _assert_params_close(tparams, jparams, **tol):
    for name, t, j in zip(type(tparams)._fields, tparams, jparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name, **tol)


def test_the_registry_holds_the_six_learners():
    assert available_learners() == ["decision_tree", "extra_tree", "gaussian_nb", "mlp",
                                    "nearest_centroid", "ridge"]
    assert get_learner("mlp").warm_fit is not None and get_learner("mlp").draw is not None
    assert all(get_learner(n).fit_batched is None for n in CLOSED_FORM + ["mlp"])


@pytest.mark.parametrize("name", CLOSED_FORM)
def test_closed_form_fit_and_predict_match_jax(name):
    """Each shard's fit, then the logits and predictions on held-out rows."""
    X, y, w, Xte = _shards(seed=1)
    spec, jspec = LearnerSpec(name, D, K, {}), JaxSpec(name, D, K, {})
    for c in range(C):
        tp = get_learner(name).fit(spec, None, _t(X[c]), _t(y[c]), _t(w[c]))
        jp = _jax_fit(name, {}, X[c], y[c], w[c])
        _assert_params_close(tp, jp, **PARAM_TOL[name])
        tl = get_learner(name).predict_logits(spec, tp, _t(Xte))
        jl = jax_learner(name).predict_logits(jspec, jp, jnp.asarray(Xte))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(get_learner(name).predict(spec, tp, _t(Xte)).numpy(),
                                      np.asarray(jax_learner(name).predict(jspec, jp,
                                                                           jnp.asarray(Xte))))


def test_gaussian_nb_smoothing_is_the_population_variance_over_padded_rows():
    """The smoothing term is ``var(X)`` over all n rows, padding included,
    with ``correction=0`` (``jnp.var``).  With 30 of 40 rows padded the
    unbiased estimator is 2.6% larger, far outside the tolerance, so the
    check catches ``correction=1``."""
    X, y, w, _ = _shards(seed=2, pad=30)
    spec = LearnerSpec("gaussian_nb", D, K, {"var_smoothing": 1.0})
    tp = get_learner("gaussian_nb").fit(spec, None, _t(X[0]), _t(y[0]), _t(w[0]))
    jp = _jax_fit("gaussian_nb", {"var_smoothing": 1.0}, X[0], y[0], w[0])
    np.testing.assert_allclose(tp.var.numpy(), np.asarray(jp.var), rtol=1e-5)
    unbiased = tp.var - torch.var(_t(X[0]), dim=0, correction=0) + torch.var(_t(X[0]), dim=0)
    assert not np.allclose(unbiased.numpy(), np.asarray(jp.var), rtol=1e-5)


def test_nearest_centroid_parks_an_empty_class():
    X, y, w, _ = _shards(seed=3)
    y = np.where(y == 2, 0, y).astype(np.int32)  # class 2 never appears
    spec = LearnerSpec("nearest_centroid", D, K, {})
    tp = get_learner("nearest_centroid").fit(spec, None, _t(X[0]), _t(y[0]), _t(w[0]))
    jp = _jax_fit("nearest_centroid", {}, X[0], y[0], w[0])
    assert bool((tp.centroid[2] == 1e6).all())
    _assert_params_close(tp, jp, rtol=1e-5, atol=1e-6)


def test_mlp_fit_from_the_jax_initial_parameters_matches_jax_at_20_steps():
    X, y, w, _ = _shards(seed=4)
    hp = {"hidden": 16, "steps": 20, "lr": 0.05}
    init = _jax_init_stack(hp, C)
    spec, jspec = LearnerSpec("mlp", D, K, hp), JaxSpec("mlp", D, K, hp)
    tp = get_learner("mlp").fit(spec, None, _t(X), _t(y), _t(w), init=init)  # all C at once
    for c in range(C):
        jinit = jax_learner("mlp").init(jspec, jax.random.PRNGKey(100 + c))
        from repro.learners.mlp import _train_mlp

        jp = _train_mlp(jspec, jinit, jnp.asarray(X[c]), jnp.asarray(y[c]), jnp.asarray(w[c]),
                        20, 0.05)
        _assert_params_close(MLPParams(*(p[c] for p in tp)), jp, rtol=0, atol=1e-5)


def test_mlp_predictions_match_jax_at_the_default_200_steps():
    X, y, w, Xte = _shards(seed=5)
    hp = {"hidden": 64, "steps": 200, "local_steps": 20}
    spec, jspec = LearnerSpec("mlp", D, K, hp), JaxSpec("mlp", D, K, hp)
    init = _jax_init_stack(hp, 1)
    tp = get_learner("mlp").fit(spec, None, _t(X[0]), _t(y[0]), _t(w[0]),
                                init=MLPParams(*(p[0] for p in init)))
    from repro.learners.mlp import _train_mlp

    jp = _train_mlp(jspec, jax_learner("mlp").init(jspec, jax.random.PRNGKey(100)),
                    jnp.asarray(X[0]), jnp.asarray(y[0]), jnp.asarray(w[0]), 200, 0.05)
    rows = np.concatenate([Xte, X[0, : N - PAD]])
    np.testing.assert_array_equal(
        get_learner("mlp").predict(spec, tp, _t(rows)).numpy(),
        np.asarray(jax_learner("mlp").predict(jspec, jp, jnp.asarray(rows))))


def test_mlp_warm_fit_matches_jax():
    """FedAvg's local training: ``local_steps`` Adam steps from given
    parameters (here the JAX package's initial ones)."""
    X, y, w, _ = _shards(seed=6)
    hp = {"hidden": 16, "local_steps": 20}
    spec, jspec = LearnerSpec("mlp", D, K, hp), JaxSpec("mlp", D, K, hp)
    jinit = jax_learner("mlp").init(jspec, jax.random.PRNGKey(7))
    tp = get_learner("mlp").warm_fit(spec, convert.params_from_numpy(
        "mlp", {f: np.asarray(a) for f, a in zip(MLPParams._fields, jinit)}, device="cpu"),
        _t(X[1]), _t(y[1]), _t(w[1]))
    jp = jax_warm_fit(jspec, jinit, jnp.asarray(X[1]), jnp.asarray(y[1]), jnp.asarray(w[1]), None)
    _assert_params_close(tp, jp, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", CLOSED_FORM + ["mlp"])
def test_batched_fit_equals_a_loop_of_single_fits(name):
    """``_local_fits`` for a learner without ``fit_batched``: one batched
    fit of all C shards (the counterpart of ``vmap(fit)``) equals each
    shard fitted alone, within atol 1e-6."""
    X, y, w, _ = _shards(seed=7)
    hp = {"hidden": 16, "steps": 10} if name == "mlp" else {}
    spec, learner = LearnerSpec(name, D, K, hp), get_learner(name)
    draws = {"init": _jax_init_stack(hp, C)} if name == "mlp" else {}
    batched = boosting._local_fits(learner, spec, _t(w), _t(X), _t(y), None, **draws)
    for c in range(C):
        one = {"init": MLPParams(*(p[c] for p in draws["init"]))} if draws else {}
        single = learner.fit(spec, None, _t(X[c]), _t(y[c]), _t(w[c]), **one)
        for a, b in zip(batched, single):
            torch.testing.assert_close(a[c], b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", CLOSED_FORM + ["mlp"])
def test_predict_with_a_hypothesis_axis_equals_each_hypothesis_alone(name):
    """``scoring.predict_tensor``: every hypothesis of a ``[H, ...]`` stack on
    every shard of ``[C, n, d]`` in one call, against one predict per pair."""
    X, y, w, _ = _shards(seed=8)
    hp = {"hidden": 16, "steps": 5} if name == "mlp" else {}
    spec, learner = LearnerSpec(name, D, K, hp), get_learner(name)
    hyps = boosting._local_fits(learner, spec, _t(w), _t(X), _t(y), None,
                                torch.Generator().manual_seed(0))
    preds = scoring.predict_tensor(learner, spec, hyps, _t(X))  # [C, H, n]
    logits = learner.predict_logits(spec, hyps, _t(X))  # [C, H, n, K]
    assert preds.shape == (C, C, N) and preds.dtype == torch.int32
    for h in range(C):
        one = type(hyps)(*(p[h] for p in hyps))
        for c in range(C):
            torch.testing.assert_close(logits[c, h], learner.predict_logits(spec, one, _t(X[c])),
                                       rtol=0, atol=1e-6)


def test_mlp_draws_each_collaborator_in_turn():
    """The initial parameters of C fits are C single draws in collaborator
    order, so a collaborator's draw does not depend on how many fit with it."""
    spec = LearnerSpec("mlp", D, K, {"hidden": 8})
    many = draw_init(spec, 3, torch.Generator().manual_seed(5), "cpu")["init"]
    g = torch.Generator().manual_seed(5)
    for c in range(3):
        one = draw_init(spec, 1, g, "cpu")["init"]
        for a, b in zip(many, one):
            assert torch.equal(a[c], b[0])
    assert float(many.W1.std()) == pytest.approx(1 / np.sqrt(D), rel=0.3)
    assert not bool(many.b1.any()) and not bool(many.b2.any())


def test_mlp_fit_without_a_generator_or_init_raises():
    X, y, w, _ = _shards()
    with pytest.raises(ValueError, match="generator or init"):
        get_learner("mlp").fit(LearnerSpec("mlp", D, K, {"steps": 1}), None, _t(X), _t(y), _t(w))


@pytest.mark.parametrize("name", CLOSED_FORM + ["mlp"])
def test_federation_of_each_new_learner_matches_the_per_round_contract(name):
    """A homogeneous AdaBoost.F federation of the learner runs, appends one
    member a round, and its ensemble serialises to the JAX package's
    layout (the same leaves as the JAX learner's init, in order)."""
    from repro_torch.core.plan import adaboost_plan
    from repro_torch.fl.federation import Federation

    X, y, w, Xte = _shards(seed=9)
    hp = {"hidden": 8, "steps": 10} if name == "mlp" else {}
    fed = Federation(adaboost_plan(rounds=3), X, y, (w > 0).astype(np.float32), Xte,
                     np.zeros(len(Xte), np.int32), LearnerSpec(name, D, K, hp), device="cpu")
    hist = fed.run(eval_every=3)
    assert fed.state.ensemble.count == 3 and len(hist) == 1
    jproto = jax_learner(name).init(JaxSpec(name, D, K, hp), jax.random.PRNGKey(0))
    slot = scoring.take_slot(fed.state.ensemble.params, 0)
    assert [tuple(t.shape) for t in slot] == [tuple(np.shape(a)) for a in jproto]


@pytest.mark.parametrize("n_bins", [4, 8, 16, 32])
def test_quantile_edges_equal_jax_to_the_bit(n_bins):
    """The trees' bin edges are ``jnp.quantile``'s bit for bit (its linear
    interpolation rounds once after a fused multiply-add, and its
    quantiles come from a reciprocal), on shards where quantile positions
    fall on and between samples; so are the bin indices.  ``torch.quantile``
    differed by an ulp, so a sample on an edge could fall on the other
    side of it."""
    from repro.learners.binning import bin_dataset as jax_bin
    from repro_torch.learners.binning import bin_dataset

    rng = np.random.default_rng(n_bins)
    for n, scale, rounded in [(40, 1.0, False), (4070, 1.0, False), (97, 100.0, True),
                              (1000, 1e-3, False), (3, 1.0, False)]:
        X = (rng.normal(size=(n, 5)) * scale).astype(np.float32)
        if rounded:
            X = np.round(X, 1)
        want = jax_bin(jnp.asarray(X), n_bins)
        got = bin_dataset(_t(X)[None], n_bins)  # a leading collaborator axis
        np.testing.assert_array_equal(got.edges[0].numpy(), np.asarray(want.edges))
        np.testing.assert_array_equal(got.bin_idx[0].numpy(), np.asarray(want.bin_idx))
