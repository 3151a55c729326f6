"""The ported ``extra_tree`` learner against the JAX package, on the CPU.

``jax.random`` cannot be reproduced in torch, so the JAX package's split
candidates are rebuilt here from its keys exactly as
``repro/learners/tree.py:_select_stage`` draws them (``choice(fold_in(key_c,
level), d*B, (max_candidates,), replace=False)``) and injected into the
port's fit; the port's own draws come from a ``torch.Generator``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.learners import LearnerSpec as JaxSpec
from repro.learners import get_learner as jax_learner
from repro.learners.binning import bin_dataset as jax_bin_dataset
from repro_torch.core.plan import adaboost_plan
from repro_torch.fl.federation import Federation
from repro_torch.learners import LearnerSpec, get_learner
from repro_torch.learners.binning import bin_dataset
from repro_torch.learners.tree import draw_candidates, fit_tree_batched
from test_torch_boosting import HP, _shards


def jax_candidates(keys, depth: int, d: int, n_bins: int, m: int) -> np.ndarray:
    """[C, depth, d, B] bool: the candidate masks the JAX package draws for
    each collaborator key and level."""
    out = np.zeros((len(keys), depth, d * n_bins), bool)
    for c, key in enumerate(keys):
        for level in range(depth):
            picked = jax.random.choice(jax.random.fold_in(key, level), d * n_bins, (m,), replace=False)
            out[c, level, np.asarray(picked)] = True
    return out.reshape(len(keys), depth, d, n_bins)


def _weights(masks, seed):
    rng = np.random.default_rng(seed)
    w = rng.lognormal(sigma=1.0, size=masks.shape).astype(np.float32) * masks
    return (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("seed,max_candidates", [(0, 8), (1, 8), (2, 3), (3, 40)])
def test_extra_tree_on_jax_masks_fits_the_jax_tree(seed, max_candidates):
    """All C collaborators' trees from JAX's ``fit_tree_batched(random_splits
    =True)`` and from the port's ``extra_tree`` fed JAX's masks: the same
    features, thresholds (rtol 1e-6) and leaf logits (atol 1e-5)."""
    Xs, ys, masks, _, _, K = _shards(seed=10 + seed)
    C, n, d = Xs.shape
    hp = {**HP, "max_candidates": max_candidates}
    w = _weights(masks, seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    jspec = JaxSpec("extra_tree", d, K, hp)
    jX = jnp.asarray(Xs)
    jcache = jax.vmap(lambda Xi: jax_bin_dataset(Xi, hp["n_bins"]))(jX)
    want = jax_learner("extra_tree").fit_batched(jspec, jX, jnp.asarray(ys), jnp.asarray(w), keys, jcache)

    cand = torch.from_numpy(jax_candidates(keys, hp["depth"], d, hp["n_bins"], max_candidates))
    tspec = LearnerSpec("extra_tree", d, K, hp)
    tX = torch.from_numpy(Xs)
    got = get_learner("extra_tree").fit_batched(tspec, tX, torch.from_numpy(ys), torch.from_numpy(w),
                                                bin_dataset(tX, hp["n_bins"]), candidates=cand)
    np.testing.assert_array_equal(got.feature.numpy(), np.asarray(want.feature))
    np.testing.assert_allclose(got.threshold.numpy(), np.asarray(want.threshold), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.leaf_logits.numpy(), np.asarray(want.leaf_logits), atol=1e-5)
    # every chosen split is one of the level's candidates
    f, lv = got.feature.long(), torch.arange(hp["depth"])
    assert bool(cand[torch.arange(C)[:, None], lv, f].any(-1).all())


def test_masks_restrict_the_split():
    """With the whole grid as candidates extra_tree is decision_tree; with
    one candidate a level it must take that one."""
    Xs, ys, masks, _, _, K = _shards(seed=20)
    C, n, d = Xs.shape
    w = torch.from_numpy(_weights(masks, 0))
    tX, ty = torch.from_numpy(Xs), torch.from_numpy(ys)
    spec = LearnerSpec("extra_tree", d, K, HP)
    cache = bin_dataset(tX, HP["n_bins"])
    every = torch.ones(C, HP["depth"], d, HP["n_bins"], dtype=torch.bool)
    a = fit_tree_batched(spec, tX, ty, w, cache, candidates=every, random_splits=True)
    b = get_learner("decision_tree").fit_batched(spec, tX, ty, w, cache)
    assert torch.equal(a.feature, b.feature) and torch.equal(a.threshold, b.threshold)
    one = torch.zeros_like(every)
    one[:, :, 5, 7] = True  # feature 5, bin 7 at every level
    c = fit_tree_batched(spec, tX, ty, w, cache, candidates=one, random_splits=True)
    assert bool((c.feature == 5).all())
    torch.testing.assert_close(c.threshold, cache.edges[:, 5, 7].unsqueeze(1).expand(C, HP["depth"]))


@pytest.mark.parametrize("m", [1, 8, 17])
def test_drawn_masks_hold_max_candidates_distinct_entries(m):
    spec = LearnerSpec("extra_tree", 6, 3, {**HP, "max_candidates": m})
    mask = draw_candidates(spec, 5, 6, torch.Generator().manual_seed(m), "cpu")
    assert mask.shape == (5, HP["depth"], 6, HP["n_bins"]) and mask.dtype == torch.bool
    assert bool((mask.flatten(2).sum(-1) == m).all())  # a bool mask: m distinct entries
    flat = mask.flatten(2)
    assert len({tuple(row.nonzero().flatten().tolist()) for row in flat.flatten(0, 1)}) > 1


def test_one_seed_gives_one_tree():
    """Two fits drawing from generators of one seed give one tree; another
    seed draws other candidates; decision_tree reads no generator."""
    Xs, ys, masks, _, _, K = _shards(seed=21)
    d = Xs.shape[2]
    tX, ty, w = torch.from_numpy(Xs), torch.from_numpy(ys), torch.from_numpy(_weights(masks, 1))
    spec = LearnerSpec("extra_tree", d, K, HP)
    cache = bin_dataset(tX, HP["n_bins"])
    fit = get_learner("extra_tree").fit_batched
    a = fit(spec, tX, ty, w, cache, generator=torch.Generator().manual_seed(5))
    b = fit(spec, tX, ty, w, cache, generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    m5 = draw_candidates(spec, Xs.shape[0], d, torch.Generator().manual_seed(5), "cpu")
    m6 = draw_candidates(spec, Xs.shape[0], d, torch.Generator().manual_seed(6), "cpu")
    assert not torch.equal(m5, m6)
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    get_learner("decision_tree").fit_batched(spec, tX, ty, w, cache, generator=g)
    assert torch.equal(g.get_state(), state)
    with pytest.raises(ValueError, match="generator or candidates"):
        fit(spec, tX, ty, w, cache)


def test_single_fit_is_the_batched_fit_of_one():
    Xs, ys, masks, _, _, K = _shards(seed=22)
    spec = LearnerSpec("extra_tree", Xs.shape[2], K, HP)
    X, y, w = torch.from_numpy(Xs[0]), torch.from_numpy(ys[0]), torch.from_numpy(_weights(masks, 2)[0])
    one = get_learner("extra_tree").fit(spec, None, X, y, w, generator=torch.Generator().manual_seed(1))
    many = get_learner("extra_tree").fit_batched(spec, X[None], y[None], w[None], None,
                                                 generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b[0]) for a, b in zip(one, many))


def test_extra_tree_federation_is_seeded():
    """AdaBoost.F over extra_tree: one seed gives one run, and its trees
    predict with decision_tree's rule."""
    Xs, ys, masks, Xte, yte, K = _shards(seed=23)
    spec = LearnerSpec("extra_tree", Xs.shape[2], K, HP)
    runs = []
    for seed in (4, 4):
        fed = Federation(adaboost_plan(rounds=5), Xs, ys, masks, Xte, yte, spec, device="cpu", seed=seed)
        fed.run(eval_every=5)
        runs.append(fed)
    a, b = runs
    assert a.per_round() == b.per_round() and a.history[-1]["f1"] == b.history[-1]["f1"]
    assert torch.equal(a.state.ensemble.params.feature, b.state.ensemble.params.feature)
    ex, dt = get_learner("extra_tree"), get_learner("decision_tree")
    params = a.state.ensemble.params
    assert torch.equal(ex.predict(spec, params, a.X_test), dt.predict(spec, params, a.X_test))
