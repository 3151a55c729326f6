"""The ported tree learner against the JAX package on the CPU: binning,
the batched fit from the JAX ``BinnedDataset`` and weights, and predict.

Quantile edges from ``jnp.quantile`` and ``torch.quantile`` may differ in
the last ulp, and a sample equal to an edge would then change bin, so the
fit comparisons start both sides from the JAX bins (carried across with
``repro_torch.convert``); ``quantile_edges`` is held on its own at atol
1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.learners import LearnerSpec as JaxSpec
from repro.learners import binning as jbin
from repro.learners import tree as jtree
from repro_torch import convert
from repro_torch.learners import LearnerSpec, binning, tree
from repro_torch.learners.binning import BinnedDataset


def _data(seed, C=4, n=169, d=18, K=4):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, K)).astype(np.float32)
    X = rng.normal(size=(C, n, d)).astype(np.float32)
    y = np.argmax(X @ W + rng.normal(size=(C, n, K)), axis=-1).astype(np.int32)
    w = rng.random((C, n), dtype=np.float32)
    w[:, -5:] = 0.0  # padded rows
    w /= w.sum()
    return X, y, w, K


@pytest.mark.parametrize("n,d,n_bins", [(169, 18, 16), (4070, 14, 16), (50, 3, 7)])
def test_quantile_edges_match_jax(n, d, n_bins):
    X = np.random.default_rng(n).normal(size=(n, d)).astype(np.float32)
    got = binning.quantile_edges(torch.from_numpy(X), n_bins)
    want = jbin.quantile_edges(jnp.asarray(X), n_bins)
    assert got.shape == (d, n_bins)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_quantile_edges_batched_equals_per_shard():
    X = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 100, 5)).astype(np.float32))
    batched = binning.quantile_edges(X, 16)
    for c in range(3):
        torch.testing.assert_close(batched[c], binning.quantile_edges(X[c], 16), rtol=0, atol=0)


def test_digitize_matches_jax_and_stays_in_range():
    """Given the same edges, bin indices are identical, and lie in
    [0, n_bins] — the range the tree_hist kernel trusts."""
    X, _, _, _ = _data(1)
    jb = jax.vmap(lambda x: jbin.bin_dataset(x, 16))(jnp.asarray(X))
    edges = np.asarray(jb.edges)
    got = binning.digitize(torch.from_numpy(X), torch.from_numpy(edges.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jb.bin_idx))
    assert got.dtype == torch.int32
    assert int(got.min()) >= 0 and int(got.max()) <= 16


@pytest.mark.parametrize("seed,depth", [(2, 4), (3, 3), (4, 5)])
def test_fit_tree_batched_matches_jax(seed, depth):
    """From the JAX BinnedDataset and weights: the same feature and
    threshold at every level, leaf_logits within atol 1e-5."""
    X, y, w, K = _data(seed)
    C, n, d = X.shape
    hp = {"depth": depth, "n_bins": 16}
    jX = jnp.asarray(X)
    cache = jax.vmap(lambda x: jbin.bin_dataset(x, 16))(jX)
    want = jtree.fit_tree_batched(JaxSpec("decision_tree", d, K, hp), jX, jnp.asarray(y),
                                  jnp.asarray(w), jax.random.split(jax.random.PRNGKey(0), C), cache)
    tcache = BinnedDataset(torch.from_numpy(np.asarray(cache.edges)),
                           torch.from_numpy(np.asarray(cache.bin_idx)))
    got = tree.fit_tree_batched(LearnerSpec("decision_tree", d, K, hp), torch.from_numpy(X),
                                torch.from_numpy(y), torch.from_numpy(w), tcache)
    assert got.feature.shape == (C, depth) and got.feature.dtype == torch.int32
    np.testing.assert_array_equal(got.feature.numpy(), np.asarray(want.feature))
    np.testing.assert_array_equal(got.threshold.numpy(), np.asarray(want.threshold))
    np.testing.assert_allclose(got.leaf_logits.numpy(), np.asarray(want.leaf_logits), atol=1e-5)


def test_fit_tree_single_is_batched_case():
    X, y, w, K = _data(5, C=2)
    spec = LearnerSpec("decision_tree", X.shape[2], K, {"depth": 4, "n_bins": 16})
    tX, ty, tw = torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w)
    batched = tree.fit_tree_batched(spec, tX, ty, tw)
    for c in range(2):
        single = tree.fit_tree(spec, None, tX[c], ty[c], tw[c])
        for a, b in zip(single, batched):
            torch.testing.assert_close(a, b[c], rtol=0, atol=0)


def test_descend_stage_keeps_leaves_in_range():
    """Each level doubles the leaf range: after level l every leaf index
    lies in [0, 2**(l+1)) — the range tree_hist's next launch trusts."""
    X, y, w, K = _data(6)
    cache = binning.bin_dataset(torch.from_numpy(X), 16)
    C, n, _ = X.shape
    leaf = torch.zeros(C, n, dtype=torch.int32)
    wy = torch.nn.functional.one_hot(torch.from_numpy(y).long(), K).float()
    for level in range(5):
        hist = tree._histogram_stage(cache.bin_idx, leaf, wy, 2**level, 16)
        f, b, _ = tree._select_stage(hist, cache.edges, 16)
        leaf = tree._descend_stage(cache.bin_idx, leaf, f, b)
        assert leaf.dtype == torch.int32
        assert int(leaf.min()) >= 0 and int(leaf.max()) < 2 ** (level + 1)


def test_tree_predict_logits_matches_jax():
    """One tree and a hypothesis stack over a collaborator stack both give
    the JAX logits (the port writes the vmap axes out)."""
    X, y, w, K = _data(7)
    C, n, d = X.shape
    spec = JaxSpec("decision_tree", d, K, {"depth": 4, "n_bins": 16})
    jX = jnp.asarray(X)
    hyps = jtree.fit_tree_batched(spec, jX, jnp.asarray(y), jnp.asarray(w),
                                  jax.random.split(jax.random.PRNGKey(0), C))
    tparams = convert.tree_params_from_numpy({k: np.asarray(v) for k, v in hyps._asdict().items()},
                                             device="cpu")
    tspec = LearnerSpec("decision_tree", d, K, {"depth": 4, "n_bins": 16})

    one = jax.tree.map(lambda a: a[1], hyps)
    want_one = np.asarray(jtree.tree_predict_logits(spec, one, jX[2]))
    got_one = tree.tree_predict_logits(tspec, tree.TreeParams(*(t[1] for t in tparams)),
                                       torch.from_numpy(X[2]))
    np.testing.assert_array_equal(got_one.numpy(), want_one)

    want = jax.vmap(lambda Xi: jax.vmap(lambda p: jtree.tree_predict_logits(spec, p, Xi))(hyps))(jX)
    got = tree.tree_predict_logits(tspec, tparams, torch.from_numpy(X))
    assert got.shape == (C, C, n, K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
