"""The ported Dirichlet split against the JAX package, on the CPU.

``repro/fl/partition.py::dirichlet_partition`` seeds a numpy
``default_rng`` with one ``jax.random.randint`` draw; given that integer
(``seed=``) the port runs the same numpy code, so the shards, labels and
masks must be equal exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.partition import dirichlet_partition as jax_dirichlet
from repro_torch.fl.partition import dirichlet_partition


def _data(n=300, d=4, K=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, K, size=n).astype(np.int32)
    return X, y, K


def _jax_seed(key) -> int:
    """The integer the JAX function seeds its numpy generator with."""
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


@pytest.mark.parametrize("alpha", [0.05, 0.5, 5.0])
@pytest.mark.parametrize("C", [3, 8])
def test_dirichlet_partition_equals_jax_for_the_injected_seed(alpha, C):
    X, y, K = _data()
    key = jax.random.PRNGKey(int(alpha * 100) + C)
    jX, jy, jm = jax_dirichlet(jnp.asarray(X), jnp.asarray(y), C, key, alpha=alpha, n_classes=K)
    tX, ty, tm = dirichlet_partition(torch.from_numpy(X), torch.from_numpy(y), C, alpha=alpha,
                                     n_classes=K, seed=_jax_seed(key))
    np.testing.assert_array_equal(tX.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.dtype == torch.float32 and tX.shape[:2] == tm.shape


@pytest.mark.parametrize("seed", range(5))
def test_dirichlet_small_alpha_never_leaves_a_collaborator_empty(seed):
    """At alpha 0.01 the proportions concentrate: the redraws and the
    repair still give every collaborator a sample, the padding is zero
    rows of label 0 under mask 0, and every sample lands exactly once."""
    X, y, K = _data(n=60, seed=seed)
    Xs, ys, mask = dirichlet_partition(torch.from_numpy(X), torch.from_numpy(y), 10, alpha=0.01,
                                       n_classes=K, generator=torch.Generator().manual_seed(seed))
    assert bool((mask.sum(dim=1) > 0).all())
    pad = mask == 0
    assert not bool(Xs[pad].any()) and not bool(ys[pad].any())
    assert int(mask.sum()) == len(y)
    got = sorted(map(tuple, Xs[~pad].numpy().tolist()))
    assert got == sorted(map(tuple, X.tolist()))


def test_dirichlet_rejects_more_collaborators_than_samples():
    X, y, K = _data(n=5)
    with pytest.raises(ValueError, match="cannot give each of 6 collaborators a sample from 5"):
        dirichlet_partition(torch.from_numpy(X), torch.from_numpy(y), 6, seed=0)
    with pytest.raises(ValueError, match="cannot give each of 6 collaborators"):
        jax_dirichlet(jnp.asarray(X), jnp.asarray(y), 6, jax.random.PRNGKey(0))


def test_dirichlet_draws_its_seed_from_the_generator():
    """Without ``seed`` the integer comes from the generator: the same
    generator state gives the same split, which is the split of that
    integer."""
    X, y, K = _data()
    g = torch.Generator().manual_seed(11)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=torch.Generator().manual_seed(11)))
    a = dirichlet_partition(torch.from_numpy(X), torch.from_numpy(y), 4, n_classes=K, generator=g)
    b = dirichlet_partition(torch.from_numpy(X), torch.from_numpy(y), 4, n_classes=K, seed=seed)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="generator or a seed"):
        dirichlet_partition(torch.from_numpy(X), torch.from_numpy(y), 4)


def test_fl_run_dirichlet_split_pads_the_shards(tmp_path):
    """``fl_run --split dirichlet``: the shards are padded to the largest,
    the padding weighs nothing, and the run learns."""
    from repro_torch.launch import fl_run

    fed = fl_run.build_federation("vehicle", 4, 3, 4, 0, "cpu", split="dirichlet",
                                  dirichlet_alpha=0.3)
    assert fed.plan.data.split == "dirichlet" and fed.plan.data.dirichlet_alpha == 0.3
    counts = fed.masks.sum(dim=1)
    assert int(counts.min()) > 0 and int(counts.max()) == fed.masks.shape[1]
    assert int(counts.min()) < int(counts.max())  # label skew: unequal shards
    hist = fed.run(eval_every=3)
    assert float(fed.state.weights[fed.masks == 0].abs().max()) == 0.0
    assert 0.0 < hist[-1]["f1"] <= 1.0
    out = fl_run.main(["--dataset", "vehicle", "--collaborators", "4", "--rounds", "2",
                       "--eval-every", "2", "--split", "dirichlet", "--dirichlet-alpha", "0.3",
                       "--device", "cpu"])
    assert out[-1]["round"] == 1


def test_plan_validates_the_split():
    from repro_torch.core.plan import DataPlan, adaboost_plan

    assert adaboost_plan(data=DataPlan(split="dirichlet", dirichlet_alpha=0.1)).data.split == "dirichlet"
    with pytest.raises(ValueError, match="unknown split"):
        adaboost_plan(data=DataPlan(split="shards"))
    with pytest.raises(ValueError, match="dirichlet_alpha must be positive"):
        adaboost_plan(data=DataPlan(split="dirichlet", dirichlet_alpha=0.0))
