"""Out-of-range member predictions in the port's vote tallies, against the
JAX package, on the CPU.

A stub learner whose "parameters" are its predictions hands the same
``[T, n]`` votes, with values of -1 and K among them, to the port's
``ensemble_votes``, ``tally_new_votes`` and ``ops.vote_argmax`` and to
the JAX package's ``ensemble_votes`` and tally.  ``jax.nn.one_hot``
gives such a value a zero row, so it votes for nothing; the port must
do the same.  Half-integer alphas make every vote sum exact in f32, so
the votes agree at atol 0 whatever the order of the sums."""
import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as jboost
from repro.core import scoring as jscoring
from repro.learners.base import LearnerSpec as JaxSpec
from repro.learners.base import WeakLearner as JaxLearner
from repro.learners.base import weighted_onehot as jax_weighted_onehot
from repro_torch.core import boosting as tboost
from repro_torch.core import scoring as tscoring
from repro_torch.kernels import ops
from repro_torch.learners.base import LearnerSpec, WeakLearner, weighted_onehot


class Votes(NamedTuple):
    preds: object  # [T, n] int32 (a slot: [n])


def _unused(*_):
    raise AssertionError("the stub learner only predicts")


@dataclasses.dataclass(frozen=True)
class _PortStub(WeakLearner):
    def predict(self, spec, params, X):
        return params.preds


@dataclasses.dataclass(frozen=True)
class _JaxStub(JaxLearner):
    def predict(self, spec, params, X):
        return params.preds


def _case(seed, T, n, K):
    rng = np.random.default_rng(seed)
    preds = rng.integers(-1, K + 1, size=(T, n), dtype=np.int32)  # -1 and K among them
    preds[0, :3] = [-1, K, 0]
    alpha = (rng.integers(1, 9, size=T) * 0.5).astype(np.float32)
    return preds, alpha


def _port(preds, alpha, count, K):
    learner = _PortStub("stub", _unused, _unused, _unused)
    spec = LearnerSpec("stub", 1, K)
    ens = tboost.Ensemble(Votes(torch.from_numpy(preds)), torch.from_numpy(alpha), count)
    return learner, spec, ens


def _jax(preds, alpha, count, K):
    learner = _JaxStub("stub", _unused, _unused, _unused)
    spec = JaxSpec("stub", 1, K)
    ens = jboost.Ensemble(Votes(jnp.asarray(preds)), jnp.asarray(alpha), jnp.int32(count))
    return learner, spec, ens


@pytest.mark.parametrize("T,n,K,count", [(6, 40, 3, 6), (9, 257, 10, 7), (1, 5, 2, 1)])
def test_out_of_range_votes_count_for_nothing(T, n, K, count):
    preds, alpha = _case(T * n + K, T, n, K)
    X = np.zeros((n, 1), np.float32)
    tl, tspec, tens = _port(preds, alpha, count, K)
    jl, jspec, jens = _jax(preds, alpha, count, K)

    want = np.asarray(jboost.ensemble_votes(jl, jspec, jens, jnp.asarray(X)))
    jtally = jscoring.tally_new_votes(jl, jspec, jens, jscoring.init_tally(n, K), jnp.asarray(X))
    np.testing.assert_array_equal(np.asarray(jtally.votes), want)

    got = tboost.ensemble_votes(tl, tspec, tens, torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)
    tally = tscoring.tally_new_votes(tl, tspec, tens, tscoring.init_tally(n, K, "cpu"),
                                     torch.from_numpy(X))
    np.testing.assert_allclose(tally.votes.numpy(), want, rtol=0, atol=0)

    classes = np.asarray(jscoring.tally_predict(jtally))
    np.testing.assert_array_equal(tscoring.tally_predict(tally).numpy(), classes)
    np.testing.assert_array_equal(
        tboost.strong_predict(tl, tspec, tens, torch.from_numpy(X)).numpy(),
        np.asarray(jboost.strong_predict(jl, jspec, jens, jnp.asarray(X))))
    used = np.where(np.arange(T) < count, alpha, 0.0).astype(np.float32)
    np.testing.assert_array_equal(
        ops.vote_argmax(torch.from_numpy(preds), torch.from_numpy(used), n_classes=K).numpy(),
        classes)


def test_out_of_range_labels_weigh_nothing():
    """``weighted_onehot`` (the trees' class-weighted labels) against
    ``jax.nn.one_hot`` times the weights: a label of -1 or K is a zero row."""
    y = np.array([0, -1, 2, 3, 1, 3], np.int32)
    w = np.array([0.5, 0.25, 1.0, 2.0, 0.0, 0.125], np.float32)
    got = weighted_onehot(torch.from_numpy(y), torch.from_numpy(w), 3)
    want = jax_weighted_onehot(jnp.asarray(y), jnp.asarray(w), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[1].any() and not got[3].any()
