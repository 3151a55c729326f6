"""Predict-once scoring (answers to the unmasked half of
``repro/core/scoring.py``).

Each round materialises the prediction tensor ``preds [C, H, n]`` once;
the error matrix, the chosen hypothesis's mispredictions and the weight
update are all reductions over it:

  * ``predict_matrix`` / ``predict_tensor`` — the one predict per round;
  * ``error_matrix``  — one ``weighted_errors`` launch over ``[C, H, n]``
    (the JAX package maps a per-shard call over C);
  * ``chosen_mis``    — a row slice of ``preds``, never a second predict;
  * ``update_weights`` — the ``weight_update`` kernel over the flattened
    ``[C*n]`` weights, then a plain global renormalisation;
  * ``VoteTally`` — incremental evaluation: a running ``[n, K]`` tally
    that adds only the members appended since the last eval.

The chosen index and alpha stay on the device throughout, so nothing
here waits for the card.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.learners.base import LearnerSpec, WeakLearner


def take_slot(params: Any, t) -> Any:
    """Slot ``t`` of a stacked hypothesis bundle; ``t`` is a host int or a
    0-dim device tensor (selected without a host sync)."""
    if isinstance(t, torch.Tensor):
        return type(params)(*(x.index_select(0, t.reshape(1).long()).squeeze(0) for x in params))
    return type(params)(*(x[t] for x in params))


# ---------------------------------------------------------------------------
# Predict once
# ---------------------------------------------------------------------------


def predict_matrix(learner: WeakLearner, spec: LearnerSpec, hyps: Any, X: torch.Tensor) -> torch.Tensor:
    """Predictions of every hypothesis on one shard: X [n, d] -> [H, n] int32."""
    return learner.predict(spec, hyps, X)


def predict_tensor(learner: WeakLearner, spec: LearnerSpec, hyps: Any, X: torch.Tensor) -> torch.Tensor:
    """Predictions of every hypothesis on every shard: X [C, n, d] -> [C, H, n] int32."""
    return learner.predict(spec, hyps, X)


# ---------------------------------------------------------------------------
# Reduce many
# ---------------------------------------------------------------------------


def error_matrix(
    preds: torch.Tensor,  # [C, H, n] int32
    y: torch.Tensor,  # [C, n] int32
    w: torch.Tensor,  # [C, n] f32
) -> torch.Tensor:
    """eps[i, h] = weighted error of hypothesis h on collaborator i's shard
    (paper step 3): one kernel launch for the whole round."""
    return ops.weighted_errors(preds, y, w)


def chosen_mis(preds: torch.Tensor, y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Misprediction mask of hypothesis ``c`` (0-dim device tensor): a row
    slice of preds [C, H, n] against y [C, n] -> [C, n] f32."""
    rows = preds.index_select(-2, c.reshape(1).long()).squeeze(-2)
    return (rows != y).to(torch.float32)


def update_weights(
    w: torch.Tensor,  # [C, n] f32
    mis: torch.Tensor,  # [C, n] f32
    mask: torch.Tensor,  # [C, n] f32
    alpha: torch.Tensor,  # 0-dim f32 on the device
) -> torch.Tensor:
    """``w * exp(alpha*mis) * mask`` by the kernel, then global
    renormalisation by a plain sum (paper step 4)."""
    flat = ops.weight_update(
        w.reshape(-1), mis.reshape(-1), mask.reshape(-1), alpha
    ).view(w.shape)
    return flat / torch.clamp_min(torch.sum(flat), 1e-30)


# ---------------------------------------------------------------------------
# Incremental ensemble evaluation
# ---------------------------------------------------------------------------


class VoteTally(NamedTuple):
    """Running alpha-weighted vote tally over a fixed eval set.

    ``votes[n, K]`` holds the one-hot votes of ensemble members
    ``[0, counted)``; ``counted`` is a host int, since members are
    appended one per round at a host-known slot."""

    votes: torch.Tensor  # [n, K] f32
    counted: int


def init_tally(n: int, n_classes: int, device) -> VoteTally:
    return VoteTally(torch.zeros(n, n_classes, dtype=torch.float32, device=device), 0)


def tally_new_votes(
    learner: WeakLearner, spec: LearnerSpec, ensemble, tally: VoteTally, X: torch.Tensor
) -> VoteTally:
    """Fold members ``[tally.counted, ensemble.count)`` into the tally."""
    votes = tally.votes
    for t in range(tally.counted, ensemble.count):
        pred = learner.predict(spec, take_slot(ensemble.params, t), X)
        votes = votes + ensemble.alpha[t] * F.one_hot(pred.long(), spec.n_classes).to(votes.dtype)
    return VoteTally(votes, ensemble.count)


def tally_predict(tally: VoteTally) -> torch.Tensor:
    return torch.argmax(tally.votes, dim=-1).to(torch.int32)
