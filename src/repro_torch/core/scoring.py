"""Predict-once scoring (answers to the unmasked half of
``repro/core/scoring.py``).

Each round materialises the prediction tensor ``preds [C, H, n]`` once;
the error matrix, the chosen hypothesis's mispredictions and the weight
update are all reductions over it:

  * ``predict_matrix`` / ``predict_tensor`` — the one predict per round;
  * ``error_matrix``  — one ``weighted_errors`` launch over ``[C, H, n]``
    (the JAX package maps a per-shard call over C); ``shard_errors`` is
    the per-shard call, for the interpreted round;
  * ``chosen_mis``    — a row slice of ``preds``, never a second predict;
  * ``update_weights`` — one ``weight_update`` launch over the flattened
    ``[C*n]`` weights, the global renormalisation included (with
    ``renormalize=False``, one ``weight_update_product`` launch: the
    product alone, for the interpreted round);
  * ``member_prediction`` — the one member-vote rule, shared by the
    incremental tally and the serving engine;
  * ``VoteTally`` — incremental evaluation: a running ``[n, K]`` tally
    that adds only the members appended since the last eval.

The chosen index and alpha stay on the device throughout, so nothing
here waits for the card.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import one_hot
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


def shard_errors(
    preds: torch.Tensor,  # [H, n] int32
    y: torch.Tensor,  # [n] int32
    w: torch.Tensor,  # [n] f32, mask folded in
) -> torch.Tensor:
    """eps[h] = weighted error of hypothesis h on one shard: one
    ``weighted_errors`` launch over ``[1, H, n]``."""
    return ops.weighted_errors(preds.unsqueeze(0), y.unsqueeze(0), w.unsqueeze(0))[0]


def chosen_mis(preds: torch.Tensor, y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Misprediction mask of hypothesis ``c`` (0-dim device tensor): a row
    slice of preds [C, H, n] against y [C, n] -> [C, n] f32."""
    rows = preds.index_select(-2, c.reshape(1).long()).squeeze(-2)
    return (rows != y).to(torch.float32)


def update_weights(
    w: torch.Tensor,  # [C, n] (or [n]) f32
    mis: torch.Tensor,  # same shape, f32
    mask: torch.Tensor,  # same shape, f32
    alpha: torch.Tensor,  # 0-dim f32 on the device
    *,
    renormalize: bool = True,
) -> torch.Tensor:
    """``w * exp(alpha*mis) * mask`` renormalised over all collaborators
    (paper step 4), in one kernel launch; ``renormalize=False`` returns the
    product alone, for a caller that renormalises from a total exchanged
    between the collaborators."""
    update = ops.weight_update if renormalize else ops.weight_update_product
    return update(w.reshape(-1), mis.reshape(-1), mask.reshape(-1), alpha).view(w.shape)


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


def committee_tally(learner: WeakLearner, spec: LearnerSpec, params_t: Any,
                    X: torch.Tensor) -> torch.Tensor:
    """The seat vote tally ``[..., [T,] n, K]`` of a committee slot
    (``[C, ...]``) or slot stack (``[T, C, ...]``): each seat's vote as a
    one-hot (out of range: a zero row), summed over the seats.  A mixed
    (heterogeneous) committee sums its groups' tallies
    (``core/hetero.py``)."""
    proto = learner.init(spec, X.device)
    lead = params_t[0].shape[: params_t[0].dim() - proto[0].dim()]  # ([T,] C)
    flat = type(params_t)(*(x.reshape((-1,) + p.shape) for x, p in zip(params_t, proto)))
    batch = X.shape[:-2]  # a leading shard axis, when X is [C, n, d]
    preds = learner.predict(spec, flat, X).view(batch + lead + X.shape[-2:-1])  # [.., [T,] C, n]
    return one_hot(preds, spec.n_classes, torch.float32).sum(dim=len(batch) + len(lead) - 1)


def member_prediction(learner: WeakLearner, spec: LearnerSpec, params_t: Any,
                      X: torch.Tensor, *, committee: bool = False) -> torch.Tensor:
    """A member's [n] class prediction (or [T, n] for a slot stack) — the
    single definition of the member vote rule, shared by full
    (``boosting.ensemble_votes``) and incremental (:func:`tally_new_votes`)
    evaluation and the serving engine.

    A DistBoost.F member is a committee of C hypotheses (slots ``[C, ...]``,
    a stack ``[T, C, ...]``) that votes within itself first: the first
    argmax of its :func:`committee_tally` is the member's class, as
    ``repro/core/scoring.py`` rules."""
    if not committee:
        return learner.predict(spec, params_t, X)
    return torch.argmax(committee_tally(learner, spec, params_t, X), dim=-1).to(torch.int32)


def tally_new_votes(
    learner: WeakLearner, spec: LearnerSpec, ensemble, tally: VoteTally, X: torch.Tensor,
    *, committee: bool = False,
) -> VoteTally:
    """Fold members ``[tally.counted, ensemble.count)`` into the tally."""
    votes = tally.votes
    for t in range(tally.counted, ensemble.count):
        pred = member_prediction(learner, spec, take_slot(ensemble.params, t), X,
                                 committee=committee)
        votes = votes + ensemble.alpha[t] * one_hot(pred, spec.n_classes, votes.dtype)
    return VoteTally(votes, ensemble.count)


def tally_predict(tally: VoteTally) -> torch.Tensor:
    return torch.argmax(tally.votes, dim=-1).to(torch.int32)
