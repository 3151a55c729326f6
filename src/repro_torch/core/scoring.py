"""Predict-once scoring (answers to ``repro/core/scoring.py``).

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
    that adds only the members appended since the last eval;
  * the masked twins (``masked_error_sum``, ``masked_argmin``,
    ``participation_denom``, ``masked_update_weights``,
    ``masked_member_prediction``, ``tally_new_votes_masked``) — the
    elastic round's step 3/4 over a :class:`Participation`.

The chosen index and alpha stay on the device throughout, so nothing
here waits for the card.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
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
# Masked (partial-participation) reductions — the elastic round's step 3/4
# ---------------------------------------------------------------------------
#
# An elastic round (fl/elastic.py) closes over a SUBSET of collaborators.
# The helpers below are the masked twins of the reductions above, with one
# contract: under full participation each is BIT-FOR-BIT the unmasked
# reduction, because it runs that reduction's literal operations (the
# renormalising ``weight_update`` launch, not the product and a sum).  The
# JAX package picks that branch on the device; here the responder set is
# known on the host (``Participation.full``), so the branch is a host
# ``if`` and no helper reads the device.


class Participation(NamedTuple):
    """A round's responders: ``mask [C]`` f32 on the device (1.0 responder,
    0.0 absent; None under full participation, where nothing reads it),
    ``full``, whether every collaborator responded, and ``responders``,
    the same ``[C]`` bool mask on the host."""

    mask: Optional[torch.Tensor]
    full: bool
    responders: np.ndarray


def participation(responders, device) -> Participation:
    """A :class:`Participation` from a host ``[C]`` mask (numpy or a
    sequence; > 0 means responded).  A partial mask goes to the device in
    one copy, from pinned memory on the card, so no round waits for it."""
    resp = np.asarray(responders) > 0
    if resp.all():
        return Participation(None, True, resp)
    mask = torch.from_numpy(resp.astype(np.float32))
    if torch.device(device).type == "cuda":
        mask = mask.pin_memory()
    return Participation(mask.to(device, non_blocking=True), False, resp)


def masked_error_sum(errs: torch.Tensor, part: Participation) -> torch.Tensor:
    """Global weighted error over responding shards: errs [C, H] -> [H].
    Absent collaborators' rows are zeroed before the shard-axis sum."""
    if part.full:
        return torch.sum(errs, dim=0)
    return torch.sum(torch.where(part.mask[:, None] > 0, errs, 0.0), dim=0)


def masked_argmin(eps: torch.Tensor, hyp_part: Participation) -> torch.Tensor:
    """argmin over the hypotheses of responding collaborators only (absent
    ones never uploaded theirs): eps [H] -> 0-dim index on the device."""
    if hyp_part.full:
        return torch.argmin(eps)
    return torch.argmin(torch.where(hyp_part.mask > 0, eps, float("inf")))


def participation_denom(weights: torch.Tensor, part: Participation) -> torch.Tensor:
    """Normaliser of a partial-participation weighted error: the
    responders' weight mass (the weights are normalised over ALL shards,
    so an error summed over responders alone underestimates).  The
    literal 1.0 under full participation, an exact identity."""
    if part.full:
        return torch.ones((), dtype=weights.dtype, device=weights.device)
    mass = torch.sum(torch.where(part.mask[:, None] > 0, weights, 0.0))
    return torch.clamp_min(mass, 1e-30)


def masked_update_weights(
    w: torch.Tensor,  # [C, n] f32
    mis: torch.Tensor,  # [C, n] f32
    mask: torch.Tensor,  # [C, n] f32
    part: Participation,
    alpha: torch.Tensor,
) -> torch.Tensor:
    """Paper step 4 over responders only: absent collaborators' rows are
    FROZEN (they never saw the chosen hypothesis), and the renormalisation
    still runs over every row, so a returning collaborator resumes with
    correctly scaled weights.  A partial round is one
    ``weight_update_product`` launch, the select and the division; a full
    one is :func:`update_weights`' one renormalising launch."""
    if part.full:
        return update_weights(w, mis, mask, alpha)
    upd = update_weights(w, mis, mask, alpha, renormalize=False)
    sel = torch.where(part.mask[:, None] > 0, upd, w)
    return sel / torch.clamp_min(torch.sum(sel), 1e-30)


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
                    X: torch.Tensor, seat_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The seat vote tally ``[..., [T,] n, K]`` of a committee slot
    (``[C, ...]``) or slot stack (``[T, C, ...]``): each seat's vote as a
    one-hot (out of range: a zero row), summed over the seats.  With
    ``seat_mask`` (``[C]`` or ``[T, C]``) a seat whose mask is 0 votes for
    nothing (an elastic committee's absent members); an all-ones mask
    gives the same bits as none.  A mixed (heterogeneous) committee sums
    its groups' tallies (``core/hetero.py``)."""
    proto = learner.init(spec, X.device)
    lead = params_t[0].shape[: params_t[0].dim() - proto[0].dim()]  # ([T,] C)
    flat = type(params_t)(*(x.reshape((-1,) + p.shape) for x, p in zip(params_t, proto)))
    batch = X.shape[:-2]  # a leading shard axis, when X is [C, n, d]
    preds = learner.predict(spec, flat, X).view(batch + lead + X.shape[-2:-1])  # [.., [T,] C, n]
    votes = one_hot(preds, spec.n_classes, torch.float32)
    if seat_mask is not None:
        votes = torch.where(seat_mask.view(lead + (1, 1)) > 0, votes, 0.0)
    return votes.sum(dim=len(batch) + len(lead) - 1)


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


def masked_member_prediction(learner: WeakLearner, spec: LearnerSpec, params_t: Any,
                             cmask: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """A DistBoost.F committee's vote with its absent members masked out:
    ``cmask`` (``[C]``, or ``[T, C]`` for a slot stack) records which of
    the slot's C seats took part in its round.  All-ones gives
    :func:`member_prediction` (``committee=True``) bit for bit."""
    tally = committee_tally(learner, spec, params_t, X, seat_mask=cmask)
    return torch.argmax(tally, dim=-1).to(torch.int32)


def tally_new_votes_masked(
    learner: WeakLearner, spec: LearnerSpec, ensemble, cmasks: torch.Tensor,
    tally: VoteTally, X: torch.Tensor,
) -> VoteTally:
    """:func:`tally_new_votes` for elastic DistBoost.F ensembles: each
    committee slot votes through its row of ``cmasks [T, C]``.  With
    all-ones masks this is ``tally_new_votes(committee=True)`` bit for
    bit."""
    votes = tally.votes
    for t in range(tally.counted, ensemble.count):
        pred = masked_member_prediction(learner, spec, take_slot(ensemble.params, t), cmasks[t], X)
        votes = votes + ensemble.alpha[t] * one_hot(pred, spec.n_classes, votes.dtype)
    return VoteTally(votes, ensemble.count)


def tally_predict(tally: VoteTally) -> torch.Tensor:
    return torch.argmax(tally.votes, dim=-1).to(torch.int32)
