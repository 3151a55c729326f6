"""Model-agnostic federated boosting: AdaBoost.F (paper §3, Fig. 1).
Answers to ``repro/core/boosting.py``; DistBoost.F, PreWeak.F and bagging
are not ported yet.

Data layout: collaborator-stacked fixed shapes —
    X [C, n, d]   y [C, n]   mask [C, n]  (padding -> mask 0)
Sample weights live in the state as w [C, n], globally normalised (the sum
over ALL collaborators is 1).

A round never waits for the card: the chosen index and alpha stay on the
device, and the ensemble slot written is the host-known member count
(AdaBoost.F appends exactly one member per round).  The ensemble's slot
buffers are updated in place, so a round allocates no copy of them.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import math

import torch

from repro_torch.core import scoring
from repro_torch.kernels.ref import one_hot
from repro_torch.learners.base import LearnerSpec, WeakLearner

# ---------------------------------------------------------------------------
# Ensemble (the "strong hypothesis")
# ---------------------------------------------------------------------------


class Ensemble(NamedTuple):
    """Pre-allocated strong hypothesis: T slots of weak-hypothesis tensors."""

    params: Any  # NamedTuple of tensors, each with leading dim T
    alpha: torch.Tensor  # [T] f32
    count: int  # slots used so far (host-known)


def init_ensemble(learner: WeakLearner, spec: LearnerSpec, T: int, device) -> Ensemble:
    proto = learner.init(spec, device)
    params = type(proto)(*(torch.zeros((T,) + x.shape, dtype=x.dtype, device=device) for x in proto))
    return Ensemble(params=params, alpha=torch.zeros(T, dtype=torch.float32, device=device), count=0)


def ensemble_to(ens: Ensemble, device) -> Ensemble:
    """The same ensemble with every tensor on ``device`` (a copy unless it
    is there already)."""
    params = type(ens.params)(*(x.to(device) for x in ens.params))
    return Ensemble(params, ens.alpha.to(device), ens.count)


def ensemble_votes(learner: WeakLearner, spec: LearnerSpec, ens: Ensemble, X: torch.Tensor) -> torch.Tensor:
    """alpha-weighted vote tally [n, K] over the used slots."""
    T = ens.alpha.shape[0]
    preds = learner.predict(spec, ens.params, X)  # [T, n]
    used = (torch.arange(T, device=X.device) < ens.count).to(torch.float32) * ens.alpha
    onehot = one_hot(preds, spec.n_classes, torch.float32)  # [T, n, K]; out of range: a zero row
    return torch.einsum("t,tnk->nk", used, onehot)


def strong_predict(learner, spec, ens: Ensemble, X) -> torch.Tensor:
    return torch.argmax(ensemble_votes(learner, spec, ens, X), dim=-1)


# ---------------------------------------------------------------------------
# Shared round machinery
# ---------------------------------------------------------------------------


class BoostState(NamedTuple):
    ensemble: Ensemble
    weights: torch.Tensor  # [C, n] — globally normalised sample weights
    # Per-collaborator X-only fit precomputation (a BinnedDataset for the
    # trees), built once at init and threaded through every round.
    fit_cache: Any = None


def init_boost_state(
    learner: WeakLearner,
    spec: LearnerSpec,
    T: int,
    mask: torch.Tensor,  # [C, n]
    *,
    X: torch.Tensor | None = None,  # [C, n, d] — enables the fit cache
) -> BoostState:
    w = mask / torch.clamp_min(torch.sum(mask), 1.0)  # uniform over the GLOBAL dataset
    cache = None
    if X is not None and learner.precompute is not None:
        cache = learner.precompute(spec, X)  # [C, ...]
    return BoostState(
        ensemble=init_ensemble(learner, spec, T, mask.device),
        weights=w.to(torch.float32),
        fit_cache=cache,
    )


def _local_fits(learner, spec, w, X, y, fit_cache):
    """Train one weak hypothesis per collaborator (paper step 2): all C
    fits as one batched tensor program over the shard-static fit cache."""
    if learner.fit_batched is None or fit_cache is None:
        raise NotImplementedError(
            f"learner {learner.name!r} needs fit_batched and a fit cache; the "
            "per-collaborator fit routes are not ported"
        )
    return learner.fit_batched(spec, X, y, w, fit_cache)


def _samme_alpha(eps: torch.Tensor, n_classes: int) -> torch.Tensor:
    eps = torch.clamp(eps, 1e-10, 1.0 - 1e-10)
    return torch.clamp(torch.log((1.0 - eps) / eps) + math.log(n_classes - 1.0), -10.0, 10.0)


def run_stages(stages, state: BoostState, X, y, mask):
    """Compose a round's named stages ``fn(state, carry, X, y, mask) ->
    (state, carry)``; the last leaves the round metrics in
    ``carry["metrics"]``.  Eager PyTorch runs each statement as written,
    so there is no cross-stage fusion to seal off."""
    carry: Dict[str, Any] = {}
    for _, fn in stages:  # mafl: allow[stage-barrier] eager torch never fuses across stages
        state, carry = fn(state, carry, X, y, mask)
    return state, carry["metrics"]


# ---------------------------------------------------------------------------
# AdaBoost.F (the paper's implemented algorithm)
# ---------------------------------------------------------------------------


def adaboost_f_stages(learner: WeakLearner, spec: LearnerSpec):
    """The AdaBoost.F round as named stages (see :func:`run_stages`)."""

    def fit(state, carry, X, y, mask):
        # step 2: local training, all C fits as one batched tensor program
        hyps = _local_fits(learner, spec, state.weights, X, y, state.fit_cache)
        return state, {"hyps": hyps}

    def score(state, carry, X, y, mask):
        # step 3: predict ONCE per (hypothesis, shard); everything
        # downstream is a reduction over this tensor
        preds = scoring.predict_tensor(learner, spec, carry["hyps"], X)  # [C, C, n]
        errs = scoring.error_matrix(preds, y, state.weights)
        return state, {**carry, "preds": preds, "errs": errs}

    def aggregate(state, carry, X, y, mask):
        # step 4 (aggregator): globally weighted error, best hypothesis, alpha
        hyps, preds, errs = carry["hyps"], carry["preds"], carry["errs"]
        eps = torch.sum(errs, dim=0)  # w globally normalised
        c = torch.argmin(eps)  # stays on the device
        eps_c = torch.take(eps, c)
        alpha = _samme_alpha(eps_c, spec.n_classes)

        ens = state.ensemble
        t = ens.count
        for slot, chosen in zip(ens.params, scoring.take_slot(hyps, c)):
            slot[t].copy_(chosen)
        ens.alpha[t].copy_(alpha)
        ens = Ensemble(ens.params, ens.alpha, t + 1)

        mis = scoring.chosen_mis(preds, y, c)  # row slice of preds
        w = scoring.update_weights(state.weights, mis, mask, alpha)
        metrics = {"epsilon": eps_c, "alpha": alpha, "chosen": c.to(torch.int32)}
        return BoostState(ens, w, state.fit_cache), {"metrics": metrics}

    return [("fit", fit), ("score", score), ("aggregate", aggregate)]


def adaboost_f_round(
    learner: WeakLearner, spec: LearnerSpec, state: BoostState, X, y, mask
) -> Tuple[BoostState, Dict[str, torch.Tensor]]:
    return run_stages(adaboost_f_stages(learner, spec), state, X, y, mask)
