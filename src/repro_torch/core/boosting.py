"""Model-agnostic federated boosting — AdaBoost.F, DistBoost.F, PreWeak.F
and federated bagging (paper §3, Fig. 1), plus the centralized AdaBoost
(SAMME) oracle (answers to ``repro/core/boosting.py``).

Data layout: collaborator-stacked fixed shapes —
    X [C, n, d]   y [C, n]   mask [C, n]  (padding -> mask 0)
Sample weights live in the state as w [C, n], globally normalised (the sum
over ALL collaborators is 1).

A round never waits for the card: the chosen index and alpha stay on the
device, and the ensemble slot written is the host-known member count
(every algorithm appends exactly one member per round).  The ensemble's
slot buffers are updated in place, so a round allocates no copy of them.

Randomness (bagging's pick, ``extra_tree``'s split candidates, drawn for
PreWeak.F's local rounds too) comes from one explicit CPU
``torch.Generator`` handed to the stage factories and drawn in a fixed
order, so the card and the CPU draw the same numbers; the JAX package's
keys have no counterpart, and its draws cannot be reproduced, only
injected (``bagging_stages(pick=)``, ``extra_tree``'s ``candidates``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

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

    params: Any  # NamedTuple of tensors, each with leading dim T ([T, C] for committees)
    alpha: torch.Tensor  # [T] f32
    count: int  # slots used so far (host-known)


def init_ensemble(learner: WeakLearner, spec: LearnerSpec, T: int, device,
                  committee_size: int | None = None) -> Ensemble:
    """T zero slots; a DistBoost.F slot holds a committee of
    ``committee_size`` hypotheses."""
    proto = learner.init(spec, device)
    lead = (T,) if committee_size is None else (T, committee_size)
    params = type(proto)(*(torch.zeros(lead + x.shape, dtype=x.dtype, device=device) for x in proto))
    return Ensemble(params=params, alpha=torch.zeros(T, dtype=torch.float32, device=device), count=0)


def ensemble_to(ens: Ensemble, device) -> Ensemble:
    """The same ensemble with every tensor on ``device`` (a copy unless it
    is there already)."""
    params = type(ens.params)(*(x.to(device) for x in ens.params))
    return Ensemble(params, ens.alpha.to(device), ens.count)


def used_weights(ens: Ensemble) -> torch.Tensor:
    """alpha over the used slots, 0 beyond ``count``: [T] f32 on the device."""
    T = ens.alpha.shape[0]
    live = torch.arange(T, device=ens.alpha.device) < ens.count
    return (live.to(torch.float32) * ens.alpha).contiguous()


def ensemble_votes(learner: WeakLearner, spec: LearnerSpec, ens: Ensemble, X: torch.Tensor,
                   *, committee: bool = False) -> torch.Tensor:
    """alpha-weighted vote tally [n, K] over the used slots."""
    preds = scoring.member_prediction(learner, spec, ens.params, X, committee=committee)  # [T, n]
    used = used_weights(ens)
    onehot = one_hot(preds, spec.n_classes, torch.float32)  # [T, n, K]; out of range: a zero row
    return torch.einsum("t,tnk->nk", used, onehot)


def strong_predict(learner, spec, ens: Ensemble, X, *, committee: bool = False) -> torch.Tensor:
    return torch.argmax(ensemble_votes(learner, spec, ens, X, committee=committee), dim=-1)


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
    committee_size: int | None = None,
    X: torch.Tensor | None = None,  # [C, n, d] — enables the fit cache
) -> BoostState:
    w = mask / torch.clamp_min(torch.sum(mask), 1.0)  # uniform over the GLOBAL dataset
    cache = None
    if X is not None and learner.precompute is not None:
        cache = learner.precompute(spec, X)  # [C, ...]
    return BoostState(
        ensemble=init_ensemble(learner, spec, T, mask.device, committee_size=committee_size),
        weights=w.to(torch.float32),
        fit_cache=cache,
    )


def _local_fits(learner, spec, w, X, y, fit_cache, generator=None, *, batched: bool = True,
                **draws):
    """Train one weak hypothesis per collaborator (paper step 2).

    Two routes, as the JAX package's ``_local_fits``:
      * batched (``batched_fit`` on): a learner with ``fit_batched`` (the
        trees) fits all C over the shard-static fit cache as one tensor
        program (one ``tree_hist`` launch a level); the others fit
        ``[C, n, ...]`` inputs natively (the counterpart of ``vmap(fit)``);
      * per collaborator (``batched_fit`` off; the counterpart of
        ``vmap(fit_cached)``): a learner with ``fit_batched`` fits each
        collaborator alone over its slice of the cache, C launches a
        level.  A randomised learner draws for all C in one call first
        and hands each fit its row, so both routes draw the same numbers.
    A randomised learner draws from ``generator``, or takes ``draws``
    injected (``learners/base.py``)."""
    if learner.fit_batched is None:
        return learner.fit(spec, None, X, y, w, generator=generator, **draws)
    if batched or fit_cache is None:
        return learner.fit_batched(spec, X, y, w, fit_cache, generator=generator, **draws)
    if learner.draw is not None and not draws:
        if generator is None:
            raise ValueError(f"{learner.name} draws: pass a generator or its draws")
        draws = learner.draw(spec, X.shape[0], generator, X.device)
    fits = []
    for i in range(X.shape[0]):
        row = slice(i, i + 1)
        cache_i = type(fit_cache)(*(x[row] for x in fit_cache))
        fits.append(learner.fit_batched(spec, X[row], y[row], w[row], cache_i,
                                        **{k: v[row] for k, v in draws.items()}))
    return type(fits[0])(*(torch.cat(leaves) for leaves in zip(*fits)))


def _append(ens: Ensemble, member: Any, alpha) -> Ensemble:
    """Write slot ``ens.count`` in place and count it."""
    t = ens.count
    for slot, x in zip(ens.params, member):
        slot[t].copy_(x)
    ens.alpha[t].copy_(alpha)
    return Ensemble(ens.params, ens.alpha, t + 1)


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


def adaboost_f_stages(learner: WeakLearner, spec: LearnerSpec, *,
                      generator: torch.Generator | None = None, batched_fit: bool = True):
    """The AdaBoost.F round as named stages (see :func:`run_stages`)."""

    def fit(state, carry, X, y, mask):
        # step 2: local training, one hypothesis per collaborator
        hyps = _local_fits(learner, spec, state.weights, X, y, state.fit_cache, generator,
                           batched=batched_fit)
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
        ens = _append(state.ensemble, scoring.take_slot(hyps, c), alpha)
        mis = scoring.chosen_mis(preds, y, c)  # row slice of preds
        w = scoring.update_weights(state.weights, mis, mask, alpha)
        metrics = {"epsilon": eps_c, "alpha": alpha, "chosen": c.to(torch.int32)}
        return BoostState(ens, w, state.fit_cache), {"metrics": metrics}

    return [("fit", fit), ("score", score), ("aggregate", aggregate)]


def adaboost_f_round(
    learner: WeakLearner, spec: LearnerSpec, state: BoostState, X, y, mask, *,
    generator: torch.Generator | None = None, batched_fit: bool = True,
) -> Tuple[BoostState, Dict[str, torch.Tensor]]:
    return run_stages(adaboost_f_stages(learner, spec, generator=generator,
                                        batched_fit=batched_fit), state, X, y, mask)


# ---------------------------------------------------------------------------
# DistBoost.F — the round hypothesis is the committee of all local models
# ---------------------------------------------------------------------------


def _committee_predict(learner, spec, committee, X) -> torch.Tensor:
    """The committee's vote on each shard: X [C, n, d] -> [C, n] int32."""
    return scoring.member_prediction(learner, spec, committee, X, committee=True)


def distboost_f_stages(learner: WeakLearner, spec: LearnerSpec, *,
                       generator: torch.Generator | None = None, batched_fit: bool = True):
    """The DistBoost.F round as named stages (see :func:`run_stages`)."""

    def fit(state, carry, X, y, mask):
        committee = _local_fits(learner, spec, state.weights, X, y, state.fit_cache, generator,
                                batched=batched_fit)
        return state, {"committee": committee}

    def score(state, carry, X, y, mask):
        # the round's only predict pass: every member on every shard, one vote per shard
        mis = (_committee_predict(learner, spec, carry["committee"], X) != y).to(torch.float32)
        return state, {**carry, "mis": mis}

    def aggregate(state, carry, X, y, mask):
        committee, mis = carry["committee"], carry["mis"]
        eps = torch.sum(state.weights * mis)
        alpha = _samme_alpha(eps, spec.n_classes)
        ens = _append(state.ensemble, committee, alpha)
        w = scoring.update_weights(state.weights, mis, mask, alpha)
        metrics = {"epsilon": eps, "alpha": alpha,
                   "chosen": torch.zeros((), dtype=torch.int32, device=eps.device)}
        return BoostState(ens, w, state.fit_cache), {"metrics": metrics}

    return [("fit", fit), ("score", score), ("aggregate", aggregate)]


def distboost_f_round(learner, spec, state, X, y, mask, *,
                      generator: torch.Generator | None = None, batched_fit: bool = True):
    return run_stages(distboost_f_stages(learner, spec, generator=generator,
                                         batched_fit=batched_fit), state, X, y, mask)


# ---------------------------------------------------------------------------
# PreWeak.F — search a pre-trained C x T hypothesis space
# ---------------------------------------------------------------------------


def _preweak_local_space(learner, spec, X, y, mask, fit_cache, T: int,
                         generator: torch.Generator | None = None):
    """Steps 1+2 of PreWeak.F: every collaborator runs T rounds of LOCAL
    AdaBoost on its own shard; returns the flat ``[C*T, ...]`` hypothesis
    block (collaborator-major, as the JAX package's ``reshape``).

    Each local round fits all C collaborators as one ``fit_batched`` (one
    ``tree_hist`` launch a level).  The local error and update stay plain
    tensor operations, renormalised per collaborator: the fused
    ``weight_update`` kernel renormalises over all collaborators."""
    C = y.shape[0]
    w = mask / torch.clamp_min(torch.sum(mask, dim=1, keepdim=True), 1.0)
    rounds = []
    for _ in range(T):
        p = _local_fits(learner, spec, w, X, y, fit_cache, generator)
        own = torch.diagonal(scoring.predict_tensor(learner, spec, p, X)).T  # [C, n]: own tree, own shard
        mis = (own != y).to(torch.float32)
        e = torch.sum(w * mis, dim=1) / torch.clamp_min(torch.sum(w, dim=1), 1e-30)
        a = _samme_alpha(e, spec.n_classes)
        w = w * torch.exp(a.unsqueeze(1) * mis) * mask
        w = w / torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1e-30)
        rounds.append(p)
    return type(rounds[0])(*(
        torch.stack(leaves, dim=1).reshape((C * T,) + leaves[0].shape[1:])
        for leaves in zip(*rounds)
    ))


def preweak_f_setup(learner, spec, state: BoostState, X, y, mask, T: int,
                    generator: torch.Generator | None = None):
    """Fuse steps 1+2: every collaborator runs T rounds of LOCAL AdaBoost,
    shipping all T hypotheses; the federation then owns a C*T space.
    Returns ``(hypothesis space, state)``."""
    return _preweak_local_space(learner, spec, X, y, mask, state.fit_cache, T, generator), state


def preweak_f_predictions(learner, spec, hyp_space, X) -> torch.Tensor:
    """Setup-time prediction cache [C, C*T, n] for the static hypothesis
    space: every round's scoring is one ``weighted_errors`` launch over it."""
    return scoring.predict_tensor(learner, spec, hyp_space, X)


def preweak_f_stages(learner, spec, hyp_space, pred_cache: torch.Tensor | None = None):
    """The PreWeak.F round as named stages (see :func:`run_stages`).  No fit
    stage: the space is pre-trained at set-up.  With ``pred_cache`` (from
    :func:`preweak_f_predictions`) a round is a reduction over the cached
    predictions; without it the space is predicted every round (the
    behaviour before the predict-once optimisation)."""

    def score(state, carry, X, y, mask):
        preds = pred_cache if pred_cache is not None else preweak_f_predictions(
            learner, spec, hyp_space, X)  # [C, C*T, n]
        errs = scoring.error_matrix(preds, y, state.weights)  # [C, C*T]
        return state, {"preds": preds, "errs": errs}

    def aggregate(state, carry, X, y, mask):
        pred_cache = carry["preds"]
        eps = torch.sum(carry["errs"], dim=0)
        c = torch.argmin(eps)  # stays on the device
        eps_c = torch.take(eps, c)
        alpha = _samme_alpha(eps_c, spec.n_classes)
        ens = _append(state.ensemble, scoring.take_slot(hyp_space, c), alpha)
        mis = scoring.chosen_mis(pred_cache, y, c)  # row slice of the predictions
        w = scoring.update_weights(state.weights, mis, mask, alpha)
        metrics = {"epsilon": eps_c, "alpha": alpha, "chosen": c.to(torch.int32)}
        return BoostState(ens, w, state.fit_cache), {"metrics": metrics}

    return [("score", score), ("aggregate", aggregate)]


def preweak_f_round(learner, spec, state, hyp_space, X, y, mask, *,
                    pred_cache: torch.Tensor | None = None):
    """Rounds loop only on steps 3-4 (the red dotted line of Fig. 1)."""
    return run_stages(preweak_f_stages(learner, spec, hyp_space, pred_cache), state, X, y, mask)


# ---------------------------------------------------------------------------
# Federated bagging — omit adaboost_update (paper §4.1)
# ---------------------------------------------------------------------------


def bagging_stages(learner, spec, *, generator: torch.Generator | None = None, pick=None,
                   batched_fit: bool = True):
    """The federated-bagging round as named stages (see :func:`run_stages`).
    No score stage.  The member kept is ``pick`` when given (a collaborator
    index, injected), else drawn uniformly from ``generator`` after the
    fit's own draws; it goes to the device, never back."""

    def fit(state, carry, X, y, mask):
        w = mask / torch.clamp_min(torch.sum(mask, dim=1, keepdim=True), 1.0)  # local-uniform
        hyps = _local_fits(learner, spec, w, X, y, state.fit_cache, generator,
                           batched=batched_fit)
        return state, {"hyps": hyps}

    def aggregate(state, carry, X, y, mask):
        if pick is None:
            if generator is None:
                raise ValueError("bagging draws its member: pass a generator or a pick")
            c = torch.randint(0, X.shape[0], (), generator=generator)
        else:
            c = torch.as_tensor(pick, dtype=torch.int64)
        c = c.to(X.device)
        one = torch.ones((), dtype=torch.float32, device=X.device)
        ens = _append(state.ensemble, scoring.take_slot(carry["hyps"], c), one)  # unweighted vote
        metrics = {"epsilon": torch.zeros_like(one), "alpha": one, "chosen": c.to(torch.int32)}
        return BoostState(ens, state.weights, state.fit_cache), {"metrics": metrics}

    return [("fit", fit), ("aggregate", aggregate)]


def bagging_round(learner, spec, state, X, y, mask, *,
                  generator: torch.Generator | None = None, pick=None, batched_fit: bool = True):
    return run_stages(bagging_stages(learner, spec, generator=generator, pick=pick,
                                     batched_fit=batched_fit), state, X, y, mask)


# ---------------------------------------------------------------------------
# Centralized AdaBoost (SAMME) — the Table 1 "Reference" oracle
# ---------------------------------------------------------------------------


def centralized_adaboost(learner: WeakLearner, spec: LearnerSpec, X: torch.Tensor,
                         y: torch.Tensor, T: int, *,
                         generator: torch.Generator | None = None) -> Ensemble:
    """T AdaBoost.F rounds over the pooled data as one collaborator."""
    Xc, yc = X[None], y[None]
    mc = torch.ones(yc.shape, dtype=torch.float32, device=X.device)
    state = init_boost_state(learner, spec, T, mc, X=Xc)
    stages = adaboost_f_stages(learner, spec, generator=generator)
    for _ in range(T):
        state, _ = run_stages(stages, state, Xc, yc, mc)
    return state.ensemble


ROUND_FNS: Dict[str, Callable] = {
    "adaboost_f": adaboost_f_round,
    "distboost_f": distboost_f_round,
    "bagging": bagging_round,
}

# Stage factories (PreWeak.F's is absent: it needs the hypothesis space and
# its prediction cache, so the federation calls preweak_f_stages directly).
ROUND_STAGES: Dict[str, Callable] = {
    "adaboost_f": adaboost_f_stages,
    "distboost_f": distboost_f_stages,
    "bagging": bagging_stages,
}
