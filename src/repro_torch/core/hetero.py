"""Heterogeneous-learner federations: a learner family per collaborator
(answers to ``repro/core/hetero.py``).

AdaBoost.F is model-agnostic: aggregation only sees hypothesis
predictions, so collaborators need not train the same model family.
``HeterogeneousSpec`` assigns each collaborator a learner group (one per
distinct (registry key, hyperparameters)); everything else follows from
it:

  * **Grouped local fits.**  Each group fits its members as one tensor
    program (``boosting._local_fits``: a tree group still launches one
    ``tree_hist`` a level).  A randomised group draws for ALL C
    collaborators, in collaborator order, and keeps its members' rows, so
    a collaborator's draws never depend on which others share its group.
  * **Cross-group voting.**  Each group's hypotheses are predicted on
    every shard and the blocks concatenate, in the group-blocked order of
    :func:`_hyp_maps`, into the ``[C, H, n]`` tensor the homogeneous
    rounds reduce: one ``weighted_errors`` launch, one ``weight_update``.
  * **Grouped ensemble.**  The strong hypothesis is a tuple of per-group
    slot-buffer ``Ensemble`` s.  A round appends its winner to the owner
    group only.  The port's ``Ensemble.count`` is a host int, and in a
    mixed federation which group's count moves depends on the device
    argmin, so :func:`_append_chosen` reads the winner's index on the host
    once a round (one device sync; none with a single group, none for
    bagging, whose pick is a host draw).  Votes commute, so evaluation is
    the sum of per-group tallies.

With a single group every step is the homogeneous port's operation on the
same values (identity gathers, a one-block concatenation, the
homogeneous append), so a one-group federation equals the homogeneous one
bit for bit (``tests/test_torch_hetero.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import scoring
from repro_torch.core.boosting import (
    BoostState,
    Ensemble,
    _append,
    _local_fits,
    _samme_alpha,
    ensemble_to,
    ensemble_votes,
    init_ensemble,
    used_weights,
)
from repro_torch.kernels.ref import one_hot
from repro_torch.learners.base import LearnerSpec, WeakLearner, get_learner

# The strong hypothesis of a heterogeneous federation: one Ensemble per
# learner group, in group order.
HeteroEnsemble = Tuple[Ensemble, ...]


@dataclasses.dataclass(frozen=True)
class HeterogeneousSpec:
    """``specs[g]`` describes learner group g; ``assignment[i]`` names
    collaborator i's group.  All groups share ``n_features`` and
    ``n_classes``, and every group owns at least one collaborator."""

    specs: Tuple[LearnerSpec, ...]
    assignment: Tuple[int, ...]

    def __post_init__(self):
        if not self.specs:
            raise ValueError("HeterogeneousSpec needs at least one learner group")
        if not self.assignment:
            raise ValueError("HeterogeneousSpec needs at least one collaborator")
        nf = {s.n_features for s in self.specs}
        nc = {s.n_classes for s in self.specs}
        if len(nf) != 1 or len(nc) != 1:
            raise ValueError(
                f"all learner groups must share the problem geometry; "
                f"got n_features={sorted(nf)}, n_classes={sorted(nc)}"
            )
        bad = [g for g in self.assignment if not 0 <= g < len(self.specs)]
        if bad:
            raise ValueError(f"assignment references unknown groups {sorted(set(bad))}")
        unused = set(range(len(self.specs))) - set(self.assignment)
        if unused:
            raise ValueError(f"learner groups {sorted(unused)} have no collaborators")

    @property
    def n_features(self) -> int:
        return self.specs[0].n_features

    @property
    def n_classes(self) -> int:
        return self.specs[0].n_classes

    @property
    def n_collaborators(self) -> int:
        return len(self.assignment)

    @property
    def n_groups(self) -> int:
        return len(self.specs)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.specs)

    def members(self, g: int) -> Tuple[int, ...]:
        """Collaborator indices of group ``g``, ascending."""
        return tuple(i for i, gi in enumerate(self.assignment) if gi == g)

    @classmethod
    def cycle(cls, names: Sequence[str], n_collaborators: int, n_features: int,
              n_classes: int, hparams: Optional[Dict[str, Dict[str, Any]]] = None
              ) -> "HeterogeneousSpec":
        """Collaborator i gets ``names[i % len(names)]``; ``hparams`` maps a
        registry key to its hyperparameters.  Identical (name, hparams)
        entries collapse into one group, so ``cycle(["decision_tree"], C,
        ...)`` is the one-group spec of the homogeneous federation."""
        if not names:
            raise ValueError("cycle() needs at least one learner name")
        hparams = hparams or {}
        groups: List[LearnerSpec] = []
        keyed: Dict[str, int] = {}  # (name, canonical hparams) -> group index
        assignment = []
        for i in range(n_collaborators):
            name = names[i % len(names)]
            hp = dict(hparams.get(name, {}))
            k = f"{name}|{json.dumps(hp, sort_keys=True)}"
            if k not in keyed:
                keyed[k] = len(groups)
                groups.append(LearnerSpec(name, n_features, n_classes, hp))
            assignment.append(keyed[k])
        return cls(specs=tuple(groups), assignment=tuple(assignment))


def resolve(hspec: HeterogeneousSpec) -> Tuple[WeakLearner, ...]:
    """Registry lookup for every group (raises KeyError on unknown keys)."""
    return tuple(get_learner(s.name) for s in hspec.specs)


def group_committee_sizes(hspec: HeterogeneousSpec, committee: bool) -> Tuple[Optional[int], ...]:
    """DistBoost.F stores each round's whole committee: group g holds its
    ``len(members(g))`` seats of it."""
    if not committee:
        return (None,) * hspec.n_groups
    return tuple(len(hspec.members(g)) for g in range(hspec.n_groups))


def hetero_count(hens: HeteroEnsemble, *, committee: bool = False) -> int:
    """Used members: the sum of the group counts, or, for committees (every
    round appends to every group), any one of them."""
    if committee:
        return hens[0].count
    return sum(e.count for e in hens)


def hetero_ensemble_to(hens: HeteroEnsemble, device) -> HeteroEnsemble:
    """The same ensemble with every tensor on ``device``."""
    return tuple(ensemble_to(e, device) for e in hens)


# ---------------------------------------------------------------------------
# Static index maps
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _device_ints(values: Tuple[int, ...], device: torch.device, dtype=torch.long) -> torch.Tensor:
    """A constant index tensor, copied to the device once per process (a
    copy from pageable host memory waits for the device)."""
    return torch.tensor(values, dtype=dtype, device=device)


def _member_index(hspec: HeterogeneousSpec, device) -> List[torch.Tensor]:
    return [_device_ints(hspec.members(g), torch.device(device)) for g in range(hspec.n_groups)]


def _hyp_maps(hspec: HeterogeneousSpec, per_member: int = 1):
    """Maps over the group-blocked global hypothesis order: group 0's
    hypotheses (its members ascending, ``per_member`` each: PreWeak.F's
    spaces carry T a member), then group 1's, ...  Returns (owner, local,
    collab) numpy arrays: hypothesis j belongs to group ``owner[j]`` at
    group-local slot ``local[j]`` and was trained by collaborator
    ``collab[j]``."""
    owner, local, collab = [], [], []
    for g in range(hspec.n_groups):
        m = hspec.members(g)
        cnt = len(m) * per_member
        owner.append(np.full(cnt, g, np.int32))
        local.append(np.arange(cnt, dtype=np.int32))
        collab.append(np.repeat(np.asarray(m, np.int32), per_member))
    return np.concatenate(owner), np.concatenate(local), np.concatenate(collab)


def _rows(x: Any, idx: torch.Tensor) -> Any:
    """Rows ``idx`` of a tensor or of every tensor of a NamedTuple."""
    if isinstance(x, torch.Tensor):
        return x.index_select(0, idx.to(x.device))
    return type(x)(*(_rows(t, idx) for t in x))


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def init_hetero_ensemble(hspec: HeterogeneousSpec, T: int, device, *,
                         committee: bool = False) -> HeteroEnsemble:
    """Per-group slot buffers, each of the full capacity ``T`` (a group can
    win every round)."""
    sizes = group_committee_sizes(hspec, committee)
    return tuple(init_ensemble(learner, spec, T, device, committee_size=cs)
                 for learner, spec, cs in zip(resolve(hspec), hspec.specs, sizes))


def init_hetero_boost_state(hspec: HeterogeneousSpec, T: int, mask: torch.Tensor, *,
                            committee: bool = False, X: Optional[torch.Tensor] = None
                            ) -> BoostState:
    """``boosting.init_boost_state`` for a mixture: the ensemble is the
    group tuple and ``fit_cache`` holds one cache per group, each over its
    own members' shards (None for a learner without ``precompute``)."""
    w = mask / torch.clamp_min(torch.sum(mask), 1.0)
    caches = None
    if X is not None:
        idx = _member_index(hspec, X.device)
        caches = tuple(
            learner.precompute(spec, X.index_select(0, idx[g]))
            if learner.precompute is not None else None
            for g, (learner, spec) in enumerate(zip(resolve(hspec), hspec.specs))
        )
    return BoostState(ensemble=init_hetero_ensemble(hspec, T, mask.device, committee=committee),
                      weights=w.to(torch.float32), fit_cache=caches)


# ---------------------------------------------------------------------------
# Grouped round machinery
# ---------------------------------------------------------------------------


def _grouped_local_fits(hspec, learners, w, X, y, caches, generator=None, *,
                        batched: bool = True) -> List[Any]:
    """Paper step 2 under heterogeneity: each group fits its members'
    slice as one tensor program (``batched`` off: a tree group fits each
    member alone, ``boosting._local_fits``).  A randomised group draws for all C
    collaborators (``learner.draw``, collaborator order) and keeps its
    members' rows; groups draw in group order.  Returns the per-group
    ``[C_g, ...]`` hypothesis stacks."""
    idx = _member_index(hspec, X.device)
    out = []
    for g, (learner, spec) in enumerate(zip(learners, hspec.specs)):
        draws = {}
        if learner.draw is not None and generator is not None:
            draws = {k: _rows(v, idx[g])
                     for k, v in learner.draw(spec, hspec.n_collaborators, generator,
                                              X.device).items()}
        i = idx[g]
        out.append(_local_fits(learner, spec, w.index_select(0, i), X.index_select(0, i),
                               y.index_select(0, i),
                               caches[g] if caches is not None else None, generator,
                               batched=batched, **draws))
    return out


def _grouped_predict_tensor(hspec, learners, hyps: Sequence[Any], X) -> torch.Tensor:
    """The cross-group ``[C, H, n]`` prediction tensor (paper step 3): every
    group's hypotheses on every shard, the blocks concatenated along the
    hypothesis axis in the group-blocked order of :func:`_hyp_maps`."""
    parts = [scoring.predict_tensor(learner, spec, hyps[g], X)
             for g, (learner, spec) in enumerate(zip(learners, hspec.specs))]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _append_chosen(hens: HeteroEnsemble, sources: Sequence[Any], owner: np.ndarray,
                   local: np.ndarray, c, alpha) -> HeteroEnsemble:
    """Append hypothesis ``c`` of the global order (``owner``/``local``) to
    its owner group only.  ``c`` is a host int or a 0-dim device tensor.
    With one group the owner is known and the slot is ``c`` itself, so the
    append is the homogeneous one with no sync; otherwise a device ``c`` is
    read on the host here, the round's one sync, since the group whose
    host-int count moves depends on it."""
    if len(hens) == 1:
        return (_append(hens[0], scoring.take_slot(sources[0], c), alpha),)
    j = int(c)  # the winner, read on the host once a round
    g, slot = int(owner[j]), int(local[j])
    out = list(hens)
    out[g] = _append(hens[g], scoring.take_slot(sources[g], slot), alpha)
    return tuple(out)


def _committee_tally(learners, hspec, params_by_group, X) -> torch.Tensor:
    """``[..., [T,] n, K]`` seat tally of a mixed committee whose group g
    seats are ``params_by_group[g]`` (``[C_g, ...]``, or ``[T, C_g, ...]``):
    the groups' seat tallies summed in group order."""
    tally = None
    for g, (learner, spec) in enumerate(zip(learners, hspec.specs)):
        t = scoring.committee_tally(learner, spec, params_by_group[g], X)
        tally = t if tally is None else tally + t
    return tally


def _committee_prediction(learners, hspec, params_by_group, X) -> torch.Tensor:
    return torch.argmax(_committee_tally(learners, hspec, params_by_group, X),
                        dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Rounds: the stage structure of core/boosting.py, grouped
# ---------------------------------------------------------------------------


def hetero_adaboost_f_stages(hspec: HeterogeneousSpec, *,
                             generator: torch.Generator | None = None, batched_fit: bool = True):
    """The grouped AdaBoost.F round as named stages (``boosting.run_stages``)."""
    learners = resolve(hspec)
    owner, local, collab = _hyp_maps(hspec)

    def fit(state, carry, X, y, mask):
        hyps = _grouped_local_fits(hspec, learners, state.weights, X, y, state.fit_cache, generator,
                                   batched=batched_fit)
        return state, {"hyps": hyps}

    def score(state, carry, X, y, mask):
        preds = _grouped_predict_tensor(hspec, learners, carry["hyps"], X)  # [C, H, n]
        errs = scoring.error_matrix(preds, y, state.weights)
        return state, {**carry, "preds": preds, "errs": errs}

    def aggregate(state, carry, X, y, mask):
        hyps, preds, errs = carry["hyps"], carry["preds"], carry["errs"]
        eps = torch.sum(errs, dim=0)
        c = torch.argmin(eps)  # stays on the device
        eps_c = torch.take(eps, c)
        alpha = _samme_alpha(eps_c, hspec.n_classes)
        ens = _append_chosen(state.ensemble, hyps, owner, local, c, alpha)
        mis = scoring.chosen_mis(preds, y, c)
        w = scoring.update_weights(state.weights, mis, mask, alpha)
        chosen = _device_ints(tuple(collab.tolist()), eps.device, torch.int32)
        chosen = chosen.index_select(0, c.reshape(1)).squeeze(0)
        metrics = {"epsilon": eps_c, "alpha": alpha, "chosen": chosen}
        return BoostState(ens, w, state.fit_cache), {"metrics": metrics}

    return [("fit", fit), ("score", score), ("aggregate", aggregate)]


def hetero_distboost_f_stages(hspec: HeterogeneousSpec, *,
                              generator: torch.Generator | None = None, batched_fit: bool = True):
    """The grouped DistBoost.F round: the round hypothesis is the whole
    mixed committee, and every group appends its seat block."""
    learners = resolve(hspec)

    def fit(state, carry, X, y, mask):
        committees = _grouped_local_fits(hspec, learners, state.weights, X, y, state.fit_cache,
                                         generator, batched=batched_fit)
        return state, {"committees": committees}

    def score(state, carry, X, y, mask):
        # the round's only predict pass: every seat on every shard, one vote per shard
        pred = _committee_prediction(learners, hspec, carry["committees"], X)  # [C, n]
        return state, {**carry, "mis": (pred != y).to(torch.float32)}

    def aggregate(state, carry, X, y, mask):
        committees, mis = carry["committees"], carry["mis"]
        eps = torch.sum(state.weights * mis)
        alpha = _samme_alpha(eps, hspec.n_classes)
        ens = tuple(_append(e, committees[g], alpha) for g, e in enumerate(state.ensemble))
        w = scoring.update_weights(state.weights, mis, mask, alpha)
        metrics = {"epsilon": eps, "alpha": alpha,
                   "chosen": torch.zeros((), dtype=torch.int32, device=eps.device)}
        return BoostState(ens, w, state.fit_cache), {"metrics": metrics}

    return [("fit", fit), ("score", score), ("aggregate", aggregate)]


def hetero_preweak_f_setup(hspec: HeterogeneousSpec, state: BoostState, X, y, mask, T: int,
                           generator: torch.Generator | None = None):
    """Grouped PreWeak.F steps 1+2: every collaborator runs T rounds of
    LOCAL AdaBoost with its own learner; each local round fits every group
    (:func:`_grouped_local_fits`), scores each hypothesis on its own shard
    and renormalises per collaborator.  Group g owns a flat
    ``[C_g * T, ...]`` block (member-major).  Returns ``(spaces, state)``."""
    learners = resolve(hspec)
    idx = _member_index(hspec, X.device)
    w = mask / torch.clamp_min(torch.sum(mask, dim=1, keepdim=True), 1.0)
    rounds: List[List[Any]] = [[] for _ in learners]
    for _ in range(T):
        hyps = _grouped_local_fits(hspec, learners, w, X, y, state.fit_cache, generator)
        own = torch.empty_like(y)
        for g, (learner, spec) in enumerate(zip(learners, hspec.specs)):
            i = idx[g]
            # each member's own hypothesis on its own shard: [C_g, n]
            own_g = torch.diagonal(scoring.predict_tensor(learner, spec, hyps[g],
                                                          X.index_select(0, i))).T
            own = own_g if len(learners) == 1 else own.index_copy(0, i, own_g)
            rounds[g].append(hyps[g])
        mis = (own != y).to(torch.float32)
        e = torch.sum(w * mis, dim=1) / torch.clamp_min(torch.sum(w, dim=1), 1e-30)
        a = _samme_alpha(e, hspec.n_classes)
        w = w * torch.exp(a.unsqueeze(1) * mis) * mask
        w = w / torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1e-30)
    spaces = tuple(
        type(rs[0])(*(torch.stack(leaves, dim=1).reshape((len(hspec.members(g)) * T,)
                                                          + leaves[0].shape[1:])
                      for leaves in zip(*rs)))
        for g, rs in enumerate(rounds)
    )
    return spaces, state


def hetero_preweak_f_predictions(hspec: HeterogeneousSpec, spaces, X) -> torch.Tensor:
    """Setup-time ``[C, Σ_g C_g·T, n]`` prediction cache over the static
    mixed space (group-blocked order)."""
    return _grouped_predict_tensor(hspec, resolve(hspec), spaces, X)


def hetero_preweak_f_stages(hspec: HeterogeneousSpec, spaces,
                            pred_cache: torch.Tensor | None = None):
    """The grouped PreWeak.F round: one ``weighted_errors`` over the cache
    (without one, over the mixed space predicted anew every round), the
    argmin appended to its owner group."""
    T = sum(space[0].shape[0] for space in spaces) // hspec.n_collaborators
    owner, local, _ = _hyp_maps(hspec, per_member=T)

    def score(state, carry, X, y, mask):
        preds = pred_cache if pred_cache is not None else hetero_preweak_f_predictions(
            hspec, spaces, X)
        return state, {"preds": preds, "errs": scoring.error_matrix(preds, y, state.weights)}

    def aggregate(state, carry, X, y, mask):
        pred_cache = carry["preds"]
        eps = torch.sum(carry["errs"], dim=0)
        c = torch.argmin(eps)
        eps_c = torch.take(eps, c)
        alpha = _samme_alpha(eps_c, hspec.n_classes)
        ens = _append_chosen(state.ensemble, spaces, owner, local, c, alpha)
        mis = scoring.chosen_mis(pred_cache, y, c)
        w = scoring.update_weights(state.weights, mis, mask, alpha)
        metrics = {"epsilon": eps_c, "alpha": alpha, "chosen": c.to(torch.int32)}
        return BoostState(ens, w, state.fit_cache), {"metrics": metrics}

    return [("score", score), ("aggregate", aggregate)]


def hetero_bagging_stages(hspec: HeterogeneousSpec, *, generator: torch.Generator | None = None,
                          pick=None, batched_fit: bool = True):
    """The grouped federated-bagging round: no score stage; the member kept
    is ``pick`` (a collaborator index, injected) or a uniform draw from
    ``generator`` after the fits' draws.  The pick is a host number, so
    its owner group is known without a sync."""
    learners = resolve(hspec)
    owner = np.asarray(hspec.assignment, np.int32)
    rank = np.zeros(hspec.n_collaborators, np.int32)  # collaborator -> group-local slot
    for g in range(hspec.n_groups):
        for r, i in enumerate(hspec.members(g)):
            rank[i] = r

    def fit(state, carry, X, y, mask):
        w = mask / torch.clamp_min(torch.sum(mask, dim=1, keepdim=True), 1.0)  # local-uniform
        hyps = _grouped_local_fits(hspec, learners, w, X, y, state.fit_cache, generator,
                                   batched=batched_fit)
        return state, {"hyps": hyps}

    def aggregate(state, carry, X, y, mask):
        if pick is None:
            if generator is None:
                raise ValueError("bagging draws its member: pass a generator or a pick")
            c = int(torch.randint(0, hspec.n_collaborators, (), generator=generator))
        else:
            c = int(pick)
        one = torch.ones((), dtype=torch.float32, device=X.device)
        ens = _append_chosen(state.ensemble, carry["hyps"], owner, rank, c, one)
        metrics = {"epsilon": torch.zeros_like(one), "alpha": one,
                   "chosen": torch.tensor(c, dtype=torch.int32, device=X.device)}
        return BoostState(ens, state.weights, state.fit_cache), {"metrics": metrics}

    return [("fit", fit), ("aggregate", aggregate)]


# Stage factories (PreWeak.F's is absent: it needs the spaces and their
# prediction cache, so the federation calls hetero_preweak_f_stages directly).
HETERO_ROUND_STAGES = {
    "adaboost_f": hetero_adaboost_f_stages,
    "distboost_f": hetero_distboost_f_stages,
    "bagging": hetero_bagging_stages,
}


# ---------------------------------------------------------------------------
# Evaluation: votes commute, so the mixture is a sum of group tallies
# ---------------------------------------------------------------------------


def active_groups(hens: HeteroEnsemble, *, committee: bool = False) -> Optional[Tuple[bool, ...]]:
    """Which groups of a plain ensemble hold a used member (host counts, no
    sync); a group with none has all-zero weights, so skipping it leaves
    every vote as it was.  None (no mask) for committees, whose groups move
    in lockstep, and for an ensemble with no used member at all."""
    if committee:
        return None
    mask = tuple(e.count > 0 for e in hens)
    return mask if any(mask) else None


def hetero_member_predictions(hspec: HeterogeneousSpec, hens: HeteroEnsemble, X, *,
                              committee: bool = False, active=None) -> torch.Tensor:
    """Every member's vote on X [n, d], ``[M, n]``.  Plain ensembles stack
    the groups' ``[T, n]`` blocks in group order, skipping a group whose
    ``active`` entry is False; committees fold each member's seats across
    the groups first (``[T, n]``)."""
    learners = resolve(hspec)
    if committee:
        return _committee_prediction(learners, hspec, [e.params for e in hens], X)
    parts = [scoring.member_prediction(learner, spec, hens[g].params, X)
             for g, (learner, spec) in enumerate(zip(learners, hspec.specs))
             if active is None or active[g]]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def hetero_used_weights(hens: HeteroEnsemble, *, committee: bool = False,
                        active=None) -> torch.Tensor:
    """The weights of :func:`hetero_member_predictions`' rows: group 0's
    used alphas for committees (the counts move in lockstep), else each
    active group's, concatenated."""
    if committee:
        return used_weights(hens[0])
    useds = [used_weights(e) for g, e in enumerate(hens) if active is None or active[g]]
    return useds[0] if len(useds) == 1 else torch.cat(useds)


def hetero_ensemble_votes(hspec: HeterogeneousSpec, hens: HeteroEnsemble, X, *,
                          committee: bool = False) -> torch.Tensor:
    """Alpha-weighted vote tally [n, K] of a mixed ensemble: the groups'
    tallies summed (plain), or the members' cross-group committee votes
    weighted by group 0's alphas (committees)."""
    if committee:
        preds = hetero_member_predictions(hspec, hens, X, committee=True)
        return torch.einsum("t,tnk->nk", used_weights(hens[0]),
                            one_hot(preds, hspec.n_classes, torch.float32))
    votes = None
    for g, (learner, spec) in enumerate(zip(resolve(hspec), hspec.specs)):
        v = ensemble_votes(learner, spec, hens[g], X)
        votes = v if votes is None else votes + v
    return votes


def hetero_strong_predict(hspec, hens, X, *, committee: bool = False) -> torch.Tensor:
    return torch.argmax(hetero_ensemble_votes(hspec, hens, X, committee=committee), dim=-1)


def init_hetero_tally(hspec: HeterogeneousSpec, n: int, device, *,
                      committee: bool = False) -> Tuple[scoring.VoteTally, ...]:
    """One running tally per group (a committee ensemble folds across the
    groups, so it keeps one)."""
    n_tallies = 1 if committee else hspec.n_groups
    return tuple(scoring.init_tally(n, hspec.n_classes, device) for _ in range(n_tallies))


def hetero_tally_new_votes(hspec: HeterogeneousSpec, hens: HeteroEnsemble,
                           tallies: Tuple[scoring.VoteTally, ...], X, *,
                           committee: bool = False) -> Tuple[scoring.VoteTally, ...]:
    """Fold only the members appended since the last fold (group counts
    move independently for plain ensembles, in lockstep for committees)."""
    learners = resolve(hspec)
    if committee:
        (tl,) = tallies
        votes = tl.votes
        for t in range(tl.counted, hens[0].count):
            pred = _committee_prediction(
                learners, hspec, [scoring.take_slot(e.params, t) for e in hens], X)
            votes = votes + hens[0].alpha[t] * one_hot(pred, hspec.n_classes, votes.dtype)
        return (scoring.VoteTally(votes, hens[0].count),)
    return tuple(scoring.tally_new_votes(learner, spec, hens[g], tallies[g], X)
                 for g, (learner, spec) in enumerate(zip(learners, hspec.specs)))


def hetero_tally_predict(tallies: Tuple[scoring.VoteTally, ...]) -> torch.Tensor:
    votes = tallies[0].votes
    for t in tallies[1:]:
        votes = votes + t.votes
    return torch.argmax(votes, dim=-1).to(torch.int32)
