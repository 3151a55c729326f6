"""Elastic federation rounds on PyTorch — partial participation, straggler
deadlines, staleness-discounted late merges and membership churn for the
MAFL boosting algorithms (answers to ``repro/fl/elastic.py``, the
in-process runtime; the multi-process one is ``fl/elastic_dist.py``).

  * **Participation masks.**  Every step-3/4 reduction takes the round's
    :class:`~repro_torch.core.scoring.Participation`: AdaBoost.F's argmin
    runs over responders' hypotheses only, error sums and weight-mass
    normalisers over responders' shards only, and absent collaborators'
    weight rows are frozen (``core/scoring.py``'s masked helpers).  The
    responder set is decided on the host, so a full-participation round
    runs the lockstep round's literal operations (one renormalising
    ``weight_update`` launch) and a partial one the product kernel
    (``weight_update_product``), a select and a division; with no faults
    and no deadline a run is bit for bit ``Federation.run``'s fused run.
  * **Straggler deadline.**  A round closes over whoever answered within
    ``ParticipationPolicy.deadline_s`` (``None`` waits for everyone).
    ``virtual`` mode derives arrival times from the ``FaultPlan``
    deterministically (tests); ``realtime`` mode waits on an
    ``_ArrivalBoard`` condition variable fed by timers.
  * **Staleness-discounted late merges.**  A hypothesis fitted for round
    ``r`` that arrives at round ``r' <= r + max_staleness`` is scored
    against the CURRENT weights over the current responders' shards and
    appended with ``alpha = gamma**(r'-r) * samme_alpha(eps_now)`` (float32
    on the device), with no weight update.  Late merges apply to AdaBoost.F
    and bagging; a DistBoost.F or PreWeak.F straggler is masked out.
  * **Membership churn.**  ``joins``/``leaves`` windows gate who takes
    part; the data stay the ``[C, n, d]`` collaborator stack, so
    membership gates participation, never shapes.

The ensemble grows at a host-int slot (every executed round and every late
merge appends one member), so capacity is ``rounds`` plus the late-merge
budget.  ``FaultPlan`` draws from ``np.random.default_rng(seed)``, as the
JAX package does, so both packages inject the same faults.  Random draws
(bagging's pick, ``extra_tree``'s candidates) come from the run's CPU
``torch.Generator``; bagging's pick can be injected (``picks``).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import boosting, scoring
from repro_torch.core.boosting import BoostState, Ensemble, _append, _samme_alpha
from repro_torch.core.metrics import f1_macro
from repro_torch.core.plan import Plan
from repro_torch.core.serialization import wire_size
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import one_hot
from repro_torch.learners.base import LearnerSpec, get_learner
from repro_torch.obs import metrics as obs_metrics, trace

# Families shared with fl/federation.py (the registry dedupes by name) plus
# the elastic-only dropout/late-merge counters (docs/ARCHITECTURE.md,
# "Observability" and "Elastic runtime").
_M_ROUNDS = obs_metrics.counter(
    "mafl_federation_rounds_total", "Federated rounds completed (all paths)."
)
_M_COMM = obs_metrics.counter(
    "mafl_federation_comm_bytes_total",
    "Wire bytes between collaborators and the aggregator: measured on the "
    "interpreted path, modelled from artifact shapes on the fused path.",
)
_M_ROUND_SECONDS = obs_metrics.histogram(
    "mafl_federation_round_seconds",
    "Wall-clock seconds per federated round (history-row averages).",
)
_M_DROPOUT = obs_metrics.counter(
    "mafl_federation_dropout_total",
    "Collaborator-rounds lost to faults, by reason: deadline (missed the "
    "straggler cutoff), drop (update never arrived), dead (process/"
    "collaborator killed), stale (arrived past max_staleness).",
    labels=("reason",),
)
_M_LATE_MERGES = obs_metrics.counter(
    "mafl_federation_dropout_late_merges_total",
    "Straggler hypotheses merged after their round closed, with a "
    "staleness-discounted alpha.",
)

METRIC_KEYS = ("epsilon", "alpha", "chosen")


def round_table(round_metrics: Sequence[Tuple[int, Dict[str, torch.Tensor]]]) -> List[Dict[str, float]]:
    """``{round, epsilon, alpha, chosen}`` rows from ``(round, metrics)``
    pairs whose values are device scalars, fetched in one transfer."""
    if not round_metrics:
        return []
    table = torch.stack([
        torch.stack([m[k].to(torch.float32) for k in METRIC_KEYS]) for _, m in round_metrics
    ]).tolist()
    return [{"round": r, "epsilon": eps, "alpha": alpha, "chosen": round(chosen)}
            for (r, _), (eps, alpha, chosen) in zip(round_metrics, table)]


def staleness_discount(gamma: float, lateness: int) -> float:
    """Discount applied to a late hypothesis's alpha: ``gamma**lateness``,
    monotone non-increasing in lateness for ``gamma`` in (0, 1]."""
    if not 0.0 < gamma <= 1.0:
        raise ValueError(f"staleness_gamma must be in (0, 1], got {gamma}")
    if lateness < 0:
        raise ValueError(f"lateness must be >= 0, got {lateness}")
    return gamma**lateness


# ---------------------------------------------------------------------------
# Fault injection — deterministic, seed-driven
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seed-driven per-collaborator fault schedule.

    All randomness comes from ``np.random.default_rng(seed)`` at
    :meth:`schedule` time, in the JAX package's order, so the same plan
    gives the same faults in both packages.

      * ``delay_p`` / ``delay_range_s`` — with probability ``delay_p`` a
        collaborator's round-``r`` upload is delayed by a uniform draw
        from ``delay_range_s`` seconds (a straggler);
      * ``drop_p``  — the upload never arrives at all;
      * ``kills``   — ``(collaborator, round)``: permanent death at the
        start of that round;
      * ``flaky``   — ``(collaborator, off_round, rejoin_round)``: offline
        for ``[off_round, rejoin_round)`` then rejoins.
    """

    seed: int = 0
    delay_p: float = 0.0
    delay_range_s: Tuple[float, float] = (0.0, 0.0)
    drop_p: float = 0.0
    kills: Tuple[Tuple[int, int], ...] = ()
    flaky: Tuple[Tuple[int, int, int], ...] = ()

    def schedule(self, rounds: int, n_collaborators: int) -> "FaultSchedule":
        C = n_collaborators
        rng = np.random.default_rng(self.seed)
        delayed = rng.random((rounds, C)) < self.delay_p
        delay = np.zeros((rounds, C))
        lo, hi = self.delay_range_s
        delay[delayed] = rng.uniform(lo, hi, size=int(delayed.sum()))
        drop = rng.random((rounds, C)) < self.drop_p
        alive = np.ones((rounds, C), bool)
        for i, r0 in self.kills:
            if r0 < rounds:
                alive[max(r0, 0):, i] = False
        offline = np.zeros((rounds, C), bool)
        for i, a, b in self.flaky:
            offline[max(a, 0):max(b, 0), i] = True
        return FaultSchedule(delay=delay, drop=drop, alive=alive, offline=offline)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Materialised per-(round, collaborator) fault arrays."""

    delay: np.ndarray  # [R, C] f64 seconds
    drop: np.ndarray  # [R, C] bool
    alive: np.ndarray  # [R, C] bool
    offline: np.ndarray  # [R, C] bool


# ---------------------------------------------------------------------------
# Participation policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParticipationPolicy:
    """How an elastic round decides who it closes over.

      * ``deadline_s``     — straggler deadline per round; ``None`` waits
        for every active collaborator (lockstep semantics);
      * ``min_responders`` — a round never closes over fewer responders:
        the deadline stretches to the fastest ``min_responders`` arrivals;
      * ``staleness_gamma`` / ``max_staleness`` / ``late_merge`` — the
        late-arrival contract (see :func:`staleness_discount`);
      * ``joins`` / ``leaves`` — ``(collaborator, round)`` membership
        windows: a collaborator takes part in rounds ``[join, leave)``;
      * ``realtime``       — wall-clock arrivals on the ``_ArrivalBoard``
        instead of the deterministic virtual clock.
    """

    deadline_s: Optional[float] = None
    min_responders: int = 1
    staleness_gamma: float = 0.5
    max_staleness: int = 2
    late_merge: bool = True
    joins: Tuple[Tuple[int, int], ...] = ()
    leaves: Tuple[Tuple[int, int], ...] = ()
    realtime: bool = False

    def validate(self) -> None:
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive or None, got {self.deadline_s}")
        if self.min_responders < 1:
            raise ValueError(f"min_responders must be >= 1, got {self.min_responders}")
        if not 0.0 < self.staleness_gamma <= 1.0:
            raise ValueError(f"staleness_gamma must be in (0, 1], got {self.staleness_gamma}")
        if self.max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {self.max_staleness}")

    def membership(self, rounds: int, n_collaborators: int) -> np.ndarray:
        """[R, C] bool — which collaborators are members at each round."""
        m = np.ones((rounds, n_collaborators), bool)
        for i, r0 in self.joins:
            m[: min(max(r0, 0), rounds), i] = False
        for i, r0 in self.leaves:
            m[min(max(r0, 0), rounds):, i] = False
        return m


# ---------------------------------------------------------------------------
# Masked round stages — the lockstep stages with `part` threaded through
# ---------------------------------------------------------------------------


def run_elastic_stages(stages, state: BoostState, X, y, mask, part: scoring.Participation):
    """:func:`boosting.run_stages` with the round's participation threaded
    through.  Returns ``(state, metrics, round_hyps)``: ``round_hyps`` is
    the ``[C, ...]`` fit output that late merges need (AdaBoost.F,
    bagging), else None."""
    carry: Dict[str, Any] = {}
    for _, fn in stages:  # mafl: allow[stage-barrier] eager torch never fuses across stages
        state, carry = fn(state, carry, X, y, mask, part)
    return state, carry["metrics"], carry.get("hyps")


def _unmasked(stage):
    """A lockstep stage of ``core/boosting.py`` as an elastic one: it runs
    over all C collaborators whoever responds (all C are fitted and
    scored, so the draws do not depend on who responds; ``part`` masks
    the outputs downstream, never the computation)."""
    return lambda state, carry, X, y, mask, part: stage(state, carry, X, y, mask)


def elastic_adaboost_f_stages(learner, spec, *, generator: torch.Generator | None = None,
                              batched_fit: bool = True):
    """AdaBoost.F with partial participation: argmin over responders'
    hypotheses and shards only; absentees' weight rows freeze."""
    lock = dict(boosting.adaboost_f_stages(learner, spec, generator=generator,
                                           batched_fit=batched_fit))

    def aggregate(state, carry, X, y, mask, part):
        hyps, preds, errs = carry["hyps"], carry["preds"], carry["errs"]
        eps = scoring.masked_error_sum(errs, part)  # responders' shards only
        c = scoring.masked_argmin(eps, part)  # responders' hypotheses only
        eps_c = torch.take(eps, c)
        if not part.full:  # the denominator is the literal 1.0 under full participation
            eps_c = eps_c / scoring.participation_denom(state.weights, part)
        alpha = _samme_alpha(eps_c, spec.n_classes)
        ens = _append(state.ensemble, scoring.take_slot(hyps, c), alpha)
        mis = scoring.chosen_mis(preds, y, c)
        w = scoring.masked_update_weights(state.weights, mis, mask, part, alpha)
        metrics = {"epsilon": eps_c, "alpha": alpha, "chosen": c.to(torch.int32)}
        return BoostState(ens, w, state.fit_cache), {"metrics": metrics, "hyps": hyps}

    return [("fit", _unmasked(lock["fit"])), ("score", _unmasked(lock["score"])),
            ("aggregate", aggregate)]


def elastic_distboost_f_stages(learner, spec, *, generator: torch.Generator | None = None,
                               batched_fit: bool = True):
    """DistBoost.F with partial participation: the committee slot still
    holds all C member buffers, but only responders vote (the caller
    records ``part`` as the slot's committee mask)."""
    lock = dict(boosting.distboost_f_stages(learner, spec, generator=generator,
                                            batched_fit=batched_fit))

    def score(state, carry, X, y, mask, part):
        committee = carry["committee"]
        if part.full:
            pred = boosting._committee_predict(learner, spec, committee, X)
        else:
            pred = scoring.masked_member_prediction(learner, spec, committee, part.mask, X)
        return state, {**carry, "mis": (pred != y).to(torch.float32)}

    def aggregate(state, carry, X, y, mask, part):
        committee, mis = carry["committee"], carry["mis"]
        w = state.weights
        if part.full:
            eps = torch.sum(w * mis)
        else:
            resp = part.mask[:, None] > 0
            eps = torch.sum(torch.where(resp, w * mis, 0.0)) / scoring.participation_denom(w, part)
        alpha = _samme_alpha(eps, spec.n_classes)
        ens = _append(state.ensemble, committee, alpha)
        w = scoring.masked_update_weights(w, mis, mask, part, alpha)
        metrics = {"epsilon": eps, "alpha": alpha,
                   "chosen": torch.zeros((), dtype=torch.int32, device=eps.device)}
        return BoostState(ens, w, state.fit_cache), {"metrics": metrics}

    return [("fit", _unmasked(lock["fit"])), ("score", score), ("aggregate", aggregate)]


def elastic_preweak_f_stages(learner, spec, hyp_space, pred_cache: torch.Tensor | None = None):
    """PreWeak.F with partial participation: the C*T space was shipped at
    set-up, so every hypothesis stays selectable; only the shard axis of
    the error reduction and the weight update are masked."""
    lock = dict(boosting.preweak_f_stages(learner, spec, hyp_space, pred_cache))

    def aggregate(state, carry, X, y, mask, part):
        preds, errs = carry["preds"], carry["errs"]
        eps = scoring.masked_error_sum(errs, part)
        c = torch.argmin(eps)  # the whole space: every hypothesis was pre-shipped
        eps_c = torch.take(eps, c)
        if not part.full:
            eps_c = eps_c / scoring.participation_denom(state.weights, part)
        alpha = _samme_alpha(eps_c, spec.n_classes)
        ens = _append(state.ensemble, scoring.take_slot(hyp_space, c), alpha)
        mis = scoring.chosen_mis(preds, y, c)
        w = scoring.masked_update_weights(state.weights, mis, mask, part, alpha)
        metrics = {"epsilon": eps_c, "alpha": alpha, "chosen": c.to(torch.int32)}
        return BoostState(ens, w, state.fit_cache), {"metrics": metrics}

    return [("score", _unmasked(lock["score"])), ("aggregate", aggregate)]


def responder_pick(c_raw: int, responders: np.ndarray) -> int:
    """Bagging's member under partial participation: the raw draw
    ``c_raw`` in ``[0, C)`` mapped onto the ``(c_raw mod n)``-th of the n
    responders (the JAX package's rank-select); with every collaborator
    responding it is ``c_raw`` itself."""
    idx = np.flatnonzero(responders)
    if not len(idx):
        return 0
    return idx[c_raw % len(idx)].tolist()


def elastic_bagging_stages(learner, spec, *, generator: torch.Generator | None = None,
                           picks: Sequence[int] | None = None, batched_fit: bool = True):
    """Federated bagging with partial participation: the random member
    pick rotates over RESPONDERS (:func:`responder_pick` of the round's
    draw); with full participation the pick is the lockstep draw.
    ``picks`` injects the member kept in each executed round, in order."""
    pick_iter = None if picks is None else iter(picks)
    lock = dict(boosting.bagging_stages(learner, spec, generator=generator, batched_fit=batched_fit))

    def aggregate(state, carry, X, y, mask, part):
        if pick_iter is not None:
            c = torch.as_tensor(next(pick_iter), dtype=torch.int64)
        else:
            if generator is None:
                raise ValueError("bagging draws its member: pass a generator or picks")
            c = torch.randint(0, X.shape[0], (), generator=generator)  # a host draw
            if not part.full:
                c = torch.as_tensor(responder_pick(c.tolist(), part.responders))
        c = c.to(X.device)
        one = torch.ones((), dtype=torch.float32, device=X.device)
        ens = _append(state.ensemble, scoring.take_slot(carry["hyps"], c), one)  # unweighted vote
        metrics = {"epsilon": torch.zeros_like(one), "alpha": one, "chosen": c.to(torch.int32)}
        return BoostState(ens, state.weights, state.fit_cache), {"metrics": metrics,
                                                                 "hyps": carry["hyps"]}

    return [("fit", _unmasked(lock["fit"])), ("aggregate", aggregate)]


ELASTIC_STAGES = {
    "adaboost_f": elastic_adaboost_f_stages,
    "distboost_f": elastic_distboost_f_stages,
    "bagging": elastic_bagging_stages,
}

# algorithms whose round artifact is a single uploaded hypothesis: the only
# ones a straggler's late arrival can be merged for
_LATE_MERGE_ALGS = ("adaboost_f", "bagging")


def masked_ensemble_votes(learner, spec, ens: Ensemble, cmasks: torch.Tensor, X) -> torch.Tensor:
    """:func:`boosting.ensemble_votes` for elastic DistBoost.F ensembles:
    each committee slot votes through its row of ``cmasks [T, C]``.
    All-ones masks give the lockstep bits."""
    preds = scoring.masked_member_prediction(learner, spec, ens.params, cmasks, X)  # [T, n]
    onehot = one_hot(preds, spec.n_classes, torch.float32)
    return torch.einsum("t,tnk->nk", boosting.used_weights(ens), onehot)


# ---------------------------------------------------------------------------
# Event-driven round closing (realtime mode)
# ---------------------------------------------------------------------------


class _ArrivalBoard:
    """Condition-variable arrival board: producers (per-collaborator
    timers) post ``(round, collaborator)`` arrivals; the round loop blocks
    in :meth:`close_round` until every expected collaborator posted or the
    deadline passes.  All shared state lives under ``self._cv``."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._posts: List[Tuple[int, int]] = []

    def post(self, round_idx: int, collaborator: int) -> None:
        with self._cv:
            self._posts.append((round_idx, collaborator))
            self._cv.notify_all()

    def close_round(
        self, round_idx: int, expected: Set[int], deadline_s: Optional[float],
        min_responders: int = 1,
    ) -> Tuple[Set[int], List[Tuple[int, int]], float, bool]:
        """Block until all of ``expected`` posted for ``round_idx`` or the
        deadline passes.  Returns ``(responders, late_posts, wait_s,
        deadline_hit)``: ``late_posts`` are drained arrivals for EARLIER
        rounds; arrivals for this round after the deadline stay posted and
        surface at a later close.  The deadline never closes a round under
        ``min_responders`` arrivals: the wait stretches until the fastest
        ``min_responders`` land."""
        t0 = time.monotonic()
        cutoff = None if deadline_s is None else t0 + deadline_s
        floor = min(min_responders, len(expected))
        with self._cv:
            deadline_hit = False
            while True:
                have = {i for (rr, i) in self._posts if rr == round_idx}
                if expected <= have:
                    break
                timeout = None if cutoff is None else cutoff - time.monotonic()
                if timeout is not None and timeout <= 0:
                    if len(have & expected) >= floor:
                        deadline_hit = True
                        break
                    timeout = None  # under the responder floor: keep waiting
                self._cv.wait(timeout)
            responders = expected & {i for (rr, i) in self._posts if rr == round_idx}
            late = [(rr, i) for (rr, i) in self._posts if rr < round_idx]
            consumed = {(round_idx, i) for i in responders} | set(late)
            self._posts = [p for p in self._posts if p not in consumed]
        return responders, late, time.monotonic() - t0, deadline_hit


@dataclasses.dataclass(frozen=True)
class _LateItem:
    src_round: int
    collaborator: int
    lateness: int


# ---------------------------------------------------------------------------
# The elastic federation runtime
# ---------------------------------------------------------------------------


class ElasticFederation:
    """Round loop under a :class:`ParticipationPolicy` and a
    :class:`FaultPlan`, on one device.

    Homogeneous fused-path federations only; normally built by
    ``Federation.run(policy=..., faults=...)``, which hands it the
    federation's tensors and generator, so that with no faults and no
    deadline ``run`` is bit for bit the fused run."""

    def __init__(self, plan: Plan, Xs, ys, masks, X_test, y_test, spec, *,
                 policy: ParticipationPolicy, faults: Optional[FaultPlan] = None,
                 device: str | torch.device = "cuda", seed: int = 0,
                 generator: torch.Generator | None = None, picks: Sequence[int] | None = None):
        plan.validate()
        policy.validate()
        if not isinstance(spec, LearnerSpec):
            raise NotImplementedError(
                "elastic rounds support homogeneous federations only; "
                "heterogeneous groups keep the lockstep loop"
            )
        if not plan.optimizations.fused_round or plan.algorithm == "fedavg":
            raise ValueError(
                "elastic rounds require the fused round path "
                "(optimizations.fused_round on, non-fedavg algorithm)"
            )
        self.plan = plan
        self.learner = get_learner(spec.name)
        self.spec = spec
        self.device = dev = resolve_device(device)
        self.Xs = torch.as_tensor(Xs, dtype=torch.float32).to(dev).contiguous()
        self.ys = torch.as_tensor(ys, dtype=torch.int32).to(dev).contiguous()
        self.masks = torch.as_tensor(masks, dtype=torch.float32).to(dev).contiguous()
        self.X_test = torch.as_tensor(X_test, dtype=torch.float32).to(dev).contiguous()
        self.y_test = torch.as_tensor(y_test, dtype=torch.int32).to(dev).contiguous()
        self.generator = generator if generator is not None else torch.Generator().manual_seed(seed)
        self.picks = picks
        self.policy = policy
        self.faults = faults or FaultPlan()
        self.n_collaborators = int(self.ys.shape[0])
        self.history: List[Dict[str, float]] = []
        self.late_log: List[Dict[str, float]] = []
        self.dropouts: Dict[str, int] = defaultdict(int)
        self.responders_log: List[int] = []
        self.comm_bytes = 0
        self.state: Optional[BoostState] = None
        self.cmasks: Optional[torch.Tensor] = None
        self.published: List[Path] = []
        self._round_metrics: List[Tuple[int, Dict[str, torch.Tensor]]] = []
        self._row_marker = (time.perf_counter(), 0, 0)

    # -- plumbing shared with Federation -----------------------------------
    def _account_comm(self, nbytes: int) -> None:
        self.comm_bytes += nbytes
        _M_COMM.inc(nbytes)

    def _history_extras(self, r: int) -> Dict[str, float]:
        now = time.perf_counter()
        t0, c0, r0 = self._row_marker
        self._row_marker = (now, self.comm_bytes, r + 1)
        dt = (now - t0) / max(r + 1 - r0, 1)
        _M_ROUND_SECONDS.observe(dt)
        return {"round_seconds": dt, "comm_bytes": float(self.comm_bytes - c0)}

    def _per_round_comm(self, h: int, n_resp: int) -> int:
        """``Federation._fused_comm_model``'s per-round bytes with the
        collaborator count replaced by this round's responders."""
        alg = self.plan.algorithm
        if alg == "preweak_f":
            return 16 * n_resp
        if alg == "distboost_f":
            return h * (1 + n_resp) + 8 * n_resp
        if alg == "bagging":
            return n_resp * h
        return n_resp * h + n_resp * h * (n_resp - 1) + (h + 8) * n_resp

    def per_round(self) -> List[Dict[str, float]]:
        """epsilon / alpha / chosen of every executed round (a round nobody
        answered has none)."""
        return round_table(self._round_metrics)

    # -- fault/membership resolution ---------------------------------------
    def _virtual_round(self, r: int, sched: FaultSchedule, active: np.ndarray):
        """Deterministic responder/late split for one round from the fault
        schedule's arrival times (no wall-clock waiting)."""
        deadline = self.policy.deadline_s
        act = np.flatnonzero(active[r]).tolist()
        delays = sched.delay[r].tolist()
        drop = sched.drop[r].tolist()
        arrived = [i for i in act if not drop[i]]
        if deadline is None:
            resp = list(arrived)
            late: List[Tuple[int, int]] = []
        else:
            resp = [i for i in arrived if delays[i] <= deadline]
            late = [(i, max(1, math.ceil(delays[i] / deadline) - 1))
                    for i in arrived if delays[i] > deadline]
            if len(resp) < self.policy.min_responders:
                # stretch the deadline to the fastest min_responders
                extra = sorted((i for i, _ in late), key=lambda i: delays[i])
                while len(resp) < self.policy.min_responders and extra:
                    i = extra.pop(0)
                    resp.append(i)
                    late = [(j, lt) for j, lt in late if j != i]
        resp_arr = np.zeros(self.n_collaborators, bool)
        resp_arr[resp] = True
        wait = max((delays[i] for i in resp), default=0.0)
        deadline_hit = deadline is not None and len(resp) < len(act)
        if deadline_hit:
            wait = deadline
        return resp_arr, late, wait, deadline_hit

    def _late_alpha(self, hyps, idx: int, w: torch.Tensor, part: scoring.Participation):
        """SAMME alpha of collaborator ``idx``'s late hypothesis scored
        against the current weights over the current responders' shards,
        in float32 on the device."""
        preds = self.learner.predict(self.spec, scoring.take_slot(hyps, idx), self.Xs)  # [C, n]
        wmis = w * (preds != self.ys).to(torch.float32)
        if part.full:
            eps, mass = torch.sum(wmis), torch.sum(w)
        else:
            resp = part.mask[:, None] > 0
            eps = torch.sum(torch.where(resp, wmis, 0.0))
            mass = torch.sum(torch.where(resp, w, 0.0))
        return _samme_alpha(eps / torch.clamp_min(mass, 1e-30), self.spec.n_classes)

    # -- main loop ---------------------------------------------------------
    def run(self, rounds: Optional[int] = None, eval_every: int = 1, *,
            publish_every: Optional[int] = None, publish_dir: Optional[str] = None,
            on_checkpoint=None) -> List[Dict[str, float]]:
        rounds = rounds or self.plan.aggregator.rounds
        pol, opt = self.policy, self.plan.optimizations
        alg, learner, spec, g = self.plan.algorithm, self.learner, self.spec, self.generator
        C, dev = self.n_collaborators, self.device
        sched = self.faults.schedule(rounds, C)
        active = pol.membership(rounds, C) & sched.alive & ~sched.offline
        late_merge = pol.late_merge and alg in _LATE_MERGE_ALGS

        # Late-merge slot budget: every (round, collaborator) whose delay
        # overshoots the deadline may become an extra ensemble slot.  Exact
        # in virtual mode, an upper bound in realtime mode (unused slots keep
        # alpha 0 and never vote); zero with no deadline, so the shapes are
        # the lockstep run's.
        late_budget = 0
        if late_merge and pol.deadline_s is not None:
            late_budget = int(np.count_nonzero(active & (sched.delay > pol.deadline_s)))
        capacity = rounds + late_budget

        distboost = alg == "distboost_f"
        state = boosting.init_boost_state(learner, spec, capacity, self.masks,
                                          committee_size=C if distboost else None, X=self.Xs)
        h = wire_size(state.ensemble.params) // max(capacity, 1)  # one slot

        if alg == "preweak_f":
            with trace.span("preweak.setup", rounds=rounds):
                hyp_space, state = boosting.preweak_f_setup(
                    learner, spec, state, self.Xs, self.ys, self.masks, rounds, g)
                cache = (boosting.preweak_f_predictions(learner, spec, hyp_space, self.Xs)
                         if opt.cache_predictions else None)
            stages = elastic_preweak_f_stages(learner, spec, hyp_space, cache)
            self._account_comm(wire_size(hyp_space) * C)
        elif alg == "bagging":
            stages = elastic_bagging_stages(learner, spec, generator=g, picks=self.picks,
                                            batched_fit=opt.batched_fit)
        else:
            stages = ELASTIC_STAGES[alg](learner, spec, generator=g, batched_fit=opt.batched_fit)

        cmasks = torch.ones(capacity, C, dtype=torch.float32, device=dev) if distboost else None
        if opt.cache_predictions:
            tally = scoring.init_tally(self.X_test.shape[0], spec.n_classes, dev)

            def evaluate(s):
                nonlocal tally
                if distboost:
                    tally = scoring.tally_new_votes_masked(learner, spec, s.ensemble, cmasks,
                                                           tally, self.X_test)
                else:
                    tally = scoring.tally_new_votes(learner, spec, s.ensemble, tally, self.X_test)
                return f1_macro(self.y_test, scoring.tally_predict(tally), spec.n_classes)
        else:
            def evaluate(s):  # the whole ensemble predicted at every evaluation
                if distboost:
                    votes = masked_ensemble_votes(learner, spec, s.ensemble, cmasks, self.X_test)
                    pred = torch.argmax(votes, dim=-1)
                else:
                    pred = boosting.strong_predict(learner, spec, s.ensemble, self.X_test)
                return f1_macro(self.y_test, pred, spec.n_classes)

        # -- the event-driven loop -----------------------------------------
        board = _ArrivalBoard() if pol.realtime else None
        timers: List[threading.Timer] = []
        pending: Dict[int, List[_LateItem]] = defaultdict(list)
        round_hyps: Dict[int, Any] = {}
        late_alphas: List[torch.Tensor] = []  # (base, alpha) pairs, read once after the loop
        self._row_marker = (time.perf_counter(), self.comm_bytes, 0)
        try:
            for r in range(rounds):
                with trace.span("round", round=r, algorithm=alg, elastic=True):
                    # collaborators dying this round (counted once)
                    died = ~sched.alive[0] if r == 0 else sched.alive[r - 1] & ~sched.alive[r]
                    for _ in range(np.count_nonzero(died)):
                        self.dropouts["dead"] += 1
                        _M_DROPOUT.labels(reason="dead").inc()

                    act_idx = np.flatnonzero(active[r]).tolist()
                    if pol.realtime:
                        expected = set()
                        delays, drops = sched.delay[r].tolist(), sched.drop[r].tolist()
                        for i in act_idx:
                            if drops[i]:
                                continue
                            expected.add(i)
                            if delays[i] <= 0:
                                board.post(r, i)
                            else:
                                t = threading.Timer(delays[i], board.post, (r, i))
                                t.daemon = True
                                t.start()
                                timers.append(t)
                        resp_set, late_posts, wait_s, deadline_hit = board.close_round(
                            r, expected, pol.deadline_s, pol.min_responders)
                        resp_arr = np.zeros(C, bool)
                        resp_arr[sorted(resp_set)] = True
                        late_now = [_LateItem(rr, i, r - rr) for rr, i in late_posts]
                    else:
                        resp_arr, late_pairs, wait_s, deadline_hit = self._virtual_round(
                            r, sched, active)
                        late_now = list(pending.pop(r, ()))
                        for i, lateness in late_pairs:
                            if late_merge and lateness <= pol.max_staleness and r + lateness < rounds:
                                pending[r + lateness].append(_LateItem(r, i, lateness))
                            else:
                                self.dropouts["stale"] += 1
                                _M_DROPOUT.labels(reason="stale").inc()

                    n_resp = len(np.flatnonzero(resp_arr))  # a host int, JSON-ready
                    self.responders_log.append(n_resp)
                    drops = sched.drop[r].tolist()
                    for i in act_idx:  # per-round dropout accounting over active members
                        if resp_arr[i]:
                            continue
                        reason = "drop" if (not pol.realtime and drops[i]) else "deadline"
                        self.dropouts[reason] += 1
                        _M_DROPOUT.labels(reason=reason).inc()

                    # the round's responders: decided here on the host, so a
                    # full round runs the lockstep operations
                    part = scoring.participation(resp_arr, dev)
                    # late merges land first: they arrived while this round's
                    # window was open
                    n_late = 0
                    for item in sorted(late_now, key=lambda it: (it.src_round, it.collaborator)):
                        if not (late_merge and item.lateness <= pol.max_staleness
                                and item.src_round in round_hyps):
                            self.dropouts["stale"] += 1
                            _M_DROPOUT.labels(reason="stale").inc()
                            continue
                        with trace.span("round.late_merge", round=r, src_round=item.src_round,
                                        collaborator=item.collaborator, lateness=item.lateness):
                            hyps_src = round_hyps[item.src_round]
                            if alg == "bagging":
                                base = torch.ones((), dtype=torch.float32, device=dev)
                            else:
                                base = self._late_alpha(hyps_src, item.collaborator,
                                                        state.weights, part)
                            disc = staleness_discount(pol.staleness_gamma, item.lateness)
                            alpha_late = base * disc  # float32: disc is a power of gamma
                            ens = _append(state.ensemble,
                                          scoring.take_slot(hyps_src, item.collaborator),
                                          alpha_late)
                            state = BoostState(ens, state.weights, state.fit_cache)
                            late_alphas += [base, alpha_late]
                            self.late_log.append({
                                "src_round": item.src_round, "merged_round": r,
                                "collaborator": item.collaborator, "lateness": item.lateness,
                                "discount": disc,
                            })
                            n_late += 1
                            _M_LATE_MERGES.inc()

                    if n_resp == 0:
                        # nobody answered: the round is lost, the state untouched
                        with trace.span("round.close", round=r, responders=0,
                                        dropped=len(act_idx), late=n_late,
                                        deadline_hit=deadline_hit, wait_s=wait_s):
                            pass
                        _M_ROUNDS.inc()
                        continue

                    slot = state.ensemble.count  # the host-int slot this round writes
                    state, metrics, hyps = run_elastic_stages(stages, state, self.Xs, self.ys,
                                                              self.masks, part)
                    self._round_metrics.append((r, metrics))
                    if distboost and not part.full:
                        cmasks[slot].copy_(part.mask)
                    if hyps is not None and late_merge:
                        round_hyps[r] = hyps
                        for rr in [k for k in round_hyps if k < r - pol.max_staleness]:
                            del round_hyps[rr]

                    with trace.span("round.close", round=r, responders=n_resp,
                                    dropped=len(act_idx) - n_resp, late=n_late,
                                    deadline_hit=deadline_hit, wait_s=wait_s):
                        self._account_comm(self._per_round_comm(h, n_resp))
                    _M_ROUNDS.inc()

                    if (r + 1) % eval_every == 0 or r == rounds - 1:
                        with trace.span("round.eval", round=r):
                            f1 = evaluate(state)
                            f1_, eps, alpha, chosen = torch.stack([f1.to(torch.float32)] + [
                                metrics[k].to(torch.float32) for k in METRIC_KEYS
                            ]).tolist()  # the one host sync of this eval
                        self.history.append({
                            "round": r, "f1": f1_, "epsilon": eps, "alpha": alpha,
                            "chosen": round(chosen), "responders": n_resp,
                            "late_merges": n_late, "wait_s": wait_s, **self._history_extras(r),
                        })
                    if publish_every and ((r + 1) % publish_every == 0 or r == rounds - 1):
                        with trace.span("round.publish", round=r):
                            self._publish_checkpoint(state, r, publish_dir, on_checkpoint)
        finally:
            for t in timers:
                t.cancel()
        # stragglers that never found a later round to merge into
        for items in pending.values():
            for _ in items:
                self.dropouts["stale"] += 1
                _M_DROPOUT.labels(reason="stale").inc()
        if late_alphas:  # every late merge's (base, alpha) in one transfer
            pairs = torch.stack(late_alphas).view(-1, 2).tolist()
            for row, (base, alpha) in zip(self.late_log, pairs):
                row.update(base_alpha=base, alpha=alpha)
        self.state = state
        self.cmasks = cmasks
        return self.history

    def _publish_checkpoint(self, state: BoostState, round_idx: int, publish_dir, on_checkpoint):
        """One rolling-artifact checkpoint (version = 1-based round): the
        ensemble goes to the host once, then to disk."""
        from repro_torch.serve.artifact import publish_artifact  # serving is optional at train time

        committee = self.n_collaborators if self.plan.algorithm == "distboost_f" else None
        path = publish_artifact(
            publish_dir, self.spec, boosting.ensemble_to(state.ensemble, "cpu"),
            version=round_idx + 1, committee_size=committee,
            extra={"round": round_idx + 1, "algorithm": self.plan.algorithm},
        )
        self.published.append(path)
        if on_checkpoint is not None:
            on_checkpoint(path, round_idx + 1)

    def summary(self) -> Dict[str, Any]:
        return {
            "algorithm": self.plan.algorithm,
            "collaborators": self.n_collaborators,
            "deadline_s": self.policy.deadline_s,
            "responders": list(self.responders_log),
            "dropouts": dict(self.dropouts),
            "late": list(self.late_log),
            "comm_bytes": self.comm_bytes,
            "history": list(self.history),
            "rounds": self.per_round(),
            "ensemble_count": None if self.state is None else self.state.ensemble.count,
            "device": str(self.device),
        }
