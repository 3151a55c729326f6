"""The MAFL federation runtime (answers to ``Federation`` in
``repro/fl/federation.py``): AdaBoost.F, DistBoost.F, PreWeak.F and
federated bagging, picked by ``plan.algorithm``, and OpenFL's FedAvg.

Two paths, chosen by ``plan.optimizations.fused_round`` (paper §5.1):

* **fused** (the default): a round is the composed stages of
  ``core/boosting.py`` run eagerly on the federation's device; its hot
  spots launch the hand-written kernels on the card.  PreWeak.F trains its
  C*T hypothesis space at set-up (the ``preweak.setup`` span) and, with
  ``cache_predictions``, predicts it on every shard once, so each round is
  one ``weighted_errors`` launch over that cache and one ``weight_update``.
  Nothing in the round loop copies to the host: the round's metrics stay
  device tensors until an evaluation row reads them, all in one transfer,
  and a serving checkpoint (``publish_every``) copies the ensemble to the
  host once.  Communication is modelled from shapes, as the JAX package's
  fused path does.
* **interpreted** (``fused_round`` off, as ``fl_run --faithful`` sets it,
  and always for FedAvg): the plan's task graph walked by
  ``core/protocol.run_round``, OpenFL-style.  Every collaborator fits
  alone, and its model travels to the aggregator as serialized bytes
  through a ``TensorDB`` (a copy to the host per collaborator per round,
  inherent to the path); a ``SynchBarrier`` follows every task, and the
  §5.1 toggles (``packed_serialization``, ``bounded_tensordb``,
  ``fast_barrier``) each restore the pre-optimisation cost.  The
  aggregator's argmin, epsilon and alpha are host float64 arithmetic, and
  each collaborator's weights are updated by the un-renormalised product
  (``weight_update_product``), then divided by a total taken on the host.
  Communication is measured: the bytes serialized.

Random draws (bagging's pick, ``extra_tree``'s split candidates, the MLP's
initial weights) come from one CPU ``torch.Generator`` seeded from
``seed``, so a run on the card draws what the same run on the CPU draws;
a draw is copied to the card, never read back.

A heterogeneous federation (a ``core/hetero.HeterogeneousSpec``, or a plan
whose ``learners`` cycle learner families over the collaborators) runs the
fused loop over ``core/hetero.py``'s grouped stages; its winner's index is
read on the host once a round, where the owner group's count moves.

``run(policy=..., faults=...)`` hands a homogeneous fused-path federation
to ``fl/elastic.ElasticFederation`` (partial participation, straggler
deadlines, late merges, injected faults) over the same tensors and
generator; with no faults and no deadline it is bit for bit the fused run.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import boosting, hetero, protocol, scoring
from repro_torch.core.aggregation import fedavg
from repro_torch.core.hetero import HeterogeneousSpec
from repro_torch.core.metrics import f1_macro
from repro_torch.core.plan import Plan
from repro_torch.core.serialization import deserialize, serialize, wire_format, wire_size
from repro_torch.core.tensordb import TensorDB, TensorKey
from repro_torch.device import resolve_device
from repro_torch.fl.elastic import (
    METRIC_KEYS, ElasticFederation, FaultPlan, ParticipationPolicy, round_table,
)
from repro_torch.kernels.ref import one_hot
from repro_torch.learners.base import LearnerSpec, get_learner
from repro_torch.obs import metrics as obs_metrics, trace

# Process-wide federation metric families (docs/ARCHITECTURE.md,
# "Observability").
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


@dataclasses.dataclass
class Collaborator:
    """One collaborator of the interpreted path: its shard (views of the
    federation's stacked tensors) and its own store."""

    idx: int
    X: torch.Tensor  # [n, d]
    y: torch.Tensor  # [n]
    mask: torch.Tensor  # [n]
    weights: torch.Tensor  # [n] raw AdaBoost sample weights
    db: TensorDB
    params: Any = None  # the current local model (FedAvg)

    @property
    def origin(self) -> str:
        return f"collaborator_{self.idx}"


@dataclasses.dataclass
class Aggregator:
    db: TensorDB
    ensemble: List[Any] = dataclasses.field(default_factory=list)  # [(params, alpha)]
    global_params: Any = None  # FedAvg


class Federation:
    """C collaborators' shards plus a held-out test set, on one device."""

    def __init__(self, plan: Plan, Xs, ys, masks, X_test, y_test,
                 spec: LearnerSpec | HeterogeneousSpec,
                 *, device: str | torch.device = "cuda", seed: int = 0):
        """``spec`` is a ``LearnerSpec`` (homogeneous) or a
        ``HeterogeneousSpec``; a plan with ``learners`` turns a LearnerSpec
        into the spec that cycles them over the collaborators (the
        LearnerSpec then gives only the problem's geometry)."""
        plan.validate()
        self.plan = plan
        self.generator = torch.Generator().manual_seed(seed)  # host draws, a fixed order
        self.device = resolve_device(device)
        C = len(ys)
        if plan.learners and isinstance(spec, LearnerSpec):
            spec = HeterogeneousSpec.cycle(
                [lp.name for lp in plan.learners], C, spec.n_features, spec.n_classes,
                hparams={lp.name: dict(lp.hparams) for lp in plan.learners})
        self.hetero = isinstance(spec, HeterogeneousSpec)
        if self.hetero:
            if spec.n_collaborators != C:
                raise ValueError(f"HeterogeneousSpec assigns {spec.n_collaborators} collaborators "
                                 f"but the partition has {C}")
            hetero.resolve(spec)  # fail fast on unknown registry keys
            self.learner = None  # per-group learners live in the spec
        else:
            self.learner = get_learner(spec.name)
        self.spec = spec
        dev = self.device
        self.Xs = torch.as_tensor(Xs, dtype=torch.float32).to(dev).contiguous()  # [C, n, d]
        self.ys = torch.as_tensor(ys, dtype=torch.int32).to(dev).contiguous()  # [C, n]
        self.masks = torch.as_tensor(masks, dtype=torch.float32).to(dev).contiguous()
        self.X_test = torch.as_tensor(X_test, dtype=torch.float32).to(dev).contiguous()
        self.y_test = torch.as_tensor(y_test, dtype=torch.int32).to(dev).contiguous()
        self.n_collaborators = C
        # the interpreted path's roles (the fused path reads the stacked tensors)
        opt = plan.optimizations
        retention = opt.tensordb_retention if opt.bounded_tensordb else None
        self.aggregator = Aggregator(db=TensorDB(retention))
        w0 = self.masks / torch.clamp_min(torch.sum(self.masks), 1.0)
        self.collaborators = [
            Collaborator(i, self.Xs[i], self.ys[i], self.masks[i], w0[i], TensorDB(retention))
            for i in range(C)
        ]
        self.barrier = protocol.SynchBarrier(C, sleep_s=plan.collaborator.sleep_s,
                                             structural=opt.fast_barrier)
        self.end_round_sleep_s = 0.0 if opt.fast_barrier else max(plan.aggregator.sleep_s * 10, 0.1)
        self._eval_every = 1
        self._wire_fmt = None  # the hypotheses' wire format, from the first one sent
        self._round_scratch: Dict[str, Any] = {}
        self._round_log: List[Dict[str, float]] = []  # interpreted rounds' metrics, on the host
        self.comm_bytes = 0
        # (wall time, comm_bytes, round) at the previous history row
        self._row_marker = (time.perf_counter(), 0, 0)
        self.history: List[Dict[str, float]] = []
        self.published: List[Path] = []  # checkpoint artifacts, oldest first
        self.state: Optional[boosting.BoostState] = None
        self._round_metrics: List[Dict[str, torch.Tensor]] = []
        self.elastic: Optional[ElasticFederation] = None  # the elastic runtime of the last run

    # -- main loop ---------------------------------------------------------
    def run(
        self,
        rounds: Optional[int] = None,
        eval_every: int = 1,
        *,
        publish_every: Optional[int] = None,
        publish_dir: Optional[str] = None,
        on_checkpoint: Optional[Callable[[Path, int], None]] = None,
        policy: Optional[ParticipationPolicy] = None,
        faults: Optional[FaultPlan] = None,
    ) -> List[Dict[str, float]]:
        """Run the federation; a history row every ``eval_every`` rounds
        and after the last.

        ``policy`` (an ``fl/elastic.ParticipationPolicy``) or ``faults``
        (an ``fl/elastic.FaultPlan``) runs the rounds through the elastic
        runtime, kept in ``self.elastic``: homogeneous fused federations
        only (a heterogeneous one raises ``NotImplementedError``, an
        interpreted or FedAvg one ``ValueError``).

        ``publish_every=k`` emits a versioned serving artifact
        (``serve/artifact.publish_artifact``) into ``publish_dir`` every k
        rounds and after the final round.  Capacity is fixed at
        ``rounds``, so successive checkpoints grow append-only and a
        ``ServeEngine`` / ``ShardVoteCache`` consumer folds only the
        appended members.  ``on_checkpoint(path, round)`` fires after each
        publish (e.g. to hot-swap a live engine)."""
        rounds = rounds or self.plan.aggregator.rounds
        fused = self.plan.optimizations.fused_round and self.plan.algorithm != "fedavg"
        if publish_every is not None:
            if publish_every <= 0:
                raise ValueError(f"publish_every must be positive, got {publish_every}")
            if publish_dir is None:
                raise ValueError("publish_every requires a publish_dir")
        if policy is not None or faults is not None:
            return self._run_elastic(rounds, eval_every, policy, faults, publish_every,
                                     publish_dir, on_checkpoint)
        if self.hetero and not fused:
            raise ValueError(
                "heterogeneous federations require the fused round path "
                "(optimizations.fused_round on, non-fedavg algorithm): the "
                "interpreted simulation and fedavg assume one hypothesis pytree"
            )
        if publish_every is not None:
            if not fused:
                raise ValueError(
                    "checkpoint publishing requires the fused round path "
                    "(optimizations.fused_round on, non-fedavg algorithm)"
                )
        if fused:
            run = self._run_fused_hetero if self.hetero else self._run_fused
            return run(rounds, eval_every, publish_every, publish_dir, on_checkpoint)
        self._eval_every = eval_every
        self._row_marker = (time.perf_counter(), self.comm_bytes, 0)
        for r in range(rounds):
            with trace.span("round", round=r, algorithm=self.plan.algorithm):
                protocol.run_round(self, r)
            _M_ROUNDS.inc()
        return self.history

    def _run_elastic(self, rounds: int, eval_every: int, policy, faults, publish_every,
                     publish_dir, on_checkpoint) -> List[Dict[str, float]]:
        """The rounds under ``fl/elastic.py``'s runtime, over this
        federation's tensors and generator; its history, state, comm bytes
        and checkpoints become this federation's."""
        if self.hetero:
            raise NotImplementedError(
                "elastic rounds support homogeneous federations only; "
                "heterogeneous groups keep the lockstep loop"
            )
        self.elastic = ElasticFederation(
            self.plan, self.Xs, self.ys, self.masks, self.X_test, self.y_test, self.spec,
            policy=policy or ParticipationPolicy(), faults=faults, device=self.device,
            generator=self.generator,
        )
        history = self.elastic.run(rounds, eval_every, publish_every=publish_every,
                                   publish_dir=publish_dir, on_checkpoint=on_checkpoint)
        self.history = self.elastic.history
        self.state = self.elastic.state
        self.comm_bytes += self.elastic.comm_bytes
        self.published.extend(self.elastic.published)
        return history

    # -- the interpreted path's messaging ----------------------------------
    def send(self, tree: Any) -> List[bytes]:
        """Serialize ``tree`` for the wire (a copy to the host) and count
        its bytes."""
        bufs = serialize(tree, packed=self.plan.optimizations.packed_serialization)
        self._account_comm(sum(len(b) for b in bufs))
        return bufs

    def recv(self, bufs: List[bytes], fmt) -> Any:
        """The tree back from its buffers, on the host."""
        return deserialize(bufs, fmt, packed=self.plan.optimizations.packed_serialization)

    def end_round_barrier(self, round_idx: int) -> None:
        if self.end_round_sleep_s:
            time.sleep(self.end_round_sleep_s)

    def strong_predict_host(self, X: torch.Tensor) -> torch.Tensor:
        """The interpreted path's ensemble vote: a loop over its
        ``(params, alpha)`` members (an empty ensemble predicts class 0)."""
        if not self.aggregator.ensemble:
            return torch.zeros(X.shape[0], dtype=torch.int32, device=X.device)
        K = self.spec.n_classes
        votes = torch.zeros(X.shape[0], K, dtype=torch.float32, device=X.device)
        for params, alpha in self.aggregator.ensemble:
            pred = self.learner.predict(self.spec, params, X)
            votes = votes + alpha * one_hot(pred, K, torch.float32)
        return torch.argmax(votes, dim=-1).to(torch.int32)

    def per_round(self) -> List[Dict[str, float]]:
        """epsilon / alpha / chosen of every round run so far (the fused
        path's fetched from the device in one transfer; an elastic run's
        executed rounds)."""
        if self.elastic is not None:
            return self.elastic.per_round()
        if self._round_log:
            return list(self._round_log)
        return round_table(list(enumerate(self._round_metrics)))

    def _history_extras(self, r: int) -> Dict[str, float]:
        """round_seconds / comm_bytes deltas since the previous history
        row (per-round averages when rows are sparser than rounds)."""
        now = time.perf_counter()
        t0, c0, r0 = self._row_marker
        self._row_marker = (now, self.comm_bytes, r + 1)
        dt = (now - t0) / max(r + 1 - r0, 1)
        _M_ROUND_SECONDS.observe(dt)
        return {"round_seconds": dt, "comm_bytes": float(self.comm_bytes - c0)}

    def _fused_comm_model(self, state: boosting.BoostState, *, setup_tree=None) -> tuple:
        """(setup bytes, per-round bytes), modelled from shapes
        (``wire_size`` reads no tensor), as the JAX package's fused path
        models them: per AdaBoost.F round every collaborator uploads its
        hypothesis, the aggregator broadcasts the hypothesis space for
        validation (C-1 extra copies each), then the (chosen hypothesis,
        alpha) pair.  PreWeak.F ships its whole C*T space once at set-up and
        only (alpha, index) a round; DistBoost.F's slot is the committee
        (the C uploads), re-broadcast to every collaborator; bagging only
        uploads."""
        C = self.n_collaborators
        # a heterogeneous ensemble is a plain tuple of group Ensembles
        parts = state.ensemble if self.hetero else (state.ensemble,)
        h = sum(wire_size(e.params) // max(e.alpha.shape[0], 1) for e in parts)  # one slot
        alg = self.plan.algorithm
        if alg == "preweak_f":
            return wire_size(setup_tree) * C, 16 * C
        if alg == "distboost_f":
            return 0, h * (1 + C) + 8 * C
        if alg == "bagging":
            return 0, C * h
        return 0, C * h + C * h * (C - 1) + (h + 8) * C

    def _account_comm(self, nbytes: int) -> None:
        self.comm_bytes += nbytes
        _M_COMM.inc(nbytes)

    @property
    def committee_size(self) -> Optional[int]:
        """C for DistBoost.F, whose every slot is the round's committee."""
        return self.n_collaborators if self.plan.algorithm == "distboost_f" else None

    def _publish_checkpoint(self, state: boosting.BoostState, round_idx: int,
                            publish_dir: str, on_checkpoint) -> None:
        """One rolling-artifact checkpoint (version = 1-based round): the
        ensemble goes to the host once, then to disk."""
        from repro_torch.serve.artifact import publish_artifact  # serving is optional at train time

        to_host = hetero.hetero_ensemble_to if self.hetero else boosting.ensemble_to
        host = to_host(state.ensemble, "cpu")
        path = publish_artifact(
            publish_dir, self.spec, host, version=round_idx + 1,
            committee_size=self.committee_size,
            extra={"round": round_idx + 1, "algorithm": self.plan.algorithm},
        )
        self.published.append(path)
        if on_checkpoint is not None:
            on_checkpoint(path, round_idx + 1)

    def _fused_loop(self, rounds: int, eval_every: int, state, round_fn: Callable,
                    evaluate: Callable, per_round_comm: int, publish_every: Optional[int],
                    publish_dir: Optional[str], on_checkpoint) -> List[Dict[str, float]]:
        """The round loop.  Metrics reach the host only at an eval row:
        ``f1`` and the round's metrics go over in one ``tolist``."""
        self._row_marker = (time.perf_counter(), self.comm_bytes, 0)
        algorithm = self.plan.algorithm
        for r in range(rounds):
            with trace.span("round", round=r, algorithm=algorithm):
                state, metrics = round_fn(state, self.Xs, self.ys, self.masks)
                self._round_metrics.append(metrics)
                self._account_comm(per_round_comm)
                _M_ROUNDS.inc()
                if (r + 1) % eval_every == 0 or r == rounds - 1:
                    with trace.span("round.eval", round=r):
                        f1 = evaluate(state)
                        f1_, eps, alpha, chosen = torch.stack([f1.to(torch.float32)] + [
                            metrics[k].to(torch.float32) for k in METRIC_KEYS
                        ]).tolist()  # the one host sync of this eval
                    self.history.append({
                        "round": r, "f1": f1_, "epsilon": eps, "alpha": alpha,
                        "chosen": round(chosen), **self._history_extras(r),
                    })
                if publish_every and ((r + 1) % publish_every == 0 or r == rounds - 1):
                    # the slot buffers keep their capacity and gain one member
                    # a round, so the stream is append-only by construction
                    with trace.span("round.publish", round=r):
                        self._publish_checkpoint(state, r, publish_dir, on_checkpoint)
        self.state = state
        return self.history

    def _run_fused(self, rounds: int, eval_every: int, publish_every: Optional[int] = None,
                   publish_dir: Optional[str] = None, on_checkpoint=None) -> List[Dict[str, float]]:
        learner, spec, alg, g = self.learner, self.spec, self.plan.algorithm, self.generator
        opt = self.plan.optimizations
        committee = self.committee_size
        state = boosting.init_boost_state(learner, spec, rounds, self.masks,
                                          committee_size=committee, X=self.Xs)
        if alg == "preweak_f":
            with trace.span("preweak.setup", rounds=rounds):
                hyp_space, state = boosting.preweak_f_setup(
                    learner, spec, state, self.Xs, self.ys, self.masks, rounds, g)
                # the C*T space is static: predicted on every shard once, every
                # round is then a reduction over this [C, C*T, n] cache
                cache = (boosting.preweak_f_predictions(learner, spec, hyp_space, self.Xs)
                         if opt.cache_predictions else None)
            stages = boosting.preweak_f_stages(learner, spec, hyp_space, cache)
            setup_bytes, per_round = self._fused_comm_model(state, setup_tree=hyp_space)
            self._account_comm(setup_bytes)
        else:
            stages = boosting.ROUND_STAGES[alg](learner, spec, generator=g,
                                                batched_fit=opt.batched_fit)
            _, per_round = self._fused_comm_model(state)

        def round_fn(s, X, y, m):
            return boosting.run_stages(stages, s, X, y, m)

        if opt.cache_predictions:
            # incremental eval: each eval adds only the members appended
            # since the previous one
            tally = scoring.init_tally(self.X_test.shape[0], spec.n_classes, self.device)

            def evaluate(s):
                nonlocal tally
                tally = scoring.tally_new_votes(learner, spec, s.ensemble, tally, self.X_test,
                                                committee=committee is not None)
                return f1_macro(self.y_test, scoring.tally_predict(tally), spec.n_classes)
        else:
            def evaluate(s):  # the whole ensemble predicted at every evaluation
                pred = boosting.strong_predict(learner, spec, s.ensemble, self.X_test,
                                               committee=committee is not None)
                return f1_macro(self.y_test, pred, spec.n_classes)

        return self._fused_loop(rounds, eval_every, state, round_fn, evaluate, per_round,
                                publish_every, publish_dir, on_checkpoint)

    def _run_fused_hetero(self, rounds: int, eval_every: int,
                          publish_every: Optional[int] = None, publish_dir: Optional[str] = None,
                          on_checkpoint=None) -> List[Dict[str, float]]:
        """``_run_fused`` over ``core/hetero.py``: grouped fits, the
        cross-group prediction tensor, per-group tallies.  With one group
        every step is the homogeneous one."""
        hspec, alg, g = self.spec, self.plan.algorithm, self.generator
        opt = self.plan.optimizations
        committee = alg == "distboost_f"
        state = hetero.init_hetero_boost_state(hspec, rounds, self.masks, committee=committee,
                                               X=self.Xs)
        if alg == "preweak_f":
            with trace.span("preweak.setup", rounds=rounds):
                spaces, state = hetero.hetero_preweak_f_setup(
                    hspec, state, self.Xs, self.ys, self.masks, rounds, g)
                cache = (hetero.hetero_preweak_f_predictions(hspec, spaces, self.Xs)
                         if opt.cache_predictions else None)
            stages = hetero.hetero_preweak_f_stages(hspec, spaces, cache)
            setup_bytes, per_round = self._fused_comm_model(state, setup_tree=spaces)
            self._account_comm(setup_bytes)
        else:
            stages = hetero.HETERO_ROUND_STAGES[alg](hspec, generator=g,
                                                     batched_fit=opt.batched_fit)
            _, per_round = self._fused_comm_model(state)

        def round_fn(s, X, y, m):
            return boosting.run_stages(stages, s, X, y, m)

        if opt.cache_predictions:
            tallies = hetero.init_hetero_tally(hspec, self.X_test.shape[0], self.device,
                                               committee=committee)

            def evaluate(s):
                nonlocal tallies
                tallies = hetero.hetero_tally_new_votes(hspec, s.ensemble, tallies, self.X_test,
                                                        committee=committee)
                return f1_macro(self.y_test, hetero.hetero_tally_predict(tallies), hspec.n_classes)
        else:
            def evaluate(s):  # the whole ensemble predicted at every evaluation
                pred = hetero.hetero_strong_predict(hspec, s.ensemble, self.X_test,
                                                    committee=committee)
                return f1_macro(self.y_test, pred, hspec.n_classes)

        return self._fused_loop(rounds, eval_every, state, round_fn, evaluate, per_round,
                                publish_every, publish_dir, on_checkpoint)


def history_summary(fed: Federation) -> Dict[str, Any]:
    """JSON-ready record of a run: history rows, every round's metrics, the
    wire bytes (measured on the interpreted path, modelled on the fused
    one), the aggregator's TensorDB peak entries and the seconds the
    barrier slept (both 0 on the fused path)."""
    return {"history": fed.history, "rounds": fed.per_round(), "comm_bytes": fed.comm_bytes,
            "tensordb_peak_entries": fed.aggregator.db.peak_entries,
            "barrier_waited_seconds": fed.barrier.waited_seconds,
            "device": str(fed.device)}


# ---------------------------------------------------------------------------
# Task executors of the interpreted path: the paper's §4.1 task vocabulary,
# step for step as repro/fl/federation.py's
# ---------------------------------------------------------------------------


@protocol.task_executor("train")
def _train(fed: Federation, r: int, args: Dict[str, Any]) -> None:
    if fed.plan.algorithm == "fedavg":
        _fedavg_train(fed, r)
        return
    for c in fed.collaborators:
        # a local fit on the AdaBoost weights, rescaled locally so that a
        # scale-sensitive learner keeps its regularisation
        wsum = torch.clamp_min(torch.sum(c.weights), 1e-30)
        w_fit = c.weights / wsum * torch.clamp_min(torch.sum(c.mask), 1.0)
        params = fed.learner.fit(fed.spec, None, c.X, c.y, w_fit, generator=fed.generator)
        if fed._wire_fmt is None:
            fed._wire_fmt = wire_format(params)
        bufs = fed.send(params)  # collaborator -> aggregator
        fed.aggregator.db.put(TensorKey("weak_hypothesis", c.origin, r), bufs)


@protocol.task_executor("weak_learners_validate")
def _weak_learners_validate(fed: Federation, r: int, args: Dict[str, Any]) -> None:
    # the aggregator broadcasts the whole hypothesis space to every collaborator
    entries = fed.aggregator.db.query(name="weak_hypothesis", round=r)
    entries.sort(key=lambda kv: kv[0].origin)
    hyps = [fed.recv(bufs, fed._wire_fmt) for _, bufs in entries]
    fed._account_comm(
        sum(sum(len(b) for b in bufs) for _, bufs in entries) * (fed.n_collaborators - 1)
    )  # n-1 extra copies on the wire
    # the space stacked once and moved to the device; each collaborator
    # predicts it on its shard once and scores it with one weighted_errors
    hyp_stack = type(hyps[0])(*(torch.stack(leaves).to(fed.device) for leaves in zip(*hyps)))
    err_rows, norm_vals, pred_rows = [], [], []
    for c in fed.collaborators:
        w = c.weights * c.mask
        preds = scoring.predict_matrix(fed.learner, fed.spec, hyp_stack, c.X)  # [H, n]
        pred_rows.append(preds)  # reused by adaboost_update: no second predict
        err_rows.append(scoring.shard_errors(preds, c.y, w))
        norm_vals.append(torch.sum(w))
        c.db.put(TensorKey("misprediction", c.origin, r), None)
    # one stacked transfer of the round's errors and norms; the float32 ->
    # float64 casts are exact
    table = torch.cat([torch.stack(err_rows), torch.stack(norm_vals).unsqueeze(1)], dim=1)
    table = table.cpu().numpy().astype(np.float64)
    errs, norms = table[:, :-1], table[:, -1]
    fed._round_scratch = {"errs": errs, "norms": norms, "hyps": hyp_stack, "preds": pred_rows}
    fed.aggregator.db.put(TensorKey("error_matrix", "aggregator", r), errs)


@protocol.task_executor("adaboost_update")
def _adaboost_update(fed: Federation, r: int, args: Dict[str, Any]) -> None:
    scratch = fed._round_scratch
    errs, norms = scratch["errs"], scratch["norms"]
    eps = errs.sum(axis=0) / max(norms.sum(), 1e-30)
    c_idx = int(np.argmin(eps))  # mafl: allow[host-sync] a numpy value, already on the host
    e = float(np.clip(eps[c_idx], 1e-10, 1 - 1e-10))  # mafl: allow[host-sync] numpy, on the host
    alpha = float(  # mafl: allow[host-sync] numpy arithmetic on the host
        np.clip(np.log((1 - e) / e) + np.log(fed.spec.n_classes - 1.0), -10, 10))
    chosen = scoring.take_slot(scratch["hyps"], c_idx)
    fed.aggregator.ensemble.append((chosen, alpha))
    fed.aggregator.db.put(TensorKey("adaboost_coeff", "aggregator", r), alpha)
    # broadcast (chosen hypothesis, alpha); the collaborators update their weights
    fed._account_comm((wire_size(chosen) + 8) * fed.n_collaborators)
    alpha_dev = torch.tensor(alpha, dtype=torch.float32).to(fed.device)
    wsums = []
    for i, c in enumerate(fed.collaborators):
        # the chosen hypothesis's mispredictions: a row of the predictions
        # weak_learners_validate made, no second predict
        mis = (scratch["preds"][i][c_idx] != c.y).to(torch.float32)
        c.weights = scoring.update_weights(c.weights, mis, c.mask, alpha_dev, renormalize=False)
        wsums.append(torch.sum(c.weights))
    # one stacked transfer; Python's left-to-right sum over the exact float64
    # casts, as the JAX package takes it
    total = sum(torch.stack(wsums).cpu().tolist())
    for c in fed.collaborators:  # the global renormalisation, from the exchanged norms
        c.weights = c.weights / max(total, 1e-30)
    fed._round_log.append({"round": r, "epsilon": float(eps[c_idx]),  # mafl: allow[host-sync] numpy
                           "alpha": alpha, "chosen": c_idx})


@protocol.task_executor("adaboost_validate")
def _adaboost_validate(fed: Federation, r: int, args: Dict[str, Any]) -> None:
    if (r + 1) % fed._eval_every and r != fed.plan.aggregator.rounds - 1:
        return
    pred = fed.strong_predict_host(fed.X_test)
    # once an evaluation: the metric is this task's output
    f1 = float(f1_macro(fed.y_test, pred, fed.spec.n_classes))  # mafl: allow[host-sync]
    last = fed.aggregator.ensemble[-1] if fed.aggregator.ensemble else (None, 0.0)
    fed.history.append({"round": r, "f1": f1, "alpha": last[1], **fed._history_extras(r)})
    fed.aggregator.db.put(TensorKey("metric/f1", "aggregator", r), f1)


# -- OpenFL's original DNN workflow: FedAvg over warm-started learners ------


def _fedavg_train(fed: Federation, r: int) -> None:
    if fed.learner.warm_fit is None:
        raise ValueError(f"learner {fed.spec.name!r} has no warm_fit; FedAvg needs one")
    if fed.aggregator.global_params is None:
        # random initial weights from the run's generator (``init`` gives
        # zeros, which would leave the hidden units symmetric)
        (init,) = fed.learner.draw(fed.spec, 1, fed.generator, fed.device).values()
        fed.aggregator.global_params = type(init)(*(x[0] for x in init))
    local, sizes = [], []
    for c in fed.collaborators:
        fed._account_comm(wire_size(fed.aggregator.global_params))  # broadcast
        p = fed.learner.warm_fit(fed.spec, fed.aggregator.global_params, c.X, c.y, c.mask,
                                 generator=fed.generator)
        c.params = p
        fed._account_comm(wire_size(p))  # upload
        local.append(p)
        sizes.append(torch.sum(c.mask))  # stays on the device
    stacked = type(local[0])(*(torch.stack(leaves) for leaves in zip(*local)))
    fed.aggregator.global_params = fedavg(stacked, torch.stack(sizes))


@protocol.task_executor("aggregated_model_validation")
def _agg_model_validation(fed: Federation, r: int, args: Dict[str, Any]) -> None:
    if fed.aggregator.global_params is None:
        return
    pred = fed.learner.predict(fed.spec, fed.aggregator.global_params, fed.X_test)
    fed.history.append({
        "round": r,
        # validation-only task, once a round: the metric is its output
        "f1": float(f1_macro(fed.y_test, pred, fed.spec.n_classes)),  # mafl: allow[host-sync]
        "alpha": 0.0,
        **fed._history_extras(r),
    })


@protocol.task_executor("locally_tuned_model_validation")
def _local_model_validation(fed: Federation, r: int, args: Dict[str, Any]) -> None:
    for c in fed.collaborators:
        if c.params is None:
            continue
        pred = fed.learner.predict(fed.spec, c.params, c.X)
        c.db.put(
            TensorKey("metric/local_f1", c.origin, r),
            # validation-only task: one metric per collaborator is the output
            float(f1_macro(c.y, pred, fed.spec.n_classes)),  # mafl: allow[host-sync]
        )
