"""The MAFL federation runtime, fused homogeneous path (answers to
``Federation`` in ``repro/fl/federation.py``): AdaBoost.F, DistBoost.F,
PreWeak.F and federated bagging, picked by ``plan.algorithm``.

A round is the composed stages of ``core/boosting.py`` run eagerly on the
federation's device; its hot spots launch the hand-written kernels on the
card.  PreWeak.F trains its C*T hypothesis space and predicts it on every
shard once, at set-up (the ``preweak.setup`` span); each of its rounds is
then one ``weighted_errors`` launch over that cache and one
``weight_update``.  Random draws (bagging's pick, ``extra_tree``'s split
candidates) come from one CPU ``torch.Generator`` seeded from ``seed``, so
a run on the card draws what the same run on the CPU draws; a draw is
copied to the card, never read back.  Nothing in the round loop copies to
the host: the round's metrics stay device tensors until an evaluation row
reads them, all in one transfer, and a serving checkpoint
(``publish_every``) copies the ensemble to the host once.  Communication
is modelled from shapes, as the JAX package's fused path does.

A heterogeneous federation (a ``core/hetero.HeterogeneousSpec``, or a plan
whose ``learners`` cycle learner families over the collaborators) runs the
same loop over ``core/hetero.py``'s grouped stages; its winner's index is
read on the host once a round, where the owner group's count moves.  The
interpreted (OpenFL-style) path and elastic federations are not ported
yet (ROADMAP Queue 1 items 11, 12).
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core import boosting, hetero, scoring
from repro_torch.core.hetero import HeterogeneousSpec
from repro_torch.core.metrics import f1_macro
from repro_torch.core.plan import Plan
from repro_torch.core.serialization import wire_size
from repro_torch.device import resolve_device
from repro_torch.learners.base import LearnerSpec, get_learner
from repro_torch.obs import metrics as obs_metrics, trace

_METRIC_KEYS = ("epsilon", "alpha", "chosen")

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
        self.n_collaborators = self.Xs.shape[0]
        self.comm_bytes = 0
        # (wall time, comm_bytes, round) at the previous history row
        self._row_marker = (time.perf_counter(), 0, 0)
        self.history: List[Dict[str, float]] = []
        self.published: List[Path] = []  # checkpoint artifacts, oldest first
        self.state: Optional[boosting.BoostState] = None
        self._round_metrics: List[Dict[str, torch.Tensor]] = []

    # -- main loop ---------------------------------------------------------
    def run(
        self,
        rounds: Optional[int] = None,
        eval_every: int = 1,
        *,
        publish_every: Optional[int] = None,
        publish_dir: Optional[str] = None,
        on_checkpoint: Optional[Callable[[Path, int], None]] = None,
    ) -> List[Dict[str, float]]:
        """Run the federation; a history row every ``eval_every`` rounds
        and after the last.

        ``publish_every=k`` emits a versioned serving artifact
        (``serve/artifact.publish_artifact``) into ``publish_dir`` every k
        rounds and after the final round.  Capacity is fixed at
        ``rounds``, so successive checkpoints grow append-only and a
        ``ServeEngine`` / ``ShardVoteCache`` consumer folds only the
        appended members.  ``on_checkpoint(path, round)`` fires after each
        publish (e.g. to hot-swap a live engine)."""
        if publish_every is not None:
            if publish_every <= 0:
                raise ValueError(f"publish_every must be positive, got {publish_every}")
            if publish_dir is None:
                raise ValueError("publish_every requires a publish_dir")
        run = self._run_fused_hetero if self.hetero else self._run_fused
        return run(rounds or self.plan.rounds, eval_every, publish_every, publish_dir,
                   on_checkpoint)

    def per_round(self) -> List[Dict[str, float]]:
        """epsilon / alpha / chosen of every round run so far, fetched from
        the device in one transfer."""
        if not self._round_metrics:
            return []
        table = torch.stack([
            torch.stack([m[k].to(torch.float32) for k in _METRIC_KEYS])
            for m in self._round_metrics
        ]).tolist()
        return [
            {"round": r, "epsilon": eps, "alpha": alpha, "chosen": round(chosen)}
            for r, (eps, alpha, chosen) in enumerate(table)
        ]

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
                            metrics[k].to(torch.float32) for k in _METRIC_KEYS
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
        committee = self.committee_size
        state = boosting.init_boost_state(learner, spec, rounds, self.masks,
                                          committee_size=committee, X=self.Xs)
        if alg == "preweak_f":
            with trace.span("preweak.setup", rounds=rounds):
                hyp_space, state = boosting.preweak_f_setup(
                    learner, spec, state, self.Xs, self.ys, self.masks, rounds, g)
                # the C*T space is static: predicted on every shard once, every
                # round is then a reduction over this [C, C*T, n] cache
                cache = boosting.preweak_f_predictions(learner, spec, hyp_space, self.Xs)
            stages = boosting.preweak_f_stages(learner, spec, hyp_space, cache)
            setup_bytes, per_round = self._fused_comm_model(state, setup_tree=hyp_space)
            self._account_comm(setup_bytes)
        else:
            stages = boosting.ROUND_STAGES[alg](learner, spec, generator=g)
            _, per_round = self._fused_comm_model(state)

        def round_fn(s, X, y, m):
            return boosting.run_stages(stages, s, X, y, m)

        # incremental eval: each eval adds only the members appended since
        # the previous one
        tally = scoring.init_tally(self.X_test.shape[0], spec.n_classes, self.device)

        def evaluate(s):
            nonlocal tally
            tally = scoring.tally_new_votes(learner, spec, s.ensemble, tally, self.X_test,
                                            committee=committee is not None)
            return f1_macro(self.y_test, scoring.tally_predict(tally), spec.n_classes)

        return self._fused_loop(rounds, eval_every, state, round_fn, evaluate, per_round,
                                publish_every, publish_dir, on_checkpoint)

    def _run_fused_hetero(self, rounds: int, eval_every: int,
                          publish_every: Optional[int] = None, publish_dir: Optional[str] = None,
                          on_checkpoint=None) -> List[Dict[str, float]]:
        """``_run_fused`` over ``core/hetero.py``: grouped fits, the
        cross-group prediction tensor, per-group tallies.  With one group
        every step is the homogeneous one."""
        hspec, alg, g = self.spec, self.plan.algorithm, self.generator
        committee = alg == "distboost_f"
        state = hetero.init_hetero_boost_state(hspec, rounds, self.masks, committee=committee,
                                               X=self.Xs)
        if alg == "preweak_f":
            with trace.span("preweak.setup", rounds=rounds):
                spaces, state = hetero.hetero_preweak_f_setup(
                    hspec, state, self.Xs, self.ys, self.masks, rounds, g)
                cache = hetero.hetero_preweak_f_predictions(hspec, spaces, self.Xs)
            stages = hetero.hetero_preweak_f_stages(hspec, spaces, cache)
            setup_bytes, per_round = self._fused_comm_model(state, setup_tree=spaces)
            self._account_comm(setup_bytes)
        else:
            stages = hetero.HETERO_ROUND_STAGES[alg](hspec, generator=g)
            _, per_round = self._fused_comm_model(state)

        def round_fn(s, X, y, m):
            return boosting.run_stages(stages, s, X, y, m)

        tallies = hetero.init_hetero_tally(hspec, self.X_test.shape[0], self.device,
                                           committee=committee)

        def evaluate(s):
            nonlocal tallies
            tallies = hetero.hetero_tally_new_votes(hspec, s.ensemble, tallies, self.X_test,
                                                    committee=committee)
            return f1_macro(self.y_test, hetero.hetero_tally_predict(tallies), hspec.n_classes)

        return self._fused_loop(rounds, eval_every, state, round_fn, evaluate, per_round,
                                publish_every, publish_dir, on_checkpoint)


def history_summary(fed: Federation) -> Dict[str, Any]:
    """JSON-ready record of a run: history rows, every round's metrics and
    the modelled wire bytes."""
    return {"history": fed.history, "rounds": fed.per_round(), "comm_bytes": fed.comm_bytes,
            "device": str(fed.device)}
