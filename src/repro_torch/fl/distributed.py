"""Process-per-collaborator MAFL runtime on PyTorch (answers to
``repro/fl/distributed.py``): the paper's OpenFL deployment topology as
real OS processes exchanging rounds over ``torch.distributed`` (gloo).

Every other path of the port runs in ONE process.  Here each
collaborator IS a process (``initialize`` + ``process_index()``), the
per-round hypothesis broadcast is a real ``all_gather`` between
processes (packed into one float32 wire buffer a round by
``fl/sharded.py``'s packing), and ``mafl_federation_comm_bytes_total``
counts the bytes those collectives move.

Topology (paper §4.3, OpenFL coordinator/collaborator):

  process i (i = 1..C-1)   collaborator i: owns shard i, fits locally,
                           scores the broadcast hypothesis space on its
                           shard only
  process 0                collaborator 0 AND the coordinator: evaluates
                           on the test split, owns the history's F1, and
                           publishes serving checkpoints

Aggregation (paper steps 3/4) is *replicated*: every process runs the
same argmin, alpha and weight update on the same gathered errors, so the
whole ``BoostState`` stays replicated without a state broadcast.

Gathers go through the host: gloo's ``all_gather`` of CUDA tensors
depends on the build, and NCCL refuses several ranks on one card, so a
payload is copied to a host tensor, gathered, stacked to ``[C, ...]`` and
moved back to the device.  Where the JAX package blocks on a result
before a collective, this runtime synchronises the device, so the fit
time stays out of the collective's span.  Every process of one card is
its own CUDA context on it; the processes take turns on the device.

Bit-exactness: on the CPU a C-process run equals the port's fused
``Federation`` run bit for bit (history, weights, ensemble) for the
batch-invariant learners (the trees, gaussian_nb): state and the fit
cache are built from the full partition before a process keeps its own
row; the plain versions of the kernels are row-independent
(``tree_hist_batched_ref`` folds the collaborator into the segment id,
``weighted_errors_ref`` is a row sum); every process makes the run's
random draws (a randomised learner's for all C collaborators, bagging's
pick, PreWeak.F's set-up) from one CPU ``torch.Generator`` in the fused
run's order, and keeps its own row.  On the card the kernels' launch
plans depend on the row count, so a card run is held to the fused run's
chosen members and F1, not its bits.

Collective schedule per round (H = hypothesis-space size):

  algorithm     collectives                              payload
  adaboost_f    hyps gather, errs gather, mis gather     [C,·] [C,H] [C,n]
  distboost_f   hyps gather, mis gather                  [C,·] [C,n]
  bagging       hyps gather                              [C,·]
  preweak_f     (setup: space gather [C,T,·])            then per round
                errs gather, mis gather                  [C,H] [C,n]
"""
from __future__ import annotations

import datetime
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core import boosting, scoring
from repro_torch.core.boosting import BoostState, _append
from repro_torch.core.hetero import HeterogeneousSpec
from repro_torch.core.metrics import f1_macro
from repro_torch.core.plan import Plan
from repro_torch.device import resolve_device, synchronize
from repro_torch.fl.elastic import METRIC_KEYS, round_table
from repro_torch.fl.sharded import _pack_leaves, _unpack_leaves
from repro_torch.learners.base import get_learner
from repro_torch.obs import metrics as obs_metrics, trace

# Same process-wide families as fl/federation.py (the registry returns
# the existing metric on re-registration): here comm bytes are measured
# collective payloads.
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

# a collective waits this long for every process before it raises
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def initialize(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join the federation's gloo process group (idempotent).  Process 0
    hosts the group's store at ``coordinator_address`` (``HOST:PORT``).
    With ``num_processes=1`` this still goes through the process group, so
    a 1-process run takes the code path of the N-process runs."""
    if dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes,
                            timeout=COLLECTIVE_TIMEOUT)


def shutdown() -> None:
    """Leave the process group once every process has reached this point."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """True on the coordinator (process 0): exactly one process prints,
    evaluates and publishes."""
    return process_index() == 0


class DistributedFederation:
    """The multi-process mirror of ``fl/federation.Federation``'s fused
    path: same Plan, same round semantics, one process per collaborator.

    Every process constructs this with the SAME full partition and seed,
    so state init (the fit cache included) and the run's draws are the
    fused path's; each process then keeps only its own shard for the
    round loop."""

    def __init__(self, plan: Plan, Xs, ys, masks, X_test, y_test, spec,
                 *, device: str | torch.device = "cuda", seed: int = 0,
                 packed_broadcast: bool = True):
        plan.validate()
        if plan.learners or isinstance(spec, HeterogeneousSpec):
            raise NotImplementedError(
                "distributed runtime is homogeneous-only: a process-per-"
                "collaborator round gathers ONE hypothesis bundle structure"
            )
        if plan.algorithm == "fedavg":
            raise NotImplementedError("distributed runtime covers the MAFL "
                                      "boosting algorithms, not fedavg")
        C = len(ys)
        if process_count() != C:
            raise ValueError(
                f"process-per-collaborator: {C} collaborators need "
                f"{C} processes, have {process_count()}"
            )
        self.device = dev = resolve_device(device)
        self.plan = plan
        self.spec = spec
        self.learner = get_learner(spec.name)
        self.C = C
        self.pidx = process_index()
        self.generator = torch.Generator().manual_seed(seed)  # the fused run's draws, in its order
        # the full partition: the replicated weight update needs every mask,
        # and state init the whole X (dropped in run())
        self._Xs = torch.as_tensor(Xs, dtype=torch.float32).to(dev).contiguous()
        self.masks = torch.as_tensor(masks, dtype=torch.float32).to(dev).contiguous()
        ys = torch.as_tensor(ys, dtype=torch.int32).to(dev)
        i = self.pidx
        self.Xi, self.yi, self.maski = self._Xs[i], ys[i].contiguous(), self.masks[i]
        self.X_test = torch.as_tensor(X_test, dtype=torch.float32).to(dev).contiguous()
        self.y_test = torch.as_tensor(y_test, dtype=torch.int32).to(dev).contiguous()
        self.packed_broadcast = packed_broadcast
        self.comm_bytes = 0
        self.collective_calls = 0
        self.comm_breakdown: Dict[str, int] = {}
        self._row_marker = (time.perf_counter(), 0, 0)
        self.history: List[Dict[str, float]] = []
        self.published: List[Path] = []
        self.state: Optional[BoostState] = None
        self._round_metrics: List[Dict[str, torch.Tensor]] = []

    # -- communication ------------------------------------------------------

    def _gather(self, x: torch.Tensor, *, span_name: str, r: int, label: str) -> torch.Tensor:
        """ONE all-gather across the process group; returns the ``[C, ...]``
        gathered tensor (process-index ordered) on the device.  Counts the
        gathered payload, the bytes every process receives off the
        collective, into the comm counter and the span."""
        with trace.span(span_name, round=r, payload=label, collective="all_gather") as sp:
            host = x.detach().to("cpu").contiguous()
            parts = [torch.empty_like(host) for _ in range(self.C)]
            dist.all_gather(parts, host)
            out = torch.stack(parts)
            nbytes = out.numel() * out.element_size()
            sp.set(bytes=nbytes)
        self.comm_bytes += nbytes
        self.collective_calls += 1
        self.comm_breakdown[label] = self.comm_breakdown.get(label, 0) + nbytes
        _M_COMM.inc(nbytes)
        return out.to(self.device)

    def _gather_hyps(self, h_local: Any, r: int, *, label: str = "hypotheses") -> Any:
        """The per-round hypothesis broadcast (paper step 2 -> 3 handoff).

        ``packed_broadcast`` on (the §5.1 buffer-packing analogue): the
        local bundle is flattened into ONE float32 wire buffer, a single
        collective a round.  Off: one collective per leaf, the
        pre-optimisation behaviour.  Both are lossless (int32 leaves travel
        bitcast), so the choice changes the wire schedule, never results."""
        if self.packed_broadcast:
            buf, fmt = _pack_leaves(h_local)
            g = self._gather(buf, span_name="round.broadcast", r=r, label=label)
            return _unpack_leaves(g, fmt, lead=(self.C,))
        return type(h_local)(*(
            self._gather(leaf, span_name="round.broadcast", r=r, label=label) for leaf in h_local
        ))

    def _history_extras(self, r: int) -> Dict[str, float]:
        now = time.perf_counter()
        t0, c0, r0 = self._row_marker
        self._row_marker = (now, self.comm_bytes, r + 1)
        dt = (now - t0) / max(r + 1 - r0, 1)
        _M_ROUND_SECONDS.observe(dt)
        return {"round_seconds": dt, "comm_bytes": float(self.comm_bytes - c0)}

    def _publish_checkpoint(self, state: BoostState, round_idx: int, publish_dir,
                            on_checkpoint) -> None:
        from repro_torch.serve.artifact import publish_artifact  # serving is optional at train time

        committee = self.C if self.plan.algorithm == "distboost_f" else None
        path = publish_artifact(
            publish_dir, self.spec, boosting.ensemble_to(state.ensemble, "cpu"),
            version=round_idx + 1, committee_size=committee,
            extra={"round": round_idx + 1, "algorithm": self.plan.algorithm},
        )
        self.published.append(path)
        if on_checkpoint is not None:
            on_checkpoint(path, round_idx + 1)

    # -- main loop ----------------------------------------------------------

    def run(
        self,
        rounds: Optional[int] = None,
        eval_every: int = 1,
        *,
        publish_every: Optional[int] = None,
        publish_dir: Optional[str] = None,
        on_checkpoint: Optional[Callable] = None,
    ) -> List[Dict[str, float]]:
        """Run the federation; returns this process's history (``f1`` is
        present only on process 0, which owns evaluation)."""
        rounds = rounds or self.plan.aggregator.rounds
        if publish_every is not None:
            if publish_every <= 0:
                raise ValueError(f"publish_every must be positive, got {publish_every}")
            if publish_dir is None:
                raise ValueError("publish_every requires a publish_dir")
        opt = self.plan.optimizations
        learner, spec, C, i, g = self.learner, self.spec, self.C, self.pidx, self.generator
        alg = self.plan.algorithm
        committee = C if alg == "distboost_f" else None
        # Full-partition init: the fit cache and uniform weights are the
        # fused path's; afterwards this process touches only its own shard
        # (and the replicated weights and masks).
        state = boosting.init_boost_state(learner, spec, rounds, self.masks,
                                          committee_size=committee, X=self._Xs)
        self._Xs = None
        cache_i = (None if state.fit_cache is None
                   else boosting._row(state.fit_cache, i))
        X1, y1, m1 = self.Xi[None], self.yi[None], self.maski[None]

        def fit_stage(r: int, w_row: torch.Tensor) -> Any:
            # the local fit (paper step 2): row i of the fused batched fit
            with trace.span("round.fit", round=r):
                h = boosting._local_fits(learner, spec, w_row, X1, y1, cache_i, g,
                                         batched=opt.batched_fit, own=(C, i))
                h = type(h)(*(x[0] for x in h))
                synchronize(self.device)  # keep the fit time out of the collective span
            return h

        def exchange(x: torch.Tensor, r: int, label: str) -> torch.Tensor:
            return self._gather(x, span_name="round.exchange", r=r, label=label)

        hyp_space = pcache_i = None
        if alg == "preweak_f":
            # steps 1+2 once: T local-AdaBoost hypotheses from THIS shard,
            # then one set-up gather assembles the C*T space (collaborator
            # major, as the fused set-up's reshape)
            with trace.span("preweak.setup", rounds=rounds):
                local_space = boosting._preweak_local_space(learner, spec, X1, y1, m1, cache_i,
                                                            rounds, g, own=(C, i))  # [T, ...]
                gathered = self._gather_hyps(local_space, -1, label="preweak_space")
                hyp_space = type(gathered)(*(x.reshape((C * rounds,) + x.shape[2:])
                                             for x in gathered))
                if opt.cache_predictions:  # a static space: predict this shard once
                    pcache_i = scoring.predict_matrix(learner, spec, hyp_space, self.Xi)

        if opt.cache_predictions:
            tally = scoring.init_tally(self.X_test.shape[0], spec.n_classes, self.device)

            def evaluate(s: BoostState) -> torch.Tensor:
                nonlocal tally
                tally = scoring.tally_new_votes(learner, spec, s.ensemble, tally, self.X_test,
                                                committee=committee is not None)
                return f1_macro(self.y_test, scoring.tally_predict(tally), spec.n_classes)
        else:
            def evaluate(s: BoostState) -> torch.Tensor:
                pred = boosting.strong_predict(learner, spec, s.ensemble, self.X_test,
                                               committee=committee is not None)
                return f1_macro(self.y_test, pred, spec.n_classes)

        def choose(state, r, predict: Callable[[], torch.Tensor]):
            """Steps 3/4 over this shard's ``[H, n_i]`` predictions: the
            gathered errors, the replicated argmin, alpha and update."""
            with trace.span("round.score", round=r):
                preds = predict()
                local_errs = scoring.shard_errors(preds, self.yi, state.weights[i])
                synchronize(self.device)
            errs = exchange(local_errs, r, "errors")  # [C, H]
            # replicated aggregation: the fused aggregate stage's choice
            c, eps_c, alpha = boosting.choose_member(errs, spec.n_classes)
            mis = exchange(scoring.chosen_mis(preds, self.yi, c), r, "mis")  # [C, n]
            with trace.span("round.aggregate", round=r):
                w = scoring.update_weights(state.weights, mis, self.masks, alpha)
            return c, eps_c, alpha, w

        def round_adaboost(state, r):
            hyps = self._gather_hyps(fit_stage(r, state.weights[i][None]), r)
            # [C, n_i]: predict ONCE
            c, eps_c, alpha, w = choose(
                state, r, lambda: scoring.predict_matrix(learner, spec, hyps, self.Xi))
            ens = _append(state.ensemble, scoring.take_slot(hyps, c), alpha)
            metrics = {"epsilon": eps_c, "alpha": alpha, "chosen": c.to(torch.int32)}
            return BoostState(ens, w, state.fit_cache), metrics

        def round_distboost(state, r):
            hyps = self._gather_hyps(fit_stage(r, state.weights[i][None]), r, label="committee")
            with trace.span("round.score", round=r):
                local_mis = (boosting._committee_predict(learner, spec, hyps, self.Xi)
                             != self.yi).to(torch.float32)
                synchronize(self.device)
            mis = exchange(local_mis, r, "mis")
            with trace.span("round.aggregate", round=r):
                eps, alpha = boosting.committee_alpha(state.weights, mis, spec.n_classes)
                w = scoring.update_weights(state.weights, mis, self.masks, alpha)
                ens = _append(state.ensemble, hyps, alpha)  # the slot is the whole committee
            metrics = {"epsilon": eps, "alpha": alpha,
                       "chosen": torch.zeros((), dtype=torch.int32, device=self.device)}
            return BoostState(ens, w, state.fit_cache), metrics

        def round_bagging(state, r):
            wfit = m1 / torch.clamp_min(torch.sum(m1, dim=1, keepdim=True), 1.0)  # local-uniform
            hyps = self._gather_hyps(fit_stage(r, wfit), r)
            with trace.span("round.aggregate", round=r):
                c = torch.randint(0, C, (), generator=g).to(self.device)  # replicated pick
                one = torch.ones((), dtype=torch.float32, device=self.device)
                ens = _append(state.ensemble, scoring.take_slot(hyps, c), one)
            metrics = {"epsilon": torch.zeros_like(one), "alpha": one, "chosen": c.to(torch.int32)}
            return BoostState(ens, state.weights, state.fit_cache), metrics

        def round_preweak(state, r):
            c, eps_c, alpha, w = choose(state, r, lambda: (
                pcache_i if pcache_i is not None
                else scoring.predict_matrix(learner, spec, hyp_space, self.Xi)))  # [C*T, n_i]
            ens = _append(state.ensemble, scoring.take_slot(hyp_space, c), alpha)
            metrics = {"epsilon": eps_c, "alpha": alpha, "chosen": c.to(torch.int32)}
            return BoostState(ens, w, state.fit_cache), metrics

        round_fn = {
            "adaboost_f": round_adaboost,
            "distboost_f": round_distboost,
            "bagging": round_bagging,
            "preweak_f": round_preweak,
        }[alg]

        self._row_marker = (time.perf_counter(), self.comm_bytes, 0)
        for r in range(rounds):
            with trace.span("round", round=r, algorithm=alg, process=i, processes=C):
                state, metrics = round_fn(state, r)
                self._round_metrics.append(metrics)
                _M_ROUNDS.inc()
                if (r + 1) % eval_every == 0 or r == rounds - 1:
                    vals = [metrics[k].to(torch.float32) for k in METRIC_KEYS]
                    row: Dict[str, float] = {"round": r}
                    if is_main():
                        with trace.span("round.eval", round=r):
                            f1, eps, alpha, chosen = torch.stack(
                                [evaluate(state).to(torch.float32)] + vals).tolist()  # one host sync
                        row["f1"] = f1
                    else:
                        eps, alpha, chosen = torch.stack(vals).tolist()
                    row.update({"epsilon": eps, "alpha": alpha, "chosen": round(chosen)})
                    row.update(self._history_extras(r))
                    self.history.append(row)
                if publish_every and ((r + 1) % publish_every == 0 or r == rounds - 1):
                    if is_main():
                        with trace.span("round.publish", round=r):
                            self._publish_checkpoint(state, r, publish_dir, on_checkpoint)
        self.state = state
        return self.history

    def per_round(self) -> List[Dict[str, float]]:
        """epsilon / alpha / chosen of every round run so far, fetched in
        one transfer."""
        return round_table(list(enumerate(self._round_metrics)))

    def summary(self) -> Dict[str, Any]:
        """Run metadata for ``--history-out``: the history rows, every
        round's metrics, and the measured wire accounting."""
        return {
            "processes": self.C,
            "process": self.pidx,
            "algorithm": self.plan.algorithm,
            "packed_broadcast": self.packed_broadcast,
            "comm_bytes": self.comm_bytes,
            "collective_calls": self.collective_calls,
            "comm_breakdown": dict(self.comm_breakdown),
            "history": self.history,
            "rounds": self.per_round(),
            "device": str(self.device),
        }
