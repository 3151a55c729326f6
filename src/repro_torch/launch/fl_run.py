"""MAFL federation runner on PyTorch — the port's main entry point
(answers to ``repro/launch/fl_run.py``'s default fused mode).

  PYTHONPATH=src python -m repro_torch.launch.fl_run --dataset adult \
      --collaborators 8 --rounds 10 --depth 4 --eval-every 5 --seed 0

  # heterogeneous federation: learner families cycled over collaborators
  PYTHONPATH=src python -m repro_torch.launch.fl_run --dataset adult \
      --collaborators 8 --learners decision_tree,ridge,gaussian_nb --split dirichlet

  # the interpreted OpenFL-style round with every §5.1 optimisation off
  PYTHONPATH=src python -m repro_torch.launch.fl_run --dataset adult --faithful

  # OpenFL's FedAvg workflow over the MLP
  PYTHONPATH=src python -m repro_torch.launch.fl_run --dataset adult \
      --algorithm fedavg --learner mlp

  # elastic rounds: a 1 s straggler deadline, 20% of uploads lost,
  # collaborator 2 killed at round 3
  PYTHONPATH=src python -m repro_torch.launch.fl_run --dataset adult --elastic \
      --deadline-ms 1000 --fault-seed 7 --fault-drop-p 0.2 --fault-kill 2:3

  # one process of a process-per-collaborator federation (launch all N
  # locally with launch/fl_spawn.py)
  PYTHONPATH=src python -m repro_torch.launch.fl_run --distributed \
      --coordinator 127.0.0.1:9781 --num-processes 4 --process-id 0 --collaborators 4

Runs AdaBoost.F (``--algorithm``: also ``distboost_f``, ``preweak_f``,
``bagging`` and ``fedavg``) over oblivious ``decision_tree`` learners (``--learner``:
any of the six registered families; ``--learners``: a comma-separated
list cycled over the collaborators, a heterogeneous federation) on an IID
split (``--split dirichlet``: label skew, ``--dirichlet-alpha``), on the
card by default (``--device cpu`` runs the kernels' plain versions on the
CPU).  ``--faithful`` runs the interpreted task graph with the paper's
§5.1 optimisations off (per-leaf serialization, an unbounded TensorDB,
sleep-polling barriers, no fused round, no prediction cache).  ``--seed``
seeds the data, the split and the run's random draws.
Prints one ``round ... f1 ... alpha ...`` line per evaluation and a
``total ...s  comm ... MB  final F1 ...`` summary.  ``--publish-every K
--publish-dir DIR`` writes a rolling serving artifact every K rounds
(``serve/artifact.py``); ``--trace`` and ``--metrics-out`` write the
run's spans and metrics.  ``--elastic`` runs the rounds through
``fl/elastic.py`` (partial participation, a straggler deadline
``--deadline-ms``, staleness-discounted late merges, ``--fault-*``
injection; ``--elastic-realtime`` waits on the wall clock), and
``--history-out`` then writes the elastic summary (responders, dropouts by
reason, late merges).  ``--distributed`` makes this process collaborator
``--process-id`` of a ``--num-processes`` federation exchanging rounds
over gloo collectives (``fl/distributed.py``; ``--no-packed-broadcast``
gathers a hypothesis leaf by leaf), or, with ``--elastic``, over the
fault-tolerant socket star (``fl/elastic_dist.py``); process 0 prints,
evaluates and writes ``--history-out``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.plan import (
    ALGORITHMS, SPLITS, DataPlan, LearnerPlan, OptimizationFlags, adaboost_plan, bagging_plan,
    fedavg_plan,
)
from repro_torch.data import PAPER_DATASETS, get_dataset
from repro_torch.device import resolve_device, synchronize
from repro_torch.fl.elastic import FaultPlan, ParticipationPolicy
from repro_torch.fl.federation import Federation, history_summary
from repro_torch.fl.partition import dirichlet_partition, iid_partition
from repro_torch.learners import LearnerSpec, available_learners, get_learner
from repro_torch.obs import metrics as obs_metrics, trace


LEARNERS = tuple(available_learners())
# --faithful: the paper's pre-optimisation OpenFL round (repro/launch/fl_run.py)
FAITHFUL = OptimizationFlags(packed_serialization=False, bounded_tensordb=False,
                             fast_barrier=False, fused_round=False, cache_predictions=False)


def default_hparams(name: str, depth: int = 4) -> dict:
    """Per-family CLI defaults (shared by fl_run, serve_fl and --learners)."""
    if name in ("decision_tree", "extra_tree"):
        return {"depth": depth, "n_bins": 16}
    if name == "mlp":
        return {"hidden": 64, "steps": 200, "local_steps": 20}
    return {}


def parse_learners(ap: argparse.ArgumentParser, value: str | None) -> tuple:
    """``--learners a,b,c`` -> a tuple of registered names (argparse error
    on an unknown one); None -> ()."""
    if not value:
        return ()
    names = tuple(n.strip() for n in value.split(",") if n.strip())
    bad = [n for n in names if n not in LEARNERS]
    if bad or not names:
        ap.error(f"--learners {value}: choose from {', '.join(LEARNERS)}")
    return names


def build_inputs(dataset: str, collaborators: int, rounds: int, depth: int, seed: int, *,
                 algorithm: str = "adaboost_f", learner: str = "decision_tree",
                 learners: tuple = (), split: str = "iid", dirichlet_alpha: float = 0.5,
                 optimizations: OptimizationFlags | None = None) -> tuple:
    """``(plan, Xs, ys, masks, X_test, y_test, spec)`` of one run, on the
    CPU: the data are drawn from ``seed`` and the split draws from the same
    generator, so every process of a multi-process run builds the same."""
    g = torch.Generator().manual_seed(seed)
    dspec, (Xtr, ytr, Xte, yte) = get_dataset(dataset, g)
    data = DataPlan(dataset=dataset, n_collaborators=collaborators, split=split,
                    dirichlet_alpha=dirichlet_alpha, seed=seed)
    plan_args = dict(rounds=rounds, data=data, optimizations=optimizations or OptimizationFlags(),
                     learners=tuple(LearnerPlan(n, default_hparams(n, depth)) for n in learners))
    if algorithm == "fedavg":
        plan = fedavg_plan(**plan_args)
    elif algorithm == "bagging":
        plan = bagging_plan(**plan_args)
    else:
        plan = adaboost_plan(algorithm=algorithm, **plan_args)
    if plan.data.split == "dirichlet":
        Xs, ys, masks = dirichlet_partition(Xtr, ytr, collaborators, alpha=plan.data.dirichlet_alpha,
                                            n_classes=dspec.n_classes, generator=g)
    else:
        Xs, ys, masks = iid_partition(Xtr, ytr, collaborators, g)
    lspec = LearnerSpec(learner, dspec.n_features, dspec.n_classes, default_hparams(learner, depth))
    return plan, Xs, ys, masks, Xte, yte, lspec


def build_federation(dataset: str, collaborators: int, rounds: int, depth: int,
                     seed: int, device, **kw) -> Federation:
    """Data, split and ``Federation`` for one run (:func:`build_inputs`'
    keywords): the data move to ``device`` and the run's own draws come
    from a generator seeded with ``seed``.  ``learners`` (registry keys)
    makes the federation heterogeneous, cycling them over the
    collaborators; ``optimizations`` sets the §5.1 flags (default: all
    on)."""
    device = resolve_device(device)
    return Federation(*build_inputs(dataset, collaborators, rounds, depth, seed, **kw),
                      device=device, seed=seed)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.fl_run")
    ap.add_argument("--dataset", default="adult", choices=sorted(PAPER_DATASETS))
    ap.add_argument("--algorithm", default="adaboost_f", choices=ALGORITHMS)
    ap.add_argument("--learner", default="decision_tree", choices=LEARNERS)
    ap.add_argument("--learners", default=None,
                    help="comma-separated learner registry keys cycled across "
                         "collaborators (e.g. decision_tree,ridge,gaussian_nb): a "
                         "heterogeneous federation; overrides --learner")
    ap.add_argument("--collaborators", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--split", default="iid", choices=SPLITS)
    ap.add_argument("--dirichlet-alpha", type=float, default=0.5)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faithful", action="store_true",
                    help="the interpreted OpenFL-style round with the paper's §5.1 "
                         "optimisations off (serialization, TensorDB, barriers)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--history-out", default=None, metavar="PATH",
                    help="write the run history, every round's metrics, the comm bytes, "
                         "the TensorDB peak and the barrier's sleep as JSON")
    ap.add_argument("--publish-every", type=int, default=None, metavar="K",
                    help="publish a versioned serving artifact every K rounds")
    ap.add_argument("--publish-dir", default=None,
                    help="directory for the rolling artifact stream")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record per-round spans (round/eval/publish) and write a "
                         "Chrome-trace JSON; also prints a phase-time summary table")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the process metrics registry in Prometheus text format")
    # -- elastic runtime (fl/elastic.py): participation policy ------------
    ap.add_argument("--elastic", action="store_true",
                    help="event-driven elastic rounds: straggler deadlines, partial "
                         "participation, staleness-discounted late merges")
    ap.add_argument("--deadline-ms", type=float, default=None, metavar="MS",
                    help="straggler deadline per round; omit to wait for every active "
                         "collaborator (lockstep semantics)")
    ap.add_argument("--min-responders", type=int, default=1,
                    help="a round never closes over fewer responders: the deadline "
                         "stretches to the fastest arrivals")
    ap.add_argument("--staleness-gamma", type=float, default=0.5,
                    help="late-merge alpha discount per round of lateness")
    ap.add_argument("--max-staleness", type=int, default=2,
                    help="rounds after which a late hypothesis is discarded")
    ap.add_argument("--no-late-merge", action="store_true",
                    help="drop stragglers' uploads instead of merging them")
    ap.add_argument("--elastic-realtime", action="store_true",
                    help="wall-clock arrival board (timers) instead of the "
                         "deterministic virtual clock")
    # -- fault injection (fl/elastic.py::FaultPlan) -----------------------
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the deterministic fault schedule")
    ap.add_argument("--fault-drop-p", type=float, default=0.0,
                    help="per-(round, collaborator) upload-loss probability")
    ap.add_argument("--fault-delay-p", type=float, default=0.0,
                    help="per-(round, collaborator) straggler probability")
    ap.add_argument("--fault-delay-ms", default="0:0", metavar="LO:HI",
                    help="straggler delay range in milliseconds")
    ap.add_argument("--fault-kill", action="append", default=[], metavar="C:ROUND",
                    help="kill collaborator C at ROUND (repeatable)")
    ap.add_argument("--fault-flaky", action="append", default=[], metavar="C:OFF:REJOIN",
                    help="collaborator C offline for rounds [OFF, REJOIN) then rejoins "
                         "(repeatable)")
    # -- the multi-process runtime (fl/distributed.py, fl/elastic_dist.py) --
    ap.add_argument("--distributed", action="store_true",
                    help="process-per-collaborator runtime: this process is collaborator "
                         "--process-id of a --num-processes federation exchanging rounds "
                         "over gloo collectives (with --elastic: the fault-tolerant "
                         "socket star with dead-process eviction)")
    ap.add_argument("--coordinator", default="127.0.0.1:9781", metavar="HOST:PORT",
                    help="the process group's address (process 0 hosts it)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--no-packed-broadcast", action="store_true",
                    help="gather the hypothesis bundle leaf by leaf instead of as one "
                         "packed wire buffer")
    args = ap.parse_args(argv)
    if args.publish_every is not None and not args.publish_dir:
        ap.error("--publish-every requires --publish-dir")
    learners = parse_learners(ap, args.learners)
    if learners and args.algorithm == "fedavg":
        ap.error("fedavg averages parameters and cannot mix model families")
    if learners and args.faithful:
        ap.error("--learners is fused-mode only; drop --faithful")
    if args.algorithm == "fedavg" and get_learner(args.learner).warm_fit is None:
        ap.error(f"learner {args.learner!r} has no warm_fit; FedAvg needs one")
    if args.distributed:
        if args.faithful or learners:
            ap.error("--distributed replaces --faithful and is homogeneous-only (no --learners)")
        if args.algorithm == "fedavg":
            ap.error("--distributed covers the MAFL boosting algorithms, not fedavg")
        if args.collaborators != args.num_processes:
            ap.error(f"--distributed is process-per-collaborator: --collaborators "
                     f"{args.collaborators} != --num-processes {args.num_processes}")
    device = resolve_device(args.device)
    if args.trace:
        trace.enable()
    if args.distributed:
        return _run_distributed(args, device)

    fed = build_federation(args.dataset, args.collaborators, args.rounds, args.depth,
                           args.seed, device, algorithm=args.algorithm, learner=args.learner,
                           learners=learners, split=args.split,
                           dirichlet_alpha=args.dirichlet_alpha,
                           optimizations=FAITHFUL if args.faithful else None)
    if fed.hetero:
        print("heterogeneous federation:",
              {i: fed.spec.specs[g].name for i, g in enumerate(fed.spec.assignment)})
    policy, faults = build_policy_faults(args) if args.elastic else (None, None)
    t0 = time.perf_counter()
    history = fed.run(eval_every=args.eval_every, publish_every=args.publish_every,
                      publish_dir=args.publish_dir, policy=policy, faults=faults)
    synchronize(device)
    dt = time.perf_counter() - t0
    _print_history(history)
    print(f"total {dt:.1f}s  comm {fed.comm_bytes/1e6:.2f} MB  final F1 {history[-1]['f1']:.4f}")
    if args.history_out:
        summary = fed.elastic.summary() if args.elastic else history_summary(fed)
        with open(args.history_out, "w") as f:
            json.dump(summary, f, indent=2)
    finish_obs(args)
    return history


def _run_distributed(args, device):
    """One process of the process-per-collaborator federation (the local
    N-process launch is ``launch/fl_spawn.py``).  ``--elastic`` skips the
    gloo group: the socket star needs none."""
    from repro_torch.fl import distributed as dist

    plan, Xs, ys, masks, Xte, yte, lspec = build_inputs(
        args.dataset, args.collaborators, args.rounds, args.depth, args.seed,
        algorithm=args.algorithm, learner=args.learner, split=args.split,
        dirichlet_alpha=args.dirichlet_alpha)
    if args.elastic:
        from repro_torch.fl.elastic_dist import run_elastic_distributed

        policy, faults = build_policy_faults(args)
        t0 = time.perf_counter()
        coord, history = run_elastic_distributed(args, policy, faults, lspec, Xs, ys, masks,
                                                 Xte, yte, device=device)
        if coord is not None:  # process 0
            dt = time.perf_counter() - t0
            _print_history(history)
            print(f"elastic distributed ({args.num_processes} processes, evicted "
                  f"{len(coord.evicted)}): total {dt:.1f}s  comm {coord.comm_bytes/1e6:.2f} MB  "
                  f"final F1 {history[-1]['f1']:.4f}")
            if args.history_out:
                with open(args.history_out, "w") as f:
                    json.dump(coord.summary(), f, indent=2)
            finish_obs(args)
        return history

    dist.initialize(args.coordinator, args.num_processes, args.process_id)
    fed = dist.DistributedFederation(plan, Xs, ys, masks, Xte, yte, lspec, device=device,
                                     seed=args.seed,
                                     packed_broadcast=not args.no_packed_broadcast)
    t0 = time.perf_counter()
    history = fed.run(eval_every=args.eval_every, publish_every=args.publish_every,
                      publish_dir=args.publish_dir)
    synchronize(device)
    dt = time.perf_counter() - t0
    if dist.is_main():
        _print_history(history)
        print(f"distributed ({fed.C} processes, "
              f"{'packed' if fed.packed_broadcast else 'per-leaf'} broadcast): total {dt:.1f}s  "
              f"comm {fed.comm_bytes/1e6:.2f} MB  final F1 {history[-1]['f1']:.4f}")
        if args.history_out:
            with open(args.history_out, "w") as f:
                json.dump(fed.summary(), f, indent=2)
        finish_obs(args)
    dist.shutdown()
    return history


def build_policy_faults(args) -> tuple:
    """--elastic / --fault-* flags -> (ParticipationPolicy, FaultPlan)."""
    lo, hi = (float(x) for x in args.fault_delay_ms.split(":"))
    kills = tuple(tuple(int(x) for x in spec.split(":")) for spec in args.fault_kill)
    flaky = tuple(tuple(int(x) for x in spec.split(":")) for spec in args.fault_flaky)
    policy = ParticipationPolicy(
        deadline_s=None if args.deadline_ms is None else args.deadline_ms / 1e3,
        min_responders=args.min_responders,
        staleness_gamma=args.staleness_gamma,
        max_staleness=args.max_staleness,
        late_merge=not args.no_late_merge,
        realtime=args.elastic_realtime,
    )
    faults = FaultPlan(seed=args.fault_seed, delay_p=args.fault_delay_p,
                       delay_range_s=(lo / 1e3, hi / 1e3), drop_p=args.fault_drop_p,
                       kills=kills, flaky=flaky)
    return policy, faults


def finish_obs(args) -> None:
    """Export the trace / metrics dump the run accumulated (shared by
    fl_run and serve_fl: both expose --trace/--metrics-out)."""
    if getattr(args, "trace", None):
        trace.export(args.trace)
        print(trace.format_summary("phase-time summary"))
        print(f"trace written to {args.trace} (open in Perfetto or chrome://tracing)")
    if getattr(args, "metrics_out", None):
        obs_metrics.dump(args.metrics_out)
        print(f"metrics written to {args.metrics_out} (Prometheus text format)")


def _print_history(history):
    for h in history:
        print(f"round {h['round']:4d}  f1 {h['f1']:.4f}  alpha {h['alpha']:.3f}"
              f"  {1e3 * h['round_seconds']:8.1f} ms/round")


if __name__ == "__main__":
    main()
