"""MAFL federation runner on PyTorch — the port's main entry point
(answers to ``repro/launch/fl_run.py``'s default fused mode).

  PYTHONPATH=src python -m repro_torch.launch.fl_run --dataset adult \
      --collaborators 8 --rounds 10 --depth 4 --eval-every 5 --seed 0

Runs AdaBoost.F (``--algorithm``: also ``distboost_f``, ``preweak_f`` and
``bagging``) over oblivious ``decision_tree`` learners (``--learner
extra_tree``: random split candidates) on an IID split, on the card by
default (``--device cpu`` runs the kernels' plain versions on the CPU).
``--seed`` seeds the data, the split and the run's random draws.  Prints one ``round ... f1 ... alpha ...`` line per
evaluation and a ``total ...s  comm ... MB  final F1 ...`` summary.
``--publish-every K --publish-dir DIR`` writes a rolling serving
artifact every K rounds (``serve/artifact.py``); ``--trace`` and
``--metrics-out`` write the run's spans and metrics.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.plan import ALGORITHMS, UNPORTED, adaboost_plan, bagging_plan
from repro_torch.data import PAPER_DATASETS, get_dataset
from repro_torch.device import resolve_device
from repro_torch.fl.federation import Federation, history_summary
from repro_torch.fl.partition import iid_partition
from repro_torch.learners import LearnerSpec
from repro_torch.obs import metrics as obs_metrics, trace


LEARNERS = ("decision_tree", "extra_tree")
# the JAX package's other learners, and the ROADMAP item that ports them
UNPORTED_LEARNERS = {name: "ROADMAP Queue 1 item 8"
                     for name in ("ridge", "gaussian_nb", "nearest_centroid", "mlp")}


def default_hparams(depth: int = 4) -> dict:
    return {"depth": depth, "n_bins": 16}


def build_federation(dataset: str, collaborators: int, rounds: int, depth: int,
                     seed: int, device, *, algorithm: str = "adaboost_f",
                     learner: str = "decision_tree") -> Federation:
    """Data, IID split and ``Federation`` for one run; the data are drawn
    on the CPU from ``seed`` and moved to ``device``, and the run's own
    draws come from a generator seeded with ``seed``."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    dspec, (Xtr, ytr, Xte, yte) = get_dataset(dataset, g)
    Xs, ys, masks = iid_partition(Xtr, ytr, collaborators, g)
    lspec = LearnerSpec(learner, dspec.n_features, dspec.n_classes, default_hparams(depth))
    plan = (bagging_plan(rounds=rounds) if algorithm == "bagging"
            else adaboost_plan(rounds=rounds, algorithm=algorithm))
    return Federation(plan, Xs, ys, masks, Xte, yte, lspec, device=device, seed=seed)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.fl_run")
    ap.add_argument("--dataset", default="adult", choices=sorted(PAPER_DATASETS))
    ap.add_argument("--algorithm", default="adaboost_f",
                    help=f"one of {', '.join(ALGORITHMS)} (fedavg: {UNPORTED['fedavg']})")
    ap.add_argument("--learner", default="decision_tree",
                    help=f"one of {', '.join(LEARNERS)}")
    ap.add_argument("--collaborators", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--history-out", default=None, metavar="PATH",
                    help="write the run history, every round's metrics and the "
                         "modelled comm bytes as JSON")
    ap.add_argument("--publish-every", type=int, default=None, metavar="K",
                    help="publish a versioned serving artifact every K rounds")
    ap.add_argument("--publish-dir", default=None,
                    help="directory for the rolling artifact stream")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record per-round spans (round/eval/publish) and write a "
                         "Chrome-trace JSON; also prints a phase-time summary table")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the process metrics registry in Prometheus text format")
    args = ap.parse_args(argv)
    if args.publish_every is not None and not args.publish_dir:
        ap.error("--publish-every requires --publish-dir")
    if args.algorithm not in ALGORITHMS:
        ap.error(f"--algorithm {args.algorithm}: "
                 + (f"not ported yet ({UNPORTED[args.algorithm]})" if args.algorithm in UNPORTED
                    else f"choose from {', '.join(ALGORITHMS)}"))
    if args.learner not in LEARNERS:
        ap.error(f"--learner {args.learner}: "
                 + (f"not ported yet ({UNPORTED_LEARNERS[args.learner]})"
                    if args.learner in UNPORTED_LEARNERS else f"choose from {', '.join(LEARNERS)}"))
    device = resolve_device(args.device)
    if args.trace:
        trace.enable()

    fed = build_federation(args.dataset, args.collaborators, args.rounds, args.depth,
                           args.seed, device, algorithm=args.algorithm, learner=args.learner)
    t0 = time.perf_counter()
    history = fed.run(eval_every=args.eval_every, publish_every=args.publish_every,
                      publish_dir=args.publish_dir)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    _print_history(history)
    print(f"total {dt:.1f}s  comm {fed.comm_bytes/1e6:.2f} MB  final F1 {history[-1]['f1']:.4f}")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history_summary(fed), f, indent=2)
    finish_obs(args)
    return history


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
