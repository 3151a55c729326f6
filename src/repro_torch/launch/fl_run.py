"""MAFL federation runner on PyTorch — the port's main entry point
(answers to ``repro/launch/fl_run.py``'s default fused mode).

  PYTHONPATH=src python -m repro_torch.launch.fl_run --dataset adult \
      --collaborators 8 --rounds 10 --depth 4 --eval-every 5 --seed 0

Runs AdaBoost.F over oblivious ``decision_tree`` learners on an IID split,
on the card by default (``--device cpu`` runs the kernels' plain versions
on the CPU).  Prints one ``round ... f1 ... alpha ...`` line per
evaluation and a ``total ...s  final F1 ...`` summary.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.plan import adaboost_plan
from repro_torch.data import PAPER_DATASETS, get_dataset
from repro_torch.device import resolve_device
from repro_torch.fl.federation import Federation, history_summary
from repro_torch.fl.partition import iid_partition
from repro_torch.learners import LearnerSpec


def default_hparams(depth: int = 4) -> dict:
    return {"depth": depth, "n_bins": 16}


def build_federation(dataset: str, collaborators: int, rounds: int, depth: int,
                     seed: int, device) -> Federation:
    """Data, IID split and ``Federation`` for one run; the data are drawn
    on the CPU from ``seed`` and moved to ``device``."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    dspec, (Xtr, ytr, Xte, yte) = get_dataset(dataset, g)
    Xs, ys, masks = iid_partition(Xtr, ytr, collaborators, g)
    lspec = LearnerSpec("decision_tree", dspec.n_features, dspec.n_classes,
                        default_hparams(depth))
    return Federation(adaboost_plan(rounds=rounds), Xs, ys, masks, Xte, yte, lspec,
                      device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.fl_run")
    ap.add_argument("--dataset", default="adult", choices=sorted(PAPER_DATASETS))
    ap.add_argument("--collaborators", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--history-out", default=None, metavar="PATH",
                    help="write the run history and every round's metrics as JSON")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    fed = build_federation(args.dataset, args.collaborators, args.rounds, args.depth,
                           args.seed, device)
    t0 = time.perf_counter()
    history = fed.run(eval_every=args.eval_every)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    _print_history(history)
    print(f"total {dt:.1f}s  final F1 {history[-1]['f1']:.4f}")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history_summary(fed), f, indent=2)
    return history


def _print_history(history):
    for h in history:
        print(f"round {h['round']:4d}  f1 {h['f1']:.4f}  alpha {h['alpha']:.3f}"
              f"  {1e3 * h['round_seconds']:8.1f} ms/round")


if __name__ == "__main__":
    main()
