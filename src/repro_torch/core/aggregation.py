"""Model-agnostic aggregation strategies, chosen by name from the plan
(answers to ``repro/core/aggregation.py``, paper §4.3).

Two kinds of artifact flow through MAFL:
  * tensor updates (OpenFL's DNN workflow) -> ``fedavg`` and the others
    here, each a plain torch function over a NamedTuple of stacked leaves
    (leading collaborator axis C);
  * whole models (the model-agnostic workflow) -> the ensemble rounds of
    ``core/boosting.py``, selected by the same names.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch


def _map(fn, *trees: Any) -> Any:
    """``fn`` over the leaves of NamedTuples of tensors, structure kept."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    return type(first)(*(_map(fn, *leaves) for leaves in zip(*trees)))


def fedavg(stacked: Any, sizes: torch.Tensor) -> Any:
    """Dataset-size-weighted average of collaborator parameters.

    stacked: leaves with a leading collaborator axis C; sizes: [C]."""
    wt = sizes / torch.clamp_min(torch.sum(sizes), 1e-12)

    def avg(leaf):
        w = wt.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)
        return torch.sum(leaf * w, dim=0)

    return _map(avg, stacked)


def fedavg_delta(global_params: Any, local_stacked: Any, sizes: torch.Tensor) -> Any:
    """FedAvg over the local updates' deltas (kinder to bf16 parameters)."""
    delta = _map(lambda l, g: l - g.unsqueeze(0), local_stacked, global_params)
    avg = fedavg(delta, sizes)
    return _map(lambda g, d: g + d.to(g.dtype), global_params, avg)


def median_aggregate(stacked: Any, sizes: torch.Tensor) -> Any:
    """Coordinate-wise median, a robust baseline the plan can select.  An
    even C averages the two middle values, as ``jnp.median`` does
    (``torch.median`` returns the lower one)."""
    del sizes
    return _map(lambda leaf: torch.quantile(leaf, 0.5, dim=0), stacked)


def trimmed_mean(stacked: Any, sizes: torch.Tensor, trim: float = 0.2) -> Any:
    del sizes

    def agg(leaf):
        C = leaf.shape[0]
        k = int(C * trim)
        srt = torch.sort(leaf, dim=0).values
        kept = srt[k: C - k] if C - 2 * k > 0 else srt
        return torch.mean(kept, dim=0)

    return _map(agg, stacked)


TENSOR_AGGREGATORS: Dict[str, Callable] = {
    "fedavg": fedavg,
    "fedavg_delta": fedavg_delta,
    "median": median_aggregate,
    "trimmed_mean": trimmed_mean,
}

# Whole-model (model-agnostic) strategies live in core/boosting.py; the plan
# selects them by the same names.
MODEL_AGNOSTIC_ALGORITHMS = ("adaboost_f", "distboost_f", "preweak_f", "bagging")


def get_tensor_aggregator(name: str) -> Callable:
    if name not in TENSOR_AGGREGATORS:
        raise KeyError(f"unknown aggregator {name!r}; have {sorted(TENSOR_AGGREGATORS)}")
    return TENSOR_AGGREGATORS[name]
