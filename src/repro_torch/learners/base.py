"""Model-agnostic weak-learner interface (answers to ``repro/learners/base.py``).

A weak hypothesis is a bundle of tensors plus functions; the federated
protocol never looks inside.  Where the JAX package maps a learner over
collaborators or hypotheses with ``vmap``, the port writes the batch axis
out:

``init(spec, device) -> params``
    Zero-valued parameters of one hypothesis.  Shapes depend on ``spec``
    alone (the ensemble pre-allocates ``T`` stacked copies).
``predict_logits(spec, params, X) -> [..., H, n, K]``
    Per-class scores.  ``params`` may carry a leading hypothesis axis
    ``H``; ``X`` is ``[n, d]`` or ``[C, n, d]``.  Unbatched params give
    ``[n, K]`` for ``X [n, d]``.
``fit(spec, params, X, y, w, *, generator=None, **draws) -> params``
    A weighted fit from ``[n, ...]`` inputs; rows with ``w == 0`` are
    padding.  The closed-form learners and the MLP take a leading
    collaborator axis natively (``[C, n, ...]`` inputs fit C hypotheses
    in one batched program): this is the route ``core/boosting.py::
    _local_fits`` takes for a learner without ``fit_batched``, the
    counterpart of the JAX package's ``vmap(fit)``.
``precompute(spec, X) -> cache``
    The X-only fit scaffold, computed once per shard (``X`` may carry a
    leading collaborator axis).
``fit_batched(spec, X, y, w, cache, *, generator=None, **draws) -> params``
    One tensor program fitting all C collaborators' hypotheses from
    ``[C, ...]`` inputs over the shard-static fit cache (the trees: one
    ``tree_hist`` launch a level).
``draw(spec, C, generator, device) -> draws``
    A randomised learner's random inputs for C fits, as the keyword
    arguments its fit takes them by (``extra_tree``: ``candidates``;
    ``mlp``: ``init``), each with a leading collaborator axis.  They are
    drawn on the host from ``generator``, an explicit CPU
    ``torch.Generator``, in a fixed order, then moved to the device, so
    the card and the CPU draw the same numbers and no draw waits for the
    card.  A fit given ``generator`` and no draws calls ``draw`` itself;
    the tests inject the JAX package's draws instead.  Nothing is
    key-shaped: the JAX package's per-collaborator keys have no
    counterpart.  A deterministic learner has no ``draw`` and ignores the
    generator.
``warm_fit(spec, params, X, y, w, *, generator=None) -> params``
    Gradient continuation from ``params`` (the MLP only; FedAvg's local
    training).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.kernels.ref import one_hot

Params = Any


@dataclasses.dataclass(frozen=True)
class LearnerSpec:
    """Static description of the learning problem + learner hyperparams."""

    name: str
    n_features: int
    n_classes: int
    hparams: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def hp(self, key: str, default: Any) -> Any:
        return self.hparams.get(key, default)


@dataclasses.dataclass(frozen=True)
class WeakLearner:
    """A weak learner = init + weighted fit + predict_logits (see the
    module docstring for the batch conventions)."""

    name: str
    init: Callable[[LearnerSpec, torch.device], Params]
    fit: Callable[..., Params]
    predict_logits: Callable[[LearnerSpec, Params, torch.Tensor], torch.Tensor]
    precompute: Callable[[LearnerSpec, torch.Tensor], Any] | None = None
    fit_batched: Callable[..., Params] | None = None
    draw: Callable[..., Dict[str, Any]] | None = None
    warm_fit: Callable[..., Params] | None = None

    def predict(self, spec: LearnerSpec, params: Params, X: torch.Tensor) -> torch.Tensor:
        """Class predictions: the argmax of ``predict_logits`` (int32)."""
        return torch.argmax(self.predict_logits(spec, params, X), dim=-1).to(torch.int32)


_REGISTRY: Dict[str, WeakLearner] = {}


def register(learner: WeakLearner) -> WeakLearner:
    _REGISTRY[learner.name] = learner
    return learner


def available_learners() -> list:
    return sorted(_REGISTRY)


def get_learner(name: str) -> WeakLearner:
    if name not in _REGISTRY:
        raise KeyError(f"unknown learner {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def weighted_onehot(y: torch.Tensor, w: torch.Tensor, n_classes: int) -> torch.Tensor:
    """[..., n] labels + [..., n] weights -> [..., n, K] weighted one-hot
    (a label outside ``[0, K)`` weighs nothing)."""
    return one_hot(y, n_classes, w.dtype) * w.unsqueeze(-1)
