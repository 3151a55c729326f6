"""Model-agnostic weak-learner interface (answers to ``repro/learners/base.py``).

A weak hypothesis is an opaque bundle of tensors plus functions; the
federated protocol never looks inside.  Where the JAX package maps a
learner over collaborators or hypotheses with ``vmap``, the port writes
the batch axis out:

``init(spec, device) -> params``
    Zero-valued parameters of one hypothesis.  Shapes depend on ``spec``
    alone (the ensemble pre-allocates ``T`` stacked copies).
``predict_logits(spec, params, X) -> [..., H, n, K]``
    Per-class scores.  ``params`` may carry a leading hypothesis axis
    ``H``; ``X`` is ``[n, d]`` or ``[C, n, d]``.  Unbatched params give
    ``[n, K]`` for ``X [n, d]``.
``precompute(spec, X) -> cache``
    The X-only fit scaffold, computed once per shard (``X`` may carry a
    leading collaborator axis).
``fit_batched(spec, X, y, w, cache, *, generator=None) -> params``
    One tensor program fitting all C collaborators' hypotheses from
    ``[C, ...]`` inputs; rows with ``w == 0`` are padding.  A randomised
    learner draws each collaborator's random choices from ``generator``, an
    explicit CPU ``torch.Generator`` (drawn on the host in a fixed order,
    then moved to the device, so the card and the CPU draw the same numbers
    and no draw waits for the card); its own keyword arguments take the
    draws injected instead (``extra_tree``'s ``candidates``), which is how
    the tests feed it the JAX package's draws.  Nothing is key-shaped: the
    JAX package's per-collaborator keys have no counterpart.  A
    deterministic learner (``decision_tree``) ignores the generator.

``fit(spec, params, X, y, w, *, generator=None)`` fits one hypothesis
from ``[n, ...]`` inputs.
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
