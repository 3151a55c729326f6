"""Weighted ridge classifier, closed form (answers to
``repro/learners/linear.py``): the 'Linear models' family of the paper's
flexibility study (§5.3).

Solves ``W = (XᵀΛX + λI)⁻¹ XᵀΛY`` with Λ the sample weights, Y the ±1
one-hot targets and a bias column folded into X.  ``fit`` takes a leading
collaborator axis natively (``[C, n, d]`` inputs fit C hypotheses in one
batched solve); ``predict_logits`` takes a leading hypothesis axis on the
params.  The solve is ``torch.linalg.solve_ex``, which reads no error
flag back to the host, so a fit on the card never waits for it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ref import one_hot
from repro_torch.learners.base import LearnerSpec, WeakLearner, register


class RidgeParams(NamedTuple):
    W: torch.Tensor  # [..., d + 1, K]


def _with_bias(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)], dim=-1)


def init_ridge(spec: LearnerSpec, device) -> RidgeParams:
    return RidgeParams(W=torch.zeros(spec.n_features + 1, spec.n_classes, device=device))


def fit_ridge(spec: LearnerSpec, params, X, y, w, *, generator=None) -> RidgeParams:
    """X [..., n, d], y and w [..., n] -> W [..., d + 1, K]; a closed form
    draws nothing and ignores ``params``."""
    del params, generator
    lam = spec.hp("l2", 1.0)
    Xb = _with_bias(X)
    Y = 2.0 * one_hot(y, spec.n_classes, torch.float32) - 1.0  # ridge-classifier ±1 targets
    Xw_t = (Xb * w.unsqueeze(-1)).transpose(-1, -2)
    eye = torch.eye(Xb.shape[-1], dtype=Xb.dtype, device=Xb.device)
    W, _ = torch.linalg.solve_ex(Xw_t @ Xb + lam * eye, Xw_t @ Y)
    return RidgeParams(W=W)


def ridge_logits(spec: LearnerSpec, params: RidgeParams, X: torch.Tensor) -> torch.Tensor:
    """params [d + 1, K] or [H, d + 1, K]; X [..., n, d] -> [..., n, K] or
    [..., H, n, K]."""
    Xb = _with_bias(X)
    if params.W.dim() == 3:
        Xb = Xb.unsqueeze(-3)
    return Xb @ params.W


ridge = register(WeakLearner("ridge", init_ridge, fit_ridge, ridge_logits))
