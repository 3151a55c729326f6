"""Weighted Gaussian naive Bayes (answers to
``repro/learners/naive_bayes.py``): the 'Naive Bayes' family (§5.3).

``fit`` takes a leading collaborator axis natively and ``predict_logits``
a leading hypothesis axis on the params (the batch conventions of
``learners/base.py``); a ``[C, H, n, K, d]`` difference tensor is
built for a ``[C, n, d]`` predict (213 MB at letter's C = H = 8, n = 2 000,
K = 26, d = 16).  The variance smoothing term is the population
variance (``correction=0``, as ``jnp.var``) of each feature over all n
rows of the shard, padding rows included, as the JAX package computes it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.learners.base import LearnerSpec, WeakLearner, register, weighted_onehot


class GNBParams(NamedTuple):
    log_prior: torch.Tensor  # [..., K]
    mean: torch.Tensor  # [..., K, d]
    var: torch.Tensor  # [..., K, d]


def init_gnb(spec: LearnerSpec, device) -> GNBParams:
    K, d = spec.n_classes, spec.n_features
    return GNBParams(torch.zeros(K, device=device), torch.zeros(K, d, device=device),
                     torch.zeros(K, d, device=device))


def fit_gnb(spec: LearnerSpec, params, X, y, w, *, generator=None) -> GNBParams:
    """X [..., n, d], y and w [..., n] -> per-class mean and variance."""
    del params, generator
    wy = weighted_onehot(y, w, spec.n_classes)  # [..., n, K]
    cls_w = torch.sum(wy, dim=-2)  # [..., K]
    denom = torch.clamp_min(cls_w, 1e-12).unsqueeze(-1)
    wy_t = wy.transpose(-1, -2)
    mean = (wy_t @ X) / denom  # [..., K, d]
    var = (wy_t @ (X * X)) / denom - mean * mean
    smooth = spec.hp("var_smoothing", 1e-3) * torch.var(X, dim=-2, correction=0)
    var = torch.clamp_min(var, 1e-6) + smooth.unsqueeze(-2)
    prior = cls_w / torch.clamp_min(torch.sum(cls_w, dim=-1, keepdim=True), 1e-12)
    return GNBParams(torch.log(prior + 1e-12), mean, var)


def gnb_logits(spec: LearnerSpec, params: GNBParams, X: torch.Tensor) -> torch.Tensor:
    """log N(x | mean, var) summed over features, plus the log prior:
    X [..., n, d] -> [..., n, K], or [..., H, n, K] for stacked params."""
    log_prior, mean, var = params
    if mean.dim() == 3:
        X = X.unsqueeze(-3)
    diff = X.unsqueeze(-2) - mean.unsqueeze(-3)  # [..., (H,) n, K, d]
    var = var.unsqueeze(-3)
    ll = -0.5 * (diff * diff / var + torch.log(2 * math.pi * var))
    return torch.sum(ll, dim=-1) + log_prior.unsqueeze(-2)


gaussian_nb = register(WeakLearner("gaussian_nb", init_gnb, fit_gnb, gnb_logits))
