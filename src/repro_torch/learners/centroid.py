"""Weighted nearest-centroid classifier (answers to
``repro/learners/centroid.py``): the 'Neighbors' family, the fixed-shape
member of it that stands in for the paper's k-nearest neighbours.

``fit`` takes a leading collaborator axis natively and ``predict_logits``
a leading hypothesis axis on the params.  A class with (near-)zero total
weight parks its centroid at 1e6 so that it never wins.  The distance is
summed as ``(x - c)²`` over features, in the JAX package's form (its
``[C, H, n, K, d]`` difference tensor is 213 MB at letter's C = H = 8,
n = 2 000, K = 26, d = 16), not expanded into ``‖x‖² - 2x·c + ‖c‖²``,
which sums in another order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.learners.base import LearnerSpec, WeakLearner, register, weighted_onehot


class CentroidParams(NamedTuple):
    centroid: torch.Tensor  # [..., K, d]
    log_prior: torch.Tensor  # [..., K] tie-break by class frequency


def init_centroid(spec: LearnerSpec, device) -> CentroidParams:
    return CentroidParams(torch.zeros(spec.n_classes, spec.n_features, device=device),
                          torch.zeros(spec.n_classes, device=device))


def fit_centroid(spec: LearnerSpec, params, X, y, w, *, generator=None) -> CentroidParams:
    del params, generator
    wy = weighted_onehot(y, w, spec.n_classes)  # [..., n, K]
    cls_w = torch.sum(wy, dim=-2)  # [..., K]
    centroid = (wy.transpose(-1, -2) @ X) / torch.clamp_min(cls_w, 1e-12).unsqueeze(-1)
    centroid = torch.where((cls_w < 1e-9).unsqueeze(-1), 1e6, centroid)
    prior = cls_w / torch.clamp_min(torch.sum(cls_w, dim=-1, keepdim=True), 1e-12)
    return CentroidParams(centroid, torch.log(prior + 1e-12))


def centroid_logits(spec: LearnerSpec, params: CentroidParams, X: torch.Tensor) -> torch.Tensor:
    """X [..., n, d] -> [..., n, K], or [..., H, n, K] for stacked params."""
    centroid, log_prior = params
    if centroid.dim() == 3:
        X = X.unsqueeze(-3)
    d2 = torch.sum((X.unsqueeze(-2) - centroid.unsqueeze(-3)) ** 2, dim=-1)  # [..., (H,) n, K]
    return -d2 + 1e-6 * log_prior.unsqueeze(-2)


nearest_centroid = register(
    WeakLearner("nearest_centroid", init_centroid, fit_centroid, centroid_logits)
)
