"""Federated data partitioning (answers to ``repro/fl/partition.py``; the
IID split only — Dirichlet splits are not ported yet).

Output layout is collaborator-stacked fixed shapes [C, n_local, ...] with
a mask.
"""
from __future__ import annotations

from typing import Tuple

import torch


def iid_partition(
    X: torch.Tensor, y: torch.Tensor, n_collaborators: int, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform random split into equal chunks: (X [C, n, d], y [C, n], mask [C, n])."""
    n = X.shape[0]
    per = n // n_collaborators
    perm = torch.randperm(n, generator=generator)[: per * n_collaborators].to(X.device)
    Xs = X[perm].reshape(n_collaborators, per, -1)
    ys = y[perm].reshape(n_collaborators, per)
    mask = torch.ones(n_collaborators, per, dtype=torch.float32, device=X.device)
    return Xs, ys, mask
