"""Quantile binning — the data layer of tree fitting (answers to
``repro/learners/binning.py``).

A shard's features are static across boosting rounds, so the quantile
edges and every cell's bin index are computed once per shard and carried
through the rounds as the fit cache.  Every function takes an optional
leading collaborator axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BinnedDataset(NamedTuple):
    """Per-shard fit precomputation for histogram-based tree learners.

    edges:   [..., d, n_bins] f32 — per-feature candidate thresholds
             (a split at bin b tests ``x > edges[f, b]``).
    bin_idx: [..., n, d] int32 in [0, n_bins] — how many edges each cell
             exceeds; the direct input of the ``tree_hist`` kernel.
    """

    edges: torch.Tensor
    bin_idx: torch.Tensor

    @property
    def n_bins(self) -> int:
        return self.edges.shape[-1]


def quantile_edges(X: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Per-feature candidate thresholds from quantiles: [..., n, d] -> [..., d, n_bins].

    Linear interpolation, as ``jnp.quantile``'s default."""
    qs = torch.linspace(0.0, 1.0, n_bins + 2, dtype=X.dtype, device=X.device)[1:-1]
    return torch.quantile(X, qs, dim=-2).movedim(0, -1).contiguous()


def digitize(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bin index of each cell, the number of edges it exceeds: [..., n, d] int32."""
    return (X.unsqueeze(-1) > edges.unsqueeze(-3)).sum(-1, dtype=torch.int32)


def bin_dataset(X: torch.Tensor, n_bins: int) -> BinnedDataset:
    """One-shot shard precomputation: quantile edges + digitized bins."""
    edges = quantile_edges(X, n_bins)
    return BinnedDataset(edges=edges, bin_idx=digitize(X, edges))
