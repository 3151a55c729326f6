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

    ``jnp.quantile``'s linear interpolation with its rounding: the
    quantiles ``i · (1 / (n_bins + 1))`` and their positions ``q · (n - 1)``
    in float32, then ``low · w_low + high · w_high``, which the JAX
    package's compiled program rounds once after the first product is
    added (a fused multiply-add; emulated here in float64, which holds the
    product exactly).  The edges are then the JAX package's to the bit, so
    a sample that lies on an edge falls on the same side of it on both."""
    n = X.shape[-2]
    # jnp.linspace(0, 1, n_bins + 2)[1:-1]: iota times the float32 reciprocal of n_bins + 1
    step = torch.ones((), dtype=torch.float32, device=X.device) / (n_bins + 1)
    qs = torch.arange(1, n_bins + 1, dtype=torch.float32, device=X.device) * step
    q = qs * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    w_low = 1.0 - w_high
    ordered = torch.sort(X, dim=-2).values
    lo = ordered.index_select(-2, low.clamp(0, n - 1).long())  # [..., n_bins, d]
    hi = ordered.index_select(-2, high.clamp(0, n - 1).long())
    edges = lo.double() * w_low.double().unsqueeze(-1) + (hi * w_high.unsqueeze(-1)).double()
    return edges.to(X.dtype).movedim(-2, -1).contiguous()


def digitize(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bin index of each cell, the number of edges it exceeds: [..., n, d] int32."""
    return (X.unsqueeze(-1) > edges.unsqueeze(-3)).sum(-1, dtype=torch.int32)


def bin_dataset(X: torch.Tensor, n_bins: int) -> BinnedDataset:
    """One-shot shard precomputation: quantile edges + digitized bins."""
    edges = quantile_edges(X, n_bins)
    return BinnedDataset(edges=edges, bin_idx=digitize(X, edges))
