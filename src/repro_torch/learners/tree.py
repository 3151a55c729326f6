"""Oblivious decision trees (answers to ``repro/learners/tree.py``,
``decision_tree`` only).

An oblivious tree applies one (feature, threshold) test per level, shared
by every node of the level, so a depth-``D`` tree has ``2**D`` leaves and
its fit is a fixed-shape tensor program.  The fit is staged:

  bin        quantile edges + bin indices, once per shard (the fit cache);
  histogram  the level's weighted class histogram C[leaf, feature, bin,
             class] — one ``tree_hist`` launch for all C collaborators;
  select     split scores from a reverse cumulative sum over bins; the
             best candidate maximises sum_leaf sum_side sum_k c_k^2 / c_tot
             (the same as minimising weighted Gini);
  descend    every sample moves one level down;
  leaf       leaf log class distributions from a weighted segment sum.

Every stage takes the collaborator axis C as its leading dimension.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.learners.base import LearnerSpec, WeakLearner, register, weighted_onehot
from repro_torch.learners.binning import BinnedDataset, bin_dataset


class TreeParams(NamedTuple):
    feature: torch.Tensor  # [..., depth] int32 — feature tested at each level
    threshold: torch.Tensor  # [..., depth] f32 — raw threshold value
    leaf_logits: torch.Tensor  # [..., 2**depth, K] f32 — log class distribution


# ---------------------------------------------------------------------------
# Pipeline stages, batched over a leading collaborator axis C
# ---------------------------------------------------------------------------


def _histogram_stage(bin_idx, leaf, wy, n_leaves: int, n_bins: int) -> torch.Tensor:
    """[C, L, d, B+1, K] level histogram: ONE kernel launch for all C."""
    return ops.tree_hist(bin_idx, leaf, wy, n_leaves=n_leaves, n_bins_p1=n_bins + 1)


def _split_scores(C: torch.Tensor) -> torch.Tensor:
    """Score every (feature, bin) split candidate.

    C: [..., L, d, B+1, K].  Splitting at bin b sends bins > b right.
    Returns [..., d, B] scores (higher = better)."""
    totals = torch.sum(C, dim=-2, keepdim=True)  # [..., L, d, 1, K]
    right = totals - torch.cumsum(C, dim=-2)  # inclusive cumsum -> strictly greater
    right = right[..., :-1, :]  # candidates b in [0, B)
    left = totals - right

    def purity(side):  # sum_k c_k^2 / c_tot, guarded for empty sides
        tot = torch.sum(side, dim=-1)
        sq = torch.sum(side * side, dim=-1) / torch.clamp_min(tot, 1e-12)
        return torch.where(tot > 0, sq, torch.zeros_like(sq))

    return torch.sum(purity(left) + purity(right), dim=-3)  # over leaves


def _select_stage(C: torch.Tensor, edges: torch.Tensor, n_bins: int):
    """Each collaborator's split: (f, b, threshold), each [C].

    ``argmax`` returns the first maximum, as ``jnp.argmax`` does."""
    scores = _split_scores(C)  # [C, d, B]
    flat = torch.argmax(scores.flatten(1), dim=1)  # [C]
    f, b = flat // n_bins, flat % n_bins
    thr = torch.gather(edges.flatten(1), 1, flat.unsqueeze(1)).squeeze(1)
    return f.to(torch.int32), b.to(torch.int32), thr


def _descend_stage(bin_idx: torch.Tensor, leaf: torch.Tensor, f, b) -> torch.Tensor:
    """Advance every sample one level down: leaf [C, n] in [0, L) -> [0, 2L)."""
    C, n, _ = bin_idx.shape
    col = torch.gather(bin_idx, 2, f.long().view(C, 1, 1).expand(C, n, 1)).squeeze(2)
    return leaf * 2 + (col > b.view(C, 1)).to(torch.int32)


def _leaf_stage(wy: torch.Tensor, leaf: torch.Tensor, depth: int) -> torch.Tensor:
    """[C, 2**depth, K] leaf log class distributions."""
    C, n, K = wy.shape
    counts = torch.zeros(C, 2**depth, K, dtype=wy.dtype, device=wy.device)
    counts.scatter_add_(1, leaf.long().unsqueeze(-1).expand(C, n, K), wy)
    tot = torch.sum(counts, dim=-1, keepdim=True)
    # Empty leaves fall back to the collaborator's global class prior.
    prior = torch.sum(wy, dim=1) / torch.clamp_min(torch.sum(wy, dim=(1, 2)), 1e-12).unsqueeze(-1)
    dist = torch.where(tot > 0, counts / torch.clamp_min(tot, 1e-12), prior.unsqueeze(1))
    return torch.log(dist + 1e-12)


# ---------------------------------------------------------------------------
# Fit: collaborator-batched, and the single fit as its C = 1 case
# ---------------------------------------------------------------------------


def fit_tree_batched(
    spec: LearnerSpec,
    X: torch.Tensor,  # [C, n, d]
    y: torch.Tensor,  # [C, n]
    w: torch.Tensor,  # [C, n]
    cache: BinnedDataset | None = None,  # [C, ...]-batched
) -> TreeParams:
    """Fit all C collaborators' trees as one tensor program: per level,
    one ``tree_hist`` launch builds every collaborator's histogram."""
    depth = spec.hp("depth", 4)
    n_bins = spec.hp("n_bins", 16)
    if cache is None:
        cache = bin_dataset(X, n_bins)
    bin_idx, edges = cache.bin_idx, cache.edges  # [C, n, d], [C, d, B]
    wy = weighted_onehot(y, w, spec.n_classes)  # [C, n, K]

    leaf = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
    feats, thrs = [], []
    for level in range(depth):
        hist = _histogram_stage(bin_idx, leaf, wy, 2**level, n_bins)  # [C, L, d, B+1, K]
        f, b, thr = _select_stage(hist, edges, n_bins)
        feats.append(f)
        thrs.append(thr)
        leaf = _descend_stage(bin_idx, leaf, f, b)

    return TreeParams(
        feature=torch.stack(feats, dim=1),  # [C, depth]
        threshold=torch.stack(thrs, dim=1),
        leaf_logits=_leaf_stage(wy, leaf, depth),
    )


def fit_tree(spec, params, X, y, w, *, cache: BinnedDataset | None = None) -> TreeParams:
    """Fit one tree from [n, ...] inputs (trees fit from scratch: ``params``
    is ignored)."""
    del params
    if cache is not None:
        cache = BinnedDataset(cache.edges[None], cache.bin_idx[None])
    out = fit_tree_batched(spec, X[None], y[None], w[None], cache)
    return TreeParams(*(t[0] for t in out))


def init_tree(spec: LearnerSpec, device) -> TreeParams:
    depth = spec.hp("depth", 4)
    return TreeParams(
        feature=torch.zeros(depth, dtype=torch.int32, device=device),
        threshold=torch.zeros(depth, dtype=torch.float32, device=device),
        leaf_logits=torch.zeros(2**depth, spec.n_classes, dtype=torch.float32, device=device),
    )


def tree_predict_logits(spec: LearnerSpec, params: TreeParams, X: torch.Tensor) -> torch.Tensor:
    """Leaf logits of every sample.

    params [depth] (one tree) or [H, depth] (a hypothesis stack);
    X [..., n, d] -> [..., n, K] or [..., H, n, K]."""
    single = params.feature.dim() == 1
    if single:
        params = TreeParams(*(t[None] for t in params))
    H, depth = params.feature.shape
    leaf = torch.zeros(X.shape[:-1] + (H,), dtype=torch.long, device=X.device)  # [..., n, H]
    for level in range(depth):
        col = X[..., params.feature[:, level].long()]  # [..., n, H]
        leaf = leaf * 2 + (col > params.threshold[:, level]).long()
    leaf = leaf.transpose(-1, -2)  # [..., H, n]
    out = params.leaf_logits[torch.arange(H, device=X.device).unsqueeze(-1), leaf]
    return out.squeeze(-3) if single else out


def tree_precompute(spec: LearnerSpec, X: torch.Tensor) -> BinnedDataset:
    """Shard-static fit precomputation: quantile edges + bin indices."""
    return bin_dataset(X, spec.hp("n_bins", 16))


decision_tree = register(
    WeakLearner(
        "decision_tree", init_tree, fit_tree, tree_predict_logits,
        precompute=tree_precompute, fit_batched=fit_tree_batched,
    )
)
