"""Oblivious decision trees (answers to ``repro/learners/tree.py``):
``decision_tree`` and ``extra_tree``.

An oblivious tree applies one (feature, threshold) test per level, shared
by every node of the level, so a depth-``D`` tree has ``2**D`` leaves and
its fit is a fixed-shape tensor program.  The fit is staged:

  bin        quantile edges + bin indices, once per shard (the fit cache);
  histogram  the level's weighted class histogram C[leaf, feature, bin,
             class] — one ``tree_hist`` launch for all C collaborators;
  select     split scores from a reverse cumulative sum over bins; the
             best candidate maximises sum_leaf sum_side sum_k c_k^2 / c_tot
             (the same as minimising weighted Gini).  ``extra_tree`` scores
             only ``max_candidates`` (default 8) random candidates per
             collaborator and level, drawn without replacement from the
             d*B candidates (ExtraTrees-style);
  descend    every sample moves one level down;
  leaf       leaf log class distributions from a weighted segment sum.

Every stage takes the collaborator axis C as its leading dimension.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import one_hot
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


def _select_stage(C: torch.Tensor, edges: torch.Tensor, n_bins: int,
                  candidates: torch.Tensor | None = None):
    """Each collaborator's split: (f, b, threshold), each [C].

    ``candidates`` [C, d, B] bool restricts each collaborator to its random
    candidates: the others score ``-inf``, as ``repro/learners/tree.py``
    masks them.  ``argmax`` returns the first maximum, as ``jnp.argmax``
    does."""
    scores = _split_scores(C)  # [C, d, B]
    if candidates is not None:
        scores = scores.masked_fill(~candidates, float("-inf"))
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
    if wy.is_cuda:
        # a sum over the samples of a leaf mask: a float scatter-add on the
        # card accumulates through atomics in arrival order, so two fits of
        # the same data would differ in the last bits
        in_leaf = one_hot(leaf, 2**depth, wy.dtype)  # [C, n, L]
        counts = torch.sum(in_leaf.unsqueeze(-1) * wy.unsqueeze(-2), dim=1)  # [C, L, K]
    else:
        # sample by sample, the order of the JAX package's segment_sum: the
        # same bits, so a leaf whose classes tie votes as the JAX tree's does
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


def draw_candidates(spec: LearnerSpec, C: int, d: int, generator: torch.Generator,
                    device) -> torch.Tensor:
    """``extra_tree``'s split candidates: [C, depth, d, B] bool, for each
    collaborator and level ``max_candidates`` distinct entries of the d*B,
    uniformly without replacement (the first ``max_candidates`` of a random
    permutation).  Drawn on the host from ``generator`` in one call, then
    moved to ``device``: the card and the CPU draw the same masks."""
    depth, n_bins = spec.hp("depth", 4), spec.hp("n_bins", 16)
    m = min(spec.hp("max_candidates", 8), d * n_bins)
    keys = torch.rand(C, depth, d * n_bins, generator=generator)
    picked = torch.argsort(keys, dim=-1)[..., :m]
    mask = torch.zeros(C, depth, d * n_bins, dtype=torch.bool).scatter_(-1, picked, True)
    return mask.view(C, depth, d, n_bins).to(device)


def draw_extra_tree(spec: LearnerSpec, C: int, generator: torch.Generator, device) -> dict:
    """``extra_tree``'s draws for C fits, as ``fit_tree_batched`` takes them."""
    return {"candidates": draw_candidates(spec, C, spec.n_features, generator, device)}


def fit_tree_batched(
    spec: LearnerSpec,
    X: torch.Tensor,  # [C, n, d]
    y: torch.Tensor,  # [C, n]
    w: torch.Tensor,  # [C, n]
    cache: BinnedDataset | None = None,  # [C, ...]-batched
    *,
    generator: torch.Generator | None = None,
    candidates: torch.Tensor | None = None,  # [C, depth, d, B] bool, injected
    random_splits: bool = False,
) -> TreeParams:
    """Fit all C collaborators' trees as one tensor program: per level,
    one ``tree_hist`` launch builds every collaborator's histogram.

    ``random_splits`` (``extra_tree``) restricts each level's split to the
    ``candidates`` given, or else to ones drawn from ``generator``
    (:func:`draw_candidates`); without it the generator is not read."""
    depth = spec.hp("depth", 4)
    n_bins = spec.hp("n_bins", 16)
    if cache is None:
        cache = bin_dataset(X, n_bins)
    bin_idx, edges = cache.bin_idx, cache.edges  # [C, n, d], [C, d, B]
    wy = weighted_onehot(y, w, spec.n_classes)  # [C, n, K]
    if random_splits and candidates is None:
        if generator is None:
            raise ValueError("extra_tree draws its split candidates: pass a generator or candidates")
        candidates = draw_candidates(spec, y.shape[0], X.shape[-1], generator, y.device)

    leaf = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
    feats, thrs = [], []
    for level in range(depth):
        hist = _histogram_stage(bin_idx, leaf, wy, 2**level, n_bins)  # [C, L, d, B+1, K]
        f, b, thr = _select_stage(hist, edges, n_bins,
                                  None if candidates is None else candidates[:, level])
        feats.append(f)
        thrs.append(thr)
        leaf = _descend_stage(bin_idx, leaf, f, b)

    return TreeParams(
        feature=torch.stack(feats, dim=1),  # [C, depth]
        threshold=torch.stack(thrs, dim=1),
        leaf_logits=_leaf_stage(wy, leaf, depth),
    )


def fit_tree(spec, params, X, y, w, *, cache: BinnedDataset | None = None,
             generator: torch.Generator | None = None, random_splits: bool = False) -> TreeParams:
    """Fit one tree from [n, ...] inputs (trees fit from scratch: ``params``
    is ignored)."""
    del params
    if cache is not None:
        cache = BinnedDataset(cache.edges[None], cache.bin_idx[None])
    out = fit_tree_batched(spec, X[None], y[None], w[None], cache, generator=generator,
                           random_splits=random_splits)
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

# the same tree, its split scored over random candidates only; prediction
# is decision_tree's
extra_tree = register(
    WeakLearner(
        "extra_tree", init_tree, functools.partial(fit_tree, random_splits=True),
        tree_predict_logits, precompute=tree_precompute,
        fit_batched=functools.partial(fit_tree_batched, random_splits=True),
        draw=draw_extra_tree,
    )
)
