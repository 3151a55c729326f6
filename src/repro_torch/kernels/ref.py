"""Plain PyTorch versions of the kernels on the ported path.

Each function is the semantic ground truth its CUDA kernel is held to
(``chip_smoke.py`` on the card) and the code the kernel wrappers run for
tensors on the CPU.  They answer to ``repro/kernels/ref.py``:

* ``tree_hist_ref`` / ``tree_hist_batched_ref`` — a segment-sum
  (``index_add_``) over combined (collaborator, leaf, feature, bin) ids;
* ``weighted_errors_ref`` — a last-axis ``sum(mis * w, -1)``, not a
  matvec, with an optional leading ``[C]`` batch;
* ``boost_weight_update_ref`` — ``w * exp(alpha * mis) * mask``.

``device_calls`` counts calls made on CUDA tensors, so a run on the card
can show that its main path never took a plain version.
"""
from __future__ import annotations

from typing import Dict

import torch

device_calls: Dict[str, int] = {"tree_hist": 0, "weighted_errors": 0, "weight_update": 0}


def _note(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        device_calls[name] += 1


def tree_hist_batched_ref(
    bin_idx: torch.Tensor,  # [H, n, d] int in [0, n_bins]
    leaf: torch.Tensor,  # [H, n] int in [0, n_leaves)
    wy: torch.Tensor,  # [H, n, K] f32 weighted one-hot labels
    n_leaves: int,
    n_bins_p1: int,
) -> torch.Tensor:
    """[H, L, d, B+1, K] weighted class histogram, one ``index_add_``.

    The collaborator index is folded into the segment id, so each
    segment receives its samples in increasing sample order, as the
    per-slice JAX oracle under ``vmap`` does."""
    _note("tree_hist", wy)
    H, n, d = bin_idx.shape
    K = wy.shape[-1]
    dev = bin_idx.device
    h = torch.arange(H, device=dev).view(H, 1, 1)
    f = torch.arange(d, device=dev).view(1, 1, d)
    seg = ((h * n_leaves + leaf.long().unsqueeze(-1)) * d + f) * n_bins_p1 + bin_idx.long()
    out = torch.zeros(H * n_leaves * d * n_bins_p1, K, dtype=wy.dtype, device=dev)
    out.index_add_(0, seg.reshape(-1), wy.unsqueeze(2).expand(H, n, d, K).reshape(-1, K))
    return out.view(H, n_leaves, d, n_bins_p1, K)


def tree_hist_ref(
    bin_idx: torch.Tensor,  # [n, d]
    leaf: torch.Tensor,  # [n]
    wy: torch.Tensor,  # [n, K]
    n_leaves: int,
    n_bins_p1: int,
) -> torch.Tensor:
    """[L, d, B+1, K] — the single-fit case of :func:`tree_hist_batched_ref`."""
    return tree_hist_batched_ref(bin_idx[None], leaf[None], wy[None], n_leaves, n_bins_p1)[0]


def weighted_errors_ref(
    preds: torch.Tensor,  # [..., H, n] int
    y: torch.Tensor,  # [..., n] int
    w: torch.Tensor,  # [..., n] f32 (mask folded in)
) -> torch.Tensor:
    """eps[..., h] = sum_n w_n * 1[preds[..., h, n] != y_n]; [..., H] f32.

    A row sum, not a matvec: each row reduces on its own, whatever the
    batch around it."""
    _note("weighted_errors", w)
    mis = (preds != y.unsqueeze(-2)).to(w.dtype)
    return torch.sum(mis * w.unsqueeze(-2), dim=-1)


def boost_weight_update_ref(
    w: torch.Tensor,  # [n] f32
    mis: torch.Tensor,  # [n] f32 — 1[chosen mispredicts]
    mask: torch.Tensor,  # [n] f32
    alpha: torch.Tensor,  # scalar f32
) -> torch.Tensor:
    """w * exp(alpha * mis) * mask (renormalisation happens globally)."""
    _note("weight_update", w)
    return w * torch.exp(alpha * mis) * mask
