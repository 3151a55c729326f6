"""Plain PyTorch versions of the kernels on the ported path.

Each function is the semantic ground truth its CUDA kernel is held to
(``chip_smoke.py`` on the card) and the code the kernel wrappers run for
tensors on the CPU.  They answer to ``repro/kernels/ref.py``:

* ``tree_hist_ref`` / ``tree_hist_batched_ref`` — a segment-sum
  (``index_add_``) over combined (collaborator, leaf, feature, bin) ids;
* ``weighted_errors_ref`` — a last-axis ``sum(mis * w, -1)``, not a
  matvec, with an optional leading ``[C]`` batch;
* ``boost_weight_update_ref`` — ``w * exp(alpha * mis) * mask`` (the
  Pallas kernel's body), and ``renormalised_weight_update_ref`` — that
  product divided by its clamped total (the ``weight_update`` kernel);
* ``vote_argmax_ref`` — a comparison one-hot (``one_hot``), an
  ``einsum`` over members and an ``argmax`` (first maximum);
* ``attention_ref`` — grouped-query attention with the whole ``[S, T]``
  logit matrix, masked with ``-1e30`` and a softmax, in float32.

``device_calls`` counts calls made on CUDA tensors, so a run on the card
can show that its main path never took a plain version.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

device_calls: Dict[str, int] = {
    "tree_hist": 0, "weighted_errors": 0, "weight_update": 0, "vote_argmax": 0,
    "flash_attention": 0,
}


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
    """w * exp(alpha * mis) * mask: the Pallas kernel's body, before the
    global renormalisation."""
    _note("weight_update", w)
    return w * torch.exp(alpha * mis) * mask


def renormalised_weight_update_ref(
    w: torch.Tensor,  # [N] f32
    mis: torch.Tensor,  # [N] f32
    mask: torch.Tensor,  # [N] f32
    alpha: torch.Tensor,  # scalar f32
) -> torch.Tensor:
    """The product renormalised to sum 1 (its total clamped at 1e-30), as
    ``repro/core/scoring.py:update_weights`` does after the kernel."""
    p = boost_weight_update_ref(w, mis, mask, alpha)
    return p / torch.clamp_min(torch.sum(p), 1e-30)


def one_hot(x: torch.Tensor, n_classes: int, dtype: torch.dtype) -> torch.Tensor:
    """[...] class indices -> [..., K] one-hot of ``dtype``, by comparison
    with ``arange(K)``: a value outside ``[0, K)`` gives a zero row, as
    ``jax.nn.one_hot`` does (``F.one_hot`` raises, and asserts on the card).
    Every vote tally and weighted label of the port is built with it."""
    return (x.unsqueeze(-1) == torch.arange(n_classes, device=x.device)).to(dtype)


def vote_argmax_ref(
    preds: torch.Tensor,  # [T, n] int — per-member class predictions
    alpha: torch.Tensor,  # [T] f32 — member weights (unused slots = 0)
    n_classes: int,
) -> torch.Tensor:
    """pred[n] = argmax_k sum_t alpha_t * 1[preds[t, n] == k]; [n] int32.

    A prediction outside ``[0, K)`` votes for nothing (:func:`one_hot`).
    The ``einsum`` may sum the members in any order."""
    _note("vote_argmax", alpha)
    votes = torch.einsum("t,tnk->nk", alpha, one_hot(preds, n_classes, alpha.dtype))
    return torch.argmax(votes, dim=-1).to(torch.int32)


def attention_ref(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,  # [B, Hkv, T, D]
    v: torch.Tensor,  # [B, Hkv, T, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,  # sliding-window size (None = full)
    softcap: Optional[float] = None,  # gemma2-style logit soft-capping
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention, float32 throughout, cast to ``q.dtype``.

    Query row ``i`` sits at absolute position ``i + T - S`` (chunked
    prefill against a longer cache).  A row that sees no key at all
    (causal with S > T) gets the mean of ``v``: its softmax runs over
    ``-1e30`` everywhere."""
    _note("flash_attention", q)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", qf, kf)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    i = torch.arange(S, device=q.device)[:, None] + (T - S)  # query absolute position
    j = torch.arange(T, device=q.device)[None, :]
    m = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        m &= j <= i
    if window is not None:
        m &= (i - j) < window
    logits = logits.masked_fill(~m, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vf).to(q.dtype)
