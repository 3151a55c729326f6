"""``tree_hist`` — the weighted class histogram of one tree level, the
compute hot spot of oblivious-tree fitting (``learners/tree.py``).

Answers to ``repro/kernels/tree_hist.py``.  On a CUDA tensor the wrapper
launches the hand-written kernel in ``csrc/tree_hist.cu`` (a shared-memory
atomic scatter-add; the source note gives its bound and design) or
raises; on a CPU tensor it runs the plain version,
``ref.tree_hist_batched_ref``.  The leading batch axis is the C
collaborators of one round, so a batched fit makes one launch per level.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

THREADS = 256
MAX_FEATURES_PER_BLOCK = 8
MAX_SHARED_BYTES = 227 * 1024  # dynamic shared memory one H100 block may opt in to
TARGET_BLOCKS = 4 * 132  # a few blocks per SM on a 132-SM card
MIN_SAMPLES_PER_CHUNK = 128


class LaunchPlan(NamedTuple):
    dblk: int  # features per block
    n_chunks: int  # sample chunks per (collaborator, feature block)
    shared_bytes: int  # dynamic shared memory per block


def launch_plan(H: int, n: int, d: int, n_leaves: int, n_bins_p1: int, K: int) -> LaunchPlan:
    """Block shape for one launch: as many features per block (up to 8)
    as 227 KB of shared histogram allow, then enough sample chunks that
    the grid holds a few hundred blocks."""
    per_feature = n_leaves * n_bins_p1 * K * 4
    dblk = min(d, MAX_FEATURES_PER_BLOCK, MAX_SHARED_BYTES // per_feature)
    if dblk < 1:
        raise ValueError(
            f"one feature's histogram ({n_leaves} leaves x {n_bins_p1} bins x {K} "
            f"classes = {per_feature} B) exceeds {MAX_SHARED_BYTES} B of shared memory"
        )
    blocks = H * -(-d // dblk)
    n_chunks = max(1, min(-(-n // MIN_SAMPLES_PER_CHUNK), -(-TARGET_BLOCKS // blocks)))
    return LaunchPlan(dblk, n_chunks, n_leaves * dblk * n_bins_p1 * K * 4)


def _check_inputs(bin_idx, leaf, wy):
    if not (bin_idx.device == leaf.device == wy.device):
        raise ValueError("tree_hist: bin_idx, leaf and wy must be on one device")
    if bin_idx.dtype != torch.int32 or leaf.dtype != torch.int32 or wy.dtype != torch.float32:
        raise TypeError(
            f"tree_hist takes int32 bin_idx, int32 leaf, float32 wy; got "
            f"{bin_idx.dtype}, {leaf.dtype}, {wy.dtype}"
        )
    if bin_idx.dim() != 3:
        raise ValueError(f"tree_hist takes a batched [H, n, d] bin_idx; got {tuple(bin_idx.shape)}")
    H, n, d = bin_idx.shape
    if leaf.shape != (H, n) or wy.dim() != 3 or wy.shape[:2] != (H, n):
        raise ValueError(
            f"tree_hist shapes disagree: bin_idx {tuple(bin_idx.shape)}, "
            f"leaf {tuple(leaf.shape)}, wy {tuple(wy.shape)}"
        )
    if not (bin_idx.is_contiguous() and leaf.is_contiguous() and wy.is_contiguous()):
        raise ValueError("tree_hist takes contiguous tensors")


def _launch(bin_idx, leaf, wy, n_leaves: int, n_bins_p1: int) -> torch.Tensor:
    H, n, d = bin_idx.shape
    K = wy.shape[2]
    out = torch.zeros(H, n_leaves, d, n_bins_p1, K, dtype=torch.float32, device=wy.device)
    if out.numel() == 0 or n == 0:
        return out
    plan = launch_plan(H, n, d, n_leaves, n_bins_p1, K)
    lib = _build.library()
    with torch.cuda.device(wy.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_tree_hist(
            bin_idx.data_ptr(), leaf.data_ptr(), wy.data_ptr(), out.data_ptr(),
            H, n, d, n_leaves, n_bins_p1, K, plan.dblk, plan.n_chunks, THREADS, stream,
        )
    _build.check(rc, "tree_hist")
    tree_hist.launches += 1
    return out


def tree_hist(
    bin_idx: torch.Tensor,  # [H, n, d] int32 in [0, n_bins]
    leaf: torch.Tensor,  # [H, n] int32 in [0, n_leaves)
    wy: torch.Tensor,  # [H, n, K] float32
    *,
    n_leaves: int,
    n_bins_p1: int,
) -> torch.Tensor:
    """C[H, L, d, B+1, K]."""
    _check_inputs(bin_idx, leaf, wy)
    if bin_idx.device.type == "cpu":
        return ref.tree_hist_batched_ref(bin_idx, leaf, wy, n_leaves, n_bins_p1)
    if bin_idx.device.type == "cuda":
        return _launch(bin_idx, leaf, wy, n_leaves, n_bins_p1)
    raise ValueError(f"tree_hist: unsupported device {bin_idx.device}")


tree_hist.launches = 0  # kernel launches since the last reset (CPU calls never count)
