"""``tree_hist`` — the weighted class histogram of one tree level, the
compute hot spot of oblivious-tree fitting (``learners/tree.py``).

Answers to ``repro/kernels/tree_hist.py``.  On a CUDA tensor the wrapper
launches the hand-written kernel in ``csrc/tree_hist.cu`` (thread-block
clusters along the sample axis, each CTA an integer fixed-point atomic
scatter-add into shared memory, reduced across the cluster through
distributed shared memory; the source note gives its bound and design)
or raises; on a CPU tensor it runs the plain version,
``ref.tree_hist_batched_ref``.  The leading batch axis is the C
collaborators of one round, so a batched fit makes one launch per level.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

MAX_FEATURES_PER_BLOCK = 8  # a sample's bins of one block live in registers (csrc: kMaxFeatures)
CLUSTER = 4  # CTAs per cluster, unless a wave cannot hold the grid (at most 8, the portable size)
MAX_SHARED_BYTES = 227 * 1024  # dynamic shared memory one H100 block may opt in to
SMS = 132  # streaming multiprocessors of an H100 SXM
SM_THREADS = 2048  # resident threads per SM
SM_REGISTERS = 65536  # 32-bit registers per SM
REGISTERS = 64  # per thread: the kernel's __launch_bounds__(1024) caps it there
SM_SHARED_BYTES = 228 * 1024  # shared memory per SM, of which each block reserves 1 KB
BLOCK_RESERVED_BYTES = 1024
MIN_THREADS, MAX_THREADS = 64, 1024


class LaunchPlan(NamedTuple):
    dblk: int  # features per CTA
    cs: int  # CTAs per cluster, splitting the samples of one feature block
    threads: int  # threads per CTA
    shared_bytes: int  # dynamic shared memory per CTA


def shared_bytes(n_leaves: int, n_bins_p1: int, K: int, dblk: int) -> int:
    """The histogram in int32, padded to 16 bytes, and a float per warp."""
    return 16 * -(-(n_leaves * dblk * n_bins_p1 * K) // 4) + 4 * MAX_THREADS // 32


def blocks_per_sm(threads: int, shared: int) -> int:
    """CTAs of ``threads`` threads and ``shared`` bytes one SM holds at
    once, by threads, registers and shared memory."""
    return min(SM_THREADS // threads, SM_REGISTERS // (REGISTERS * threads),
               SM_SHARED_BYTES // (shared + BLOCK_RESERVED_BYTES), 32)


def _warps(x: int) -> int:
    return min(MAX_THREADS, max(MIN_THREADS, 32 * -(-x // 32)))


def launch_plan(H: int, n: int, d: int, n_leaves: int, n_bins_p1: int, K: int) -> LaunchPlan:
    """CTA shape for one launch: the fewest balanced feature blocks of at
    most 8 whose histogram fits in 227 KB of shared memory; clusters of 4
    CTAs with a thread for each sample of their range (up to 1024); then,
    until the grid fits in one wave (every CTA resident at once), half the
    threads, down to 256, and then half the cluster."""
    cap = min(d, MAX_FEATURES_PER_BLOCK)
    while cap >= 1 and shared_bytes(n_leaves, n_bins_p1, K, cap) > MAX_SHARED_BYTES:
        cap -= 1
    if cap < 1:
        raise ValueError(
            f"one feature's histogram ({n_leaves} leaves x {n_bins_p1} bins x {K} "
            f"classes) exceeds {MAX_SHARED_BYTES} B of shared memory"
        )
    dblk = -(-d // -(-d // cap))  # balanced blocks
    smem = shared_bytes(n_leaves, n_bins_p1, K, dblk)
    ctas = H * -(-d // dblk)
    cs, threads = CLUSTER, _warps(-(-n // CLUSTER))

    def fits():
        return ctas * cs <= SMS * blocks_per_sm(threads, smem)

    while not fits() and threads > 256:
        threads = _warps(threads // 2)
    while not fits() and cs > 1:
        cs //= 2
    return LaunchPlan(dblk, cs, threads, smem)


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
    # every cell is written by the kernel: no memset
    out = torch.empty(H, n_leaves, d, n_bins_p1, K, dtype=torch.float32, device=wy.device)
    if out.numel() == 0:
        return out
    plan = launch_plan(H, n, d, n_leaves, n_bins_p1, K)
    lib = _build.library()
    with torch.cuda.device(wy.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_tree_hist(
            bin_idx.data_ptr(), leaf.data_ptr(), wy.data_ptr(), out.data_ptr(),
            H, n, d, n_leaves, n_bins_p1, K, plan.dblk, plan.cs, plan.threads, stream,
        )
    _build.check(rc, "tree_hist")
    _build.count(tree_hist)
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
tree_hist.captures = 0  # calls captured into a CUDA graph
