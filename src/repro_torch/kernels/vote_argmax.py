"""``vote_argmax`` — the serving reduction:

  pred[n] = argmax_k sum_t alpha_t * 1[preds[t, n] == k]

the alpha-weighted majority vote that turns the ensemble members' class
predictions into the strong hypothesis's answer.  Every served batch ends
in one call (``serve/engine.py``).

Answers to ``repro/kernels/vote_argmax.py``.  On CUDA tensors the wrapper
launches the hand-written kernel in ``csrc/vote_argmax.cu`` (one thread
per sample, the member loop inside the block; the source note gives its
bound and design) or raises; on CPU tensors it runs the plain version,
``ref.vote_argmax_ref``.  Unused members vote with ``alpha == 0``; a
prediction outside ``[0, n_classes)`` votes for nothing; ties go to the
lowest class index.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

THREADS = 256
DEFAULT_SHARED_BYTES = 48 * 1024  # dynamic shared memory a block gets without opting in
MAX_SHARED_BYTES = 227 * 1024 - 1024  # the opt-in limit less the kernel's static alpha tile


class LaunchPlan(NamedTuple):
    threads: int  # samples per block
    shared_bytes: int  # dynamic shared memory per block: votes[K][threads] f32


def launch_plan(n_classes: int) -> LaunchPlan:
    """The widest block (up to 256 threads, at least one warp) whose vote
    columns fit in 48 KB; a class count too large for even one warp there
    opts in to more, up to the card's 227 KB."""
    threads = THREADS
    while threads > 32 and n_classes * threads * 4 > DEFAULT_SHARED_BYTES:
        threads //= 2
    smem = n_classes * threads * 4
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"vote_argmax: {n_classes} classes need {smem} B of shared vote columns "
            f"for one warp, over the {MAX_SHARED_BYTES} B a block may have"
        )
    return LaunchPlan(threads, smem)


def _check_inputs(preds: torch.Tensor, alpha: torch.Tensor, n_classes: int) -> None:
    if preds.device != alpha.device:
        raise ValueError("vote_argmax: preds and alpha must be on one device")
    if preds.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vote_argmax: unsupported device {preds.device}")
    if preds.dtype != torch.int32 or alpha.dtype != torch.float32:
        raise TypeError(
            f"vote_argmax takes int32 preds and float32 alpha; got {preds.dtype}, {alpha.dtype}"
        )
    if preds.dim() != 2 or alpha.shape != (preds.shape[0],):
        raise ValueError(
            f"vote_argmax takes [T, n] preds and [T] alpha; got "
            f"{tuple(preds.shape)}, {tuple(alpha.shape)}"
        )
    if not (preds.is_contiguous() and alpha.is_contiguous()):
        raise ValueError("vote_argmax takes contiguous tensors")
    if n_classes < 1:
        raise ValueError(f"vote_argmax: n_classes must be positive, got {n_classes}")


def vote_argmax(
    preds: torch.Tensor,  # [T, n] int32 — per-member class predictions
    alpha: torch.Tensor,  # [T] float32 — member weights (unused slots = 0)
    *,
    n_classes: int,
) -> torch.Tensor:
    """[n] int32 winning class of each sample."""
    _check_inputs(preds, alpha, n_classes)
    if preds.device.type == "cpu":
        return ref.vote_argmax_ref(preds, alpha, n_classes)
    T, n = preds.shape
    out = torch.empty(n, dtype=torch.int32, device=preds.device)
    if n == 0:
        return out
    plan = launch_plan(n_classes)
    lib = _build.library()
    with torch.cuda.device(preds.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_vote_argmax(
            preds.data_ptr(), alpha.data_ptr(), out.data_ptr(),
            T, n, n_classes, plan.threads, stream,
        )
    _build.check(rc, "vote_argmax")
    vote_argmax.launches += 1
    return out


vote_argmax.launches = 0  # kernel launches since the last reset (CPU calls never count)
