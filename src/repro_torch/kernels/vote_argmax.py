"""``vote_argmax`` — the serving reduction:

  pred[n] = argmax_k sum_t alpha_t * 1[preds[t, n] == k]

the alpha-weighted majority vote that turns the ensemble members' class
predictions into the strong hypothesis's answer.  Every served batch ends
in one call (``serve/engine.py``).

Answers to ``repro/kernels/vote_argmax.py``.  On CUDA tensors the wrapper
launches the hand-written kernel in ``csrc/vote_argmax.cu`` (a strip of 8
samples a block, the members staged in shared memory by ``cp.async``, a
thread per (sample, class) summing in registers; the source note gives its
bound and design) or raises; on CPU tensors it runs the plain version,
``ref.vote_argmax_ref``.  Unused members vote with ``alpha == 0``; a
prediction outside ``[0, n_classes)`` votes for nothing; ties go to the
lowest class index.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

STRIP = 8  # samples per block (csrc: STRIP)
MEMBER_TILE = 128  # members staged per shared-memory tile, double-buffered (csrc: MEMBER_TILE)
MAX_THREADS = 1024
CLASSES_PER_THREAD = (1, 2, 4, 8, 16)  # the kernel's template instances
MAX_CLASSES = MAX_THREADS // STRIP * CLASSES_PER_THREAD[-1]
# static shared memory per block: two [MEMBER_TILE, STRIP] int32 tiles and
# their alphas, and a (value, class) pair per warp and sample for the argmax
SHARED_BYTES = 2 * MEMBER_TILE * (STRIP + 1) * 4 + 32 * STRIP * 8


class LaunchPlan(NamedTuple):
    strip: int  # samples per block
    classes_per_thread: int  # class sums a thread keeps in registers
    threads: int  # per block: STRIP * ceil(K / classes_per_thread), in whole warps
    shared_bytes: int  # static shared memory per block


def launch_plan(n_classes: int) -> LaunchPlan:
    """A thread per (sample, class) pair of an 8-sample strip, in whole
    warps; past 1024 threads (K > 128) each thread sums 2, 4, 8 or 16
    classes.  The shared memory does not grow with K: registers and the
    1024-thread block bound it, at 2048 classes."""
    for cpt in CLASSES_PER_THREAD:
        threads = 32 * -(-STRIP * -(-n_classes // cpt) // 32)
        if threads <= MAX_THREADS:
            return LaunchPlan(STRIP, cpt, threads, SHARED_BYTES)
    raise ValueError(
        f"vote_argmax: {n_classes} classes exceed the {MAX_CLASSES} a block sums: "
        f"{MAX_THREADS} threads of {CLASSES_PER_THREAD[-1]} register sums for {STRIP} samples "
        f"(shared memory, {SHARED_BYTES} B a block, is not the limit)"
    )


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
            T, n, n_classes, plan.classes_per_thread, plan.threads, stream,
        )
    _build.check(rc, "vote_argmax")
    _build.count(vote_argmax)
    return out


vote_argmax.launches = 0  # kernel launches since the last reset (CPU calls never count)
vote_argmax.captures = 0  # calls captured into a CUDA graph
