"""The AdaBoost.F inner-loop kernels (paper steps 3-4):

* ``weighted_errors`` — eps[c, h] = sum_n w[c, n] * 1[preds[c, h, n] != y[c, n]],
  one launch over the round's whole ``[C, H, n]`` prediction tensor (AdaBoost.F's
  H = C rows, PreWeak.F's C*T): a warp per (row, sample slice), the rows
  split over the grid and each row's slices over a thread-block cluster,
  reduced through distributed shared memory;
* ``weight_update`` — w * exp(alpha * mis) * mask, renormalised to sum 1
  (its total clamped at 1e-30), one thread-block cluster over the whole
  vector reduced through distributed shared memory, with ``alpha`` read
  on the device;
* ``weight_update_product`` — the product w * exp(alpha * mis) * mask alone,
  a grid-stride elementwise pass: the interpreted round's update of one
  collaborator's weights, renormalised afterwards from a total taken on
  the host (``renormalize=False`` in ``core/scoring.py:update_weights``).

Answers to ``repro/kernels/boost_update.py`` (``weight_update`` together
with the renormalisation of ``repro/core/scoring.py:update_weights``).
On CUDA tensors each wrapper launches its kernel from
``csrc/boost_update.cu`` or raises; on CPU tensors it runs the plain
version in ``ref.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.tree_hist import SMS

UPDATE_CLUSTER = 16  # weight_update: CTAs of its one cluster (the non-portable size)
UPDATE_REGISTERS = 8  # products a thread keeps in registers (csrc: UPDATE_REGS)
ERRORS_CLUSTER = 8  # weighted_errors: CTAs per cluster at most (the portable size)
ERRORS_ROWS = 8  # rows per CTA, a warp each
ERRORS_WARPS = SMS * 32  # the sample slices grow until the grid holds this many warps
MIN_THREADS, MAX_THREADS = 64, 1024  # per CTA of weight_update
PRODUCT_THREADS = 256  # per CTA of weight_update_product


def _cta_threads(n: int, cs: int) -> int:
    """Whole warps, a thread for each of a CTA's ceil(n / cs) elements, from 64 up to 1024."""
    per_cta = -(-n // cs)
    return min(MAX_THREADS, max(MIN_THREADS, 32 * -(-per_cta // 32)))


class ErrorsPlan(NamedTuple):
    cs: int  # CTAs per cluster, splitting each row's n samples into cs slices
    rows: int  # rows per CTA, a warp each (32 * rows threads)


def errors_plan(C: int, H: int, n: int) -> ErrorsPlan:
    """A warp per (row, sample slice), CTAs of 8 rows, and clusters that
    split each row's samples into the fewest slices (1 to 8) that give the
    grid 32 warps an SM, so that a warp reads as long a slice as the
    card's occupancy allows: AdaBoost.F's 64 rows at adult take 8 slices a
    row, PreWeak.F's 6 400 at T = 100 one.  Shared memory holds one float
    a warp, so H has no cap."""
    cs = 1
    while cs < ERRORS_CLUSTER and C * H * cs < ERRORS_WARPS:
        cs *= 2
    return ErrorsPlan(cs, ERRORS_ROWS)


class UpdatePlan(NamedTuple):
    cs: int  # CTAs in the one cluster
    threads: int  # threads per CTA


def update_plan(N: int) -> UpdatePlan:
    """One cluster of 16 CTAs over the whole ``[N]`` vector, with a thread
    per element up to 1024 a CTA (whole warps, at least 64); past 16 384
    elements each thread takes ``ceil(N / 16384)``, the first 8 of them in
    registers."""
    return UpdatePlan(UPDATE_CLUSTER, _cta_threads(N, UPDATE_CLUSTER))


class ProductPlan(NamedTuple):
    blocks: int
    threads: int  # per CTA


def product_plan(N: int) -> ProductPlan:
    """A thread an element in CTAs of 256, at most 8 CTAs an SM; past that
    each thread strides over the vector."""
    return ProductPlan(max(1, min(-(-N // PRODUCT_THREADS), 8 * SMS)), PRODUCT_THREADS)


def _same_device(name: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: all tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def weighted_errors(
    preds: torch.Tensor,  # [C, H, n] int32
    y: torch.Tensor,  # [C, n] int32
    w: torch.Tensor,  # [C, n] float32, mask folded in
) -> torch.Tensor:
    """[C, H] weighted misprediction mass."""
    dev = _same_device("weighted_errors", preds, y, w)
    if preds.dtype != torch.int32 or y.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(
            f"weighted_errors takes int32 preds/y and float32 w; got "
            f"{preds.dtype}, {y.dtype}, {w.dtype}"
        )
    if preds.dim() != 3 or y.shape != (preds.shape[0], preds.shape[2]) or w.shape != y.shape:
        raise ValueError(
            f"weighted_errors takes [C, H, n] preds and [C, n] y and w; got "
            f"{tuple(preds.shape)}, {tuple(y.shape)}, {tuple(w.shape)}"
        )
    if not (preds.is_contiguous() and y.is_contiguous() and w.is_contiguous()):
        raise ValueError("weighted_errors takes contiguous tensors")
    if dev.type == "cpu":
        return ref.weighted_errors_ref(preds, y, w)
    C, H, n = preds.shape
    out = torch.empty(C, H, dtype=torch.float32, device=dev)  # every element is written: no memset
    if C * H > 0:
        plan = errors_plan(C, H, n)
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.repro_weighted_errors(
                preds.data_ptr(), y.data_ptr(), w.data_ptr(), out.data_ptr(),
                C, H, n, plan.cs, plan.rows, stream,
            )
        _build.check(rc, "weighted_errors")
        _build.count(weighted_errors)
    return out


def weight_update(
    w: torch.Tensor,  # [N] float32
    mis: torch.Tensor,  # [N] float32
    mask: torch.Tensor,  # [N] float32
    alpha: torch.Tensor,  # scalar float32, on the same device
) -> torch.Tensor:
    """p / max(sum(p), 1e-30) with p = w * exp(alpha * mis) * mask; [N]
    float32.  Answers to the Pallas ``weight_update`` followed by the
    renormalisation at ``repro/core/scoring.py:136-138``."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=w.device)
    dev = _same_device("weight_update", w, mis, mask, alpha)
    if any(t.dtype != torch.float32 for t in (w, mis, mask)):
        raise TypeError("weight_update takes float32 w, mis and mask")
    if w.dim() != 1 or mis.shape != w.shape or mask.shape != w.shape or alpha.numel() != 1:
        raise ValueError(
            f"weight_update takes [N] w/mis/mask and a scalar alpha; got "
            f"{tuple(w.shape)}, {tuple(mis.shape)}, {tuple(mask.shape)}, {tuple(alpha.shape)}"
        )
    if not (w.is_contiguous() and mis.is_contiguous() and mask.is_contiguous()):
        raise ValueError("weight_update takes contiguous tensors")
    if dev.type == "cpu":
        return ref.renormalised_weight_update_ref(w, mis, mask, alpha)
    out = torch.empty_like(w)  # every element is written: no memset
    N = w.numel()
    if N > 0:
        plan = update_plan(N)
        alpha = alpha.reshape(1).contiguous()
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.repro_weight_update(
                w.data_ptr(), mis.data_ptr(), mask.data_ptr(), alpha.data_ptr(),
                out.data_ptr(), N, plan.cs, plan.threads, stream,
            )
        _build.check(rc, "weight_update")
        _build.count(weight_update)
    return out


def weight_update_product(
    w: torch.Tensor,  # [N] float32
    mis: torch.Tensor,  # [N] float32
    mask: torch.Tensor,  # [N] float32
    alpha: torch.Tensor,  # scalar float32, on the same device
) -> torch.Tensor:
    """w * exp(alpha * mis) * mask, [N] float32: the Pallas
    ``weight_update`` body alone (``renormalize=False``)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=w.device)
    dev = _same_device("weight_update_product", w, mis, mask, alpha)
    if any(t.dtype != torch.float32 for t in (w, mis, mask)):
        raise TypeError("weight_update_product takes float32 w, mis and mask")
    if w.dim() != 1 or mis.shape != w.shape or mask.shape != w.shape or alpha.numel() != 1:
        raise ValueError(
            f"weight_update_product takes [N] w/mis/mask and a scalar alpha; got "
            f"{tuple(w.shape)}, {tuple(mis.shape)}, {tuple(mask.shape)}, {tuple(alpha.shape)}"
        )
    if not (w.is_contiguous() and mis.is_contiguous() and mask.is_contiguous()):
        raise ValueError("weight_update_product takes contiguous tensors")
    if dev.type == "cpu":
        return ref.boost_weight_update_ref(w, mis, mask, alpha)
    out = torch.empty_like(w)  # every element is written: no memset
    N = w.numel()
    if N > 0:
        plan = product_plan(N)
        alpha = alpha.reshape(1).contiguous()
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.repro_weight_update_product(
                w.data_ptr(), mis.data_ptr(), mask.data_ptr(), alpha.data_ptr(),
                out.data_ptr(), N, plan.blocks, plan.threads, stream,
            )
        _build.check(rc, "weight_update_product")
        _build.count(weight_update_product)
    return out


weighted_errors.launches = 0  # kernel launches since the last reset
weighted_errors.captures = 0  # calls captured into a CUDA graph
weight_update.launches = 0
weight_update.captures = 0
weight_update_product.launches = 0
weight_update_product.captures = 0
