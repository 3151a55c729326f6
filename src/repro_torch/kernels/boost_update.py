"""The AdaBoost.F inner-loop kernels (paper steps 3-4):

* ``weighted_errors`` — eps[c, h] = sum_n w[c, n] * 1[preds[c, h, n] != y[c, n]],
  one launch over the round's whole ``[C, H, n]`` prediction tensor;
* ``weight_update`` — w * exp(alpha * mis) * mask, elementwise, with
  ``alpha`` read on the device.

Answers to ``repro/kernels/boost_update.py``.  On CUDA tensors each
wrapper launches its kernel from ``csrc/boost_update.cu`` or raises; on
CPU tensors it runs the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

THREADS = 256
MAX_UPDATE_BLOCKS = 132 * 8  # grid-stride beyond this


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
    out = torch.zeros(C, H, dtype=torch.float32, device=dev)
    if C * H > 0 and n > 0:
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.repro_weighted_errors(
                preds.data_ptr(), y.data_ptr(), w.data_ptr(), out.data_ptr(),
                C, H, n, THREADS, stream,
            )
        _build.check(rc, "weighted_errors")
        weighted_errors.launches += 1
    return out


def weight_update(
    w: torch.Tensor,  # [N] float32
    mis: torch.Tensor,  # [N] float32
    mask: torch.Tensor,  # [N] float32
    alpha: torch.Tensor,  # scalar float32, on the same device
) -> torch.Tensor:
    """w * exp(alpha * mis) * mask; [N] float32."""
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
        return ref.boost_weight_update_ref(w, mis, mask, alpha)
    out = torch.empty_like(w)
    N = w.numel()
    if N > 0:
        blocks = min(-(-N // THREADS), MAX_UPDATE_BLOCKS)
        alpha = alpha.reshape(1).contiguous()
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.repro_weight_update(
                w.data_ptr(), mis.data_ptr(), mask.data_ptr(), alpha.data_ptr(),
                out.data_ptr(), N, blocks, THREADS, stream,
            )
        _build.check(rc, "weight_update")
        weight_update.launches += 1
    return out


weighted_errors.launches = 0  # kernel launches since the last reset
weight_update.launches = 0
