"""``flash_attention`` — blockwise online-softmax attention with grouped
KV heads, causal masking, a sliding window and logit soft-capping: the
attention of every full-sequence pass of the LLM path
(``models/attention.py:attend_full``), once per layer of a prefill.

Answers to ``repro/kernels/flash_attention.py``.  On CUDA tensors the
wrapper launches a hand-written kernel or raises; the dtype picks it:

* bfloat16: ``csrc/flash_attention_sm90.cu``, TMA loads into swizzled
  shared memory and ``wgmma`` on bf16 tiles with float32 accumulators.
  TMA needs 16-byte aligned base addresses and strides, so a view it
  cannot describe raises (:func:`check_tma_views`); nothing is copied;
* float32: ``csrc/flash_attention.cu``, float32 on the CUDA cores (TF32
  tensor cores would keep about three decimal digits).

The source notes give each kernel's bound and design.  On CPU tensors the
wrapper runs the plain version, ``ref.attention_ref``.  Block sizes are
the kernels' own: the JAX ``block_q``/``block_k`` arguments have no
counterpart.

Query row ``i`` sits at absolute position ``i + T - S``, so a chunk of
queries attends causally against a longer cache.  Causal attention with
``S > T`` would leave rows that see no key at all, where the Pallas kernel
returns 0 and ``attention_ref`` the mean of ``v``; the wrapper refuses it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128, 256)  # the kernels' compiled head dimensions
MAX_GRID_Y = 65535  # B·H blocks along the float32 kernel's grid y axis
TMA_ALIGN = 16  # bytes: TMA's alignment of base addresses and strides


def _check_inputs(q, k, v, causal: bool, window: Optional[int], softcap: Optional[float]) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention takes q [B, H, S, D] and k, v [B, Hkv, T, D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv < 1 or H % Hkv:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
            "(batch, head_dim, or H not a multiple of Hkv)"
        )
    if T < 1:
        raise ValueError("flash_attention: no keys (T == 0)")
    if causal and S > T:
        raise ValueError(
            f"flash_attention: causal with S = {S} > T = {T} leaves query rows that see no key"
        )
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be positive, got {softcap}")


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the CUDA kernel does not take: a head dimension it was
    not compiled for, a type other than float32 or bfloat16, a last axis
    that is not contiguous, more than 65535 ``(b, h)`` pairs, or tensors
    that need autograd (the kernel has no backward)."""
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: the head_dim axis must be contiguous")
    if B * H > MAX_GRID_Y:
        raise ValueError(f"flash_attention kernel: B·H = {B * H} exceeds {MAX_GRID_Y}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention kernel has no backward; call it under torch.no_grad()")


def check_tma_views(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless TMA can describe each bf16 input as it lies in memory:
    a base address and the strides of axes b, h and s (where they hold
    more than one element) that are multiples of 16 bytes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(
                f"flash_attention bf16 kernel: {name}'s address is not {TMA_ALIGN}-byte aligned "
                "(TMA cannot load it); pass a tensor that starts on a 16-byte boundary"
            )
        bad = [a for a in range(3)
               if t.shape[a] > 1 and (t.stride(a) < 1 or t.stride(a) * t.element_size() % TMA_ALIGN)]
        if bad:
            raise ValueError(
                f"flash_attention bf16 kernel: {name}'s strides {tuple(t.stride())} (elements) "
                f"on axes {bad} are not positive multiples of {TMA_ALIGN} bytes (TMA cannot "
                "describe the view)"
            )


def flash_attention(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,  # [B, Hkv, T, D]
    v: torch.Tensor,  # [B, Hkv, T, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """[B, H, S, D] attention output in ``q.dtype``; float32 inside."""
    _check_inputs(q, k, v, causal, window, softcap)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
    check_kernel_inputs(q, k, v)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        check_tma_views(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)  # q's strides where q is dense: a transposed view stays one
    if S == 0 or B * H == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(a) for t in (q, k, v, out) for a in range(3))
    )
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.library()
    launch = lib.repro_flash_attention_bf16 if bf16 else lib.repro_flash_attention_f32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            B, H, Hkv, S, T, D, int(causal), window or 0, scale, float(softcap or 0.0), stream,
        )
    _build.check(rc, "flash_attention")
    _build.count(flash_attention)
    return out


flash_attention.launches = 0  # kernel launches since the last reset (CPU calls never count)
flash_attention.captures = 0  # calls captured into a CUDA graph
