"""``flash_attention`` — blockwise online-softmax attention with grouped
KV heads, causal masking, a sliding window and logit soft-capping: the
attention of every full-sequence pass of the LLM path
(``models/attention.py:attend_full``), once per layer of a prefill.

Answers to ``repro/kernels/flash_attention.py``.  On CUDA tensors the
wrapper launches a hand-written kernel or raises; the dtype picks it:

* bfloat16: ``csrc/flash_attention_sm90.cu``, TMA loads into swizzled
  shared memory and ``wgmma`` on bf16 tiles with float32 accumulators.
  Head dims 64 and 128 take a warp-specialised kernel (a producer
  warpgroup, 128-key tiles, two consumer warpgroups taking turns at the
  tensor cores, the softcap on the exp unit); 32 and 256 the first design
  (:func:`bf16_plan`).  TMA needs 16-byte aligned base addresses and
  strides, so a view it cannot describe raises (:func:`check_tma_views`);
  nothing is copied;
* float32: ``csrc/flash_attention.cu``, both products on the tensor cores
  in 3xTF32 (each operand split into two TF32 numbers, three products
  into a float32 accumulator: near float32's error, where one TF32
  product would keep about three decimal digits), K/V tiles through a
  ``cp.async`` ring, and where the grid would not fill the card, clusters
  that split the keys (:func:`f32_plan`).  16-byte copies need 16-byte
  aligned addresses and strides, so a view they cannot take raises
  (:func:`check_cp_async_views`).

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
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128, 256)  # the kernels' compiled head dimensions
MAX_GRID_Y = 65535  # B·H blocks along the float32 kernel's grid y axis
COPY_ALIGN = 16  # bytes: TMA's and cp.async's alignment of base addresses and strides
SMS = 132  # streaming multiprocessors of an H100 SXM
F32_BQ = 64  # query rows of a float32 CTA: four warps of 16
F32_MAX_SPLIT = 8  # CTAs of a float32 cluster along the keys (the portable size)


BF16_WS_DIMS = (64, 128)  # head dims the warp-specialised bf16 kernel serves
BF16_BM = 64  # query rows of a consumer warpgroup (both bf16 kernels)
BF16_BN = 64  # keys a tile, the first design
BF16_WS_BN = 128  # keys a tile, the warp-specialised kernel


class Bf16Plan(NamedTuple):
    kernel: str  # "ws": the warp-specialised kernel (D = 64, 128); "sm90": the first design
    bm: int  # query rows a block
    bn: int  # keys a tile
    tiles: Tuple[Tuple[int, int], ...]  # each query block's key tiles [first, last), by first row


def block_tiles(S: int, T: int, q0: int, rows: int, bn: int, causal: bool,
                window: Optional[int]) -> Tuple[int, int]:
    """The tiles ``[first, last)`` of ``bn`` keys that any of the ``rows``
    query rows from ``q0`` can see: the tiles a bf16 block loads (the
    kernels' ``block_tiles``)."""
    off = T - S
    pos_lo, pos_hi = q0 + off, min(q0 + rows, S) - 1 + off
    k_end = min(T, pos_hi + 1) if causal else T
    k_begin = max(0, pos_lo - window + 1) if window else 0
    first = k_begin // bn
    return first, first + max(0, -(-k_end // bn) - first)


def bf16_plan(B: int, H: int, Hkv: int, S: int, T: int, D: int, causal: bool,
              window: Optional[int]) -> Bf16Plan:
    """The bf16 route's launch plan (``repro_flash_attention_bf16_plan``
    computes the same).  D = 64, 128: blocks of 128 query rows (two
    consumer warpgroups) over 128-key tiles; D = 32, 256: the first
    design's blocks of 128 rows (64 where S <= 64) over 64-key tiles.
    The grid is ``B·H`` by the query blocks, whatever the plan."""
    if D in BF16_WS_DIMS:
        kernel, bm, bn = "ws", 2 * BF16_BM, BF16_WS_BN
    else:
        kernel, bm, bn = "sm90", (1 if S <= BF16_BM else 2) * BF16_BM, BF16_BN
    tiles = tuple(block_tiles(S, T, q0, bm, bn, causal, window) for q0 in range(0, S, bm))
    return Bf16Plan(kernel, bm, bn, tiles)


class F32Plan(NamedTuple):
    splits: int  # CTAs per cluster, each walking a contiguous share of the key tiles
    bq: int  # query rows per CTA
    bk: int  # keys per tile


def f32_key_tile(D: int) -> int:
    """Keys per staged tile: 32 (64 at D = 32), so that q and a 2-stage K/V
    ring leave room for four CTAs an SM at D <= 64."""
    return 64 if D == 32 else 32


def visible_tiles(S: int, T: int, q0: int, bk: int, causal: bool, window: Optional[int]) -> Tuple[int, int]:
    """The key tiles ``[first, last)`` of ``bk`` keys that any row of the
    float32 kernel's query block starting at ``q0`` can see."""
    return block_tiles(S, T, q0, F32_BQ, bk, causal, window)


def key_split(first: int, last: int, splits: int) -> List[Tuple[int, int]]:
    """Each cluster rank's contiguous share ``[lo, hi)`` of the tiles ``[first, last)``."""
    n = last - first
    return [(first + n * r // splits, first + n * (r + 1) // splits) for r in range(splits)]


def f32_plan(B: int, H: int, S: int, T: int, D: int, causal: bool, window: Optional[int]) -> F32Plan:
    """The float32 kernel's launch plan (``csrc/flash_attention.cu`` computes
    the same): one CTA per 64 query rows of a (b, h) when those fill the
    SMs; else clusters of up to 8 CTAs along the keys, each with at least
    two key tiles of the longest range."""
    bk = f32_key_tile(D)
    nqb = -(-S // F32_BQ)
    if B * H * nqb >= SMS:
        return F32Plan(1, F32_BQ, bk)
    most = max(last - first for first, last in
               (visible_tiles(S, T, qb * F32_BQ, bk, causal, window) for qb in range(nqb)))
    return F32Plan(max(1, min(F32_MAX_SPLIT, most // 2)), F32_BQ, bk)


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


def kernel_f32_plan(B: int, H: int, Hkv: int, S: int, T: int, D: int, causal: bool,
                    window: Optional[int]) -> F32Plan:
    """The plan ``csrc/flash_attention.cu`` launches for these shapes (it
    builds the kernels): the card's tests hold it to :func:`f32_plan`."""
    plan = (ctypes.c_int * 3)()
    rc = _build.library().repro_flash_attention_f32_plan(B, H, Hkv, S, T, D, int(causal), window or 0, plan)
    _build.check(rc, "flash_attention plan")
    return F32Plan(*plan)


def kernel_bf16_plan(B: int, H: int, Hkv: int, S: int, T: int, D: int, causal: bool,
                     window: Optional[int]) -> Bf16Plan:
    """The plan ``csrc/flash_attention_sm90.cu`` launches for these shapes
    (it builds the kernels): the card's tests hold it to :func:`bf16_plan`."""
    cap = 4 + 2 * -(-S // BF16_BM)
    plan = (ctypes.c_int * cap)()
    rc = _build.library().repro_flash_attention_bf16_plan(
        B, H, Hkv, S, T, D, int(causal), window or 0, plan, cap)
    _build.check(rc, "flash_attention bf16 plan")
    kernel, bm, bn, nq = plan[:4]
    tiles = tuple((plan[4 + 2 * i], plan[5 + 2 * i]) for i in range(nq))
    return Bf16Plan("ws" if kernel else "sm90", bm, bn, tiles)


def _check_copy_views(q, k, v, kernel: str, copier: str, zero_strides: bool) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % COPY_ALIGN:
            raise ValueError(
                f"flash_attention {kernel} kernel: {name}'s address is not {COPY_ALIGN}-byte aligned "
                f"({copier} cannot load it); pass a tensor that starts on a 16-byte boundary"
            )
        bad = [a for a in range(3)
               if t.shape[a] > 1 and ((t.stride(a) < 1 and not zero_strides)
                                      or t.stride(a) * t.element_size() % COPY_ALIGN)]
        if bad:
            raise ValueError(
                f"flash_attention {kernel} kernel: {name}'s strides {tuple(t.stride())} (elements) "
                f"on axes {bad} are not {'' if zero_strides else 'positive '}multiples of "
                f"{COPY_ALIGN} bytes ({copier} cannot take the view)"
            )


def check_tma_views(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless TMA can describe each bf16 input as it lies in memory:
    a base address and the strides of axes b, h and s (where they hold
    more than one element) that are multiples of 16 bytes."""
    _check_copy_views(q, k, v, "bf16", "TMA", zero_strides=False)


def check_cp_async_views(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless 16-byte ``cp.async`` copies can load each float32 input:
    a base address and the strides of axes b, h and s (where they hold
    more than one element) that are multiples of 16 bytes, that is of 4
    elements.  A zero stride (a broadcast row) copies the same row again."""
    _check_copy_views(q, k, v, "float32", "16-byte cp.async copies", zero_strides=True)


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
    (check_tma_views if bf16 else check_cp_async_views)(q, k, v)
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
