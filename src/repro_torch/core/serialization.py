"""Model-agnostic serialization (paper §4.2/§5.1; answers to
``repro/core/serialization.py``).

A weak hypothesis is a bundle of fixed-shape tensors, so a model crosses
the wire as every leaf packed into ONE contiguous byte buffer whose
layout is known from the :class:`WireFormat` (``packed=True``), or as a
naive per-leaf list of buffers (``packed=False``).

The port's bundles are NamedTuples of tensors.  They flatten
depth-first in field order, which is the leaf order ``jax.tree.flatten``
gives the JAX package's pytrees of the same structure, so the same model serializes to the same
bytes in both packages.  A host ``int`` leaf — ``Ensemble.count`` — is a
0-dim ``int32``, as the JAX ensemble carries its count.  Tensors leave
the device once, in :func:`flatten_leaves`.

The quantized leaf codecs (raw, u8, bf16, int8) are the serving
artifact's payload shrinkers; see the comment above ``CODEC_RAW``.  The
bf16 codec rounds through ``torch.bfloat16`` (round to nearest even, as
``ml_dtypes`` does) and stores its bits as ``int16``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

# Leaf kinds a structure records, so unflatten gives back what flatten took.
_TENSOR, _INT = "tensor", "int"


def _structure(tree: Any, visit) -> Any:
    """Walk ``tree`` depth-first in field order, calling ``visit`` on each
    leaf; returns a hashable description of the nesting (two trees of
    equal structure have equal descriptions)."""

    def walk(x):
        if isinstance(x, torch.Tensor):
            visit(x)
            return _TENSOR
        if isinstance(x, bool):
            raise TypeError("bool leaves are not serializable; use a tensor")
        if isinstance(x, int):
            visit(x)
            return _INT
        if isinstance(x, tuple):
            return (type(x), tuple(walk(c) for c in x))
        raise TypeError(f"cannot serialize a leaf of type {type(x).__name__}")

    return walk(tree)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x, np.int32)


def flatten(tree: Any) -> Tuple[List[np.ndarray], Any]:
    """``(leaves, structure)``: host numpy leaves in depth-first field
    order, and the structure :func:`unflatten` rebuilds from."""
    leaves: List[np.ndarray] = []
    structure = _structure(tree, lambda x: leaves.append(_host(x)))
    return leaves, structure


def flatten_leaves(tree: Any) -> List[np.ndarray]:
    return flatten(tree)[0]


def leaf_specs(tree: Any) -> Tuple[Any, List[Tuple[Tuple[int, ...], str]]]:
    """``(structure, [(shape, dtype name), ...])`` without copying any
    tensor off its device."""
    specs: List[Tuple[Tuple[int, ...], str]] = []

    def visit(x):
        if isinstance(x, torch.Tensor):
            specs.append((tuple(x.shape), str(x.dtype).replace("torch.", "")))
        else:
            specs.append(((), "int32"))

    return _structure(tree, visit), specs


def unflatten(structure: Any, leaves: List[np.ndarray]) -> Any:
    """Rebuild a tree from :func:`flatten`'s structure and host leaves.
    Tensor leaves come back as CPU tensors owning a copy of the bytes."""
    it = iter(leaves)

    def build(s):
        if s == _TENSOR:
            return torch.from_numpy(np.array(next(it), copy=True))
        if s == _INT:
            return int(next(it))
        kind, children = s
        vals = [build(c) for c in children]
        return tuple(vals) if kind is tuple else kind(*vals)  # a NamedTuple

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


@dataclasses.dataclass(frozen=True)
class WireFormat:
    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]


def wire_format(tree: Any) -> WireFormat:
    leaves, structure = flatten(tree)
    return WireFormat(
        treedef=structure,
        shapes=tuple(tuple(l.shape) for l in leaves),
        dtypes=tuple(str(l.dtype) for l in leaves),
    )


def serialize(tree: Any, packed: bool = True) -> List[bytes]:
    """tree -> wire buffers.  packed: one contiguous buffer (header-less
    payload; format known from WireFormat).  unpacked: one buffer per leaf."""
    leaves = [np.ascontiguousarray(l) for l in flatten_leaves(tree)]
    if packed:
        return [b"".join(l.tobytes() for l in leaves)]
    return [l.tobytes() for l in leaves]


def deserialize(buffers: List[bytes], fmt: WireFormat, packed: bool = True) -> Any:
    leaves = []
    if packed:
        (buf,) = buffers
        off = 0
        for shape, dtype in zip(fmt.shapes, fmt.dtypes):
            n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            leaves.append(np.frombuffer(buf[off : off + n], dtype=dtype).reshape(shape))
            off += n
    else:
        for buf, shape, dtype in zip(buffers, fmt.shapes, fmt.dtypes):
            leaves.append(np.frombuffer(buf, dtype=dtype).reshape(shape))
    return unflatten(fmt.treedef, leaves)


def wire_size(tree: Any) -> int:
    """Bytes on the wire for one copy of ``tree`` (feeds the Fig.-5 comm
    model).  Shape-only: no tensor leaves the device."""
    return sum(
        int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        for shape, dtype in leaf_specs(tree)[1]
    )


def roundtrip_equal(tree: Any, packed: bool = True) -> bool:
    fmt = wire_format(tree)
    back = deserialize(serialize(tree, packed), fmt, packed)
    return all(
        a.shape == b.shape and np.array_equal(a, b)
        for a, b in zip(flatten_leaves(tree), flatten_leaves(back))
    )


# ---------------------------------------------------------------------------
# Quantized leaf codecs — the serving-artifact payload shrinkers
# ---------------------------------------------------------------------------
#
# Ensemble outputs are argmax votes, so a serving artifact only has to
# preserve the *decision function*, not the float values.  Each leaf
# carries its own codec (recorded per leaf in the artifact manifest; see
# ``serve/artifact.py``):
#
#   raw   — exact bytes (always valid; the only codec for alpha/count).
#   u8    — lossless uint8 downcast for integer leaves whose values fit
#           [0, 255] (tree feature indices): 4x, bit-exact.
#   bf16  — float32 -> bfloat16, rounded to nearest even: 2x.
#   int8  — per-slot affine uint8 grid over the leading (member-slot)
#           axis, with three decision-preserving refinements:
#             * outlier rows (axis -2 rows whose magnitude dwarfs the
#               rest) are stored raw so they do not inflate the step;
#             * per last-axis-row argmax repair: if rounding changed a
#               row's (first-index) argmax, the original winner's code
#               is bumped one step above the row max — for tree leaf
#               logits this makes every member vote EXACT for all inputs;
#             * promoted slots (``promoted_slots``) are stored raw — the
#               calibration escape hatch for members whose votes int8
#               cannot preserve.
#
# The int8 payload layout per leaf, sizes fully determined by (shape,
# plan): uint8 codes for the full leaf, f32 scale[T], f32 low[T], f32
# outlier rows [T, n_out, R], f32 promoted slots.

CODEC_RAW = "raw"
CODEC_U8 = "u8"
CODEC_BF16 = "bf16"
CODEC_INT8 = "int8"
LEAF_CODECS = (CODEC_RAW, CODEC_U8, CODEC_BF16, CODEC_INT8)

# int8 grid: 255 levels, one level of headroom for the argmax repair bump
_INT8_LEVELS = 254
# a row is an outlier when its absmax exceeds this multiple of the median
# row absmax (per leaf) — it would stretch everyone's grid
OUTLIER_ROW_RATIO = 4.0


def outlier_rows(arr: Any) -> List[int]:
    """Rows along axis -2 whose magnitude dwarfs the leaf's median row.
    Quantizing them on the shared per-slot grid would stretch the grid
    for every other row, so the int8 codec stores them raw."""
    a = np.asarray(arr)
    if a.ndim < 3:
        return []  # axis -2 is the slot axis itself; nothing to single out
    reduce_axes = tuple(i for i in range(a.ndim) if i != a.ndim - 2)
    row_absmax = np.abs(a).max(axis=reduce_axes)
    med = np.median(row_absmax)
    if med == 0:
        return []
    return [int(i) for i in np.nonzero(row_absmax > OUTLIER_ROW_RATIO * med)[0]]


def _int8_sections(plan: dict, shape) -> List[int]:
    """Byte length of each int8 payload section, in layout order."""
    size = int(np.prod(shape, dtype=np.int64))
    T = shape[0]
    R = shape[-1] if len(shape) >= 2 else 1
    slot = size // T
    n_out = len(plan.get("outlier_rows", ()))
    n_promo = len(plan.get("promoted_slots", ()))
    return [size, 4 * T, 4 * T, 4 * T * n_out * R, 4 * n_promo * slot]


def encoded_nbytes(plan: dict, shape, dtype) -> int:
    """Exact payload bytes of one encoded leaf — reader and writer derive
    section offsets from (shape, plan) alone, no per-leaf framing."""
    size = int(np.prod(shape, dtype=np.int64))
    codec = plan["codec"]
    if codec == CODEC_RAW:
        return size * np.dtype(dtype).itemsize
    if codec == CODEC_U8:
        return size
    if codec == CODEC_BF16:
        return 2 * size
    if codec == CODEC_INT8:
        return sum(_int8_sections(plan, shape))
    raise ValueError(f"unknown leaf codec {codec!r}; known: {LEAF_CODECS}")


def _outlier_mask(shape, rows) -> np.ndarray:
    mask = np.zeros(shape, bool)
    if rows:
        sl = [slice(None)] * len(shape)
        sl[-2] = list(rows)
        mask[tuple(sl)] = True
    return mask


def _to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """float -> bfloat16 (nearest even) bit patterns as int16."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy()


def _from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.array(bits, np.int16, copy=True)).view(torch.bfloat16)
    return t.to(torch.float32).numpy()


def encode_leaf(arr: Any, plan: dict) -> bytes:
    """One leaf -> payload bytes under ``plan`` (see the comment above)."""
    a = np.ascontiguousarray(np.asarray(arr))
    codec = plan["codec"]
    if codec == CODEC_RAW:
        return a.tobytes()
    if codec == CODEC_U8:
        if not np.issubdtype(a.dtype, np.integer):
            raise ValueError(f"u8 codec needs an integer leaf, got {a.dtype}")
        if a.size and (a.min() < 0 or a.max() > 255):
            raise ValueError("u8 codec needs values in [0, 255]")
        return a.astype(np.uint8).tobytes()
    if not np.issubdtype(a.dtype, np.floating):
        raise ValueError(f"{codec} codec needs a float leaf, got {a.dtype}")
    if codec == CODEC_BF16:
        return _to_bf16_bits(a).tobytes()
    if codec != CODEC_INT8:
        raise ValueError(f"unknown leaf codec {codec!r}; known: {LEAF_CODECS}")

    a = a.astype(np.float32)
    T = a.shape[0]
    o_rows = list(plan.get("outlier_rows", ()))
    promoted = sorted(plan.get("promoted_slots", ()))
    out_mask = _outlier_mask(a.shape, o_rows)
    kept = np.where(out_mask, np.nan, a).reshape(T, -1)
    with np.errstate(all="ignore"):
        lo = np.nanmin(kept, axis=1)
        hi = np.nanmax(kept, axis=1)
    lo = np.where(np.isfinite(lo), lo, 0.0).astype(np.float32)
    hi = np.where(np.isfinite(hi), hi, 0.0).astype(np.float32)
    scale = ((hi - lo) / _INT8_LEVELS).astype(np.float32)
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    code = np.clip(
        np.rint((a.reshape(T, -1) - lo[:, None]) / scale[:, None]),
        0, _INT8_LEVELS,
    ).astype(np.uint8).reshape(a.shape)
    if a.ndim >= 2:  # argmax repair per last-axis row
        rows_c = code.reshape(-1, a.shape[-1])
        rows_o = a.reshape(-1, a.shape[-1])
        skip = out_mask.reshape(-1, a.shape[-1]).any(axis=1)
        want = rows_o.argmax(axis=1)
        bad = (rows_c.argmax(axis=1) != want) & ~skip
        idx = np.arange(len(rows_c))
        rows_c[idx, want] = np.where(
            bad, rows_c.max(axis=1).astype(np.uint16) + 1, rows_c[idx, want]
        ).astype(np.uint8)
        code = rows_c.reshape(a.shape)
    code = np.where(out_mask, 0, code).astype(np.uint8)
    if promoted:
        code[promoted] = 0  # dead codes; the raw section overrides
    parts = [code.tobytes(), scale.tobytes(), lo.tobytes()]
    if o_rows:
        parts.append(np.ascontiguousarray(np.take(a, o_rows, axis=-2)).tobytes())
    if promoted:
        parts.append(np.ascontiguousarray(a[promoted]).tobytes())
    return b"".join(parts)


def decode_leaf(buf: bytes, plan: dict, shape, dtype) -> np.ndarray:
    """Payload bytes -> leaf with the ORIGINAL shape/dtype (quantized
    codecs dequantize, so the structure the engine serves is identical to
    the f32 artifact's)."""
    shape = tuple(shape)
    codec = plan["codec"]
    if codec == CODEC_RAW:
        return np.frombuffer(buf, dtype=dtype).reshape(shape)
    if codec == CODEC_U8:
        return np.frombuffer(buf, dtype=np.uint8).astype(dtype).reshape(shape)
    if codec == CODEC_BF16:
        return _from_bf16_bits(np.frombuffer(buf, dtype=np.int16)).astype(dtype).reshape(shape)
    if codec != CODEC_INT8:
        raise ValueError(f"unknown leaf codec {codec!r}; known: {LEAF_CODECS}")
    sections = _int8_sections(plan, shape)
    offs = np.cumsum([0] + sections)
    if len(buf) != offs[-1]:
        raise ValueError(f"int8 leaf payload is {len(buf)} bytes, expected {offs[-1]}")
    cut = [bytes(buf[offs[i] : offs[i + 1]]) for i in range(len(sections))]
    T = shape[0]
    code = np.frombuffer(cut[0], dtype=np.uint8).reshape(shape)
    scale = np.frombuffer(cut[1], dtype=np.float32)
    lo = np.frombuffer(cut[2], dtype=np.float32)
    a = (code.reshape(T, -1).astype(np.float32) * scale[:, None] + lo[:, None])
    a = a.reshape(shape).astype(dtype)
    o_rows = list(plan.get("outlier_rows", ()))
    if o_rows:
        R = shape[-1]
        vals = np.frombuffer(cut[3], dtype=np.float32).reshape(T, len(o_rows), R)
        sl = [slice(None)] * len(shape)
        sl[-2] = list(o_rows)
        a[tuple(sl)] = vals.reshape(a[tuple(sl)].shape).astype(dtype)
    promoted = sorted(plan.get("promoted_slots", ()))
    if promoted:
        slot_shape = (len(promoted),) + shape[1:]
        a[promoted] = np.frombuffer(cut[4], dtype=np.float32).reshape(slot_shape)
    return a
