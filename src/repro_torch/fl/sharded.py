"""The packed wire buffer of the hypothesis broadcast (answers to the
helpers ``_pack_leaves`` / ``_unpack_leaves`` of ``repro/fl/sharded.py``).

A hypothesis bundle (a NamedTuple of float32 and int32 tensors) travels
as ONE float32 buffer: the paper's buffer-packing optimisation applied to
a collective, one all-gather a round instead of one per leaf.  int32
leaves travel bitcast (``Tensor.view``, never a conversion), so the
buffer is the JAX package's byte for byte and the round trip is exact;
nothing on the wire does arithmetic on it.  ``fl/distributed.py`` packs
with these.  The SPMD round of ``repro/fl/sharded.py`` itself is not
ported yet (ROADMAP Queue 1 item 12d).
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.core.serialization import _TENSOR, _structure


def _pack_leaves(tree: Any) -> Tuple[torch.Tensor, Any]:
    """``(buffer, format)``: every leaf of ``tree`` flattened in field
    order into one float32 buffer on the leaves' device, and what
    :func:`_unpack_leaves` needs to rebuild the tree."""
    leaves: List[torch.Tensor] = []
    structure = _structure(tree, leaves.append)
    flats, meta, off = [], [], 0
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"only tensor leaves pack, got {type(leaf).__name__}")
        flat = leaf.reshape(-1)
        if flat.dtype == torch.int32:
            flat, kind = flat.view(torch.float32), "i32"
        else:
            flat, kind = flat.to(torch.float32), str(leaf.dtype).replace("torch.", "")
        flats.append(flat)
        meta.append((off, tuple(leaf.shape), kind))
        off += flat.numel()
    return torch.cat(flats), (structure, meta)


def _unpack_leaves(buf: torch.Tensor, fmt: Any, lead: Tuple[int, ...] = ()) -> Any:
    """Inverse of :func:`_pack_leaves`; ``lead`` gives the buffer's extra
    leading dimensions (``(C,)`` for a gathered ``[C, L]`` buffer)."""
    structure, meta = fmt
    leaves = []
    for off, shape, kind in meta:
        n = 1
        for s in shape:
            n *= s
        flat = buf[..., off:off + n]
        if kind == "i32":
            flat = flat.contiguous().view(torch.int32)
        elif kind != "float32":
            flat = flat.to(getattr(torch, kind))
        leaves.append(flat.reshape(tuple(lead) + shape))
    it = iter(leaves)

    def build(s):
        if s == _TENSOR:
            return next(it)
        kind, children = s
        vals = [build(c) for c in children]
        return tuple(vals) if kind is tuple else kind(*vals)  # a NamedTuple

    return build(structure)
