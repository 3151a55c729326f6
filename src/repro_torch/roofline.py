"""Roofline analysis of the dry-run (``launch/dryrun.py``): the port's
counterpart of ``repro/roofline.py``.

Three terms per (arch x shape x mesh), all in seconds:

  compute    = FLOPs per device / the card's peak
  memory     = bytes accessed per device / the card's memory rate
  collective = per-device collective bytes on the wire / the link rate

They are bounds from shapes and datasheet peaks, not measurements.  The
peaks are an NVIDIA H100 SXM's (NVIDIA H100 Tensor Core GPU datasheet):
989 TFLOP/s dense bf16 and 3.35 TB/s of HBM3, as the kernel table of
``PERF.md`` uses.  The link rate is NVLink 4's 900 GB/s a GPU, the
datasheet's figure for both directions together; a ring collective sends
and receives at once, so the wire bytes one device sends are divided by
the half of it one direction carries, 450 GB/s.

The production mesh is ``(16, 16)`` over ``("data", "model")`` for parity
with the JAX package's TPU mesh.  On HGX H100 boards NVLink joins 8 GPUs;
a 16-way ``model`` axis therefore spans two NVLink domains, and its
collectives would cross the slower inter-node network.  The collective
term ignores this (every byte at the NVLink rate), so it is a lower
bound for the ``model`` axis.

Where the JAX package reads FLOPs, bytes and collectives from XLA's
compiled program, the dry-run records them from one pass of the port's
step over DTensors on a fake process group (``launch/mesh.py``):

* :class:`DeviceCostMode` (a ``FlopCounterMode``) counts each op's FLOPs
  with PyTorch's FLOP formulas.  An op on DTensors is counted at its global
  shapes; its count is divided by the number of devices its output is
  split over (a ``Shard`` or ``Partial`` placement), which is each device's
  share of it.  An op on plain tensors (a ``local_map`` region's, on one
  device's block) is counted as it is.  Bytes accessed are the unfused sum
  of every op's input and output bytes on one device (a DTensor's local
  block): XLA's figure is after fusion, so this one is larger.
* :class:`CollectiveRecorder` records every ``_c10d_functional``
  collective the step issues (DTensor's redistributions): op, result bytes
  on one device, group size.  ``CollectiveStats`` sums them with the ring
  factors below.

Collective bytes-on-wire factors (ring algorithms, n = group size):
  all-reduce          2 (n-1)/n * result_bytes
  all-gather            (n-1)/n * result_bytes   (result = gathered)
  reduce-scatter        (n-1)   * result_bytes   (result = shard)
  all-to-all            (n-1)/n * result_bytes
  collective-permute    1       * result_bytes
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.models.shardings import mesh_shape

# NVIDIA H100 SXM (datasheet): dense bf16, HBM3, NVLink 4 one direction
PEAK_FLOPS = 989e12  # FLOP/s
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s: half the 900 GB/s NVLink 4 figure, which counts both directions

_WIRE_FACTORS = {
    "all-reduce": lambda n: 2 * (n - 1) / max(n, 1),
    "all-gather": lambda n: (n - 1) / max(n, 1),
    "reduce-scatter": lambda n: float(n - 1),
    "all-to-all": lambda n: (n - 1) / max(n, 1),
    "collective-permute": lambda n: 1.0,
}

# _c10d_functional op -> the HLO collective it is
_C10D_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
# the c10d ops of torch.distributed's own calls (the SPMD round's host
# collectives); each op's first argument holds its result
_C10D_OWN = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute",
}


@dataclasses.dataclass
class CollectiveStats:
    ops: Dict[str, int]
    raw_bytes: Dict[str, int]  # sum of result bytes per op kind
    wire_bytes: float  # factor-adjusted per-device bytes on the wire

    def to_dict(self) -> Dict[str, Any]:
        return {"ops": self.ops, "raw_bytes": self.raw_bytes, "wire_bytes": self.wire_bytes}


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def local_bytes(tree) -> int:
    """One device's bytes of every tensor in ``tree`` (a DTensor's block)."""
    from torch.distributed.tensor import DTensor

    return sum((t._local_tensor if isinstance(t, DTensor) else t).numel() * t.element_size()
               for t in _tensors(tree))


class CollectiveRecorder(TorchDispatchMode):
    """Records each collective issued inside it (a ``_c10d_functional`` op,
    as DTensor's redistributions issue, or a ``torch.distributed`` call's
    ``c10d`` op): (kind, result bytes on one device, group size) in
    ``calls``.  An op on DTensors is passed on (``NotImplemented``), so
    DTensor runs it and the collectives it issues come back through here,
    as ``CommDebugMode`` does; enter it before ``DeviceCostMode``, which
    must see the DTensor op itself."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional" and name in _C10D_KINDS:
            from torch.distributed.distributed_c10d import _resolve_process_group

            group = _resolve_process_group(args[-1])
            self.calls.append((_C10D_KINDS[name], local_bytes(out), group.size()))
        elif func.namespace == "c10d" and name in _C10D_OWN:
            from torch.distributed import ProcessGroup

            group = ProcessGroup.unbox(next(a for a in args if isinstance(a, torch.ScriptObject)))
            self.calls.append((_C10D_OWN[name], local_bytes(args[0]), group.size()))
        return out

    def stats(self) -> CollectiveStats:
        return collective_stats(self.calls)


def collective_stats(calls) -> CollectiveStats:
    """Sum (kind, result bytes, group size) records with the wire factors."""
    ops: Dict[str, int] = {}
    raw: Dict[str, int] = {}
    wire = 0.0
    for kind, b, n in calls:
        ops[kind] = ops.get(kind, 0) + 1
        raw[kind] = raw.get(kind, 0) + b
        wire += _WIRE_FACTORS[kind](n) * b
    return CollectiveStats(ops, raw, wire)


def _split(out) -> int:
    """The number of devices an op's output is split over: the product of
    the mesh axes its (first) DTensor output is Shard or Partial on."""
    from torch.distributed.tensor import DTensor

    for t in _tensors(out):
        if isinstance(t, DTensor):
            sizes = mesh_shape(t.device_mesh).values()
            return math.prod(n for n, pl in zip(sizes, t.placements) if not pl.is_replicate())
    return 1


class DeviceCostMode(FlopCounterMode):
    """A ``FlopCounterMode`` whose ``flops`` and ``bytes_accessed`` are one
    device's (the module docstring)."""

    def __init__(self):
        super().__init__(display=False)
        self.flops = 0.0
        self.bytes_accessed = 0

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet in self.flop_registry:
            f = self.flop_registry[func_packet](*args, **kwargs, out_val=out)
            self.flops += f / _split(out)
        self.bytes_accessed += local_bytes(args) + local_bytes(out)
        return super()._count_flops(func_packet, out, args, kwargs)


def roofline_terms(flops: float, bytes_accessed: float, wire_bytes: float) -> Dict[str, Any]:
    compute = flops / PEAK_FLOPS
    memory = bytes_accessed / HBM_BW
    collective = wire_bytes / LINK_BW
    terms: Dict[str, Any] = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    return terms


# ---------------------------------------------------------------------------
# MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE)
# ---------------------------------------------------------------------------


def param_counts(cfg, shapes: Dict[str, Any], axes: Dict[str, Tuple]) -> Tuple[int, int]:
    """(total params, active params per token) from ``{name: shaped}`` and
    ``{name: logical axes}`` (``models/model.py``'s ``param_tree`` and
    ``param_axes``)."""
    total = sum(math.prod(s.shape) for s in shapes.values())
    expert = sum(math.prod(s.shape) for k, s in shapes.items() if "experts" in axes[k])
    if cfg.is_moe and cfg.n_experts > 0:
        active = total - expert + expert * cfg.experts_per_token // cfg.n_experts
    else:
        active = total
    return total, active


def model_flops(cfg, shapes: Dict[str, Any], axes: Dict[str, Tuple], shape) -> float:
    """6 * N_active * D with D = tokens processed by the step."""
    _, active = param_counts(cfg, shapes, axes)
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len  # forward only
    return 2.0 * active * shape.global_batch  # decode: one token per sequence
