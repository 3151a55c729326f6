"""Logical-axis -> mesh-axis resolution: the port's counterpart of
``repro/models/shardings.py``.

Parameter layout: Megatron-style tensor parallelism on ``model`` (heads,
d_ff, vocabulary, d_inner), plus FSDP-style sharding of the remaining
large dimension over ``data`` for ``cfg.fsdp`` architectures.  Multi-pod:
parameters are replicated over ``pod``; each pod is a federation silo.
Every rule checks divisibility; a dimension that does not divide stays
replicated.

A spec is the port's ``PartitionSpec``: a tuple with one entry per tensor
dimension, each ``None`` (replicated), a mesh axis name, or a tuple of
names (the dimension split over those axes jointly, the first the
major one).  :func:`placements` turns a spec into DTensor ``Shard`` /
``Replicate`` placements over a ``DeviceMesh`` (a dimension split over
two axes is ``Shard`` on both; DTensor orders the split by mesh axis,
which changes which device holds which block but not a block's size).

The port's parameters are one layer each (``models/model.py:param_tree``),
where the JAX package stacks a unit's layers into ``[R, ...]`` leaves with
a leading ``"layers"`` axis that no pass ever shards; a port leaf's spec
is therefore the JAX leaf's without its first entry.

A mesh here is anything with a ``shape`` mapping axis names to sizes in
axis order (``launch/mesh.py``'s ``Mesh``, a ``DeviceMesh`` through
:func:`mesh_shape`, or a shape-only stand-in).  The three constraints
(:func:`constrain_group_dim`, :func:`constrain_microbatch`,
:func:`maybe_gather_weight`) redistribute a DTensor over its own mesh and
return any other tensor as it is: the JAX constraints are no-ops outside
a mesh context, and a plain tensor is outside one.
"""
from __future__ import annotations

import contextlib
import math
import sys
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig, InputShape

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# logical axis -> candidate mesh axis (in priority order per leaf)
_MODEL_AXES = ("vocab", "ff", "dinner", "heads", "kv_heads", "experts")
_FSDP_AXES = ("embed", "experts", "ff")  # the first divisible one gets 'data'


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a port ``Mesh``, a ``DeviceMesh`` or a
    shape-only stand-in."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and not isinstance(getattr(mesh, "shape", None), Mapping):
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        with unset_fake_temporarily():  # the DeviceMesh's own rank tensor is a real one
            return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _axis_size(shape: Mapping[str, int], name: str) -> int:
    return shape.get(name, 1)


def batch_axes(mesh) -> Tuple[str, ...]:
    ms = mesh if isinstance(mesh, Mapping) else mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in ms)


def _entry(axes: Tuple[str, ...]) -> Entry:
    """One spec entry naming ``axes``: a single axis by its name, as JAX's
    ``PartitionSpec`` writes it."""
    return axes[0] if len(axes) == 1 else axes


def _dp_total(ms: Mapping[str, int]) -> int:
    return math.prod(_axis_size(ms, a) for a in batch_axes(ms))


def dp_size(mesh) -> int:
    """The product of the mesh's data-parallel axes' sizes."""
    return _dp_total(mesh_shape(mesh))


# The mesh of the ranks running this program (the counterpart of JAX's
# mesh context): ``shardings.use_mesh(mesh)`` sets it around a forward.
_MESH = None


def current_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a port ``Mesh`` of this process group's ranks) the
    current mesh inside the block."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def resolve_leaf_spec(
    cfg: ArchConfig,
    axes: Tuple[Optional[str], ...],
    shape: Tuple[int, ...],
    mesh,
    policy: str = "baseline",
    zero1: bool = False,
) -> Spec:
    """Greedy left-to-right assignment of mesh axes to one parameter leaf.

    Policies:
      baseline  — model TP on the first divisible model-axis dim, FSDP
                  'data' on the first ``_FSDP_AXES`` dim (often the
                  contracting 'embed' dim: the activations are then
                  partial-summed and all-reduced);
      gather2d  — never put 'data' on a contracting dim: the ff/dinner/
                  vocab output dim is sharded over ('model', 'data')
                  jointly when divisible, so every contraction stays local
                  (a weight gather, not an activation all-reduce).
    zero1       — optimizer state only: additionally shard the first
                  divisible dim over 'data' (elementwise update).
    """
    ms = mesh_shape(mesh)
    model_n, data_n = _axis_size(ms, "model"), _axis_size(ms, "data")
    out: list = [None] * len(shape)
    used = set()

    # pass 1: tensor parallelism on 'model' (optionally joint with data)
    for i, (ax, dim) in enumerate(zip(axes, shape)):
        if "model" in used:
            break
        if ax in _MODEL_AXES and ax != "experts" and model_n > 1 and dim % model_n == 0:
            if (policy == "gather2d" and cfg.fsdp and ax in ("ff", "dinner", "vocab")
                    and data_n > 1 and dim % (model_n * data_n) == 0):
                out[i] = ("model", "data")
                used.update(("model", "data"))
            else:
                out[i] = "model"
                used.add("model")
    # pass 2: FSDP on 'data'
    if cfg.fsdp and data_n > 1 and "data" not in used and policy == "baseline":
        for i, (ax, dim) in enumerate(zip(axes, shape)):
            if out[i] is None and ax in _FSDP_AXES and dim % data_n == 0:
                out[i] = "data"
                used.add("data")
                break
    # pass 3: ZeRO-1 (optimizer state only): any divisible dim takes 'data'
    if zero1 and data_n > 1 and "data" not in used:
        for i, (ax, dim) in enumerate(zip(axes, shape)):
            if ax == "layers":
                continue  # never shard the scan dim
            if out[i] is None and dim % data_n == 0 and dim >= data_n:
                out[i] = "data"
                used.add("data")
                break
    return tuple(out)


# "fsdp-gather": before each use, constrain an FSDP-sharded weight to its
# model-only layout, so the (small, bf16) weight is all-gathered over
# 'data' instead of the (large, float32) activations being all-reduced.


def param_specs(cfg: ArchConfig, shapes: Dict[str, Any], axes: Dict[str, Tuple], mesh,
                policy: str = "baseline", zero1: bool = False) -> Dict[str, Spec]:
    """{name: spec} for ``shapes`` ({name: a tensor or anything with a
    ``shape``}, as ``models/model.py:param_tree`` gives) and ``axes``
    ({name: logical axes}, ``param_axes``)."""
    if set(shapes) != set(axes):
        raise KeyError(sorted(set(shapes) ^ set(axes)))
    return {k: resolve_leaf_spec(cfg, axes[k], tuple(s.shape), mesh, policy=policy, zero1=zero1)
            for k, s in shapes.items()}


def model_only_spec(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...], mesh) -> Spec:
    """A weight's model-only layout: ``model`` on its first divisible
    model-axis dim, every other dim replicated."""
    model_n = mesh_shape(mesh).get("model", 1)
    out: list = [None] * len(shape)
    for i, (ax, dim) in enumerate(zip(axes, shape)):
        if ax in _MODEL_AXES and ax != "experts" and model_n > 1 and dim % model_n == 0:
            out[i] = "model"
            break
    return tuple(out)


# ---------------------------------------------------------------------------
# The constraints (redistributions of a DTensor; the identity otherwise)
# ---------------------------------------------------------------------------


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  The model code asks this of every
    weight and activation it branches on, so it costs one dict lookup
    while DTensor's module is not loaded (no DTensor can exist then) and an
    ``isinstance`` once it is; importing the module here would add over a
    second to every process that imports the models."""
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(x, dt.DTensor)


# "fsdp-gather": before each use, constrain an FSDP-sharded weight to its
# model-only layout, so the (small, bf16) weight is all-gathered over
# 'data' instead of the (large, float32) activations being all-reduced.
FSDP_WEIGHT_GATHER = False


def set_fsdp_weight_gather(value: bool) -> None:
    global FSDP_WEIGHT_GATHER
    FSDP_WEIGHT_GATHER = value


def _constrain(x, spec: Spec):
    """``x`` redistributed to ``spec`` over its own mesh."""
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def constrain_group_dim(x):
    """Pin dim 0 of a ``[G, ...]`` dispatch tensor to the data-parallel
    axes: a reshape from ``[B, S, ...]`` can drop the batch sharding, after
    which the whole MoE dispatch is replicated.  The identity on a plain
    tensor."""
    if not is_dtensor(x):
        return x
    ms = mesh_shape(x.device_mesh)
    dp = batch_axes(ms)
    if not dp or x.shape[0] % math.prod(ms[a] for a in dp):
        return x
    return _constrain(x, (dp,) + (None,) * (x.ndim - 1))


def constrain_batch(x):
    """Pin an activation ``[B, ...]`` to the data-parallel layout
    (:func:`batch_spec`).  The port puts it on the residual stream at every
    layer's entry: DTensor has no sharding rule for a matmul whose
    flattened input carries a strided split (an embedding table sharded
    over 'data' leaves one), and XLA's own choice there has no counterpart
    to copy.  The identity on a plain tensor."""
    return _constrain(x, batch_spec(x, x.device_mesh)) if is_dtensor(x) else x


def whole_batch(x):
    """A DTensor with its dim 0 gathered whole (the data-parallel split
    undone), so that it can be reshaped into microbatches; any other tensor
    as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if p.is_shard(0) else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def constrain_microbatch(x):
    """Pin dim 1 of an ``[accum, B/accum, ...]`` microbatch stack to the
    data-parallel axes.  The identity on a plain tensor."""
    if not is_dtensor(x) or x.ndim < 2:
        return x
    ms = mesh_shape(x.device_mesh)
    dp = batch_axes(ms)
    if not dp or x.shape[1] % math.prod(ms[a] for a in dp):
        return x
    return _constrain(x, (None, dp) + (None,) * (x.ndim - 2))


def maybe_gather_weight(w, axes: Tuple[Optional[str], ...]):
    """Under ``FSDP_WEIGHT_GATHER``, a DTensor weight redistributed to its
    model-only layout (its 'data' sharding gathered).  Any other weight as
    it is."""
    if not FSDP_WEIGHT_GATHER or not is_dtensor(w) or "model" not in mesh_shape(w.device_mesh):
        return w
    return _constrain(w, model_only_spec(axes, tuple(w.shape), w.device_mesh))


# ---------------------------------------------------------------------------
# Activation / input sharding
# ---------------------------------------------------------------------------


def input_spec_tree(cfg: ArchConfig, shape: InputShape, specs_in: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Specs for ``models/model.py:input_specs``' stand-ins, in the same
    tree (a decode state's host position stays as it is).

    Batch-shardable inputs go over (pod, data); a small-batch decode
    state shards its largest dim over ('data', 'model') instead
    (sequence-sharded KV, long-context decode).  A state leaf is one
    layer's ``[B, ...]`` (the JAX package's ``[R, B, ...]`` without its
    scan dim)."""
    ms = mesh_shape(mesh)
    dp = _dp_total(ms)

    def token_like(s) -> Spec:
        if s.shape[0] % dp == 0 and dp > 1:
            return (_entry(batch_axes(ms)),) + (None,) * (len(s.shape) - 1)
        return (None,) * len(s.shape)

    out: Dict[str, Any] = {}
    for key, val in specs_in.items():
        if key in ("tokens", "token", "prefix", "frames"):
            out[key] = token_like(val)
        elif key == "state":
            out[key] = pytree.tree_map_only(torch.Tensor, lambda s: state_leaf_spec(tuple(s.shape),
                                                                                   shape.global_batch, ms), val)
        else:
            raise KeyError(key)
    return out


def state_leaf_spec(dims: Tuple[int, ...], global_batch: int, mesh) -> Spec:
    """The spec of one layer's decode-state leaf ``[B, ...]``: the batch
    over (pod, data) and the largest other dim over ``model``; a batch too
    small to split puts the largest dim over (data, model) instead."""
    ms = mesh_shape(mesh)
    dp, ba = _dp_total(ms), _entry(batch_axes(ms))
    model_n, data_n = _axis_size(ms, "model"), _axis_size(ms, "data")
    out: list = [None] * len(dims)
    if len(dims) >= 1 and dims[0] == global_batch and dims[0] % dp == 0 and dp > 1:
        out[0] = ba
        # additionally shard the largest remaining dim over 'model'
        rest = [(d, i) for i, d in enumerate(dims[1:], start=1)]
        if rest:
            d, i = max(rest)
            if d % model_n == 0 and model_n > 1 and d >= model_n * 8:
                out[i] = "model"
        return tuple(out)
    # tiny batch (long_500k): shard the largest dim over (data, model)
    rest = [(d, i) for i, d in enumerate(dims)]
    if rest:
        d, i = max(rest)
        if d % (data_n * model_n) == 0 and d >= data_n * model_n * 8:
            out[i] = ("data", "model")
        elif d % data_n == 0 and data_n > 1 and d >= data_n * 8:
            out[i] = "data"
        elif d % model_n == 0 and model_n > 1 and d >= model_n * 8:
            out[i] = "model"
    return tuple(out)


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` over ``mesh`` (a ``DeviceMesh`` or a
    port ``Mesh``), one per mesh axis: ``Shard(i)`` where dimension ``i``
    names the axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    where: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            if a in where:
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            where[a] = i
    unknown = set(where) - set(names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} the mesh {names} lacks")
    return tuple(Shard(where[a]) if a in where else Replicate() for a in names)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The block of a ``shape`` tensor that one device holds under
    ``spec`` (every sharded dim divides, as the passes above ensure)."""
    ms = mesh_shape(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = math.prod(ms[a] for a in ((entry,) if isinstance(entry, str) else entry or ()))
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {entry} ({n} ways)")
        out.append(dim // n)
    return tuple(out)


def distribute(x: torch.Tensor, spec: Spec, mesh):
    """A DTensor of ``x``'s shape and dtype at ``spec``: each device's
    block is a fresh tensor of the same kind as ``x`` (zeros; a fake tensor
    under ``FakeTensorMode``), so nothing of the global ``x`` is copied."""
    from torch.distributed.tensor import DTensor

    loc = torch.zeros(local_shape(tuple(x.shape), spec, mesh), dtype=x.dtype, device=x.device)
    return DTensor.from_local(loc, mesh, placements(spec, mesh), run_check=False,
                              shape=x.shape, stride=x.stride())


def place_state(state: Any, global_batch: int, mesh) -> Any:
    """A zero decode state's every tensor leaf as a zero DTensor at its
    ``state_leaf_spec``."""
    return pytree.tree_map_only(
        torch.Tensor, lambda t: distribute(t, state_leaf_spec(tuple(t.shape), global_batch, mesh), mesh), state)


# ---------------------------------------------------------------------------
# Regions that run on each device's block (the counterpart of shard_map)
# ---------------------------------------------------------------------------


class Summed(NamedTuple):
    """An output spec in a local region whose blocks are each a summand
    over the mesh axes ``axes`` (a product contracted over a dim split
    over them): DTensor's ``Partial``."""

    spec: Spec
    axes: Tuple[str, ...]


def local_region(fn: Callable, in_specs: Sequence[Optional[Spec]], out_specs, *args):
    """``fn(*args)``; when an argument is a DTensor, ``fn`` runs on each
    device's block under ``local_map`` instead: a tensor argument is first
    redistributed to its spec in ``in_specs`` (``None`` for a non-tensor),
    and each output is the DTensor of its spec in ``out_specs`` (a spec or
    a :class:`Summed`; a list of them for a tuple output).  A tensor input
    replicated over a mesh axis that another input is split over (a weight
    against batch-split rows) gets its gradient as a partial sum over that
    axis: each device's rows add their share.  On plain tensors this is
    ``fn(*args)`` and nothing else."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    def out_pl(spec):
        if isinstance(spec, Summed):
            return tuple(Partial() if a in spec.axes else pl
                         for a, pl in zip(mesh_shape(mesh), placements(spec.spec, mesh)))
        return placements(spec, mesh)

    in_pl = tuple(None if s is None else placements(s, mesh) for s in in_specs)
    split = {i for pl in in_pl if pl is not None for i, p in enumerate(pl) if p.is_shard()}
    grad_pl = tuple(None if pl is None else tuple(Partial() if i in split and p.is_replicate() else p
                                                  for i, p in enumerate(pl)) for pl in in_pl)
    out = tuple(list(out_pl(s)) for s in (out_specs if isinstance(out_specs, list) else [out_specs]))
    return local_map(fn, out_placements=out, in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def batch_spec(x, mesh) -> Spec:
    """``x``'s dim 0 over the data-parallel axes where it divides, every
    other dim replicated."""
    ms = mesh_shape(mesh)
    dp = batch_axes(ms)
    b = dp if dp and x.shape[0] % math.prod(ms[a] for a in dp) == 0 else None
    return (b,) + (None,) * (x.ndim - 1)


def heads_spec(x, head_dim: int, n_heads: Sequence[int], mesh) -> Spec:
    """An attention tensor's spec in a local region: its batch as
    :func:`batch_spec` puts it, its heads over ``model`` where every head
    count in ``n_heads`` (the query and the K/V heads) divides, so each
    device's query heads find their K/V heads on the same device."""
    m = mesh_shape(mesh).get("model", 1)
    out = list(batch_spec(x, mesh))
    if m > 1 and all(h % m == 0 for h in n_heads):
        out[head_dim] = "model"
    return tuple(out)


def projection_specs(x, w) -> Tuple[Spec, Spec, Spec]:
    """The specs of a head projection ``x [B, S, d] @ w [d, H, D] -> [B, S,
    H, D]`` run on each device's block: the batch as :func:`batch_spec`
    puts it, the heads over ``model`` where they divide (else replicated),
    ``d`` whole (an FSDP 'data' shard of ``w`` gathered)."""
    ms = mesh_shape(w.device_mesh)
    b = batch_spec(x, w.device_mesh)[0]
    h = "model" if ms.get("model", 1) > 1 and w.shape[1] % ms["model"] == 0 else None
    return (b,) + (None,) * (x.ndim - 1), (None, h, None), (b,) + (None,) * (x.ndim - 2) + (h, None)


def output_specs(o, wo) -> Tuple[Spec, Spec, "Summed"]:
    """The specs of an attention output projection ``o [B, S, H, D] @ wo
    [H, D, d] -> [B, S, d]`` run on each device's block: the batch as in
    :func:`batch_spec` puts it, the heads over ``model`` where they divide
    (the result then a partial sum over it), ``d`` whole."""
    ms = mesh_shape(wo.device_mesh)
    b = batch_spec(o, wo.device_mesh)[0]
    h = "model" if ms.get("model", 1) > 1 and wo.shape[0] % ms["model"] == 0 else None
    return (b, None, h, None), (h, None, None), Summed((b, None, None), ("model",) if h else ())


def embedding_local(tokens, table):
    """``table[tokens]`` over DTensors: each device looks its rows up in
    its block of the vocabulary (ids outside it read zeros), and the blocks'
    results are summed over the axes the vocabulary is split over (the
    vocabulary-parallel lookup); the embedding dim is gathered whole."""
    from torch.distributed.tensor import DTensor

    mesh = table.device_mesh
    ms = mesh_shape(mesh)
    names, dp = list(ms), batch_axes(ms)
    vocab = tuple(names[i] for i, p in enumerate(table.placements) if p.is_shard(0) and names[i] not in dp)
    t_spec = batch_spec(tokens, mesh)
    w_spec = (_entry(vocab) if vocab else None, None)
    # each device's first vocabulary id: its block index (mesh-axis major,
    # as DTensor splits a dim over several axes) times the block's rows
    coord, block = mesh.get_coordinate(), 0
    for a in vocab:
        block = block * ms[a] + coord[names.index(a)]
    n_blocks = math.prod(ms[a] for a in vocab)
    first = DTensor.from_local(torch.full((1,), block * (table.shape[0] // n_blocks), dtype=torch.int64,
                                          device=table.device),
                               mesh, placements((_entry(vocab) if vocab else None,), mesh), run_check=False,
                               shape=(n_blocks,), stride=(1,))

    def lookup(tok, w, start):
        local = tok.long() - start.reshape(())
        inside = (local >= 0) & (local < w.shape[0])
        return torch.nn.functional.embedding(torch.where(inside, local, 0), w) * inside[..., None].to(w.dtype)

    return local_region(lookup, (t_spec, w_spec, (_entry(vocab) if vocab else None,)),
                        Summed(t_spec + (None,), vocab), tokens, table, first)
