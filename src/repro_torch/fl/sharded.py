"""SPMD MAFL: the AdaBoost.F round as one program on every rank of a
mesh (answers to ``repro/fl/sharded.py``), the port's re-expression of
the JAX package's ``shard_map`` round:

  collaborator i        = the ranks at flat index i over the mesh's
                          (pod, data) axes
  hypothesis broadcast  = an all-gather of the weak hypothesis along those
                          axes (one packed float32 buffer, or one a leaf)
  error report          = an all-reduce (sum) of each shard's ``[C]`` errors
  synch barrier         = the collectives themselves (lockstep)

The ``model`` axis replicates the small tabular learners: each of its
positions runs the same federation.  The mesh is ``launch/mesh.py``'s
(``torch.distributed`` process groups, one per axis); every collective
moves host tensors over gloo, so the ranks may share one card.  Where a
``shard_map`` body sees its block of a sharded array, a rank here holds
its collaborator's rows alone (:func:`shard_rows`): ``X [1, n, d]``,
``y``/``mask [1, n]``, the state's ``weights [1, n]`` and fit-cache rows;
the ensemble is replicated.

The packed wire buffer: a hypothesis bundle (a NamedTuple of float32 and
int32 tensors) travels as ONE float32 buffer, one all-gather a round
instead of one a leaf.  int32 leaves travel bitcast (``Tensor.view``,
never a conversion), so the buffer is the JAX package's byte for byte and
the round trip is exact; nothing on the wire does arithmetic on it.
``fl/distributed.py`` packs with the same helpers.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import scoring
from repro_torch.core.boosting import BoostState, Ensemble, _append, _local_fits, _samme_alpha
from repro_torch.core.serialization import _TENSOR, _structure
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh
from repro_torch.learners.base import LearnerSpec, WeakLearner


def fl_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The federation axes of ``mesh``: ``pod`` and ``data``, those it has."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def fl_shards(mesh: Mesh) -> int:
    """The number of collaborators the mesh holds (the product of its
    federation axes)."""
    return math.prod(mesh.shape[a] for a in fl_axes(mesh))


def collaborator_index(mesh: Mesh) -> int:
    """This rank's flat collaborator index over the federation axes, the
    first axis slowest (the JAX round's ``axis_index`` fold)."""
    idx = 0
    for a in fl_axes(mesh):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def shard_rows(mesh: Mesh, x: Any) -> Any:
    """This rank's block of a collaborator-stacked ``[C, ...]`` tensor or
    bundle, its leading axis kept (``[1, ...]``): what ``shard_map`` hands
    its body under a collaborator-sharded spec."""
    C, i = fl_shards(mesh), collaborator_index(mesh)
    leaves = tuple(x) if isinstance(x, tuple) else (x,)
    if any(t.shape[0] != C for t in leaves):
        raise ValueError(f"the mesh holds {C} collaborators; got leading axes "
                         f"{[t.shape[0] for t in leaves]}")
    rows = tuple(t[i:i + 1] for t in leaves)
    return type(x)(*rows) if isinstance(x, tuple) else rows[0]


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


# ---------------------------------------------------------------------------
# Collectives over the federation axes
# ---------------------------------------------------------------------------


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``[n_axis, ...]``: every rank's ``x`` along ``axis``, in coordinate
    order, gathered on the host and put back on ``x``'s device."""
    n = mesh.shape[axis]
    if n == 1:
        return x.unsqueeze(0)
    host = x.detach().to("cpu").contiguous()
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=mesh.group(axis))
    return torch.stack(parts).to(x.device)


def _multi_gather(x: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]) -> torch.Tensor:
    """All-gather over several axes, the last first, flattened to one
    leading collaborator axis (``[C, ...]``, collaborator-major)."""
    for a in reversed(axes):
        x = _all_gather(x, mesh, a)
    return x.reshape((-1,) + x.shape[len(axes):])


def _multi_psum(x: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the federation axes, the same
    bits on every rank (an all-reduce on the host)."""
    host = None
    for a in axes:
        if mesh.shape[a] == 1:
            continue
        if host is None:
            host = x.detach().to("cpu").contiguous().clone()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group(a))
    return x if host is None else host.to(x.device)


# ---------------------------------------------------------------------------
# The SPMD round
# ---------------------------------------------------------------------------


def sharded_adaboost_round(
    learner: WeakLearner,
    spec: LearnerSpec,
    mesh: Mesh,
    state: BoostState,
    X: torch.Tensor,  # [1, n, d] — this rank's collaborator block (shard_rows)
    y: torch.Tensor,  # [1, n]
    mask: torch.Tensor,  # [1, n]
    *,
    packed_broadcast: bool = True,
    generator: torch.Generator | None = None,
) -> Tuple[BoostState, dict]:
    """One AdaBoost.F round, collaborator-parallel over the mesh; every
    rank of the mesh calls it with its own block (``state.weights`` and
    ``state.fit_cache`` are this rank's rows; the ensemble is replicated).

    ``packed_broadcast`` (on by default, the §5.1 buffer-packing analogue)
    gathers the hypothesis as one float32 buffer, one collective a round;
    off, one collective a leaf.  Both are lossless.

    Step 2 fits on the shard-static fit cache (the trees' ``BinnedDataset``)
    with the local weights rescaled to the shard's sample count, as the
    JAX round does.  A randomised learner draws for all C collaborators
    from ``generator`` and fits on its own row's draws, as the fused run
    would (``boosting._local_fits(own=)``).  Step 3 predicts once: the
    ``[C, n]`` prediction matrix gives the shard's errors (one
    ``weighted_errors`` launch over ``[1, C, n]``), all-reduced over the
    federation axes, and the chosen member's mispredictions are a row of
    it.  Step 4 is replicated: the argmin, the SAMME alpha and the slot
    append run on every rank on the same summed errors.  The weight update
    is the un-renormalised product (one ``weight_update_product`` launch
    over ``[n]``), renormalised by the all-reduced total."""
    axes = fl_axes(mesh)
    C, i = fl_shards(mesh), collaborator_index(mesh)
    if X.shape[0] != 1 or y.shape[0] != 1 or mask.shape[0] != 1 or state.weights.shape[0] != 1:
        raise ValueError("sharded_adaboost_round takes this rank's block ([1, n, ...], shard_rows)")
    wi, mi, Xi, yi = state.weights[0], mask[0], X[0], y[0]

    # paper step 2: local training + hypothesis-space broadcast
    w_fit = wi / torch.clamp_min(torch.sum(wi), 1e-30) * torch.clamp_min(torch.sum(mi), 1.0)
    h = _local_fits(learner, spec, w_fit[None], X, y, state.fit_cache, generator, own=(C, i))
    h_local = type(h)(*(x[0] for x in h))
    if packed_broadcast:  # one collective for the whole hypothesis
        buf, fmt = _pack_leaves(h_local)
        hyps = _unpack_leaves(_multi_gather(buf, mesh, axes), fmt, lead=(C,))
    else:  # one all-gather a leaf (the pre-optimisation behaviour)
        hyps = type(h_local)(*(_multi_gather(leaf, mesh, axes) for leaf in h_local))

    # paper step 3: score the whole space on the local shard, predict once
    preds = scoring.predict_matrix(learner, spec, hyps, Xi)  # [C, n]
    local_errs = scoring.shard_errors(preds, yi, wi * mi)
    eps = _multi_psum(local_errs, mesh, axes)  # the weights are globally normalised

    # paper step 4 (the aggregator, replicated): select, alpha, append
    c = torch.argmin(eps)
    eps_c = torch.take(eps, c)
    alpha = _samme_alpha(eps_c, spec.n_classes)
    ens = _append(state.ensemble, scoring.take_slot(hyps, c), alpha)

    # the weight update, renormalised by the cross-shard total
    mis = scoring.chosen_mis(preds, yi, c)  # a row of preds
    wi = scoring.update_weights(wi, mis, mi, alpha, renormalize=False)
    total = _multi_psum(torch.sum(wi), mesh, axes)
    wi = wi / torch.clamp_min(total, 1e-30)
    metrics = {"epsilon": eps_c, "alpha": alpha, "chosen": c.to(torch.int32)}
    return BoostState(ens, wi[None], state.fit_cache), metrics


# ---------------------------------------------------------------------------
# Batch-sharded serving
# ---------------------------------------------------------------------------


def make_batch_predict(
    learner: WeakLearner,
    spec: LearnerSpec,
    mesh: Mesh,
    *,
    committee: bool = False,
) -> Callable[..., torch.Tensor]:
    """The serving engine's mesh backend (``serve/engine.EngineConfig(mesh=
    ...)``): ``fn(params, alpha, count, X) -> [n] int32``.

    Every rank of the mesh calls ``fn`` with the same ``X [n, d]`` (the
    params and alpha are replicated); each scores its slice of ``n //
    shards`` rows, at its flat collaborator index, with the SAME member
    vote and ``vote_argmax`` launch the local engine runs, and the slices
    are gathered in collaborator order.  A row's answer does not depend on
    the rows batched with it, so the answers are the local engine's bit for
    bit.  ``n`` must divide over the federation shards: the engine admits
    only a ``batch_size`` that does."""
    axes = fl_axes(mesh)
    shards, i = fl_shards(mesh), collaborator_index(mesh)

    def batch_predict(params, alpha: torch.Tensor, count: int, X: torch.Tensor) -> torch.Tensor:
        n = X.shape[0]
        if n % shards:
            raise ValueError(f"a batch of {n} rows does not divide over {shards} federation shards")
        b = n // shards
        preds = scoring.member_prediction(learner, spec, params, X[i * b:(i + 1) * b],
                                          committee=committee)  # [T, n / shards]
        T = alpha.shape[0]
        used = (torch.arange(T, device=alpha.device) < count).to(torch.float32) * alpha
        local = ops.vote_argmax(preds, used, n_classes=spec.n_classes)
        return _multi_gather(local, mesh, axes).reshape(-1)

    return batch_predict


def sharded_strong_predict(
    learner: WeakLearner, spec: LearnerSpec, mesh: Mesh, ens: Ensemble, X: torch.Tensor,
    *, committee: bool = False,
) -> torch.Tensor:
    """Ensemble inference, batch-sharded over the federation axes (the
    one-shot convenience over :func:`make_batch_predict`)."""
    fn = make_batch_predict(learner, spec, mesh, committee=committee)
    return fn(ens.params, ens.alpha, ens.count, X)
