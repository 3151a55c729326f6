"""Mixture-of-Experts FFN (grok-1, llama4-scout): the port's counterpart
of ``repro/models/moe.py``.

Dispatch is sort-based with a static capacity: tokens are flattened,
their top-k expert choices sorted by expert id (a stable sort), and each
expert processes a static ``[capacity]`` slice of its sorted tokens, so no
``[tokens, experts, capacity]`` one-hot tensor is ever built.  A token past
its expert's capacity is dropped (standard capacity-factor semantics) and
the Switch-style auxiliary load-balance loss discourages overflow.

The router's logits, softmax, top-k and the aux loss are float32 on
float32 router weights.  The expert FFN is always ``silu(x·W_gate) ·
(x·W_up) · W_down``, whatever ``cfg.mlp_type`` says (the JAX package's
experts ignore it too).  The three expert products are plain batched
matmuls in the activation dtype, as the JAX package's einsums are (no
Pallas kernel there, none here).

Three places where PyTorch and JAX differ, and what this module does:

* **Top-k ties.**  ``jax.lax.top_k`` puts the lower index first among
  equal values; ``torch.topk`` promises no order.  The choices are the
  first k of a *stable* descending sort of the probabilities.
* **The sort.**  ``jnp.argsort`` is stable; so is ``torch.argsort(...,
  stable=True)``, and each expert's first slot is
  ``torch.searchsorted(side="left")``, as in the JAX package.
* **The combine.**  The JAX package scatter-adds each kept slot's
  gate-weighted output onto its token (``.at[].add``); a CUDA
  ``index_add_`` adds in arrival order.  Here each (token, choice) reads
  its own slot (a gather), and the k ≤ 2 contributions are added onto
  zeros in choice order: the same sum as the scatter (addition of two
  terms commutes), deterministic by construction.

The four stages run inside spans (``obs/trace.py``: ``moe.route``,
``moe.dispatch``, ``moe.experts``, ``moe.combine``), so a profile attributes
the device time of an MoE layer to them.

While a recorder is on (``trace.recording()``: the port's tracer or
``torch.profiler``), each dense dispatch also counts its work into the
``mafl_moe_*`` counter families, labelled ``phase``: ``prefill`` or
``decode`` inside ``model.prefill`` or ``model.serve_step``, ``other``
outside both (a training forward).  ``rows_routed`` (the (token, choice)
pairs, ``n·k`` a group), ``rows_computed`` (the rows the experts multiply,
``G·E·cap``) and ``experts_read`` (``E``: every expert's weights are read)
are host ints.  ``rows_dropped`` (pairs past capacity) and
``experts_routed`` (experts with a routed pair) are added on the device,
with no host sync, into one ``[E + 1]`` accumulator a phase, which is
copied to the host and folded into the families when one is read.  The
counting runs inside ``moe.dispatch``, so a profile puts its cost in the
MoE layer.  Off, nothing is counted.

``DISPATCH_GROUPS`` (``set_dispatch_groups``) splits the tokens into G
groups that sort and fill their own expert buffers, as the JAX package's
dense grouped dispatch does.  When G equals the size of the current mesh's
data-parallel axes, the dispatch is data-parallel (the JAX ``shard_map``
branch): each data-parallel rank runs ``_moe_dense(x_local, G=1)`` on its
own ``B / dp`` rows, and the aux loss is the mean of the ranks' local aux
losses.  The mesh is a DTensor's own (the dry-run: the branch is then a
``local_map`` region), or, for plain tensors, the port ``Mesh`` of
``shardings.use_mesh`` (ranks of a process group: each rank's ``x`` is its
own rows, and the aux mean is a host all-reduce over the data axes).

Over DTensors (the dry-run's production mesh) every other dispatch also
runs in a ``local_map`` region, on all the tokens (G groups of them) and
each device's block of the experts' ``ff`` dim: the sort, gather and
scatter have no DTensor sharding rule, and the global dispatch gathers
the tokens, as the JAX package's auto-partitioned dispatch does.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import shardings
from repro_torch.models.layers import make_param, pdtype
from repro_torch.models.shardings import maybe_gather_weight as _mg
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace


class MoE(nn.Module):
    """``router [d, E]`` float32, ``w_gate``/``w_up [E, d, ff]`` and
    ``w_down [E, ff, d]`` in the model's dtype."""

    AXES = {"router": ("embed", None), "w_gate": ("experts", "embed", "ff"),
            "w_up": ("experts", "embed", "ff"), "w_down": ("experts", "ff", "embed")}

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        d, ff, E, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, pdtype(cfg)
        self.router = make_param(gen, (d, E), torch.float32)
        self.w_gate = make_param(gen, (E, d, ff), dt, fan_in=d)
        self.w_up = make_param(gen, (E, d, ff), dt, fan_in=d)
        self.w_down = make_param(gen, (E, ff, d), dt, fan_in=ff)


# The grouped dispatch: G groups of N / G tokens each sort and fill their
# own expert buffers.  G = 1 is the global dispatch.
DISPATCH_GROUPS = 1


def set_dispatch_groups(value: int) -> None:
    global DISPATCH_GROUPS
    DISPATCH_GROUPS = value


# -- the counters (recorded only while trace.recording()) --------------------

PHASES = {"model.prefill": "prefill", "model.serve_step": "decode"}  # enclosing span -> phase
_ACC: dict = {}  # (phase, E, device) -> [E + 1] int64: dispatches that routed to each expert, pairs dropped
_ACC_LOCK = threading.Lock()


def _fold() -> None:
    """Takes the accumulators into the families: one copy to the host a
    phase."""
    with _ACC_LOCK:
        taken = list(_ACC.items())
        _ACC.clear()
    for (phase, E, _), acc in taken:
        counts = acc.tolist()
        EXPERTS_ROUTED.labels(phase=phase).inc(sum(counts[:E]))
        ROWS_DROPPED.labels(phase=phase).inc(counts[E])


ROWS_ROUTED = obs_metrics.counter("mafl_moe_rows_routed_total", "(token, choice) pairs routed",
                                  labels=("phase",))
ROWS_COMPUTED = obs_metrics.counter("mafl_moe_rows_computed_total", "expert rows multiplied (G*E*capacity)",
                                    labels=("phase",))
ROWS_DROPPED = obs_metrics.counter("mafl_moe_rows_dropped_total", "routed pairs past their expert's capacity",
                                   labels=("phase",), fold=_fold)
EXPERTS_READ = obs_metrics.counter("mafl_moe_experts_read_total", "experts whose weights the experts stage read",
                                   labels=("phase",))
EXPERTS_ROUTED = obs_metrics.counter("mafl_moe_experts_routed_total", "experts with at least one routed pair",
                                     labels=("phase",), fold=_fold)


def _phase() -> str:
    for name in reversed(trace.open_spans()):
        if name in PHASES:
            return PHASES[name]
    return "other"


def _count(E: int, cap: int, flat_expert: torch.Tensor, keep: torch.Tensor) -> None:
    """One dispatch's counts (``flat_expert [G, n·k]``, ``keep`` its pairs
    within capacity): host ints, and on the device the experts with a pair
    and the pairs dropped, added into the phase's accumulator."""
    G, nk = flat_expert.shape
    phase = _phase()
    ROWS_ROUTED.labels(phase=phase).inc(G * nk)
    ROWS_COMPUTED.labels(phase=phase).inc(G * E * cap)
    EXPERTS_READ.labels(phase=phase).inc(E)
    call = torch.zeros(E + 1, dtype=torch.int64, device=keep.device)
    call.scatter_(0, flat_expert.reshape(-1), 1)  # 1 for each expert with a routed pair
    call[E] = keep.numel() - keep.sum()
    key = (phase, E, keep.device)
    with _ACC_LOCK:
        if key in _ACC:
            _ACC[key].add_(call)
        else:
            _ACC[key] = call


def capacity(cfg: ArchConfig, n: int) -> int:
    """Slots an expert holds for a group of ``n`` tokens: the ceiling of
    ``n·k / E`` times the capacity factor, at least ``min(n·k, 8)`` so that
    tiny decode batches do not drop tokens on router collisions; truncated
    to an int, as the JAX package writes it."""
    k, E = cfg.experts_per_token, cfg.n_experts
    return int(max(-(-n * k // E) * cfg.capacity_factor, min(n * k, 8)))


def route(cfg: ArchConfig, p: MoE, xf: torch.Tensor):
    """The router over ``xf [G, n, d]``: (probabilities ``[G, n, E]``, the
    chosen experts ``[G, n, k]`` int64 and their gates ``[G, n, k]``
    float32, renormalised over the k choices when k > 1)."""
    k = cfg.experts_per_token
    logits = torch.einsum("gnd,de->gne", xf.float(), p.router)
    probs = torch.softmax(logits, dim=-1)
    # top-k as jax.lax.top_k ranks: descending, the lower index first on ties
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = gate_vals[..., :k], expert_ids[..., :k]
    if k > 1:  # renormalise the selected gates
        gate_vals = gate_vals / torch.clamp_min(torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    return probs, expert_ids, gate_vals


def apply_moe(cfg: ArchConfig, p: MoE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], the aux load-balance loss, a float32
    scalar).  ``DISPATCH_GROUPS`` > 1 dispatches in that many groups when
    it divides the token count, data-parallel when it is the current
    mesh's data-parallel size (the module docstring)."""
    B, S, _ = x.shape
    dt = shardings.is_dtensor(x)
    mesh = x.device_mesh if dt else shardings.current_mesh()
    dp = shardings.dp_size(mesh) if mesh is not None else 1
    N = B * S * (1 if dt else dp)  # the global token count: a rank's x holds its own rows
    G = DISPATCH_GROUPS if (DISPATCH_GROUPS > 1 and N % DISPATCH_GROUPS == 0) else 1
    if G > 1 and G == dp:
        return _dp_dispatch(cfg, p, x, mesh)
    if dt:
        return _moe_region(cfg, p, x, (None, None, None), G)
    return _moe_dense(cfg, p, x, G)


class _Experts(NamedTuple):
    router: torch.Tensor
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor


def _dp_dispatch(cfg: ArchConfig, p: MoE, x: torch.Tensor, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The data-parallel dispatch: each rank's rows through ``_moe_dense(.,
    G=1)``, the aux loss the mean of the local ones."""
    axes = shardings.batch_axes(mesh)
    if shardings.is_dtensor(x):
        out, aux = _moe_region(cfg, p, x, (axes, None, None), 1)
        return out, torch.mean(aux)
    out, aux = _moe_dense(cfg, p, x, 1)
    total = aux.detach().to("cpu").clone()
    for a in axes:
        if mesh.shape[a] > 1:
            torch.distributed.all_reduce(total, group=mesh.group(a))
    return out, total.to(aux.device) / shardings.dp_size(mesh)


def _moe_region(cfg: ArchConfig, p: MoE, x: torch.Tensor, x_spec, G: int):
    """``_moe_dense(x, G)`` in a ``local_map`` region: ``x`` at ``x_spec``,
    the experts at their model-only layouts (a 'data' shard gathered), the
    output summed over the axes the experts' ``ff`` dim is split over.
    With a sharded batch, each device's aux comes back as one entry of a
    ``[dp]`` vector."""
    mesh = x.device_mesh
    w_specs = {k: shardings.model_only_spec(MoE.AXES[k], getattr(p, k).shape, mesh) for k in _Experts._fields}
    summed = tuple(a for s in w_specs.values() for e in s for a in ((e,) if isinstance(e, str) else e or ()))
    dp_rows = x_spec[0] is not None

    def local(xl, *ws):
        out, aux = _moe_dense(cfg, _Experts(*ws), xl, G)
        return out, (aux[None] if dp_rows else aux)

    aux_spec = (x_spec[0],) if dp_rows else ()
    return shardings.local_region(local, (x_spec, *w_specs.values()),
                                  [shardings.Summed(x_spec, summed), aux_spec],
                                  x, *(getattr(p, k) for k in _Experts._fields))


def _moe_dense(cfg: ArchConfig, p: MoE, x: torch.Tensor, G: int) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    N = B * S
    n = N // G  # tokens per dispatch group
    dev = x.device
    xf = x.reshape(G, n, d)
    with trace.span("moe.route"):
        probs, expert_ids, gate_vals = route(cfg, p, xf)
        # Switch-style aux loss: E * sum_e f_e * P_e (global means)
        me = torch.mean(probs, dim=(0, 1))  # [E]
        top1 = expert_ids[..., 0]
        ce = torch.sum((top1[..., None] == torch.arange(E, device=dev)).to(torch.float32), dim=(0, 1)) / N
        aux = E * torch.sum(me * ce)

    # ---- sort-based dispatch (per group) ---------------------------------
    cap = capacity(cfg, n)
    nk = n * k
    with trace.span("moe.dispatch"):
        flat_expert = expert_ids.reshape(G, nk)
        flat_gate = gate_vals.reshape(G, nk)
        flat_token = torch.arange(n, device=dev).repeat_interleave(k).expand(G, nk)
        order = torch.argsort(flat_expert, dim=-1, stable=True)
        se = torch.take_along_dim(flat_expert, order, dim=-1).contiguous()
        st = torch.take_along_dim(flat_token, order, dim=-1)
        sg = torch.take_along_dim(flat_gate, order, dim=-1)
        # rank within its expert = running index - index of the expert's first slot
        first = torch.searchsorted(se, torch.arange(E, device=dev).expand(G, E).contiguous(), side="left")
        rank = torch.arange(nk, device=dev)[None] - torch.take_along_dim(first, se, dim=-1)
        keep = rank < cap
        # a dropped choice writes the sink column E*cap, cut off below
        slot = torch.where(keep, se * cap + rank, E * cap)

        # the expert buffers [G, E*cap]: each kept slot's token (n: the dummy
        # zero row) and its gate; kept slots are unique, so no write collides
        buf_tok = torch.full((G, E * cap + 1), n, dtype=torch.int64, device=dev)
        buf_tok.scatter_(1, slot, st)
        buf_tok = buf_tok[:, :E * cap]
        gates_slot = torch.zeros((G, E * cap + 1), dtype=torch.float32, device=dev)
        gates_slot.scatter_(1, slot, sg)
        gates_slot = gates_slot[:, :E * cap]
        xpad = torch.cat([xf, torch.zeros((G, 1, d), dtype=xf.dtype, device=dev)], dim=1)
        inp = torch.take_along_dim(xpad, buf_tok[:, :, None], dim=1).reshape(G, E, cap, d)
        if trace.recording():
            _count(E, cap, flat_expert, keep)

    # the experts: silu(x W_gate) * (x W_up) W_down, batched over E
    with trace.span("moe.experts"):
        ax = MoE.AXES
        h = F.silu(torch.einsum("gecd,edf->gecf", inp, _mg(p.w_gate, ax["w_gate"]))) * \
            torch.einsum("gecd,edf->gecf", inp, _mg(p.w_up, ax["w_up"]))
        out_e = torch.einsum("gecf,efd->gecd", h, _mg(p.w_down, ax["w_down"])).reshape(G, E * cap, d)

    # the combine: each (token, choice) reads its slot's gate-weighted
    # output (the zero row E*cap when dropped), added onto zeros in choice order
    with trace.span("moe.combine"):
        valid = (buf_tok < n).to(out_e.dtype)
        contrib = out_e * (gates_slot * valid)[:, :, None].to(out_e.dtype)
        contrib = torch.cat([contrib, torch.zeros((G, 1, d), dtype=contrib.dtype, device=dev)], dim=1)
        slot_of_choice = torch.empty_like(slot).scatter_(1, order, slot)  # [G, n*k], token-major
        picked = torch.take_along_dim(contrib, slot_of_choice[:, :, None], dim=1).reshape(G, n, k, d)
        out = torch.zeros((G, n, d), dtype=contrib.dtype, device=dev)
        for j in range(k):
            out = out + picked[:, :, j]
    return out.reshape(B, S, d).to(x.dtype), aux
