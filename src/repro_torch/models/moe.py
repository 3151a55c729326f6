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

The four stages run inside ``torch.profiler.record_function`` ranges
(``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``), so a
profile attributes the device time of an MoE layer to them.

``DISPATCH_GROUPS`` (``set_dispatch_groups``) splits the tokens into G
groups that sort and fill their own expert buffers, as the JAX package's
dense grouped dispatch does.  Its ``shard_map`` branch, which pins each
group to a data-parallel device group, needs a mesh of such devices and
has no one-card counterpart (ROADMAP Queue 1 item 13g).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import make_param, pdtype


class MoE(nn.Module):
    """``router [d, E]`` float32, ``w_gate``/``w_up [E, d, ff]`` and
    ``w_down [E, ff, d]`` in the model's dtype."""

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
    it divides the token count."""
    B, S, _ = x.shape
    N = B * S
    G = DISPATCH_GROUPS if (DISPATCH_GROUPS > 1 and N % DISPATCH_GROUPS == 0) else 1
    return _moe_dense(cfg, p, x, G)


def _moe_dense(cfg: ArchConfig, p: MoE, x: torch.Tensor, G: int) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    N = B * S
    n = N // G  # tokens per dispatch group
    dev = x.device
    xf = x.reshape(G, n, d)
    with record_function("moe.route"):
        probs, expert_ids, gate_vals = route(cfg, p, xf)
        # Switch-style aux loss: E * sum_e f_e * P_e (global means)
        me = torch.mean(probs, dim=(0, 1))  # [E]
        top1 = expert_ids[..., 0]
        ce = torch.sum((top1[..., None] == torch.arange(E, device=dev)).to(torch.float32), dim=(0, 1)) / N
        aux = E * torch.sum(me * ce)

    # ---- sort-based dispatch (per group) ---------------------------------
    cap = capacity(cfg, n)
    nk = n * k
    with record_function("moe.dispatch"):
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

    # the experts: silu(x W_gate) * (x W_up) W_down, batched over E
    with record_function("moe.experts"):
        h = F.silu(torch.einsum("gecd,edf->gecf", inp, p.w_gate)) * \
            torch.einsum("gecd,edf->gecf", inp, p.w_up)
        out_e = torch.einsum("gecf,efd->gecd", h, p.w_down).reshape(G, E * cap, d)

    # the combine: each (token, choice) reads its slot's gate-weighted
    # output (the zero row E*cap when dropped), added onto zeros in choice order
    with record_function("moe.combine"):
        valid = (buf_tok < n).to(out_e.dtype)
        contrib = out_e * (gates_slot * valid)[:, :, None].to(out_e.dtype)
        contrib = torch.cat([contrib, torch.zeros((G, 1, d), dtype=contrib.dtype, device=dev)], dim=1)
        slot_of_choice = torch.empty_like(slot).scatter_(1, order, slot)  # [G, n*k], token-major
        picked = torch.take_along_dim(contrib, slot_of_choice[:, :, None], dim=1).reshape(G, n, k, d)
        out = torch.zeros((G, n, d), dtype=contrib.dtype, device=dev)
        for j in range(k):
            out = out + picked[:, :, j]
    return out.reshape(B, S, d).to(x.dtype), aux
