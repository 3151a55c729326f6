"""Public model API over the decoder stack, the port's counterpart of
``repro/models/model.py``:

  * ``loss_fn``     — next-token CE, sequence-chunked (never
                      materialises [B, S, V] logits);
  * ``train_step``  — AdamW step, with micro-batch accumulation;
  * ``prefill``     — full-sequence forward filling per-layer KV caches
                      and recurrent states;
  * ``serve_step``  — one token against the caches.

The training forward runs the attention's plain route
(``plain_attention=True``: ``attention_ref``, or ``_chunked_local_attention``
on window layers), because the JAX training forward runs without Pallas;
prefill runs the ``flash_attention`` kernel, which has no backward.

A ``TrainState`` holds the model itself as its parameters, and
``train_step`` updates them and the AdamW moments in place: a state is
consumed by the step that advances it, as a ``ServeState`` is by the
serving step (its caches are written in place).  The decode position is a
host ``int``: the loop never reads it back from the device.

For the production-mesh dry-run (``launch/dryrun.py``): ``param_axes``
gives each parameter's logical axes beside ``param_tree``,
``abstract_model`` builds a model whose parameters are fake tensors (shapes
and dtypes, no storage, as ``jax.eval_shape`` gives), and ``input_specs``
the stand-ins of an ``InputShape``'s inputs.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.models.attention import init_cache
from repro_torch.models.layers import pdtype, unembed
from repro_torch.models.shardings import constrain_microbatch, is_dtensor, place_state, whole_batch
from repro_torch.models.transformer import Cache, Transformer, init_caches, init_state
from repro_torch.obs import trace
from repro_torch.optim.optimizers import AdamWConfig, AdamWState, Tree, adamw_update, init_adamw

MOE_AUX_WEIGHT = 0.01


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _chunk_loss(cfg: ArchConfig, embed, h, t, m):
    logits = unembed(cfg, embed, h)  # [B, c, V] f32
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):  # a vocabulary sharded over a mesh: contract with a one-hot, as JAX does
        hit = torch.arange(logits.shape[-1], device=logits.device) == t.long()[..., None]
        ll = torch.sum(logits * hit.to(logits.dtype), dim=-1)
    else:  # the gather picks the one-hot contraction's value exactly
        ll = torch.gather(logits, -1, t.long()[..., None])[..., 0]
    return torch.sum((lse - ll) * m), torch.sum(m)


def _chunked_ce(cfg: ArchConfig, model: Transformer, hidden: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Cross-entropy over sequence chunks; each chunk is recomputed in the
    backward, so its [B, c, V] logits are transient in both passes, which
    is what makes 256k-vocab training fit."""
    S = hidden.shape[1]
    chunk = min(chunk, S)
    tot = cnt = torch.zeros((), device=hidden.device)
    for lo in range(0, S, chunk):  # S // chunk whole chunks, then the remainder
        hi = min(lo + chunk, S)
        args = (cfg, model.embed, hidden[:, lo:hi], targets[:, lo:hi], mask[:, lo:hi])
        if torch.is_grad_enabled():
            l, c = checkpoint(_chunk_loss, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            l, c = _chunk_loss(*args)
        tot, cnt = tot + l, cnt + c
    return tot / torch.clamp_min(cnt, 1.0)


def loss_fn(cfg: ArchConfig, model: Transformer, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"] [B, S+1]`` (and
    its optional float ``loss_mask [B, S]``), plus ``MOE_AUX_WEIGHT`` times
    the MoE layers' load-balance loss.  A VLM batch's ``prefix`` and an
    audio batch's ``frames`` go to the forward; the loss scores the token
    positions only (``hidden[:, P:]``)."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    prefix = batch.get("prefix")
    hidden, aux = model(inputs, prefix=prefix, frames=batch.get("frames"), plain_attention=True,
                        return_aux=True)
    if prefix is not None:
        hidden = hidden[:, cfg.prefix_tokens:]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    # aux: the MoE layers' load-balance loss (0 without MoE layers)
    return _chunked_ce(cfg, model, hidden, targets, mask) + MOE_AUX_WEIGHT * aux


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def _jax_key(name: str, period: int):
    """Where the JAX package's params pytree holds the port parameter
    ``name``: (key path, slice of the stacked unit leaf).  Layer ``r`` is
    unit position ``L{r % period}`` at slice ``r // period``; encoder layer
    ``i`` is ``encoder/unit`` at slice ``i``."""
    parts = [p for p in name.split(".") if p != "gamma"]
    if parts[0] == "layers":
        r = int(parts[1])
        return ("unit", f"L{r % period}", *parts[2:]), r // period
    if parts[:2] == ["encoder", "layers"]:
        return ("encoder", "unit", *parts[3:]), int(parts[2])
    return tuple(parts), 0


def param_tree(model: Transformer) -> Tree:
    """The model's parameters by name, in the JAX package's leaf order
    (``jax.tree`` flattens dicts in sorted key order; a stacked unit leaf
    holds its layers in order), the order the global norm sums them in."""
    period = len(model.cfg.pattern()[0])
    named = dict(model.named_parameters())
    return {k: named[k] for k in sorted(named, key=lambda k: _jax_key(k, period))}


def param_axes(model: Transformer) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each parameter's logical axes ("vocab", "embed", "ff", "heads", ...),
    keyed and ordered as ``param_tree``: the ``AXES`` table of the module
    that owns it, the JAX package's axes tree leaf without its ``"layers"``
    axis."""
    owners = dict(model.named_modules())
    out = {}
    for name in param_tree(model):
        mod, _, leaf = name.rpartition(".")
        out[name] = type(owners[mod]).AXES[leaf]
    return out


def abstract_model(cfg: ArchConfig, mode=None) -> Transformer:
    """The model of ``cfg`` with fake-tensor parameters under ``mode`` (a
    ``FakeTensorMode``; a new one by default): every shape and dtype,
    nothing allocated, so grok-1's 314 G parameters fit on any host."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with mode or FakeTensorMode():
        return Transformer(cfg, torch.Generator())


class TrainState(NamedTuple):
    params: Transformer
    opt: AdamWState


def init_train_state(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> TrainState:
    """The model's weights drawn from ``generator`` (on its device), placed
    on ``device``, and zero AdamW moments."""
    dev = resolve_device(device)
    model = Transformer(cfg, generator).to(dev)
    return TrainState(model, init_adamw(param_tree(model)))


@contextlib.contextmanager
def _grads_of(params: List[torch.Tensor]):
    for p in params:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(False)


def _loss_and_grads(cfg: ArchConfig, model: Transformer, params: Tree, batch):
    with torch.enable_grad(), _grads_of(list(params.values())):
        loss = loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def train_step(
    cfg: ArchConfig,
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    opt_cfg: AdamWConfig = AdamWConfig(),
    accum: int = 1,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One synchronous step: the gradient of ``loss_fn``, then AdamW.

    ``accum`` > 1 splits the batch into micro-batches and sums their
    gradients in float32 buffers from zeros, then divides by ``accum``, as
    the JAX package's scan does; with ``accum == 1`` the gradients keep the
    parameters' dtype.  Returns the advanced state (the same model and
    moments, updated in place) and {"loss", "grad_norm"} as device
    scalars."""
    model = state.params
    params = param_tree(model)
    if accum == 1:
        loss, grads = _loss_and_grads(cfg, model, params, batch)
    else:
        B = batch["tokens"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} micro-batches")
        mb = B // accum
        stacked = {k: constrain_microbatch(whole_batch(v).reshape(accum, mb, *v.shape[1:]))
                   for k, v in batch.items()}
        loss = torch.zeros((), device=batch["tokens"].device)
        grads = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        for i in range(accum):
            micro = {k: v[i] for k, v in stacked.items()}
            l, gi = _loss_and_grads(cfg, model, params, micro)
            loss = loss + l
            for k, g in gi.items():
                grads[k].add_(g.float())
            del gi
        loss = loss / accum
        for g in grads.values():
            g.div_(accum)
    _, opt, gnorm = adamw_update(opt_cfg, params, grads, state.opt)
    return TrainState(model, opt), {"loss": loss, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


class ServeState(NamedTuple):
    caches: List[Cache]  # one per layer: [B, T, Kv, D], a window's ring or a recurrent state
    pos: int  # next absolute position


def init_serve_state(cfg: ArchConfig, batch: int, cache_len: int, device) -> ServeState:
    return ServeState(init_caches(cfg, batch, cache_len, device), 0)


def _prefill_caches(model: Transformer, batch: int, cache_len: int, n_frames: int, device,
                    cross_dtype=None) -> List[Cache]:
    """The state prefill fills: full layers at ``cache_len`` slots (zero
    past the prompt; the decode mask ``j <= pos`` ignores them), window
    layers at ``window`` slots whatever the prompt, recurrent layers'
    states at their constant size; an audio layer's cross cache at the
    ``n_frames`` the encoder sees, in ``cross_dtype`` (default the
    model's)."""
    cfg = model.cfg

    def one(layer) -> Cache:
        if layer.recurrent:
            c = init_state(cfg, layer.kind, batch, device)
        else:
            # A ring holds ``window`` slots here, not init_caches' min(window,
            # cache_len): the JAX package's prefill pads a short prompt's window
            # cache to the window, and its _pad_caches grows only full layers
            # (nor the cross caches).
            c = init_cache(cfg, batch, cache_len if layer.window is None else layer.window, None,
                           pdtype(cfg), device)
        if layer.has_cross:
            return c, init_cache(cfg, batch, n_frames, None, cross_dtype or pdtype(cfg), device)
        return c

    return [one(layer) for layer in model.layers]


@torch.no_grad()
def prefill(
    model: Transformer,
    batch: Dict[str, torch.Tensor],
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, ServeState]:
    """Full-sequence forward over ``batch["tokens"] [B, S]`` (after a VLM
    batch's ``prefix [B, P, d]``; an audio batch's ``frames [B, F, d]``
    through the encoder); returns the last position's logits [B, V]
    (float32) and the state at position P + S, its full layers' caches at
    ``max(P + S, cache_len)`` slots, its cross caches at F."""
    tokens, prefix, frames = batch["tokens"], batch.get("prefix"), batch.get("frames")
    B = tokens.shape[0]
    end = tokens.shape[1] + (0 if prefix is None else prefix.shape[1])
    with trace.span("model.prefill", rows=B, positions=end):
        n_frames = model.cfg.encoder_seq if frames is None else frames.shape[1]
        # the cross caches hold the encoder output's K/V in its promoted dtype
        # (float32 from float32 frames), as the JAX prefill returns them
        cross = None if frames is None else torch.promote_types(frames.dtype, pdtype(model.cfg))
        caches = _prefill_caches(model, B, max(end, cache_len or end), n_frames, tokens.device, cross)
        if is_dtensor(tokens):  # the dry-run's mesh: the caches are DTensors too
            caches = place_state(caches, B, tokens.device_mesh)
        state = ServeState(caches, end)
        hidden = model(tokens, prefix=prefix, frames=frames, caches=state.caches)
        logits = unembed(model.cfg, model.embed, hidden[:, -1:, :])[:, 0]
    return logits, state


@torch.no_grad()
def serve_step(
    model: Transformer, state: ServeState, token: torch.Tensor
) -> Tuple[torch.Tensor, ServeState]:
    """token [B, 1] -> (logits [B, V] float32, the advanced state)."""
    with trace.span("model.serve_step", rows=token.shape[0], pos=state.pos):
        logits, caches = model.decode_step(state.caches, token, state.pos)
    return logits, ServeState(caches, state.pos + 1)


# ---------------------------------------------------------------------------
# Dry-run input specs (fake-tensor stand-ins: no allocation)
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: InputShape, mode=None) -> Dict[str, Any]:
    """Stand-ins of every model input of ``shape``, fake tensors under
    ``mode`` (a ``FakeTensorMode``; a new one by default): ``tokens`` (train
    ``[B, S + 1]``, prefill ``[B, S]``) with a VLM's ``prefix`` or an audio
    model's ``frames`` in the model's dtype, or, for decode, ``token [B, 1]``
    and the ``init_serve_state`` of ``S`` slots."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    B, S = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, pdtype(cfg)
    with mode or FakeTensorMode():
        ex: Dict[str, Any] = {}
        if cfg.arch_type == "vlm":
            ex["prefix"] = torch.empty((B, cfg.prefix_tokens, cfg.d_model), dtype=dt)
        if cfg.arch_type == "audio":
            ex["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model), dtype=dt)
        if shape.kind == "train":
            return {"tokens": torch.empty((B, S + 1), dtype=i32), **ex}
        if shape.kind == "prefill":
            return {"tokens": torch.empty((B, S), dtype=i32), **ex}
        if shape.kind == "decode":
            return {"token": torch.empty((B, 1), dtype=i32), "state": init_serve_state(cfg, B, S, "cpu")}
    raise ValueError(shape.kind)
