"""Attention sublayers: GQA/MQA with RoPE, sliding-window local layers and
logit soft-capping, over the full sequence (training and prefill) and for
one decoded token against a full or ring-buffer KV cache.  The port's
counterpart of ``repro/models/attention.py``.

The full-sequence attention takes one of two routes, as in the JAX package:
prefill runs the ``flash_attention`` kernel (the JAX ``use_pallas=True``
route), and the training forward, which the JAX package runs without
Pallas, runs that route's plain functions with ``plain_attention=True``:
``kernels/ref.py::attention_ref``, or ``_chunked_local_attention`` on a
window layer whose sequence is a multiple (at least 2) of the window.  The
kernel has no backward; this is the JAX route that has none, not a
fallback.

Cross-attention (whisper's decoder) takes its K/V from the encoder's
output (``kv_x``): non-causal, without RoPE, S queries against the
encoder's T frames, always on the kernel's (or, in training, the plain)
full route.

Decode caches: a full layer's is ``[B, T, Kv, D]`` and slot ``j`` holds
position ``j``; a local layer's is a ring buffer of ``min(window, T)``
slots, slot ``pos % T``; a cross-attention layer's holds the encoder
output's K/V, every slot valid, and is read-only.  Unlike the JAX package,
:func:`attend_decode` writes the new token's K/V into the cache in place:
a step then copies nothing of the cache, and the caller's ``LayerCache``
is the updated one.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import make_param, matmul, pdtype, rope
from repro_torch.models import shardings
from repro_torch.models.shardings import maybe_gather_weight as _mg
from repro_torch.obs import trace


class Attention(nn.Module):
    """``wq [d, H, D]``, ``wk``/``wv [d, Kv, D]``, ``wo [H, D, d]``."""

    AXES = {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed")}

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        d, H, Kv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = pdtype(cfg)
        self.wq = make_param(gen, (d, H, D), dt, fan_in=d)
        self.wk = make_param(gen, (d, Kv, D), dt, fan_in=d)
        self.wv = make_param(gen, (d, Kv, D), dt, fan_in=d)
        self.wo = make_param(gen, (H, D, d), dt, fan_in=H * D)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, S, d] @ [d, H, D] -> [B, S, H, D], one matmul, last axis contiguous.
    Over DTensors, a local region (``shardings.projection_specs``): DTensor
    cannot split the flattened head dim of a product, or of its gradient,
    over an axis the heads do not divide."""
    if shardings.is_dtensor(w):
        xs, ws, outs = shardings.projection_specs(x, w)
        return shardings.local_region(_heads, (xs, ws), outs, x, w)
    return matmul(x, w.flatten(1)).unflatten(-1, w.shape[1:])


def _project_qkv(p: Attention, x: torch.Tensor, kv_x: Optional[torch.Tensor] = None):
    kv_x = x if kv_x is None else kv_x
    ax = Attention.AXES
    return _heads(x, _mg(p.wq, ax["wq"])), _heads(kv_x, _mg(p.wk, ax["wk"])), _heads(kv_x, _mg(p.wv, ax["wv"]))


def _out(p: Attention, o: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] against ``wo [H, D, d]`` -> [B, S, d].  Over DTensors, a
    local region (``shardings.output_specs``), for the reason ``_heads``
    gives."""
    with trace.span("attn.out"):
        if shardings.is_dtensor(p.wo):
            os_, ws, outs = shardings.output_specs(o, p.wo)
            return shardings.local_region(_out_local, (os_, ws), outs, o, p.wo)
        return _out_local(o, p.wo)


def _out_local(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return matmul(o.reshape(*o.shape[:2], -1), wo.flatten(0, 1))


# Block-local computation for sliding-window layers: O(S * 2w) instead of
# O(S^2).  Semantically identical to masked full attention (every query in
# chunk i only sees keys in chunks i-1, i under ``pos_q - pos_k < w``).
CHUNKED_LOCAL = True


def set_chunked_local(value: bool) -> None:
    global CHUNKED_LOCAL
    CHUNKED_LOCAL = value


def _chunked_local_attention(cfg: ArchConfig, q, k, v, window: int) -> torch.Tensor:
    """q/k/v: [B, S, H|Kv, D] with S % window == 0.  Causal sliding window,
    float32 logits and softmax, cast to ``q.dtype``."""
    B, S, H, D = q.shape
    Kv = k.shape[2]
    g = H // Kv
    w = window
    nc = S // w
    qc = q.reshape(B, nc, w, H, D)
    # keys for chunk i = [chunk i-1 ; chunk i]  (zero-pad chunk -1)
    kc = k.reshape(B, nc, w, Kv, D)
    vc = v.reshape(B, nc, w, Kv, D)
    k2 = torch.cat([torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], 1), kc], 2)  # [B, nc, 2w, Kv, D]
    v2 = torch.cat([torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], 1), vc], 2)

    scale = float(1.0 / torch.tensor(float(D)).sqrt())  # in float32, as the JAX package's
    qg = qc.reshape(B, nc, w, Kv, g, D)
    logits = torch.einsum("bcsKgd,bctKd->bcKgst", qg.float(), k2.float()) * scale  # [B, nc, Kv, g, w, 2w]
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    dev = q.device
    qpos = torch.arange(w, device=dev)[:, None] + w  # position within the 2w key span
    kpos = torch.arange(2 * w, device=dev)[None, :]
    mask = (kpos <= qpos) & ((qpos - kpos) < w)  # causal + window
    first = torch.arange(nc, device=dev) == 0  # chunk 0 has no (real) previous chunk
    mask = mask[None, :, :] & ~(first[:, None, None] & (kpos < w)[None])
    logits = logits.masked_fill(~mask[None, :, None, None, :, :], -1e30)
    att = torch.softmax(logits, dim=-1)
    out = torch.einsum("bcKgst,bctKd->bcsKgd", att, v2.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def attend_full(
    cfg: ArchConfig,
    p: Attention,
    x: torch.Tensor,  # [B, S, d]
    positions: torch.Tensor,  # [S]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    use_rope: bool = True,
    plain_attention: bool = False,
    kv_x: Optional[torch.Tensor] = None,  # cross-attention source [B, T, d]
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention; returns (out [B, S, d], (k, v) [B, T, Kv,
    D]) so that prefill can cache.  Self-attention unless ``kv_x`` is
    given (T = S then).  The kernel takes the ``[B, H, S, D]`` transposes
    as strided views: nothing is copied for it.  ``plain_attention`` (the
    training forward's) takes the plain route."""
    with trace.span("attn.qkv"):
        q, k, v = _project_qkv(p, x, kv_x)
        if use_rope and cfg.pos_emb == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions if kv_x is None else torch.arange(k.shape[1], device=k.device), cfg.rope_theta)
    S = q.shape[1]
    if (plain_attention and CHUNKED_LOCAL and window is not None and causal and kv_x is None
            and S % window == 0 and S // window >= 2):
        out = _heads_local(lambda q, k, v: _chunked_local_attention(cfg, q, k, v, window), q, k, v, 2)
    else:
        # a float32 encoder output against bf16 queries (whisper's cross-attention
        # over float32 frames) attends in float32, the result in q's dtype, as
        # the JAX package's attention returns it
        dt = torch.promote_types(q.dtype, k.dtype)
        attend = ref.attention_ref if plain_attention else ops.flash_attention
        out = _heads_local(functools.partial(attend, causal=causal, window=window, softcap=cfg.logit_softcap),
                           q.transpose(1, 2).to(dt), k.transpose(1, 2), v.transpose(1, 2),
                           1).transpose(1, 2).to(q.dtype)  # [B, S, H, D]
    return _out(p, out), (k, v)


def _heads_local(fn, q, k, v, head_dim: int):
    """``fn(q, k, v)``; over DTensors (the dry-run's production mesh), on
    each device's block of batch rows and heads (``shardings.heads_spec``),
    as the attention of one (row, head) needs no other's."""
    if not shardings.is_dtensor(q):
        return fn(q, k, v)
    mesh = q.device_mesh
    n = (q.shape[head_dim], k.shape[head_dim])
    qs, ks = shardings.heads_spec(q, head_dim, n, mesh), shardings.heads_spec(k, head_dim, n, mesh)
    return shardings.local_region(fn, (qs, ks, ks), qs, q, k, v)


class LayerCache(NamedTuple):
    """KV cache of one attention layer."""

    k: torch.Tensor  # [B, T_cache, Kv, D]
    v: torch.Tensor  # [B, T_cache, Kv, D]


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, window: Optional[int], dtype,
               device) -> LayerCache:
    """Zeros of ``[B, T, Kv, D]``: ``T = seq_len``, or a ring of
    ``min(window, seq_len)`` slots for a window layer."""
    T = min(window, seq_len) if window else seq_len
    shape = (batch, T, cfg.n_kv_heads, cfg.hd)
    return LayerCache(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device))


def attend_decode(
    cfg: ArchConfig,
    p: Attention,
    x: torch.Tensor,  # [B, 1, d]
    cache: LayerCache,
    pos: int,  # position of the new token
    *,
    window: Optional[int] = None,
    use_rope: bool = True,
    cross: bool = False,
) -> Tuple[torch.Tensor, LayerCache]:
    """One decode step in plain PyTorch (the JAX package's decode never
    reaches the kernel either).  Writes slot ``pos`` (a window layer's
    ring: ``pos % T``) of ``cache`` in place and attends over the valid
    slots: ``<= pos``, and every slot of a ring once ``pos >= T``; logits
    and softmax in float32.  A ``cross`` cache holds the encoder's K/V:
    only q is projected, nothing is written, every slot is valid."""
    T = cache.k.shape[1]
    if not cross and (pos < 0 or (not window and pos >= T)):
        raise ValueError(f"decode position {pos} outside the cache's {T} slots")
    with trace.span("attn.qkv"):
        q = _heads(x, p.wq)  # [B, 1, H, D]
        at = torch.full((1,), pos, device=x.device) if use_rope and cfg.pos_emb == "rope" else None
        if at is not None:
            q = rope(q, at, cfg.rope_theta)
        if not cross:
            kn, vn = _heads(x, p.wk), _heads(x, p.wv)  # [B, 1, Kv, D]
            if at is not None:
                kn = rope(kn, at, cfg.rope_theta)
    with trace.span("attn.decode"):
        if cross:
            valid = None
        else:
            slot = pos % T if window else pos
            cache.k[:, slot] = kn[:, 0].to(cache.k.dtype)
            cache.v[:, slot] = vn[:, 0].to(cache.v.dtype)
            valid = torch.arange(T, device=x.device) <= pos  # a ring's every slot once pos >= T
        out = _heads_local(functools.partial(_decode_attention, cfg, valid=valid), q, cache.k, cache.v, 2)
    return _out(p, out), cache


def _decode_attention(cfg: ArchConfig, q, k, v, valid) -> torch.Tensor:
    """q [B, 1, H, D] against the cache's k, v [B, T, Kv, D] where ``valid``
    [T] (None: every slot) -> [B, 1, H, D] in q's dtype."""
    # grouped heads attend without a repeated K/V: q [B,1,H,D] -> [B,1,Kv,g,D]
    B, _, H, D = q.shape
    Kv = k.shape[2]
    # 1/sqrt(D) in float32, rounded to q's type, as the JAX package scales
    scale = float((1.0 / torch.tensor(float(D)).sqrt()).to(q.dtype))
    qg = q.reshape(B, 1, Kv, H // Kv, D) * scale
    logits = torch.einsum("bsKgd,btKd->bKgst", qg.float(), k.float())
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if valid is not None:
        logits = logits.masked_fill(~valid, -1e30)
    att = torch.softmax(logits, dim=-1)  # [B, Kv, g, 1, T]
    out = torch.einsum("bKgst,btKd->bsKgd", att, v.float())
    return out.reshape(B, 1, H, D).to(q.dtype)
