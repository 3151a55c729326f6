"""Attention sublayers: GQA/MQA with RoPE and logit soft-capping, over the
full sequence (prefill, through the ``flash_attention`` kernel) and for one
decoded token against a KV cache.  The port's counterpart of
``repro/models/attention.py`` for full-attention layers.

The decode cache of a layer is ``[B, T, Kv, D]``; slot ``j`` holds position
``j``.  Unlike the JAX package, :func:`attend_decode` writes the new
token's K/V into the cache in place: a step then copies nothing of the
cache, and the caller's ``LayerCache`` is the updated one.  Sliding-window
layers (ring-buffer caches, ``_chunked_local_attention``) arrive with the
windowed architectures (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import make_param, pdtype, rope


class Attention(nn.Module):
    """``wq [d, H, D]``, ``wk``/``wv [d, Kv, D]``, ``wo [H, D, d]``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        d, H, Kv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = pdtype(cfg)
        self.wq = make_param(gen, (d, H, D), dt, fan_in=d)
        self.wk = make_param(gen, (d, Kv, D), dt, fan_in=d)
        self.wv = make_param(gen, (d, Kv, D), dt, fan_in=d)
        self.wo = make_param(gen, (H, D, d), dt, fan_in=H * D)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, S, d] @ [d, H, D] -> [B, S, H, D], one matmul, last axis contiguous."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _project_qkv(p: Attention, x: torch.Tensor):
    return _heads(x, p.wq), _heads(x, p.wk), _heads(x, p.wv)


def _out(p: Attention, o: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] against ``wo [H, D, d]`` -> [B, S, d]."""
    return o.reshape(*o.shape[:2], -1) @ p.wo.flatten(0, 1)


def attend_full(
    cfg: ArchConfig,
    p: Attention,
    x: torch.Tensor,  # [B, S, d]
    positions: torch.Tensor,  # [S]
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal full-sequence self-attention; returns (out [B, S, d], (k, v)
    [B, S, Kv, D]) so that prefill can cache.  The kernel takes the
    ``[B, H, S, D]`` transposes as strided views: nothing is copied for it."""
    q, k, v = _project_qkv(p, x)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, softcap=cfg.logit_softcap,
    ).transpose(1, 2)  # [B, S, H, D]
    return _out(p, out), (k, v)


class LayerCache(NamedTuple):
    """KV cache of one attention layer."""

    k: torch.Tensor  # [B, T_cache, Kv, D]
    v: torch.Tensor  # [B, T_cache, Kv, D]


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype, device) -> LayerCache:
    shape = (batch, seq_len, cfg.n_kv_heads, cfg.hd)
    return LayerCache(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device))


def attend_decode(
    cfg: ArchConfig,
    p: Attention,
    x: torch.Tensor,  # [B, 1, d]
    cache: LayerCache,
    pos: int,  # position of the new token
) -> Tuple[torch.Tensor, LayerCache]:
    """One decode step in plain PyTorch (the JAX package's decode never
    reaches the kernel either).  Writes slot ``pos`` of ``cache`` in place
    and attends over slots ``<= pos``; logits and softmax in float32."""
    B = x.shape[0]
    T = cache.k.shape[1]
    if not 0 <= pos < T:
        raise ValueError(f"decode position {pos} outside the cache's {T} slots")
    q = _heads(x, p.wq)  # [B, 1, H, D]
    kn, vn = _heads(x, p.wk), _heads(x, p.wv)  # [B, 1, Kv, D]
    if cfg.pos_emb == "rope":
        at = torch.full((1,), pos, device=x.device)
        q = rope(q, at, cfg.rope_theta)
        kn = rope(kn, at, cfg.rope_theta)
    cache.k[:, pos] = kn[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = vn[:, 0].to(cache.v.dtype)
    valid = torch.arange(T, device=x.device) <= pos

    # grouped heads attend without a repeated K/V: q [B,1,H,D] -> [B,1,Kv,g,D]
    Kv, g, D = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    # 1/sqrt(D) in float32, rounded to q's type, as the JAX package scales
    scale = float((1.0 / torch.tensor(float(D)).sqrt()).to(q.dtype))
    qg = q.reshape(B, 1, Kv, g, D) * scale
    logits = torch.einsum("bsKgd,btKd->bKgst", qg.float(), cache.k.float())
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    logits = logits.masked_fill(~valid, -1e30)
    att = torch.softmax(logits, dim=-1)  # [B, Kv, g, 1, T]
    out = torch.einsum("bKgst,btKd->bsKgd", att, cache.v.float())
    out = out.reshape(B, 1, cfg.n_heads, D).to(x.dtype)
    return _out(p, out), cache
