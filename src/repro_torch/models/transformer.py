"""The decoder stack as an ``nn.Module``: embedding, ``n_layers`` layers
(RMSNorm, attention, RMSNorm, MLP, each with a residual), final RMSNorm.
The port's counterpart of ``repro/models/transformer.py`` for attention
mixers and MLP FFNs.

The JAX package scans one repeating unit over ``[R, ...]``-stacked
weights; here the layers are a ``ModuleList`` walked in a Python loop, so
each layer's full-sequence attention is one ``flash_attention`` launch.
Two entry points: ``forward`` (prefill; given caches it also writes each
layer's K/V into them, where the JAX ``collect_cache`` returns them) and
``decode_step`` (one token against the caches).  Architectures other than
dense, MoE layers, layer patterns other than ``full`` and gemma2's
post-norms raise ``NotImplementedError`` (ROADMAP Queue 1 item 13).  The
JAX ``forward`` also returns the MoE auxiliary loss; with no MoE layers
here it is always 0 and is left out.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import NOT_PORTED, ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    MLP,
    Embed,
    RMSNorm,
    apply_mlp,
    embed_tokens,
    pdtype,
    sinusoidal,
    unembed,
)


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.arch_type != "dense":
        raise NotImplementedError(f"{cfg.name}: the {cfg.arch_type!r} architecture {NOT_PORTED}")
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE layers {NOT_PORTED}")
    if cfg.layer_pattern != "full":
        raise NotImplementedError(f"{cfg.name}: the {cfg.layer_pattern!r} layer pattern {NOT_PORTED}")
    if cfg.post_norm:
        raise NotImplementedError(f"{cfg.name}: post-norms {NOT_PORTED}")


class Layer(nn.Module):
    """One decoder layer: ``norm1``, ``mixer`` (attention), ``norm2``,
    ``ffn`` (MLP)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.mixer = attn.Attention(cfg, gen)
        self.norm1 = RMSNorm(cfg, gen.device)
        self.ffn = MLP(cfg, gen)
        self.norm2 = RMSNorm(cfg, gen.device)


class Transformer(nn.Module):
    """The model of ``cfg``, its weights drawn from ``generator`` on the
    generator's device (``torch.Generator(device=...)``)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg, generator)
        self.layers = nn.ModuleList(Layer(cfg, generator) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, generator.device)

    def _embed(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = embed_tokens(self.cfg, self.embed, tokens)
        if self.cfg.pos_emb == "sinusoidal":
            x = x + sinusoidal(positions, self.cfg.d_model)[None].to(x.dtype)
        return x

    def forward(
        self, tokens: torch.Tensor, *, caches: Optional[List[attn.LayerCache]] = None
    ) -> torch.Tensor:
        """tokens [B, S] -> final hidden [B, S, d].  With ``caches`` (one
        per layer, at least S slots), each layer writes its K/V into slots
        ``[:S]`` in place: prefill fills the decode state this way."""
        cfg = self.cfg
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        x = self._embed(tokens, positions)
        for i, layer in enumerate(self.layers):
            out, (k, v) = attn.attend_full(cfg, layer.mixer, layer.norm1(x), positions)
            x = x + out
            x = x + apply_mlp(cfg, layer.ffn, layer.norm2(x))
            if caches is not None:
                caches[i].k[:, :S] = k
                caches[i].v[:, :S] = v
        return self.final_norm(x)

    def decode_step(
        self, caches: List[attn.LayerCache], token: torch.Tensor, pos: int
    ) -> Tuple[torch.Tensor, List[attn.LayerCache]]:
        """token [B, 1] at position ``pos`` -> (logits [B, V] float32,
        caches, each written in place at slot ``pos``)."""
        cfg = self.cfg
        x = self._embed(token, torch.full((1,), pos, device=token.device))
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            out, cache = attn.attend_decode(cfg, layer.mixer, layer.norm1(x), cache, pos)
            x = x + out
            x = x + apply_mlp(cfg, layer.ffn, layer.norm2(x))
            new_caches.append(cache)
        x = self.final_norm(x)
        return unembed(cfg, self.embed, x)[:, 0, :], new_caches


def init_caches(cfg: ArchConfig, batch: int, cache_len: int, device) -> List[attn.LayerCache]:
    """Zero decode state: one ``[B, cache_len, Kv, D]`` cache per layer."""
    return [attn.init_cache(cfg, batch, cache_len, pdtype(cfg), device) for _ in range(cfg.n_layers)]
