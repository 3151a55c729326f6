"""The decoder stack as an ``nn.Module``: embedding, ``n_layers`` layers
(RMSNorm, mixer, RMSNorm, MLP or MoE FFN, each with a residual; a layer
whose descriptor says ``ffn == "none"`` has no second half), final
RMSNorm.  The port's counterpart of ``repro/models/transformer.py``.

The JAX package scans one repeating unit of ``cfg.pattern()``'s layer
descriptors over ``[R, ...]``-stacked weights; here layer ``r`` is built
from descriptor ``r % len(unit)`` and the layers are a ``ModuleList`` walked
in a Python loop, so each attention layer's full-sequence attention is one
``flash_attention`` launch.  A layer's mixer is attention (``attn_full``,
``attn_local``) or a recurrent mixer of ``models/ssm.py`` (``mamba``,
``mlstm``, ``slstm``).  An attention layer keeps its descriptor's sliding
window (``attn_local``) and whether it applies RoPE (not a
``chunked_global`` full layer: llama4's NoPE layers).  Two entry points:
``forward`` (training and prefill; given caches it also writes each
attention layer's K/V and each recurrent layer's final state into them,
where the JAX ``collect_cache`` returns them) and ``decode_step`` (one
token against the caches).  Under autograd and ``cfg.remat`` each layer is
recomputed in the backward (``torch.utils.checkpoint``), as the JAX
package checkpoints its scanned unit.

An MoE layer (``models/moe.py``) adds its load-balance loss to the
forward's ``aux``, float32 from 0 in layer order as the JAX package's scan
carries it (``forward(return_aux=True)``); decode drops it.  gemma2's
post-norms and the audio and VLM front ends (item 13f) raise
``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerDesc, not_ported
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
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

# one layer's decode state: an attention layer's KV cache or a recurrent layer's state
Cache = Union[attn.LayerCache, ssm.MambaState, ssm.MLSTMState, ssm.SLSTMState]

_ARCH_ITEM = {"audio": "13f", "vlm": "13f"}


class _Recurrent(NamedTuple):
    module: type
    forward: Callable  # (cfg, p, x) -> (out, final state)
    decode: Callable  # (cfg, p, x, state) -> (out, new state)
    init_state: Callable  # (cfg, batch, device) -> zero state


_RECURRENT = {
    "mamba": _Recurrent(ssm.Mamba, ssm.mamba_prefill, ssm.mamba_decode,
                        lambda cfg, batch, device: ssm.init_mamba_state(cfg, batch, pdtype(cfg), device)),
    "mlstm": _Recurrent(ssm.MLSTM, ssm.apply_mlstm, ssm.mlstm_decode, ssm.init_mlstm_state),
    "slstm": _Recurrent(ssm.SLSTM, ssm.apply_slstm, ssm.slstm_decode, ssm.init_slstm_state),
}


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.arch_type not in ("dense", "moe", "ssm", "hybrid"):
        item = _ARCH_ITEM.get(cfg.arch_type, "13")
        raise NotImplementedError(f"{cfg.name}: the {cfg.arch_type!r} architecture {not_ported(item)}")
    if cfg.is_moe and not 1 <= cfg.experts_per_token <= cfg.n_experts:
        raise ValueError(f"{cfg.name}: {cfg.experts_per_token} experts a token out of {cfg.n_experts}")
    if cfg.post_norm:
        raise NotImplementedError(f"{cfg.name}: post-norms {not_ported('13f')}")
    cfg.pattern()


def _mixer_window(cfg: ArchConfig, desc: LayerDesc) -> Optional[int]:
    return cfg.window if desc.mixer == "attn_local" else None


def _use_rope(cfg: ArchConfig, desc: LayerDesc) -> bool:
    # llama4 NoPE: the periodic global layers drop positional encoding
    if cfg.layer_pattern == "chunked_global" and desc.mixer == "attn_full":
        return False
    return cfg.pos_emb == "rope"


class Layer(nn.Module):
    """One decoder layer: ``norm1``, ``mixer`` (attention, or the recurrent
    mixer ``kind`` names), then ``norm2`` and ``ffn`` (an MLP, or an MoE
    where the descriptor says ``moe``; neither where it says ``none``);
    ``window`` and ``use_rope`` from its descriptor."""

    def __init__(self, cfg: ArchConfig, desc: LayerDesc, gen: torch.Generator):
        super().__init__()
        self.kind = desc.mixer
        if desc.mixer.startswith("attn"):
            self.mixer = attn.Attention(cfg, gen)
        elif desc.mixer in _RECURRENT:
            self.mixer = _RECURRENT[desc.mixer].module(cfg, gen)
        else:
            raise ValueError(f"unknown mixer {desc.mixer!r}")
        self.norm1 = RMSNorm(cfg, gen.device)
        self.moe = desc.ffn == "moe"
        self.has_ffn = desc.ffn != "none"
        if self.has_ffn:
            self.ffn = moe_mod.MoE(cfg, gen) if self.moe else MLP(cfg, gen)
            self.norm2 = RMSNorm(cfg, gen.device)
        self.window = _mixer_window(cfg, desc)
        self.use_rope = _use_rope(cfg, desc)

    @property
    def recurrent(self) -> bool:
        return self.kind in _RECURRENT

    def apply_ffn(self, cfg: ArchConfig, x: torch.Tensor):
        """(the FFN sublayer's output, its aux loss: None for an MLP)."""
        if self.moe:
            return moe_mod.apply_moe(cfg, self.ffn, x)
        return apply_mlp(cfg, self.ffn, x), None


class Transformer(nn.Module):
    """The model of ``cfg``, its weights drawn from ``generator`` on the
    generator's device (``torch.Generator(device=...)``)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        unit, _ = cfg.pattern()
        self.embed = Embed(cfg, generator)
        self.layers = nn.ModuleList(Layer(cfg, unit[r % len(unit)], generator)
                                    for r in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, generator.device)

    def _embed(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = embed_tokens(self.cfg, self.embed, tokens)
        if self.cfg.pos_emb == "sinusoidal":
            x = x + sinusoidal(positions, self.cfg.d_model)[None].to(x.dtype)
        return x

    def _layer(self, layer: Layer, x: torch.Tensor, positions: torch.Tensor,
               cache: Optional[Cache], plain_attention: bool):
        cfg = self.cfg
        h = layer.norm1(x)
        if layer.recurrent:
            out, state = _RECURRENT[layer.kind].forward(cfg, layer.mixer, h)
            if cache is not None:
                for dst, src in zip(cache, state):
                    dst.copy_(src)
        else:
            out, (k, v) = attn.attend_full(cfg, layer.mixer, h, positions, window=layer.window,
                                           use_rope=layer.use_rope, plain_attention=plain_attention)
            if cache is not None:
                _write_prefill(cache, k, v, layer.window)
        x = x + out
        aux = None
        if layer.has_ffn:
            out, aux = layer.apply_ffn(cfg, layer.norm2(x))
            x = x + out
        return x, aux

    def forward(
        self, tokens: torch.Tensor, *, caches: Optional[List[Cache]] = None,
        plain_attention: bool = False, return_aux: bool = False,
    ):
        """tokens [B, S] -> final hidden [B, S, d] (with ``return_aux``:
        (hidden, the MoE layers' summed aux loss, a float32 scalar)).  With
        ``caches`` (one per layer: a full layer's of at least S slots, a
        window layer's of ``window``, a recurrent layer's state), each layer
        writes its K/V or its final state into them in place: prefill fills
        the decode state this way.  ``plain_attention``
        (set by ``model.loss_fn``) runs the attention's plain route, as the
        JAX training forward does."""
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        x = self._embed(tokens, positions)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        remat = self.cfg.remat and caches is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            fn = functools.partial(self._layer, layer, positions=positions,
                                   cache=None if caches is None else caches[i],
                                   plain_attention=plain_attention)
            x, a = checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False) if remat else fn(x)
            if a is not None:
                aux = aux + a
        x = self.final_norm(x)
        return (x, aux) if return_aux else x

    def decode_step(
        self, caches: List[Cache], token: torch.Tensor, pos: int
    ) -> Tuple[torch.Tensor, List[Cache]]:
        """token [B, 1] at position ``pos`` -> (logits [B, V] float32,
        caches: an attention layer's written in place at its slot for
        ``pos``, a recurrent layer's the new state)."""
        cfg = self.cfg
        x = self._embed(token, torch.full((1,), pos, device=token.device))
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            h = layer.norm1(x)
            if layer.recurrent:
                out, cache = _RECURRENT[layer.kind].decode(cfg, layer.mixer, h, cache)
            else:
                out, cache = attn.attend_decode(cfg, layer.mixer, h, cache, pos,
                                                window=layer.window, use_rope=layer.use_rope)
            x = x + out
            if layer.has_ffn:
                x = x + layer.apply_ffn(cfg, layer.norm2(x))[0]  # an MoE's aux is dropped
            new_caches.append(cache)
        x = self.final_norm(x)
        return unembed(cfg, self.embed, x)[:, 0, :], new_caches


def _write_prefill(cache: attn.LayerCache, k: torch.Tensor, v: torch.Tensor,
                   window: Optional[int]) -> None:
    """A full layer's K/V go to slots ``[:S]``.  A window layer keeps its
    last ``w`` rows (ring alignment: slot = pos % w, which needs S % w ==
    0) or, from a shorter prompt, all S rows and zeros after them."""
    S = k.shape[1]
    if window and S > window:
        if S % window:
            raise ValueError(f"window must divide prefill length (window {window}, prompt {S})")
        k, v = k[:, -window:], v[:, -window:]
        S = window
    cache.k[:, :S] = k
    cache.v[:, :S] = v


def init_state(cfg: ArchConfig, kind: str, batch: int, device) -> Cache:
    """A recurrent mixer's zero state (a constant size, whatever the
    sequence)."""
    return _RECURRENT[kind].init_state(cfg, batch, device)


def init_caches(cfg: ArchConfig, batch: int, cache_len: int, device) -> List[Cache]:
    """Zero decode state, one cache per layer: ``[B, cache_len, Kv, D]``,
    a ring of ``min(window, cache_len)`` slots for a window layer, or a
    recurrent layer's constant-size state."""
    unit, _ = cfg.pattern()

    def one(desc: LayerDesc) -> Cache:
        if desc.mixer in _RECURRENT:
            return init_state(cfg, desc.mixer, batch, device)
        return attn.init_cache(cfg, batch, cache_len, _mixer_window(cfg, desc), pdtype(cfg), device)

    return [one(unit[r % len(unit)]) for r in range(cfg.n_layers)]
