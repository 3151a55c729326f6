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
carries it (``forward(return_aux=True)``); decode drops it.

The front ends.  ``cfg.post_norm`` (gemma2) norms the mixer's output
(``post_norm1``) and the FFN's (``post_norm2``) before their residual
adds.  A ``vlm`` batch's ``prefix [B, P, d]`` (patch embeddings) goes
before the token embeddings, so positions run over P + S.  An ``audio``
architecture (whisper) has an :class:`Encoder` over ``frames [B, F, d]``
(``encoder_layers`` non-causal layers, sinusoidal positions, its own final
norm) and, in every decoder layer, a cross-attention sublayer
(``norm_cross``, ``cross``) after the mixer, against the encoder's output;
its decode state per layer is the pair (self cache, cross cache), the
second holding the encoder output's K/V.  ``pos_emb == "sinusoidal"``
adds the sin/cos table at each position.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ARCH_TYPES, ArchConfig, LayerDesc
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models import shardings
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
from repro_torch.obs import trace

# one layer's decode state: an attention layer's KV cache or a recurrent
# layer's state; an audio decoder layer's is (that, its cross cache)
Cache = Union[attn.LayerCache, ssm.MambaState, ssm.MLSTMState, ssm.SLSTMState, Tuple]

# the whisper encoder's layers (the MLP's kind is cfg.mlp_type's, as in the JAX package)
ENCODER_LAYER = LayerDesc("attn_full", "gelu")


class _Recurrent(NamedTuple):
    module: type
    forward: Callable  # (cfg, p, x) -> (out, final state)
    decode: Callable  # (cfg, p, x, state) -> (out, new state)
    init_state: Callable  # (cfg, batch, device) -> zero state
    state: type  # the state's NamedTuple


_RECURRENT = {
    "mamba": _Recurrent(ssm.Mamba, ssm.mamba_prefill, ssm.mamba_decode,
                        lambda cfg, batch, device: ssm.init_mamba_state(cfg, batch, pdtype(cfg), device),
                        ssm.MambaState),
    "mlstm": _Recurrent(ssm.MLSTM, ssm.apply_mlstm, ssm.mlstm_decode, ssm.init_mlstm_state, ssm.MLSTMState),
    "slstm": _Recurrent(ssm.SLSTM, ssm.apply_slstm, ssm.slstm_decode, ssm.init_slstm_state, ssm.SLSTMState),
}


def _recurrent(kind: str, step: str, cfg: ArchConfig, mixer, x: torch.Tensor, *state):
    """A recurrent mixer's ``forward`` or ``decode`` (``step``): (out, state).
    Over DTensors (the dry-run's mesh) it runs on each device's batch rows
    with the mixer's weights whole: its scans and gates have no DTensor
    sharding rules, and a row's recurrence needs no other row."""
    rec = _RECURRENT[kind]
    fn = getattr(rec, step)
    if not shardings.is_dtensor(x):
        return fn(cfg, mixer, x, *state)
    names = [n for n, _ in mixer.named_parameters(recurse=False)]

    def local(xl, *rest):
        ws, st = rest[:len(names)], rest[len(names):]
        out, new = fn(cfg, SimpleNamespace(**dict(zip(names, ws))), xl, *((rec.state(*st),) if st else ()))
        return out, *new

    def row(t):
        return shardings.batch_spec(t, x.device_mesh)

    flat = [t for s in state for t in s]
    weights = [getattr(mixer, n) for n in names]
    in_specs = (row(x), *((None,) * w.ndim for w in weights), *(row(t) for t in flat))
    zero = rec.init_state(cfg, x.shape[0], "meta")  # the state's shapes
    res = shardings.local_region(local, in_specs, [row(x)] + [row(t) for t in zero], x, *weights, *flat)
    return res[0], rec.state(*res[1:])


def _check_config(cfg: ArchConfig) -> None:
    if cfg.arch_type not in ARCH_TYPES:
        raise ValueError(f"{cfg.name}: unknown arch_type {cfg.arch_type!r}; have {ARCH_TYPES}")
    if cfg.is_moe and not 1 <= cfg.experts_per_token <= cfg.n_experts:
        raise ValueError(f"{cfg.name}: {cfg.experts_per_token} experts a token out of {cfg.n_experts}")
    cfg.pattern()


def _mixer_window(cfg: ArchConfig, desc: LayerDesc) -> Optional[int]:
    return cfg.window if desc.mixer == "attn_local" else None


def _use_rope(cfg: ArchConfig, desc: LayerDesc) -> bool:
    # llama4 NoPE: the periodic global layers drop positional encoding
    if cfg.layer_pattern == "chunked_global" and desc.mixer == "attn_full":
        return False
    return cfg.pos_emb == "rope"


class Layer(nn.Module):
    """One layer: ``norm1``, ``mixer`` (attention, or the recurrent mixer
    ``kind`` names) and, under ``cfg.post_norm``, ``post_norm1``; with
    ``cross``, ``norm_cross`` and the cross-attention ``cross``; then
    ``norm2`` and ``ffn`` (an MLP, or an MoE where the descriptor says
    ``moe``; neither where it says ``none``) and ``post_norm2``; ``window``
    and ``use_rope`` from its descriptor."""

    def __init__(self, cfg: ArchConfig, desc: LayerDesc, gen: torch.Generator, cross: bool = False):
        super().__init__()
        self.kind = desc.mixer
        if desc.mixer.startswith("attn"):
            self.mixer = attn.Attention(cfg, gen)
        elif desc.mixer in _RECURRENT:
            self.mixer = _RECURRENT[desc.mixer].module(cfg, gen)
        else:
            raise ValueError(f"unknown mixer {desc.mixer!r}")
        self.norm1 = RMSNorm(cfg, gen.device)
        self.post_norm = cfg.post_norm
        if self.post_norm:
            self.post_norm1 = RMSNorm(cfg, gen.device)
        self.has_cross = cross
        if cross:
            self.cross = attn.Attention(cfg, gen)
            self.norm_cross = RMSNorm(cfg, gen.device)
        self.moe = desc.ffn == "moe"
        self.has_ffn = desc.ffn != "none"
        if self.has_ffn:
            self.ffn = moe_mod.MoE(cfg, gen) if self.moe else MLP(cfg, gen)
            self.norm2 = RMSNorm(cfg, gen.device)
            if self.post_norm:
                self.post_norm2 = RMSNorm(cfg, gen.device)
        self.window = _mixer_window(cfg, desc)
        self.use_rope = _use_rope(cfg, desc)

    @property
    def recurrent(self) -> bool:
        return self.kind in _RECURRENT

    def apply_ffn(self, cfg: ArchConfig, x: torch.Tensor):
        """(the FFN sublayer's output, post-normed where the architecture
        says so, and its aux loss: None for an MLP)."""
        if self.moe:
            out, aux = moe_mod.apply_moe(cfg, self.ffn, x)
        else:
            out, aux = apply_mlp(cfg, self.ffn, x), None
        return (self.post_norm2(out) if self.post_norm else out), aux


def _apply_layer(cfg: ArchConfig, layer: Layer, x: torch.Tensor, positions: torch.Tensor,
                 cache: Optional[Cache], plain_attention: bool, causal: bool = True,
                 enc_out: Optional[torch.Tensor] = None):
    """One layer over the full sequence: (x, the FFN's aux loss or None).
    Given ``cache``, the layer's K/V or final state (and its cross-attention
    K/V) are written into it."""
    self_c, cross_c = cache if (layer.has_cross and cache is not None) else (cache, None)
    h = layer.norm1(x)
    if layer.recurrent:
        out, state = _recurrent(layer.kind, "forward", cfg, layer.mixer, h)
        if self_c is not None:
            for dst, src in zip(self_c, state):
                dst.copy_(src)
    else:
        out, (k, v) = attn.attend_full(cfg, layer.mixer, h, positions, causal=causal, window=layer.window,
                                       use_rope=layer.use_rope, plain_attention=plain_attention)
        if self_c is not None:
            _write_prefill(self_c, k, v, layer.window)
    if layer.post_norm:
        out = layer.post_norm1(out)
    x = x + out
    if layer.has_cross:
        out, (k, v) = attn.attend_full(cfg, layer.cross, layer.norm_cross(x), positions, causal=False,
                                       use_rope=False, plain_attention=plain_attention, kv_x=enc_out)
        x = x + out
        if cross_c is not None:
            _write_prefill(cross_c, k, v, None)
    aux = None
    if layer.has_ffn:
        out, aux = layer.apply_ffn(cfg, layer.norm2(x))
        x = x + out
    return x, aux


def _run_layers(cfg: ArchConfig, layers, x: torch.Tensor, positions: torch.Tensor, caches,
                plain_attention: bool, causal: bool = True, enc_out: Optional[torch.Tensor] = None):
    """``layers`` in order, each recomputed in the backward under autograd
    and ``cfg.remat`` when no cache is written: (x, the summed aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for i, layer in enumerate(layers):
        x = shardings.constrain_batch(x)
        fn = functools.partial(_apply_layer, cfg, layer, positions=positions,
                               cache=None if caches is None else caches[i],
                               plain_attention=plain_attention, causal=causal, enc_out=enc_out)
        x, a = checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False) if remat else fn(x)
        if a is not None:
            aux = aux + a
    return shardings.constrain_batch(x), aux


class Encoder(nn.Module):
    """Whisper's encoder: ``encoder_layers`` layers of :data:`ENCODER_LAYER`
    (non-causal attention, RoPE only where ``pos_emb`` is ``rope``) and
    ``final_norm``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(Layer(cfg, ENCODER_LAYER, gen) for _ in range(cfg.encoder_layers))
        self.final_norm = RMSNorm(cfg, gen.device)

    def forward(self, frames: torch.Tensor, plain_attention: bool = False) -> torch.Tensor:
        """frames [B, F, d] (the post-conv frame embeddings) -> the encoder
        output [B, F, d].  The stream keeps ``frames.dtype``, as the JAX
        package's does: float32 frames run the encoder in float32 against
        the weights (each product promotes, ``layers.matmul``)."""
        cfg = self.cfg
        positions = torch.arange(frames.shape[1], device=frames.device)
        x = frames + sinusoidal(positions, cfg.d_model)[None].to(frames.dtype)
        x, _ = _run_layers(cfg, self.layers, x, positions, None, plain_attention, causal=False)
        return self.final_norm(x)


class Transformer(nn.Module):
    """The model of ``cfg``, its weights drawn from ``generator`` on the
    generator's device (``torch.Generator(device=...)``)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        unit, _ = cfg.pattern()
        self.audio = cfg.arch_type == "audio"
        self.embed = Embed(cfg, generator)
        self.layers = nn.ModuleList(Layer(cfg, unit[r % len(unit)], generator, cross=self.audio)
                                    for r in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, generator.device)
        if self.audio:
            self.encoder = Encoder(cfg, generator)

    def _positional(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        if self.cfg.pos_emb == "sinusoidal":
            x = x + sinusoidal(positions, self.cfg.d_model)[None].to(x.dtype)
        return x

    def forward(
        self, tokens: torch.Tensor, *, prefix: Optional[torch.Tensor] = None,
        frames: Optional[torch.Tensor] = None, caches: Optional[List[Cache]] = None,
        plain_attention: bool = False, return_aux: bool = False,
    ):
        """tokens [B, S] -> final hidden [B, P + S, d] (with ``return_aux``:
        (hidden, the MoE layers' summed aux loss, a float32 scalar)).
        ``prefix [B, P, d]`` goes before the token embeddings; an audio
        architecture needs ``frames [B, F, d]`` for its encoder.  With
        ``caches`` (one per layer: a full layer's of at least P + S slots,
        a window layer's of ``window``, a recurrent layer's state; an audio
        layer's paired with a cross cache of F slots), each layer writes its
        K/V or its final state into them in place: prefill fills the decode
        state this way.  ``plain_attention`` (set by ``model.loss_fn``)
        runs the attention's plain route, as the JAX training forward
        does."""
        cfg = self.cfg
        x = embed_tokens(cfg, self.embed, tokens)
        if prefix is not None:
            if tuple(prefix.shape) != (x.shape[0], cfg.prefix_tokens, cfg.d_model):
                raise ValueError(f"{cfg.name}: prefix {tuple(prefix.shape)}, not "
                                 f"[{x.shape[0]}, {cfg.prefix_tokens}, {cfg.d_model}]")
            x = torch.cat([prefix.to(x.dtype), x], dim=1)  # embed_scale touched the tokens only
        positions = torch.arange(x.shape[1], device=tokens.device)
        x = self._positional(x, positions)
        enc_out = None
        if self.audio:
            if frames is None:
                raise ValueError(f"{cfg.name}: an audio architecture needs frame embeddings (frames=)")
            enc_out = self.encoder(frames, plain_attention)
        x, aux = _run_layers(cfg, self.layers, x, positions, caches, plain_attention, enc_out=enc_out)
        x = self.final_norm(x)
        return (x, aux) if return_aux else x

    def decode_step(
        self, caches: List[Cache], token: torch.Tensor, pos: int
    ) -> Tuple[torch.Tensor, List[Cache]]:
        """token [B, 1] at position ``pos`` -> (logits [B, V] float32,
        caches: an attention layer's written in place at its slot for
        ``pos``, a recurrent layer's the new state, a cross cache as it
        was)."""
        cfg = self.cfg
        x = self._positional(embed_tokens(cfg, self.embed, token), torch.full((1,), pos, device=token.device))
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x = shardings.constrain_batch(x)
            self_c, cross_c = cache if layer.has_cross else (cache, None)
            h = layer.norm1(x)
            if layer.recurrent:
                out, self_c = _recurrent(layer.kind, "decode", cfg, layer.mixer, h, self_c)
            else:
                out, self_c = attn.attend_decode(cfg, layer.mixer, h, self_c, pos,
                                                 window=layer.window, use_rope=layer.use_rope)
            if layer.post_norm:
                out = layer.post_norm1(out)
            x = x + out
            if layer.has_cross:
                x = x + attn.attend_decode(cfg, layer.cross, layer.norm_cross(x), cross_c, pos,
                                           use_rope=False, cross=True)[0]
            if layer.has_ffn:
                x = x + layer.apply_ffn(cfg, layer.norm2(x))[0]  # an MoE's aux is dropped
            new_caches.append((self_c, cross_c) if layer.has_cross else self_c)
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
    with trace.span("cache.write"):
        cache.k[:, :S] = k
        cache.v[:, :S] = v


def init_state(cfg: ArchConfig, kind: str, batch: int, device) -> Cache:
    """A recurrent mixer's zero state (a constant size, whatever the
    sequence)."""
    return _RECURRENT[kind].init_state(cfg, batch, device)


def init_caches(cfg: ArchConfig, batch: int, cache_len: int, device) -> List[Cache]:
    """Zero decode state, one cache per layer: ``[B, cache_len, Kv, D]``,
    a ring of ``min(window, cache_len)`` slots for a window layer, or a
    recurrent layer's constant-size state; an audio architecture pairs each
    with a cross cache of ``encoder_seq`` slots."""
    unit, _ = cfg.pattern()

    def one(desc: LayerDesc) -> Cache:
        if desc.mixer in _RECURRENT:
            c = init_state(cfg, desc.mixer, batch, device)
        else:
            c = attn.init_cache(cfg, batch, cache_len, _mixer_window(cfg, desc), pdtype(cfg), device)
        if cfg.arch_type == "audio":
            return c, attn.init_cache(cfg, batch, cfg.encoder_seq, None, pdtype(cfg), device)
        return c

    return [one(unit[r % len(unit)]) for r in range(cfg.n_layers)]
