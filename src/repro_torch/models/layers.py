"""Shared building blocks: RMSNorm, RoPE, sinusoidal positions, GLU MLPs,
embeddings.  The port's counterpart of ``repro/models/layers.py``.

The functions keep the JAX package's arithmetic (the float32 islands, the
casts back to the activation type) and its layouts: activations
``[B, S, d]``, heads ``[B, S, H, D]``.  The modules only hold weights,
initialised with ``make_param``'s scales from an explicit
``torch.Generator``, without ``requires_grad``: ``models/model.py``'s
``train_step`` turns gradients on for the length of a step, and every
function here is differentiable as written (the serving path runs the
same operations).  Each module's ``AXES`` names its parameters' logical
axes, as the JAX init functions' axes trees do (``models/shardings.py``
resolves them onto a mesh).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.shardings import embedding_local, is_dtensor
from repro_torch.models.shardings import maybe_gather_weight as _mg
from repro_torch.obs import trace


def pdtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def make_param(
    gen: torch.Generator,
    shape: Tuple[int, ...],
    dtype: torch.dtype,
    fan_in: Optional[int] = None,
) -> nn.Parameter:
    """N(0, 1/fan_in) in float32, then cast; ``fan_in`` defaults to
    ``shape[0]``.  Drawn on the generator's device."""
    scale = 1.0 / math.sqrt(fan_in if fan_in else shape[0])
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale
    return nn.Parameter(w.to(dtype), requires_grad=False)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in their promoted dtype, as a JAX product of a float32
    activation and a bf16 weight computes in float32 (whisper's encoder
    over float32 frames); two operands of one dtype multiply as they are."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def _zeros(shape: Tuple[int, ...], device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device), requires_grad=False)


# -- norms ------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    with trace.span("norm"):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


class RMSNorm(nn.Module):
    """``gamma`` starts at 0: the scale is ``1 + gamma``."""

    AXES = {"gamma": ("embed",)}

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.gamma = _zeros((cfg.d_model,), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.gamma, self.eps)


# -- rotary / sinusoidal positions -------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE.  x: [B, S, H, D]; positions: [S] or [B, S]."""
    with trace.span("rope"):
        half = x.shape[-1] // 2
        freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
        if positions.dim() == 1:
            positions = positions[None, :]
        ang = positions[:, :, None].float() * freqs[None, None, :]  # [B, S, half]
        cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
        x1, x2 = x[..., :half].float(), x[..., half:].float()
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """[S] -> [S, d] sin/cos table, float32."""
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * ar / max(half - 1, 1))
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -- MLPs ---------------------------------------------------------------------


class MLP(nn.Module):
    """GLU (swiglu, geglu: ``w_gate``, ``w_up``, ``w_down``) or plain gelu
    (``w_up``, ``b_up``, ``w_down``, ``b_down``) weights."""

    AXES = {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"), "w_down": ("ff", "embed"),
            "b_up": ("ff",), "b_down": ("embed",)}

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        d, ff, dt = cfg.d_model, cfg.d_ff, pdtype(cfg)
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.w_gate = make_param(gen, (d, ff), dt)
            self.w_up = make_param(gen, (d, ff), dt)
            self.w_down = make_param(gen, (ff, d), dt, fan_in=ff)
        elif cfg.mlp_type == "gelu":
            self.w_up = make_param(gen, (d, ff), dt)
            self.b_up = _zeros((ff,), gen.device)
            self.w_down = make_param(gen, (ff, d), dt, fan_in=ff)
            self.b_down = _zeros((d,), gen.device)
        else:
            raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}")


def apply_mlp(cfg: ArchConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    with trace.span("mlp"):
        up_ax, down_ax = MLP.AXES["w_up"], MLP.AXES["w_down"]
        w_up, w_down = _mg(p.w_up, up_ax), _mg(p.w_down, down_ax)
        if cfg.mlp_type == "swiglu":
            return matmul(F.silu(matmul(x, _mg(p.w_gate, up_ax))) * matmul(x, w_up), w_down)
        if cfg.mlp_type == "geglu":
            return matmul(F.gelu(matmul(x, _mg(p.w_gate, up_ax)), approximate="tanh") * matmul(x, w_up), w_down)
        h = F.gelu(matmul(x, w_up) + p.b_up.to(x.dtype), approximate="tanh")
        return matmul(h, w_down) + p.b_down.to(x.dtype)


# -- embeddings ---------------------------------------------------------------


class Embed(nn.Module):
    """``embedding [V, d]`` over the padded vocabulary, and ``unembed
    [d, V]`` unless the embeddings are tied."""

    AXES = {"embedding": ("vocab", "embed"), "unembed": ("embed", "vocab")}

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        V, d, dt = cfg.padded_vocab(), cfg.d_model, pdtype(cfg)
        self.embedding = make_param(gen, (V, d), dt, fan_in=d)
        if not cfg.tie_embeddings:
            self.unembed = make_param(gen, (d, V), dt)


def embed_tokens(cfg: ArchConfig, p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    with trace.span("embed"):
        if is_dtensor(p.embedding):  # a table sharded over a mesh: the vocabulary-parallel lookup
            x = embedding_local(tokens, p.embedding)
        else:
            x = p.embedding[tokens]
        if cfg.embed_scale:  # sqrt(d) in float32, rounded to the activation type
            x = x * float(torch.tensor(float(cfg.d_model)).sqrt().to(x.dtype))
        return x


def unembed(cfg: ArchConfig, p: Embed, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits over the padded vocabulary, soft-capped if the
    architecture caps them."""
    with trace.span("unembed"):
        w = p.embedding.t() if cfg.tie_embeddings else p.unembed
        logits = (x @ w).float()
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        return logits
