"""Architecture configuration schema and registry.

The port's own copy of ``repro/configs/base.py``, cut to the fields that
the attention, MoE and recurrent paths read: an ``ArchConfig`` holds a
published architecture's exact dimensions (source cited in ``source``),
and ``reduced()`` gives its smoke-test variant (``2·period`` layers, or one
unit of more than 4, d_model 128, at most 4 experts at a drop-free
capacity, windows of at most 64, an encoder of at most 2 layers over at
most 32 frames, a prefix of at most 16, ``d_state`` 8, float32) for CPU
tests.
``pattern()`` expands the architecture into a repeating unit of per-layer
descriptors (``LayerDesc``) for the ``full``, ``local_global`` (gemma2: a
sliding-window layer, then a full one), ``chunked_global`` (llama4:
``pattern_period - 1`` window layers, then a full layer without RoPE),
``mamba_attn`` (jamba: one attention layer at ``attn_index`` of each
``pattern_period``, Mamba layers around it) and ``xlstm`` (``slstm_every
- 1`` mLSTM blocks, then an sLSTM block, none with a separate FFN)
patterns, with an MoE FFN on every ``moe_every``-th layer of an MoE
architecture.  The front ends: an ``audio`` architecture (whisper) has an
encoder of ``encoder_layers`` layers over ``encoder_seq`` frame
embeddings and a cross-attention sublayer in every decoder layer; a
``vlm`` architecture takes ``prefix_tokens`` patch embeddings before its
tokens; ``post_norm`` (gemma2) norms each sublayer's output before its
residual add.  ``fsdp`` additionally shards a large parameter dimension
over the production mesh's ``data`` axis (``models/shardings.py``).
``INPUT_SHAPES`` are the dry-run's four input shapes (``launch/dryrun.py``).
gemma-2b, xlstm-1.3b, grok-1-314b and llama4-scout-17b-a16e
are registered, as in the JAX package.  :meth:`ArchConfig.with_layers`
cuts an architecture's depth (the card's runs of grok-1 and llama4-scout,
and of xlstm-1.3b's train step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    mixer: str  # attn_full | attn_local | mamba | mlstm | slstm
    ffn: str  # swiglu | geglu | gelu | moe | none


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str
    head_dim: Optional[int] = None  # default d_model // n_heads
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # MoE FFN on every k-th layer
    capacity_factor: float = 1.25
    layer_pattern: str = "full"  # full | local_global | chunked_global | mamba_attn | xlstm
    window: Optional[int] = None  # sliding-window size of the local layers
    pattern_period: int = 1  # layers per repeating unit (chunked_global, mamba_attn)
    attn_index: int = 0  # position of the attention layer inside a hybrid unit
    logit_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    # SSM
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0  # xlstm: one sLSTM block per k blocks (0 = none)
    # Modality front ends: the encoders' own inputs arrive as embeddings
    encoder_layers: int = 0  # whisper audio encoder depth
    encoder_seq: int = 0  # post-conv mel frames (whisper-large: 1500)
    prefix_tokens: int = 0  # VLM patch-embedding prefix length
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    pos_emb: str = "rope"  # rope | sinusoidal
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    post_norm: bool = False  # gemma2 extra post-norms
    dtype: str = "bfloat16"
    # Distribution
    fsdp: bool = False  # additionally shard big param dims over the data axis
    remat: bool = True  # recompute each layer's activations in the backward

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def padded_vocab(self, multiple: int = 2048) -> int:
        return -(-self.vocab_size // multiple) * multiple

    def pattern(self) -> Tuple[Tuple[LayerDesc, ...], int]:
        """(repeating unit of layer descriptors, n_repeats)."""

        def ffn_for(idx_in_unit: int, base: str) -> str:
            if self.is_moe and (idx_in_unit % self.moe_every == self.moe_every - 1):
                return "moe"
            return base

        if self.layer_pattern == "full":
            period = self.moe_every if self.is_moe else 1
            unit = tuple(LayerDesc("attn_full", ffn_for(i, self.mlp_type)) for i in range(period))
            return unit, self._repeats(period)
        if self.layer_pattern == "local_global":
            unit = (LayerDesc("attn_local", self.mlp_type), LayerDesc("attn_full", self.mlp_type))
            return unit, self._repeats(2)
        if self.layer_pattern == "chunked_global":
            p = self.pattern_period
            unit = tuple(LayerDesc("attn_local" if i < p - 1 else "attn_full", ffn_for(i, self.mlp_type))
                         for i in range(p))
            return unit, self._repeats(p)
        if self.layer_pattern == "mamba_attn":
            # jamba: one attention layer per ``pattern_period`` (the rest
            # Mamba), an MoE FFN every ``moe_every``-th layer
            p = self.pattern_period
            unit = tuple(LayerDesc("attn_full" if i == self.attn_index else "mamba",
                                   ffn_for(i, self.mlp_type)) for i in range(p))
            return unit, self._repeats(p)
        if self.layer_pattern == "xlstm":
            # xLSTM [k-1 : 1] mLSTM : sLSTM blocks; the blocks carry their
            # own projections, no separate FFN
            p = self.slstm_every or 1
            unit = tuple(LayerDesc("slstm" if (self.slstm_every and i == p - 1) else "mlstm", "none")
                         for i in range(p))
            return unit, self._repeats(p)
        raise ValueError(f"unknown layer_pattern {self.layer_pattern!r}")

    def _repeats(self, period: int) -> int:
        """Units in the stack: a whole number of them, or a stack shorter
        than one unit (a depth cut keeps the unit's first layers)."""
        if self.n_layers > period and self.n_layers % period:
            raise ValueError(f"{self.name}: {self.n_layers} layers do not repeat a unit of {period}")
        return -(-self.n_layers // period)

    def with_layers(self, n_layers: int) -> "ArchConfig":
        """The same architecture cut to its first ``n_layers`` layers (layer
        ``r`` keeps unit position ``r % period``): the depth cut of the
        card's full-width runs."""
        if n_layers < 1:
            raise ValueError(f"a depth cut keeps at least one layer, got {n_layers}")
        return dataclasses.replace(self, n_layers=n_layers)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims (the JAX package's
        ``reduced()`` over the fields the port has)."""
        unit, _ = self.pattern()
        period = len(unit)
        heads = max(2, min(4, self.n_heads))
        return dataclasses.replace(
            self,
            n_layers=period * (2 if period <= 4 else 1),
            d_model=128,
            n_heads=heads,
            n_kv_heads=max(1, min(self.n_kv_heads, heads)),
            head_dim=32,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            # Effectively drop-free (cap >= all tokens on one expert), as the
            # JAX package's reduced() is: the untrained router is skewed at
            # smoke scale.  The full configs keep the realistic 1.25.
            capacity_factor=float(2 * max(self.n_experts, 1)),
            window=min(self.window, 64) if self.window else None,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            prefix_tokens=min(self.prefix_tokens, 16) if self.prefix_tokens else 0,
            d_state=8,
            fsdp=False,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


_ARCH_REGISTRY: Dict[str, ArchConfig] = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _ARCH_REGISTRY:
        _load_all()
    if name not in _ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCH_REGISTRY)}")
    return _ARCH_REGISTRY[name]


def all_archs() -> Dict[str, ArchConfig]:
    if not _ARCH_REGISTRY:
        _load_all()
    return dict(_ARCH_REGISTRY)


def _load_all() -> None:
    import importlib

    for mod in ("gemma_2b", "xlstm_1_3b", "grok_1_314b", "llama4_scout_17b_a16e"):
        importlib.import_module(f"repro_torch.configs.{mod}")
