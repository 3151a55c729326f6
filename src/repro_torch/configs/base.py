"""Architecture configuration schema and registry.

The port's own copy of ``repro/configs/base.py``, cut to the fields that
the dense full-attention serving path reads: an ``ArchConfig`` holds a
published architecture's exact dimensions (source cited in ``source``),
and ``reduced()`` gives its smoke-test variant (2 layers, d_model 128,
float32) for CPU tests.  ``arch_type``, ``n_experts``, ``layer_pattern``
and ``post_norm`` are kept so that the model can refuse what it does not
serve yet (``models/transformer.py``); the MoE, window, SSM, front-end and
distribution fields, ``LayerDesc`` and ``pattern()`` arrive with the
architectures that read them.  Only gemma-2b is registered; the others
raise in :func:`get_arch`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item 13)"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str  # dense (served); ssm | moe | audio | vlm | hybrid raise
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str
    head_dim: Optional[int] = None  # default d_model // n_heads
    n_experts: int = 0  # MoE layers raise
    layer_pattern: str = "full"  # every other pattern raises
    logit_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    pos_emb: str = "rope"  # rope | sinusoidal
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    post_norm: bool = False  # gemma2 extra post-norms; raise
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def padded_vocab(self, multiple: int = 2048) -> int:
        return -(-self.vocab_size // multiple) * multiple

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims, two layers, float32
        (the JAX package's ``reduced()`` for the ``full`` pattern)."""
        heads = max(2, min(4, self.n_heads))
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=128,
            n_heads=heads,
            n_kv_heads=max(1, min(self.n_kv_heads, heads)),
            head_dim=32,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            dtype="float32",
        )


# Architectures the JAX package has and the port does not yet serve; each
# arrives with ROADMAP Queue 1 item 13's later parts (MoE, recurrent mixers,
# chunked-local attention).
UNPORTED = ("grok-1-314b", "llama4-scout-17b-a16e", "xlstm-1.3b")

_ARCH_REGISTRY: Dict[str, ArchConfig] = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _ARCH_REGISTRY:
        _load_all()
    if name in UNPORTED:
        raise NotImplementedError(f"arch {name!r} {NOT_PORTED}; the port has {sorted(_ARCH_REGISTRY)}")
    if name not in _ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCH_REGISTRY)}")
    return _ARCH_REGISTRY[name]


def _load_all() -> None:
    import importlib

    for mod in ("gemma_2b",):
        importlib.import_module(f"repro_torch.configs.{mod}")
