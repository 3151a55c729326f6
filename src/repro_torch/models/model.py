"""Serving API over the decoder stack: ``prefill`` a batch of prompts into
per-layer KV caches, then ``serve_step`` one token at a time.  The port's
counterpart of the serving half of ``repro/models/model.py``; the loss,
the train step and the dry-run input specs wait for the training slice.

The decode position is a host ``int``: the loop never reads it back from
the device.  The caches are written in place by each step
(``models/attention.py``), so a ``ServeState`` is consumed by the step
that advances it.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import LayerCache
from repro_torch.models.layers import unembed
from repro_torch.models.transformer import Transformer, init_caches


class ServeState(NamedTuple):
    caches: List[LayerCache]  # one [B, T, Kv, D] cache per layer
    pos: int  # next absolute position


def init_serve_state(cfg: ArchConfig, batch: int, cache_len: int, device) -> ServeState:
    return ServeState(init_caches(cfg, batch, cache_len, device), 0)


def prefill(
    model: Transformer,
    batch: Dict[str, torch.Tensor],
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, ServeState]:
    """Full-sequence forward over ``batch["tokens"] [B, S]``; returns the
    last position's logits [B, V] (float32) and the state.  The caches are
    allocated at ``max(S, cache_len)`` slots, zero past the prompt (the
    decode mask ``j <= pos`` ignores them), and the forward writes the
    prompt's K/V into them."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    state = init_serve_state(model.cfg, B, max(S, cache_len or S), tokens.device)
    hidden = model(tokens, caches=state.caches)
    logits = unembed(model.cfg, model.embed, hidden[:, -1:, :])[:, 0]
    return logits, state._replace(pos=S)


def serve_step(
    model: Transformer, state: ServeState, token: torch.Tensor
) -> Tuple[torch.Tensor, ServeState]:
    """token [B, 1] -> (logits [B, V] float32, the advanced state)."""
    logits, caches = model.decode_step(state.caches, token, state.pos)
    return logits, ServeState(caches, state.pos + 1)
