"""Token data pipeline for the LLM workflows: the port's copy of
``repro/data/pipeline.py``.

Synthetic but *learnable* streams: a Zipf-distributed unigram background
mixed with deterministic induction patterns (a -> b bigram copies), so a
real model shows a real loss curve.  The stream is numpy's, draw for draw
the JAX package's; only the tokens' last stop differs: an int32 tensor on
``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    zipf_a: float = 1.2
    induction_frac: float = 0.5  # fraction of positions forced to repeat pairs
    seed: int = 0


def _zipf_probs(V: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, V + 1) ** a
    return p / p.sum()


def token_batches(cfg: TokenStreamConfig, device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Yields {"tokens": [B, S+1] int32} batches on ``device`` forever."""
    dev = resolve_device(device)
    return _stream(cfg, dev)


def _stream(cfg: TokenStreamConfig, dev: torch.device) -> Iterator[Dict[str, torch.Tensor]]:
    rng = np.random.default_rng(cfg.seed)
    probs = _zipf_probs(cfg.vocab_size, cfg.zipf_a)
    # fixed random bigram successor table: the learnable structure
    succ = rng.integers(0, cfg.vocab_size, size=cfg.vocab_size)
    while True:
        base = rng.choice(cfg.vocab_size, size=(cfg.batch_size, cfg.seq_len + 1), p=probs)
        # induction: with prob induction_frac, token t+1 = succ[token t]
        flip = rng.random((cfg.batch_size, cfg.seq_len)) < cfg.induction_frac
        for s in range(cfg.seq_len):
            nxt = succ[base[:, s]]
            base[:, s + 1] = np.where(flip[:, s], nxt, base[:, s + 1])
        yield {"tokens": torch.from_numpy(base.astype(np.int32)).to(dev)}


def federated_token_batches(cfg: TokenStreamConfig, n_collaborators: int,
                            device="cuda") -> List[Iterator[Dict[str, torch.Tensor]]]:
    """Per-collaborator streams with DISTINCT successor tables — the
    non-IID-across-silos setting MAFL targets."""
    return [
        token_batches(dataclasses.replace(cfg, seed=cfg.seed + 1000 * i), device)
        for i in range(n_collaborators)
    ]
