"""The work a decoder needs for the inputs it is given: operations and
bytes computed from the configuration and the shapes, not from what the
program runs (an MoE layer's experts at ``experts_per_token`` choices a
token, whatever slots the program fills; attention over the causally
visible (query, key) pairs only).  A product of an ``m x n`` by an ``n x p``
matrix is ``2mnp`` operations.  Weights and activations are read once at
the configuration's element size."""
from __future__ import annotations

from typing import Dict


def padded_vocab(config) -> int:
    m = config["vocab_pad_multiple"]
    return -(-config["vocab_size"] // m) * m


def head_dim(config) -> int:
    return config.get("head_dim") or config["d_model"] // config["n_heads"]


def is_moe_layer(config, i: int) -> bool:
    every = config.get("moe_every", 1)
    return config.get("n_experts", 0) > 0 and i % every == every - 1


def elem_bytes(config) -> int:
    return {"bfloat16": 2, "float32": 4}[config["dtype"]]


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def attn_proj_params(config) -> int:
    d, H, Kv, D = config["d_model"], config["n_heads"], config["n_kv_heads"], head_dim(config)
    return d * (H * D + 2 * Kv * D) + H * D * d


def ffn_params_per_token(config, i: int) -> int:
    """Weights of layer ``i``'s FFN one token multiplies by: its dense MLP,
    or the router and ``experts_per_token`` experts."""
    d, ff = config["d_model"], config["d_ff"]
    if is_moe_layer(config, i):
        return d * config["n_experts"] + config["experts_per_token"] * 3 * d * ff
    return 3 * d * ff


def token_flops(config) -> int:
    """Operations a token needs in every layer's products (attention's
    scores and values apart)."""
    return sum(2 * (attn_proj_params(config) + ffn_params_per_token(config, i))
               for i in range(config["n_layers"]))


def attention_flops(config, pairs: int) -> int:
    """q.k and p.v over ``pairs`` (query, key) pairs, every head and layer."""
    return 4 * head_dim(config) * config["n_heads"] * pairs * config["n_layers"]


def logits_flops(config) -> int:
    return 2 * config["d_model"] * padded_vocab(config)


def prefill_flops(config, rows: int, positions: int) -> int:
    """A prefill of ``rows`` rows of ``positions`` positions, logits at the
    last position only (what the first token needs)."""
    return rows * (positions * token_flops(config) + attention_flops(config, causal_pairs(positions))
                   + logits_flops(config))


def decode_step_flops(config, rows: int, pos: int) -> int:
    """One decode step of ``rows`` tokens at position ``pos``."""
    return rows * (token_flops(config) + attention_flops(config, pos + 1) + logits_flops(config))


def decode_step_bytes(config, rows: int, pos: int) -> int:
    """One decode step's least traffic: every weight a token needs once
    (an MoE layer's router and ``experts_per_token`` experts: fewer the
    routing cannot need), the embedding rows, the unembedding, the K/V
    cache up to ``pos`` read and the new K/V written."""
    e, d = elem_bytes(config), config["d_model"]
    Kv, D, L = config["n_kv_heads"], head_dim(config), config["n_layers"]
    weights = sum(attn_proj_params(config) * e + 2 * d * 4 for _ in range(L))  # projections, two norms
    for i in range(L):
        if is_moe_layer(config, i):
            weights += d * config["n_experts"] * 4 + config["experts_per_token"] * 3 * d * config["d_ff"] * e
        else:
            weights += 3 * d * config["d_ff"] * e
    weights += d * padded_vocab(config) * e + d * 4  # unembedding, final norm
    kv = rows * L * 2 * Kv * D * e * (pos + 2)  # read positions 0..pos, write pos
    return weights + rows * d * e + kv


def bound_s(flops: float, nbytes: float, peak: Dict[str, float]) -> float:
    """The least time: the larger of the operations at the bf16 peak and
    the bytes at the HBM rate."""
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes"])


def experts_call(config, tokens: int):
    """(operations, bytes) one MoE layer's experts need for ``tokens``
    tokens: ``experts_per_token`` SiLU-gated products a token, each
    routed expert's three matrices read once (at least
    ``min(E, tokens * k)`` experts are routed to) and the tokens in and out."""
    d, ff, e = config["d_model"], config["d_ff"], elem_bytes(config)
    k, E = config["experts_per_token"], config["n_experts"]
    flops = tokens * k * 3 * 2 * d * ff
    nbytes = min(E, tokens * k) * 3 * d * ff * e + 2 * tokens * d * e
    return flops, nbytes


def flash_call(config, rows: int, positions: int):
    """(operations, bytes) of one layer's causal self-attention over a
    prefill: q.k and p.v over the visible pairs of every query head, and
    q, k, v and the output read or written once."""
    H, Kv, D, e = config["n_heads"], config["n_kv_heads"], head_dim(config), elem_bytes(config)
    flops = 4 * D * H * causal_pairs(positions) * rows
    nbytes = rows * positions * D * e * (2 * H + 2 * Kv)
    return flops, nbytes
