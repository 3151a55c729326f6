"""llama4-scout-17b-a16e [moe] — 16 experts top-1, chunked local attention
(8192) with every-4th-layer global/NoPE, early-fusion multimodal (text
path modeled; fusion embeds enter like tokens)
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import ArchConfig, register_arch

LLAMA4_SCOUT_17B_A16E = register_arch(ArchConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    experts_per_token=1,
    moe_every=1,
    layer_pattern="chunked_global",
    pattern_period=4,  # 3 chunked-local + 1 global
    window=8192,
    mlp_type="swiglu",
    fsdp=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (model card)",
))
