"""grok-1-314b [moe] — 8 experts top-2, GQA kv=8, attn logit softcap
[hf:xai-org/grok-1]."""
from repro_torch.configs.base import ArchConfig, register_arch

GROK_1_314B = register_arch(ArchConfig(
    name="grok-1-314b",
    arch_type="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    experts_per_token=2,
    moe_every=1,
    logit_softcap=30.0,
    mlp_type="geglu",
    layer_pattern="full",
    fsdp=True,
    source="hf:xai-org/grok-1 (model card + released config)",
))
