"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1) [arXiv:2403.08295]."""
from repro_torch.configs.base import ArchConfig, register_arch

GEMMA_2B = register_arch(ArchConfig(
    name="gemma-2b",
    arch_type="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_type="geglu",
    tie_embeddings=True,
    embed_scale=True,
    layer_pattern="full",
    fsdp=False,
    source="arXiv:2403.08295 (Gemma: Open Models Based on Gemini)",
))
