"""xlstm-1.3b [ssm] — mLSTM + sLSTM blocks, 4 heads, no separate FFN
(blocks carry their own up/down projections) [arXiv:2405.04517]."""
from repro_torch.configs.base import ArchConfig, register_arch

XLSTM_1_3B = register_arch(ArchConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    layer_pattern="xlstm",
    slstm_every=8,  # xLSTM[7:1] — one sLSTM block per 8
    fsdp=False,
    source="arXiv:2405.04517 (xLSTM: Extended Long Short-Term Memory)",
))
