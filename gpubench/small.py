"""Small cells for the CPU tests: each cell of ``BENCHMARK.json`` with its
configuration cut to a width the CPU runs in a second (float32, two
layers, d_model 64; a VLM prefix of 16) and its traffic to short rows,
everything else as the cell has it."""
from __future__ import annotations

from gpubench import spec


def small_cell(name: str, dtype: str = "float32", head_dim: int = 16) -> spec.Cell:
    """``head_dim`` 32 and ``dtype`` bfloat16 put the card's attention
    kernel on the path."""
    c = spec.cell(name)
    config = dict(c.config, d_model=4 * head_dim, n_heads=4, n_kv_heads=2, head_dim=head_dim, d_ff=128,
                  vocab_size=500, n_layers=2, dtype=dtype)
    if config.get("prefix_tokens"):
        config["prefix_tokens"] = 16
    traffic = dict(c.traffic)
    prompt = dict(traffic["prompt"])
    if prompt["dist"] == "loguniform":
        prompt.update(min=16, max=64, multiple=8, block=5)
    else:
        prompt["value"] = 24
    traffic["prompt"] = prompt
    if traffic.get("decode_steps"):
        traffic["decode_steps"] = 8
    return c._replace(config=config, traffic=traffic)
