"""The whole prefill step's share of the card's bf16 peak: the operations
the window's prefills need (``counts.prefill_flops``: experts at
``experts_per_token`` choices a token, attention over the causally
visible pairs, logits at the last position) over the window's seconds
(the untraced window: the host's clock), %."""
from gpubench import counts
from gpubench.peaks import peaks


def read(run):
    peak = peaks(run.kind)
    if peak is None or not run.batches or run.traffic.get("decode_steps", 0):
        return None
    flops = sum(counts.prefill_flops(run.config, b.rows, b.positions) for b in run.batches)
    return 100.0 * flops / (run.window_s * peak["bf16_flops"])
