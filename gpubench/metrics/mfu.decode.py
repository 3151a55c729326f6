"""The whole decode step's roofline share: each step's least time (the
larger of its operations at the bf16 peak and its least bytes at the HBM
rate, ``counts.decode_step_flops`` and ``decode_step_bytes``: an MoE
layer's router and ``experts_per_token`` experts, whatever the routing)
over the step's time (the interval between its token and the last, by
CUDA events in the untraced window), summed over the window's steps, %."""
from gpubench import counts
from gpubench.peaks import peaks


def read(run):
    peak = peaks(run.kind)
    steps = [b for b in run.batches if b.intervals_s]
    if peak is None or not steps:
        return None
    bound = time = 0.0
    for b in steps:
        for i, s in enumerate(b.intervals_s):
            pos = b.positions + i  # the position the step's token is fed at
            bound += counts.bound_s(counts.decode_step_flops(run.config, b.rows, pos),
                                    counts.decode_step_bytes(run.config, b.rows, pos), peak)
            time += s
    return 100.0 * bound / time
