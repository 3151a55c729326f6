"""The MoE layers' experts against their roofline in prefill: each layer
call's least time (``counts.experts_call``: ``experts_per_token`` SiLU-gated
products a token at the bf16 peak, or the routed experts' weights at the
HBM rate, whichever is longer) summed over the traced block, over the
device time of the kernels under the program's ``moe.experts`` ranges
there, %."""
from gpubench import counts
from gpubench.peaks import peaks


def read(run):
    peak = peaks(run.kind)
    if run.trace is None or peak is None or run.traffic.get("decode_steps", 0):
        return None
    t = run.trace.range_device_s(("moe.experts",))
    layers = sum(counts.is_moe_layer(run.config, i) for i in range(run.config["n_layers"]))
    if not t or not layers:
        return None
    bound = sum(layers * counts.bound_s(*counts.experts_call(run.config, b.rows * b.positions), peak)
                for b in run.traced)
    return 100.0 * bound / t
