"""``flash_attention`` against its roofline in prefill: each call's least
time (``counts.flash_call``: q.k and p.v over the causally visible pairs
at the bf16 peak, or q, k, v and the output once at the HBM rate,
whichever is longer; one call a layer a prefill) summed over the traced
block, over the device time of the kernels named below there, %."""
from gpubench import counts
from gpubench.peaks import peaks

KERNELS = ("flash_attention_sm90_ws_kernel", "flash_attention_sm90_kernel", "flash_attention_f32_kernel")


def read(run):
    peak = peaks(run.kind)
    if run.trace is None or peak is None or run.traffic.get("decode_steps", 0):
        return None
    t = run.trace.kernel_s(KERNELS)
    if not t:
        return None
    bound = sum(run.config["n_layers"] * counts.bound_s(*counts.flash_call(run.config, b.rows, b.positions), peak)
                for b in run.traced)
    return 100.0 * bound / t
