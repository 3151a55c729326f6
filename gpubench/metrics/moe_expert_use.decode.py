"""Experts with at least one routed (token, choice) pair, over the experts
whose weights the MoE experts stage read, in decode steps:
``mafl_moe_experts_routed_total`` over ``mafl_moe_experts_read_total``,
phase ``decode``, %.  The program counts them (``models/moe.py``) only
while a recorder is on, so in a run they hold the traced block's steps; a
program without the counters gives nothing."""


def _count(name: str, phase: str):
    from repro_torch.obs.metrics import REGISTRY

    family = REGISTRY.get(name)
    if family is None:
        return None
    return sum(c.value for c in family.children() if ("phase", phase) in c.labels)


def read(run):
    if run.trace is None:
        return None
    routed = _count("mafl_moe_experts_routed_total", "decode")
    read_ = _count("mafl_moe_experts_read_total", "decode")
    if routed is None or not read_:
        return None
    return 100.0 * routed / read_
