"""Routed (token, choice) pairs the MoE experts kept, over the expert rows
they multiplied, in prefill: ``mafl_moe_rows_routed_total`` less
``mafl_moe_rows_dropped_total`` over ``mafl_moe_rows_computed_total``,
phase ``prefill``, %.  The program counts them (``models/moe.py``) only
while a recorder is on, so in a run they hold the traced block's prefills;
a program without the counters gives nothing."""


def _count(name: str, phase: str):
    from repro_torch.obs.metrics import REGISTRY

    family = REGISTRY.get(name)
    if family is None:
        return None
    return sum(c.value for c in family.children() if ("phase", phase) in c.labels)


def read(run):
    if run.trace is None:
        return None
    routed, dropped, computed = (_count(f"mafl_moe_rows_{what}_total", "prefill")
                                 for what in ("routed", "dropped", "computed"))
    if routed is None or dropped is None or not computed:
        return None
    return 100.0 * (routed - dropped) / computed
