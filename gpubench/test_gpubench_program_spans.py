"""The readers of the program's spans and counters on the CPU's small
cells: ``moe_slot_use.prefill`` equals the count ``models/moe.py``'s
``capacity`` gives for the traced block, and every reader returns None
where the run gives it nothing to read (no traced block, no MoE layer, no
kernel on a device)."""
import pytest

from gpubench import bench, spec
from gpubench.small import small_cell

SEED = 2**32 + 23
READERS = ("moe_slot_use.prefill", "moe_expert_use.decode", "norm_rope_share.prefill", "moe_idle_share.decode")


def _traced(cell):
    from repro_torch.obs import metrics

    metrics.reset()  # the counters hold this run's traced block alone, as in a process of its own
    c = small_cell(cell)
    line, run, readings = bench.run(c, SEED, 0.05, True, device="cpu")
    assert line["correct"], readings
    return c, run


def _read(name, run):
    return spec.metric_reader(name).read(run)


def test_slot_use_is_the_count_capacity_gives():
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import moe

    c, run = _traced("grok1-prefill")
    cfg = ArchConfig(**spec.port_fields(c.config))
    rows = [b.rows * b.positions for b in run.traced]
    want = 100.0 * sum(n * cfg.experts_per_token for n in rows) / sum(cfg.n_experts * moe.capacity(cfg, n)
                                                                       for n in rows)
    assert _read("moe_slot_use.prefill", run) == pytest.approx(want, rel=1e-12)
    assert want == 25.0  # capacity factor 4.0 over 8 experts, top-2: the experts compute 8n rows for 2n
    for name in ("norm_rope_share.prefill", "moe_idle_share.decode"):  # no kernel on a device
        assert _read(name, run) is None, name


def test_the_readers_give_nothing_where_the_run_holds_nothing():
    _, run = _traced("internvl2-prefill")  # no MoE layer, no device
    for name in READERS:
        assert _read(name, run) is None, name
    _, run = _traced("grok1-decode")
    assert 0.0 < _read("moe_expert_use.decode", run) <= 100.0
    assert _read("moe_idle_share.decode", run) is None
    untraced = run._replace(trace=None, traced=[])
    for name in READERS:
        assert _read(name, untraced) is None, name
