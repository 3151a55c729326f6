"""A traced run on the CPU: the window as an untraced run serves it, then
one block of the mix under the profiler; the per-layer metrics the CPU
can give, the device's busy and window seconds, the breakdown, and the
check over both."""
import pytest

from gpubench import bench, spec
from gpubench.small import small_cell

SEED = 2**32 + 19
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_serves_the_window_then_one_traced_block(cell):
    c = small_cell(cell)
    line, run, readings = bench.run(c, SEED, 0.05, True, device="cpu")
    _, t = bench.traffic_of(c, SEED, "cpu")
    assert line["correct"] and list(line)[-1] == "checks", readings
    assert len(run.batches) % len(t.block) == 0 and len(run.traced) == len(t.block)
    assert [b.index for b in run.batches + run.traced] == list(range(len(run.batches) + len(t.block)))
    assert line["attempted"] == sum(b.rows for b in run.batches + run.traced)
    assert line["device"]["window_s"] > 0 and set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}
    if t.steps:
        assert "host_dispatch_ms.decode" in line["metrics"]
