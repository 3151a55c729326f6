"""On the card: each cell at a small width in bfloat16 through the port's
kernels, judged by the same check (correct), and its control (incorrect).
Skips itself where there is no card."""
import pytest
import torch

from gpubench import bench, check
from gpubench.small import small_cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["grok1-prefill", "internvl2-prefill", "grok1-decode"])
def test_small_cells_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.models import model as M

    c = small_cell(cell, dtype="bfloat16", head_dim=32)
    line, run, _ = bench.run(c, 11, 1e-6, True, device="cuda")
    assert line["correct"] and line["device"]["busy_s"] > 0, line
    w = bench.Weights(c.config, "cuda")
    gen, t = bench.traffic_of(c, 11, "cuda")
    clock = bench._Clock(torch.device("cuda"))
    batches, _ = gen.window(t, bench.sender(M, bench.build(c.config, w.draw(11)), t, clock), clock.sync, 1e-6)
    _, ctrl, _ = bench.outputs_check(c, w, t, batches, 11, control=True)
    assert not check.verdict(ctrl, c.limits["limits"], 0)[0]
