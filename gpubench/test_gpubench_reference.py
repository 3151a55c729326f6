"""The plain reference against ``repro_torch`` at a reduced width on the
CPU (float32: the two agree to rounding), the routing's admissible sets,
and the control (the reference in float8) failing the check."""
import pytest
import torch

from gpubench import bench, check, spec
from gpubench.small import small_cell
from gpubench.weights import Weights

REF = spec.reference("decoder")


def _setup(cell, seed=5):
    c = small_cell(cell)
    w = Weights(c.config, "cpu").draw(seed)
    return c, w, bench.build(c.config, w), bench.traffic_of(c, seed, "cpu")[1]


@pytest.mark.parametrize("cell", ["grok1-prefill", "internvl2-prefill"])
def test_prefill_logits_equal_the_port(cell):
    """grok-1's dropless MoE and softcap, InternLM2's VLM prefix: the last
    position's logits of every row."""
    from repro_torch.models import model as M

    c, w, model, t = _setup(cell)
    inputs = t.inputs(3)
    logits, _ = M.prefill(model, inputs)
    P = t.positions(3)
    rows = [REF.Row(inputs["tokens"][r], inputs["prefix"][r] if "prefix" in inputs else None,
                    torch.tensor([P - 1])) for r in range(t.batch)]
    res, _ = REF.forward(c.config, w.tensors, rows)
    for r in range(t.batch):
        torch.testing.assert_close(res[r].logits[0], logits[r], atol=1e-4, rtol=1e-4)


def test_prefill_then_decode_equals_the_reference_forward():
    """The port's prefill and greedy steps through its cache against one
    teacher-forced reference pass over the prompt and the served tokens."""
    from repro_torch.models import model as M

    c, w, model, t = _setup("grok1-decode")
    inputs = t.inputs(0)
    b = bench.serve(M, model, inputs, t.positions(0), t.steps, bench._Clock(torch.device("cpu")))
    P = t.positions(0)
    logits, state = M.prefill(model, inputs, cache_len=P + t.steps)
    step_logits = [logits]
    tok = logits.argmax(-1)
    for _ in range(t.steps):
        lg, state = M.serve_step(model, state, tok[:, None])
        step_logits.append(lg)
        tok = lg.argmax(-1)
    served = [check.Served(0, r, P, b.served[r], None) for r in range(t.batch)]
    res, _ = REF.forward(c.config, w.tensors, check.rows_for(REF, served, t.inputs))
    for r in range(t.batch):
        torch.testing.assert_close(res[r].logits, torch.stack([s[r] for s in step_logits]), atol=1e-4, rtol=1e-4)


def test_admissible_sets_near_a_tie():
    logits = torch.tensor([3.0, 1.0, 0.98, -2.0])
    assert REF.admissible(logits, 2, 0.0) == [(0, 1)]
    assert REF.admissible(logits, 2, 0.05) == [(0, 1), (0, 2)]
    assert REF.admissible(torch.tensor([1.0, 0.99, 0.98, -2.0]), 2, 0.05) == [(0, 1), (0, 2), (1, 2)]
    assert REF.admissible(torch.tensor([2.0, 2.0, 0.0, 0.0]), 2, 0.05) == [(0, 1)]


def test_a_flipped_route_is_followed_as_an_alternative(monkeypatch):
    """With a margin wide enough to take in every token's second and third
    choice, each compared position gains paths, the reference's own first."""
    c, w, model, t = _setup("grok1-prefill")
    inputs = t.inputs(0)
    rows = [REF.Row(inputs["tokens"][0], None, torch.tensor([t.positions(0) - 1]))]
    monkeypatch.setattr(REF, "ROUTE_MARGIN", 0.0)
    base, _ = REF.forward(c.config, w.tensors, rows)
    monkeypatch.setattr(REF, "ROUTE_MARGIN", 10.0)
    wide, stats = REF.forward(c.config, w.tensors, rows)
    assert stats["branched"] == 1 and stats["paths"] >= 1
    torch.testing.assert_close(wide[0].logits, base[0].logits)
    assert all(i == 0 for i, _ in wide[0].alternatives)


@pytest.mark.parametrize("cell", ["grok1-prefill", "internvl2-prefill", "grok1-decode"])
def test_the_control_fails_the_check(cell):
    """The reference in float8 e4m3 in the program's place reads past the
    cell's limits on three seeds."""
    from repro_torch.models import model as M

    for seed in (1, 2, 3):
        c, w, model, t = _setup(cell, seed)
        gen = spec.generator(c.traffic["generator"])
        clock = bench._Clock(torch.device("cpu"))
        batches, _ = gen.window(t, bench.sender(M, model, t, clock), clock.sync, 0.05)
        readings, ctrl, failed = bench.outputs_check(c, w, t, batches, seed, control=True)
        assert check.verdict(readings, c.limits["limits"], failed)[0]
        assert not check.verdict(ctrl, c.limits["limits"], 0)[0]
