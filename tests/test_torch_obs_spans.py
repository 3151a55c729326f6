"""The port's one span API on the LLM path (``repro_torch/obs/trace.py``)
and the MoE counters (``models/moe.py``), on the CPU: off, a span is the
shared no-op and nothing counts; under ``torch.profiler`` every span of
the LLM path is a range, nested as ``docs/ARCHITECTURE.md`` says; the
port tracer's timestamps are the profiler's clock; the counters against
hand counts; and tracing changes no bit of what is served."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace

LLM_SPANS = {"model.prefill", "model.serve_step", "embed", "unembed", "norm", "rope", "attn.qkv", "attn.decode",
             "attn.out", "cache.write", "mlp", "moe.route", "moe.dispatch", "moe.experts", "moe.combine"}
HARNESS_RANGES = {"window", "request", "prefill", "decode_step", "warmup", "reference"}  # gpubench's own
B, S, STEPS = 2, 32, 3


@pytest.fixture(scope="module")
def tiny():
    """Reduced grok-1 cut to two layers, a dense one then an MoE one."""
    cfg = dataclasses.replace(get_arch("grok-1-314b").reduced(), n_layers=2, moe_every=2, capacity_factor=4.0)
    model = M.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu").params
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    return cfg, model, tokens


@pytest.fixture(autouse=True)
def fresh():
    trace.disable()
    trace.reset()
    obs_metrics.reset()
    yield
    trace.disable()
    trace.reset()
    obs_metrics.reset()


def _serve(model, tokens, steps=STEPS):
    """A prefill then ``steps`` greedy steps: (prefill logits, every token)."""
    logits, state = M.prefill(model, {"tokens": tokens}, cache_len=tokens.shape[1] + steps)
    first = logits
    tok = torch.argmax(logits, -1)[:, None]
    toks = [tok]
    for _ in range(steps):
        logits, state = M.serve_step(model, state, tok)
        tok = torch.argmax(logits, -1)[:, None]
        toks.append(tok)
    return first, torch.cat(toks, 1)


def _value(name, **labels):
    fam = obs_metrics.REGISTRY.get(name)
    want = set(labels.items())
    return sum(c.value for c in fam.children() if want <= set(c.labels))


def _ranges(prof):
    """The user ranges of a profile: [(start ns, end ns, name)], by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.is_user_annotation())


def test_off_a_span_is_the_shared_noop_and_nothing_is_recorded_or_counted(tiny, monkeypatch):
    cfg, model, tokens = tiny
    entered, counted = [], []
    real = trace.record_function
    monkeypatch.setattr(trace, "record_function", lambda name: entered.append(name) or real(name))
    monkeypatch.setattr(moe, "_count", lambda *a: counted.append(a))
    before = obs_metrics.REGISTRY.prometheus_text()
    assert not trace.recording()
    assert trace.span("model.prefill", rows=1) is trace.NOOP_SPAN and trace.span("norm") is trace.NOOP_SPAN
    _serve(model, tokens)
    assert entered == [] and counted == [] and trace.TRACER.events() == []
    assert obs_metrics.REGISTRY.prometheus_text() == before


def test_under_the_profiler_every_llm_span_is_a_range_nested_as_documented(tiny):
    cfg, model, tokens = tiny
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(model, tokens)
    ranges = _ranges(prof)
    names = {n for _, _, n in ranges}
    assert LLM_SPANS <= names and not names & HARNESS_RANGES, names

    def inside(child, parents):
        outer = [(a, b) for a, b, n in ranges if n in parents]
        for a, b, n in ranges:
            if n == child:
                assert any(pa <= a and b <= pb for pa, pb in outer), (child, parents)

    steps = {"model.prefill", "model.serve_step"}
    assert sum(n == "model.serve_step" for _, _, n in ranges) == STEPS
    inside("rope", {"attn.qkv"})
    for child in ("embed", "unembed", "norm", "attn.qkv", "attn.out", "mlp", "moe.route", "moe.dispatch",
                  "moe.experts", "moe.combine"):
        inside(child, steps)
    inside("cache.write", {"model.prefill"})
    inside("attn.decode", {"model.serve_step"})
    # the counters took their phase from the enclosing span: one MoE layer
    k = cfg.experts_per_token
    assert _value("mafl_moe_rows_routed_total", phase="prefill") == B * S * k
    assert _value("mafl_moe_rows_routed_total", phase="decode") == STEPS * B * k
    assert _value("mafl_moe_rows_routed_total", phase="other") == 0


def test_the_port_tracer_stamps_spans_on_the_profilers_clock(tiny):
    cfg, model, tokens = tiny
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(model, tokens, steps=1)
    trace.disable()
    mine = sorted((e["ts"], e["name"]) for e in trace.TRACER.events())
    theirs = [(a / 1e3, n) for a, _, n in _ranges(prof)]
    assert [n for _, n in mine] == [n for _, n in theirs] and len(mine) > 40
    worst = max(abs(a - b) for (a, _), (b, _) in zip(mine, theirs))
    assert worst < 500.0, worst  # µs
    for e in trace.TRACER.events():  # a child ends inside its parent
        if e["args"]["parent_id"] is not None:
            parent = next(p for p in trace.TRACER.events() if p["args"]["span_id"] == e["args"]["parent_id"])
            assert parent["ts"] <= e["ts"] and e["ts"] + e["dur"] <= parent["ts"] + parent["dur"]


def _skewed(cfg, offset=0.5):
    """An MoE layer whose router prefers expert 0, and inputs that make it."""
    p = moe.MoE(cfg, torch.Generator().manual_seed(3))
    p.router.data[:, 0] += offset / cfg.d_model
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(4)) + 1.0
    return p, x.to(p.w_gate.dtype)


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_the_moe_counters_against_hand_counts(tiny, cf, groups):
    cfg = dataclasses.replace(tiny[0], capacity_factor=cf)
    E, k = cfg.n_experts, cfg.experts_per_token
    p, x = _skewed(cfg)
    n = B * S // groups
    cap = moe.capacity(cfg, n)
    _, ids, _ = moe.route(cfg, p, x.reshape(groups, n, -1))
    per_group = torch.stack([torch.bincount(ids[g].reshape(-1), minlength=E) for g in range(groups)])
    dropped = int(torch.clamp_min(per_group - cap, 0).sum())  # per-expert pairs past capacity, from the router
    moe.set_dispatch_groups(groups)
    try:
        trace.enable()
        moe.apply_moe(cfg, p, x)
        trace.disable()
    finally:
        moe.set_dispatch_groups(1)
    per_expert = per_group.sum(0)
    assert _value("mafl_moe_rows_routed_total", phase="other") == B * S * k
    assert _value("mafl_moe_rows_computed_total", phase="other") == groups * E * cap
    assert _value("mafl_moe_experts_routed_total", phase="other") == int((per_expert > 0).sum())
    assert _value("mafl_moe_experts_read_total", phase="other") == E
    assert _value("mafl_moe_rows_dropped_total", phase="other") == dropped
    assert (dropped > 0) == (cf == 1.0), dropped


def test_counts_wait_on_the_device_until_a_family_is_read(tiny):
    cfg = tiny[0]
    p, x = _skewed(cfg)
    trace.enable()
    moe.apply_moe(cfg, p, x)
    moe.apply_moe(cfg, p, x)
    trace.disable()
    (key, acc), = moe._ACC.items()  # one accumulator: both dispatches added into it
    assert key == ("other", cfg.n_experts, x.device) and acc.shape == (cfg.n_experts + 1,)
    held = acc.tolist()
    routed = _value("mafl_moe_experts_routed_total", phase="other")
    assert moe._ACC == {} and routed == sum(held[:-1]) and 0 < routed <= 2 * cfg.n_experts
    assert _value("mafl_moe_rows_dropped_total", phase="other") == held[-1]
    assert "mafl_moe_rows_dropped_total" in obs_metrics.REGISTRY.prometheus_text()


def test_tracing_changes_no_bit_of_the_prefill_or_the_greedy_tokens(tiny):
    cfg, model, tokens = tiny
    off_logits, off_tokens = _serve(model, tokens, steps=4)
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]):
        on_logits, on_tokens = _serve(model, tokens, steps=4)
    trace.disable()
    assert torch.equal(off_logits, on_logits) and torch.equal(off_tokens, on_tokens)
