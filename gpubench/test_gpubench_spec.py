"""BENCHMARK.json and the files it names: they load, keep to the
schema BENCHMARK.json keeps to, and state the published widths."""
import json
import re

import pytest

from gpubench import counts, spec
from gpubench.run import ROOT

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_keeps_to_its_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    assert all(NAME.match(n) for n in names)
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("gpubench/")
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert ("_roofline" not in m["name"] and "mfu" not in m["name"]) or m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_and_reports_what_it_must(cell):
    c = spec.cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]).read)
    for m in c.end_to_end:
        assert callable(spec.metric_reader(m["name"]).read)
    ref = spec.reference(c.config["reference"])
    for fn in ("layout", "inputs", "positions", "row", "forward"):
        assert callable(getattr(ref, fn)), fn
    assert c.limits["limits"] and all(isinstance(v, (int, float)) for v in c.limits["limits"].values())
    gen = spec.generator(c.traffic["generator"])
    assert callable(gen.window) and gen.Traffic(c.traffic, c.config, 0, "cpu").shapes()


def _grok():
    return spec.load_json(ROOT / "gpubench/configs/grok-1-314b-l4.json")


def _internvl2():
    return spec.load_json(ROOT / "gpubench/configs/internvl2-26b.json")


def test_grok_widths_are_the_released_ones():
    c, pub = _grok(), _grok()["published"]
    assert (c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]) == (
        pub["emb_size"], pub["num_q_heads"], pub["num_kv_heads"], pub["key_size"])
    ffn = int(pub["widening_factor"] * pub["emb_size"]) * 2 // 3
    assert c["d_ff"] == pub["ffn_size"] == ffn + (-ffn) % 8
    assert (c["n_experts"], c["experts_per_token"], c["vocab_size"]) == (
        pub["num_experts"], pub["num_selected_experts"], pub["vocab_size"])
    assert (c["logit_softcap"], c["rope_theta"], c["norm_eps"]) == (
        pub["attn_logit_softcap"], pub["rope_base"], pub["rms_norm_eps"])
    assert c["n_layers"] != pub["num_layers"] and c["reduced"] == ["n_layers", "capacity_factor"]
    from repro_torch.configs import get_arch

    port = get_arch("grok-1-314b")
    for key in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size", "n_experts",
                "experts_per_token", "logit_softcap"):
        assert c[key] == getattr(port, key), key


def test_internvl2_widths_are_internlm2_20b():
    c, pub = _internvl2(), _internvl2()["published"]
    assert (c["d_model"], c["n_layers"], c["n_heads"], c["n_kv_heads"], c["d_ff"], c["vocab_size"]) == (
        pub["hidden_size"], pub["num_hidden_layers"], pub["num_attention_heads"], pub["num_key_value_heads"],
        pub["intermediate_size"], pub["vocab_size"])
    patches = (pub["force_image_size"] // 14 * pub["downsample_ratio"]) ** 2
    assert patches == pub["image_tokens_per_tile"] and c["prefix_tokens"] == 4 * patches
    assert c["reduced"] == [] and c["mlp_type"] == "swiglu" and "n_experts" not in c


def _token_counts(cell):
    """Every token count one MoE call of ``cell`` sees: a prefill's rows x
    positions, a decode step's rows."""
    c = spec.cell(cell)
    t = spec.generator(c.traffic["generator"]).Traffic(c.traffic, c.config, 0, "cpu")
    tokens = {t.batch * t.positions(0, n) for n in t.shapes()}
    if t.steps:
        tokens.add(t.batch)
    return sorted(tokens)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"] if w["config"] == "grok-1-314b-l4"])
def test_grok_drops_no_routed_choice(cell):
    """capacity(cfg, n) >= n at every token count: an expert can hold every
    token, and a token's two choices name two experts, so none is dropped."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.moe import capacity

    cfg = ArchConfig(**spec.port_fields(_grok()))
    for n in _token_counts(cell):
        assert capacity(cfg, n) >= n, (cell, n)


def test_padded_vocabulary_matches_the_port():
    from repro_torch.configs.base import ArchConfig

    for c in (_grok(), _internvl2()):
        V = ArchConfig(**spec.port_fields(c)).padded_vocab()
        unembed = {leaf.name: leaf for leaf in spec.reference(c["reference"]).layout(c)}["embed.unembed"]
        assert counts.padded_vocab(c) == V == unembed.shape[1] and unembed.drawn_cols == c["vocab_size"]
