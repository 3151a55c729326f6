"""The operation and byte counts of ``counts.py`` against values worked by
hand at one small shape each, and the readers' arithmetic on a made-up run."""
from types import SimpleNamespace

import pytest

from gpubench import counts, spec

# d 4, H 2 over Kv 1 heads of 2, ff 8, vocabulary 10, one layer, bf16
DENSE = {"d_model": 4, "n_heads": 2, "n_kv_heads": 1, "head_dim": 2, "d_ff": 8, "vocab_size": 10,
         "vocab_pad_multiple": 2, "n_layers": 1, "dtype": "bfloat16"}
MOE = dict(DENSE, n_experts=4, experts_per_token=2, moe_every=1)
PEAK = {"bf16_flops": 1e3, "hbm_bytes": 1e2}


def test_dense_counts_by_hand():
    # projections 4·(2·2 + 2·1·2) + 2·2·4 = 48, SwiGLU 3·4·8 = 96: 2·(48 + 96) = 288 a token
    assert counts.token_flops(DENSE) == 288
    assert counts.causal_pairs(3) == 6
    assert counts.attention_flops(DENSE, 6) == 96  # 4·D·H·pairs
    assert counts.logits_flops(DENSE) == 80
    assert counts.prefill_flops(DENSE, 2, 3) == 2 * (3 * 288 + 96 + 80)
    assert counts.decode_step_flops(DENSE, 2, 3) == 2 * (288 + 4 * 2 * 2 * 4 + 80)
    # weights 48·2 + norms 2·4·4 + FFN 96·2 + unembedding 40·2 + final norm 16 = 416;
    # embedding rows 2·4·2 = 16; K/V 2 rows · 2 · 1·2 · 2 bytes · 5 positions = 80
    assert counts.decode_step_bytes(DENSE, 2, 3) == 416 + 16 + 80


def test_moe_counts_by_hand():
    # router 4·4 + 2 experts · 3·4·8 = 208 a token in the FFN
    assert counts.token_flops(MOE) == 2 * (48 + 16 + 192)
    flops, nbytes = counts.experts_call(MOE, 3)
    assert flops == 3 * 2 * 3 * 2 * 4 * 8
    assert nbytes == 4 * 3 * 4 * 8 * 2 + 2 * 3 * 4 * 2
    assert counts.experts_call(MOE, 1)[1] == 2 * 3 * 4 * 8 * 2 + 2 * 4 * 2  # one token reaches 2 experts
    # weights: projections 96, norms 32, router 4·4·4 = 64, 2 experts 2·96·2 = 384, unembedding 80, norm 16
    assert counts.decode_step_bytes(MOE, 1, 0) == 96 + 32 + 64 + 384 + 80 + 16 + 8 + 1 * 2 * 2 * 2 * 2


def test_flash_counts_by_hand():
    flops, nbytes = counts.flash_call(DENSE, 2, 3)
    assert flops == 4 * 2 * 2 * 6 * 2
    assert nbytes == 2 * 3 * 2 * 2 * (2 * 2 + 2 * 1)
    assert counts.bound_s(2000, 100, PEAK) == 2.0 and counts.bound_s(10, 500, PEAK) == 5.0


def _run(**kw):
    base = dict(config=DENSE, traffic={"decode_steps": 0}, kind="NVIDIA H100 80GB HBM3", window_s=2.0, setup_s=1.0,
                traced=[])
    base.update(kw)
    return SimpleNamespace(**base)


def _batch(rows, positions, t0, t1, intervals=(), dispatch=(), served=None):
    return SimpleNamespace(rows=rows, positions=positions, t0=t0, t1=t1, intervals_s=list(intervals),
                           dispatch_s=list(dispatch), served=served or [[1]] * rows)


def test_end_to_end_readers_on_a_made_up_run():
    batches = [_batch(1, 100, 0.0, 0.1 * (i + 1)) for i in range(20)]
    run = _run(batches=batches)
    assert spec.metric_reader("prefill_tok_s").read(run) == pytest.approx(20 * 100 / 2.0)
    assert spec.metric_reader("ttft_p95_ms").read(run) == pytest.approx(1905.0)  # between 1900 and 2000
    assert spec.metric_reader("setup_s").read(run) == 1.0
    dec = _run(traffic={"decode_steps": 2}, batches=[_batch(2, 10, 0, 1, [0.01, 0.03], [0.002, 0.004],
                                                              [[1, 2, 3], [4, 5, 6]])])
    assert spec.metric_reader("output_tok_s").read(dec) == pytest.approx(6 / 2.0)
    assert spec.metric_reader("host_dispatch_ms.decode").read(dec) == pytest.approx(3.0)
    assert spec.metric_reader("prefill_tok_s").read(dec) is None


def test_trace_readers_give_nothing_without_a_trace_or_a_known_card():
    """The readers of the trace give nothing without one; the whole step's
    shares (``mfu.*``) read the untraced window and need only a known card."""
    run = _run(batches=[_batch(1, 100, 0.0, 0.1)], trace=None)
    for name in ("device_idle.prefill", "flash_attention_roofline.prefill", "moe_experts_roofline.prefill",
                 "device_idle.decode", "moe_ms_per_step.decode"):
        assert spec.metric_reader(name).read(run) is None
    assert spec.metric_reader("mfu.prefill").read(run) == pytest.approx(
        100 * counts.prefill_flops(DENSE, 1, 100) / (2.0 * 989.4e12))
    assert spec.metric_reader("mfu.decode").read(run) is None  # no decode step
    assert spec.metric_reader("mfu.decode").read(_run(batches=[_batch(1, 100, 0.0, 0.1, [0.5])], trace=None,
                                                     kind="cpu")) is None
    trace = SimpleNamespace(window_s=2.0, busy_s=1.5, kernel_s=lambda names: 0.0,
                            range_device_s=lambda names, inside=None: 0.0)
    unknown = _run(batches=[_batch(1, 100, 0.0, 0.1)], trace=trace, kind="cpu")
    assert spec.metric_reader("mfu.prefill").read(unknown) is None
    known = _run(batches=[_batch(1, 100, 0.0, 0.1)], trace=trace)
    assert spec.metric_reader("device_idle.prefill").read(known) == pytest.approx(25.0)
    assert spec.metric_reader("flash_attention_roofline.prefill").read(known) is None  # no kernel time: nothing
    assert spec.metric_reader("mfu.prefill").read(known) == pytest.approx(
        100 * counts.prefill_flops(DENSE, 1, 100) / (2.0 * 989.4e12))
