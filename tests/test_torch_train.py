"""The port's LM training step on the CPU against the JAX package, on
reduced gemma-2b (float32; d_model 128, 4 query heads over 1 KV head,
head_dim 32, vocabulary 512) in the ``full``, ``local_global`` and
``chunked_global`` layer patterns (window 64, the reduced one).

Both sides start from the same state: the JAX package initialises it and
``convert.train_state_from_numpy`` carries it across; token batches are
numpy arrays made from a seed.  The JAX side runs its jitted ``train_step``
(plain attention, ``use_pallas=False``: its training path never reaches
Pallas), the port's side the same functions in PyTorch.

Tolerances: the schedule, the bias corrections and the token streams
exactly; losses within 1e-5 relative (measured at most 1.2e-7), grad-norms
within 1e-4 (measured at most 7.2e-7), parameters within 1e-4 absolute
after 3 steps (measured at most 2.9e-5: AdamW's first steps move every
weight by about the learning rate whatever the gradient's size).  The
moments are as small as the gradients (``nu`` peaks near 9e-5 here), so
each leaf of ``mu`` and ``nu`` is held within 1e-4 of its own largest
|value| (measured at most 8.4e-6 of it).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data import pipeline as JP
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import optimizers as JO
from repro_torch.configs import get_arch
from repro_torch.convert import model_params_from_numpy, train_state_from_numpy
from repro_torch.data import pipeline as P
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import optimizers as O

PATTERNS = {
    "full": {},
    "local_global": {"layer_pattern": "local_global", "window": 4096},
    "chunked_global": {"layer_pattern": "chunked_global", "window": 4096, "pattern_period": 3},
}
LOSS_RTOL, GNORM_ATOL, PARAM_ATOL, MOMENT_SCALED_TOL = 1e-5, 1e-4, 1e-4, 1e-4
SEQ = 128  # twice the reduced window: the window layers take _chunked_local_attention


def _cfgs(pattern):
    changes = PATTERNS[pattern]
    return (dataclasses.replace(jax_get_arch("gemma-2b"), **changes).reduced(),
            dataclasses.replace(get_arch("gemma-2b"), **changes).reduced())


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _assert_state_close(state, state_j, cfg, atol=PARAM_ATOL):
    """Every parameter and moment of the port's ``state`` against the JAX
    state's, carried across by the converter (a moment leaf within
    ``MOMENT_SCALED_TOL`` of its largest |value|); the step exactly."""
    tree = _numpy(state_j)
    want = train_state_from_numpy(cfg, tree.params, tree.opt, device="cpu")
    got_p, want_p = M.param_tree(state.params), M.param_tree(want.params)
    assert list(got_p) == list(want_p)
    for k in got_p:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k].numpy(), atol=atol, rtol=0, err_msg=k)
        for got_m, want_m in ((state.opt.mu, want.opt.mu), (state.opt.nu, want.opt.nu)):
            scale = float(want_m[k].abs().max())
            assert scale > 0, k
            np.testing.assert_allclose(got_m[k].numpy(), want_m[k].numpy(),
                                       atol=MOMENT_SCALED_TOL * scale, rtol=0, err_msg=k)
    assert state.opt.step.dtype == torch.int32 and int(state.opt.step) == int(tree.opt.step)


# -- the optimizer's schedule --------------------------------------------------------


@pytest.mark.parametrize("cfg", [O.AdamWConfig(warmup_steps=20, total_steps=300),
                                 O.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=30),
                                 O.AdamWConfig(),
                                 O.AdamWConfig(warmup_steps=30, total_steps=10)],
                         ids=["cli_300", "cli_30", "default", "warmup_past_total"])
def test_schedule_equals_jax_to_the_bit(cfg):
    """Steps 0 to total_steps + 5 (and past the warm-up where it is longer)."""
    cfg_j = JO.AdamWConfig(**dataclasses.asdict(cfg))
    steps = np.arange(max(cfg.total_steps, cfg.warmup_steps) + 6, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: JO._schedule(cfg_j, s)))(jnp.asarray(steps)))
    got = np.array([O._schedule(cfg, torch.tensor(s)).item() for s in steps], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert O._schedule(cfg, torch.tensor(7, dtype=torch.int32)).dtype == torch.float32


@pytest.mark.parametrize("b", [0.9, 0.95, 0.999])
def test_bias_corrections_equal_jax_to_the_bit(b):
    steps = np.arange(0, 20000, 7, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: 1.0 - b ** s.astype(jnp.float32))(jnp.asarray(steps)))
    table = torch.from_numpy(O.bias_table(b))
    got = np.array([O._lookup(table, torch.tensor(s)).item() for s in steps], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_global_norm_sums_in_the_jax_leaf_order():
    cfg_j, cfg = _cfgs("local_global")
    params = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    model = model_params_from_numpy(cfg, _numpy(params), device="cpu")
    tree = M.param_tree(model)
    # the first leaves: embed/embedding, final_norm, then unit/L0/ffn/w_down of each L0 layer
    assert list(tree)[:4] == ["embed.embedding", "final_norm.gamma", "layers.0.ffn.w_down",
                              "layers.2.ffn.w_down"]
    want = float(JO.global_norm(params))
    np.testing.assert_allclose(float(O.global_norm(tree)), want, rtol=1e-6)


# -- the token streams ---------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 16, 3, 0), (8192, 128, 4, 1), (4096, 33, 2, 7)])
def test_token_batches_equal_jax(vocab, seq, batch, seed):
    stream_j = JP.token_batches(JP.TokenStreamConfig(vocab, seq, batch, seed=seed))
    stream = P.token_batches(P.TokenStreamConfig(vocab, seq, batch, seed=seed), device="cpu")
    for _ in range(4):
        want, got = next(stream_j)["tokens"], next(stream)["tokens"]
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_federated_token_batches_equal_jax():
    cfg_j = JP.TokenStreamConfig(512, 24, 2, seed=3)
    streams_j = JP.federated_token_batches(cfg_j, 3)
    streams = P.federated_token_batches(P.TokenStreamConfig(512, 24, 2, seed=3), 3, device="cpu")
    assert len(streams) == 3
    for _ in range(3):
        for sj, st in zip(streams_j, streams):
            np.testing.assert_array_equal(next(st)["tokens"].numpy(), np.asarray(next(sj)["tokens"]))


# -- the loss ------------------------------------------------------------------------


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_loss_fn_equals_jax(pattern, monkeypatch):
    """The loss with the gradient path (layers and CE chunks under
    ``torch.utils.checkpoint``) and without it (``torch.no_grad``), against
    the JAX ``loss_fn``; the window layers take _chunked_local_attention."""
    cfg_j, cfg = _cfgs(pattern)
    params = JM.init_params(cfg_j, jax.random.PRNGKey(1))
    model = model_params_from_numpy(cfg, _numpy(params), device="cpu")
    tok = _tokens(2, (2, SEQ + 1))
    want = float(JM.loss_fn(cfg_j, params, {"tokens": jnp.asarray(tok)}))
    calls = []
    chunked = A._chunked_local_attention
    monkeypatch.setattr(A, "_chunked_local_attention", lambda *a: calls.append(a[-1]) or chunked(*a))
    for p in model.parameters():
        p.requires_grad_(True)
    with_grad = M.loss_fn(cfg, model, {"tokens": torch.tensor(tok)})
    assert with_grad.requires_grad
    with torch.no_grad():
        no_grad = M.loss_fn(cfg, model, {"tokens": torch.tensor(tok)})
    n_local = sum(layer.window is not None for layer in model.layers)
    assert calls == [cfg.window] * (2 * n_local)
    assert n_local == {"full": 0, "local_global": 2, "chunked_global": 4}[pattern]
    np.testing.assert_allclose(float(with_grad.detach()), want, rtol=LOSS_RTOL)
    assert float(no_grad) == float(with_grad.detach())


def test_loss_mask_and_chunks_past_512_equal_jax():
    """S = 1100: two whole 512-position CE chunks and a remainder, with a
    loss mask."""
    cfg_j, cfg = _cfgs("full")
    params = JM.init_params(cfg_j, jax.random.PRNGKey(2))
    model = model_params_from_numpy(cfg, _numpy(params), device="cpu")
    tok = _tokens(3, (2, 1101))
    mask = (np.random.default_rng(4).random((2, 1100)) < 0.7).astype(np.float32)
    want = float(JM.loss_fn(cfg_j, params, {"tokens": jnp.asarray(tok), "loss_mask": jnp.asarray(mask)}))
    with torch.no_grad():
        got = M.loss_fn(cfg, model, {"tokens": torch.tensor(tok), "loss_mask": torch.tensor(mask)})
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


def test_the_training_forward_never_calls_the_kernel_wrapper(monkeypatch):
    """``loss_fn`` runs the plain attention (``attention_ref``) on full
    layers, as the JAX training forward does; prefill runs the kernel's
    wrapper."""
    _, cfg = _cfgs("full")
    model = M.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu").params

    def refuse(*a, **k):
        raise AssertionError("the training forward reached ops.flash_attention")

    monkeypatch.setattr(A.ops, "flash_attention", refuse)
    M.loss_fn(cfg, model, {"tokens": torch.tensor(_tokens(5, (2, 17)))})
    with pytest.raises(AssertionError, match="reached ops.flash_attention"):
        M.prefill(model, {"tokens": torch.tensor(_tokens(5, (2, 16)))})


# -- the building blocks' gradients --------------------------------------------------


def _block(name):
    """(port function, JAX function, numpy inputs): each function maps its
    inputs to a float32 output whose weighted sum is differentiated."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 128), dtype=np.float32)
    if name == "rmsnorm":
        gamma = rng.standard_normal(128, dtype=np.float32) * 0.1
        return (lambda a, g: L.rmsnorm(a, g, 1e-6)), (lambda a, g: JL.rmsnorm(a, g, 1e-6)), [x, gamma]
    if name == "rope":
        h = rng.standard_normal((2, 5, 4, 32), dtype=np.float32)
        return (lambda a: L.rope(a, torch.arange(3, 8), 1e4)), (lambda a: JL.rope(a, jnp.arange(3, 8), 1e4)), [h]
    cfg_j, cfg = _cfgs("full")
    if name in ("geglu", "swiglu"):
        cfg, cfg_j = (dataclasses.replace(c, mlp_type=name) for c in (cfg, cfg_j))
        w = [rng.standard_normal(shape, dtype=np.float32) * 0.05 for shape in ((128, 256), (128, 256), (256, 128))]

        return (lambda a, g, u, d: L.apply_mlp(cfg, SimpleNamespace(w_gate=g, w_up=u, w_down=d), a)), (lambda a, g, u, d: JL.apply_mlp(cfg_j, {"w_gate": g, "w_up": u, "w_down": d}, a)), [x, *w]
    cfg, cfg_j = (dataclasses.replace(c, final_softcap=30.0) for c in (cfg, cfg_j))
    emb = rng.standard_normal((2048, 128), dtype=np.float32) * 0.1

    if name == "embed_tokens":
        tok = rng.integers(0, 512, (2, 7))
        return (lambda e: L.embed_tokens(cfg, SimpleNamespace(embedding=e), torch.from_numpy(tok))), \
            (lambda e: JL.embed_tokens(cfg_j, {"embedding": e}, jnp.asarray(tok))), [emb]
    return (lambda a, e: L.unembed(cfg, SimpleNamespace(embedding=e), a)), \
        (lambda a, e: JL.unembed(cfg_j, {"embedding": e}, a)), [x, emb]


@pytest.mark.parametrize("name", ["rmsnorm", "rope", "geglu", "swiglu", "embed_tokens", "unembed"])
def test_building_block_gradients_equal_jax(name):
    """``models/layers.py`` is differentiable as written: each block's
    gradients (every input) against ``jax.grad`` of the JAX block, for a
    random weighting of its output (float32 on both sides; atol 1e-5 plus
    rtol 1e-5: ``unembed``'s input gradient sums 2048 logits and reaches
    14, where float32 sums in another order differ by 1e-5)."""
    port, jax_fn, inputs = _block(name)
    out_shape = np.shape(jax_fn(*(jnp.asarray(a) for a in inputs)))
    weight = np.random.default_rng(6).standard_normal(out_shape, dtype=np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * weight), argnums=tuple(range(len(inputs))))(
        *(jnp.asarray(a) for a in inputs))
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    got = torch.autograd.grad(torch.sum(port(*ts) * torch.from_numpy(weight)), ts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


# -- the train step ------------------------------------------------------------------


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_three_train_steps_equal_jax(pattern):
    cfg_j, cfg = _cfgs(pattern)
    state_j = JM.init_train_state(cfg_j, jax.random.PRNGKey(0))
    tree = _numpy(state_j)
    state = train_state_from_numpy(cfg, tree.params, tree.opt, device="cpu")
    opt_j = JO.AdamWConfig(warmup_steps=2, total_steps=10)
    opt = O.AdamWConfig(warmup_steps=2, total_steps=10)
    step_j = jax.jit(lambda s, b: JM.train_step(cfg_j, s, b, opt_j))
    for i in range(3):
        tok = _tokens(10 + i, (2, SEQ + 1))
        state_j, m_j = step_j(state_j, {"tokens": jnp.asarray(tok)})
        state, m = M.train_step(cfg, state, {"tokens": torch.tensor(tok)}, opt)
        np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(m_j["grad_norm"]), atol=GNORM_ATOL)
    _assert_state_close(state, state_j, cfg)
    assert not any(p.requires_grad for p in state.params.parameters())


def test_accumulation_equals_jax_and_the_single_step():
    """``accum = 2`` against JAX's ``accum = 2``, and against the port's
    ``accum = 1`` at ``tests/test_perf_variants.py``'s tolerances (loss
    2e-4, parameters 5e-3: the micro-batches' sums round differently)."""
    cfg_j, cfg = _cfgs("full")
    state_j = JM.init_train_state(cfg_j, jax.random.PRNGKey(3))
    tree = _numpy(state_j)
    tok = _tokens(6, (4, 33))
    s2_j, m2_j = jax.jit(lambda s, b: JM.train_step(cfg_j, s, b, accum=2))(state_j, {"tokens": jnp.asarray(tok)})
    s1, m1 = M.train_step(cfg, train_state_from_numpy(cfg, tree.params, tree.opt, device="cpu"),
                          {"tokens": torch.tensor(tok)}, accum=1)
    s2, m2 = M.train_step(cfg, train_state_from_numpy(cfg, tree.params, tree.opt, device="cpu"),
                          {"tokens": torch.tensor(tok)}, accum=2)
    np.testing.assert_allclose(float(m2["loss"]), float(m2_j["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m2_j["grad_norm"]), atol=GNORM_ATOL)
    _assert_state_close(s2, s2_j, cfg)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-4
    p1, p2 = M.param_tree(s1.params), M.param_tree(s2.params)
    assert max(float((p1[k] - p2[k]).abs().max()) for k in p1) < 5e-3


def test_bf16_train_step_keeps_the_parameter_dtype():
    cfg = dataclasses.replace(get_arch("gemma-2b").reduced(), dtype="bfloat16")
    state = M.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = {k: p.clone() for k, p in M.param_tree(state.params).items()}
    state, m = M.train_step(cfg, state, {"tokens": torch.tensor(_tokens(7, (2, 33)))})
    after = M.param_tree(state.params)
    assert all(after[k].dtype == before[k].dtype for k in after)  # the norms' gammas are float32
    assert after["embed.embedding"].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in state.opt.mu.values())
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert any(not torch.equal(before[k], after[k]) for k in after)


# -- the driver ----------------------------------------------------------------------


def test_train_cli_lm10m_on_the_cpu_loss_falls(capsys):
    """30 steps at sequence 64, on one CPU thread: the suite's parallel
    workers share the cores, and many threads a worker slowed this test
    fifty-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses = train_cli.main(["--preset", "lm10m", "--device", "cpu", "--steps", "30", "--seq", "64"])
    finally:
        torch.set_num_threads(threads)
    assert len(losses) == 30 and losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "arch=lm10m params=6.0M vocab=4096" in out and "final loss" in out


def test_train_step_and_pattern_refuse_what_does_not_divide():
    _, cfg = _cfgs("full")
    state = M.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="does not split into 3 micro-batches"):
        M.train_step(cfg, state, {"tokens": torch.tensor(_tokens(8, (4, 17)))}, accum=3)
    odd = dataclasses.replace(get_arch("gemma-2b"), layer_pattern="local_global", n_layers=3)
    with pytest.raises(ValueError, match="do not repeat a unit of 2"):
        odd.pattern()
