"""The port's recurrent mixers (``repro_torch/models/ssm.py``: Mamba, mLSTM,
sLSTM) and the models built of them on the CPU against the JAX package:
reduced xlstm-1.3b (7 mLSTM blocks and an sLSTM block, float32, d_model
128) and a reduced Mamba hybrid (gemma-2b with jamba's layout through
``dataclasses.replace``, as the JAX tests reach it: 7 Mamba layers around
one attention layer, ``d_state`` 8).

Both sides compute from the same weights (the JAX package initialises
them, ``convert`` carries them across), the same numpy inputs and, for
decode, the same state (``convert.caches_from_numpy`` of a JAX prefill's).

Tolerances, float32 on both sides:
* a mixer's outputs and final states: 1e-5 relative to the largest
  magnitude of the JAX value (measured at most ~2e-7).  Mamba's chunk scan
  is a doubling scan here and XLA's tree there, so its products round in
  another order; torch's ``softplus`` returns ``x`` past 20 where JAX's
  returns ``log1p(exp(x))``, which differ by under an ulp;
* logits: 1e-4 absolute (``tests/test_torch_window.py``'s) for the hybrid;
  4e-4 for xlstm, about twice the JAX package's own float32 error there:
  its float32 prefill logits are 2.4e-4 from a float64 evaluation of the
  same model and weights, the port's 8.3e-5 (measured at this file's
  weights and tokens), so the two float32 sides differ by up to about
  1.6e-4.  The mLSTM's input gate reaches exp(8) inside a 128-token
  chunk, and its sums lose ~3e-6 relative a layer whichever order they
  add in;
* decode against a cache-free forward: the JAX test's ``atol=5e-4,
  rtol=5e-3`` (``tests/test_models_smoke.py::test_decode_matches_forward``);
* a prefill's states: the first layer's within 1e-5 relative, as a
  mixer's; every layer's within 3e-4 relative, which carries the earlier
  layers' float32 differences (measured up to 9.6e-5 at xlstm's seventh
  layer, ~1e-6 in the hybrid);
* three train steps (``tests/test_torch_ssm_train.py``, with decode against
  a forward): the loss 1e-5 relative and every parameter 1e-4
  absolute (``tests/test_torch_train.py``'s); the grad norm 1e-4 in the
  hybrid, 2e-3 in xlstm's first step (a norm of ~62: the JAX package's
  float32 value is 5.0e-4 from a float64 evaluation, the port's 4.2e-4 on
  the other side, so they differ by 9.2e-4); xlstm's later steps to
  ``XLSTM_LATER`` (:func:`test_three_train_steps_equal_jax` says why);
* the first step's AdamW moments, leaf by leaf (each a gradient's image:
  ``mu`` is ``0.1 g`` and ``nu`` ``0.001 g²`` after the clip), within
  ``MOMENT_SCALED_TOL`` of that leaf's largest |value|: the hybrid at
  ``tests/test_torch_train.py``'s 1e-4 (measured at most 9.1e-6); xlstm
  at 1.2e-3, twice the largest spread measured in float32 (the port
  against the JAX package 3.0e-4 on ``mu``, 6.0e-4 on ``nu``; the JAX
  package against itself from weights perturbed by 1e-7 relative 4.4e-4
  and 5.5e-4).  A leaf whose gradient is dropped reads 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.convert import caches_from_numpy, model_params_from_numpy
from repro_torch.launch import serve, train
from repro_torch.models import model as M
from repro_torch.models import ssm

MIXER_RTOL, STATE_RTOL = 1e-5, 3e-4
LOGIT_ATOL = {"hybrid": 1e-4, "xlstm": 4e-4}
GNORM_ATOL = {"hybrid": 1e-4, "xlstm": 2e-3}
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
# xlstm's train steps 2-3 (test_three_train_steps_equal_jax)
XLSTM_LATER = {"loss_rtol": 5e-4, "gnorm_rtol": 0.2, "param_atol": 2e-3}
MOMENT_SCALED_TOL = {"hybrid": 1e-4, "xlstm": 1.2e-3}
# jamba's layout on gemma-2b: one attention layer at position 4 of 8
HYBRID = {"arch_type": "hybrid", "layer_pattern": "mamba_attn", "pattern_period": 8, "attn_index": 4,
          "n_layers": 8}
MODELS = ["xlstm", "hybrid"]
B = 2


def _cfgs(name):
    if name == "xlstm":
        return jax_get_arch("xlstm-1.3b").reduced(), get_arch("xlstm-1.3b").reduced()
    return (dataclasses.replace(jax_get_arch("gemma-2b"), **HYBRID).reduced(),
            dataclasses.replace(get_arch("gemma-2b"), **HYBRID).reduced())


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=0)


# -- the mixers on their own --------------------------------------------------------------

MIXERS = {
    # name: (JAX init, port module, JAX forward(cfg, p, x, state), port forward, state fields)
    "mamba": (jssm.init_mamba, ssm.Mamba,
              lambda c, p, x, s: jssm.mamba_prefill(c, p, x) if s is None else jssm.mamba_decode(c, p, x, s),
              lambda c, p, x, s: ssm.mamba_prefill(c, p, x) if s is None else ssm.mamba_decode(c, p, x, s),
              jssm.MambaState),
    "mlstm": (jssm.init_mlstm, ssm.MLSTM, jssm.apply_mlstm, ssm.apply_mlstm, jssm.MLSTMState),
    "slstm": (jssm.init_slstm, ssm.SLSTM, jssm.apply_slstm, ssm.apply_slstm, jssm.SLSTMState),
}
ZERO_INIT = ("dt_bias", "b_if", "b")  # drawn anew so that the tests see them


def _mixer_pair(name, cfg_j, cfg, seed):
    init_j, cls = MIXERS[name][:2]
    p, _ = init_j(cfg_j, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    p = {k: (jnp.asarray(0.1 * rng.standard_normal(v.shape, dtype=np.float32)) if k in ZERO_INIT else v)
         for k, v in p.items()}
    m = cls(cfg, torch.Generator().manual_seed(0))
    assert sorted(n for n, _ in m.named_parameters()) == sorted(p)
    for k, v in p.items():
        getattr(m, k).data.copy_(torch.from_numpy(np.array(v)))
    return p, m


def _random_state(name, cfg_j, seed):
    """A JAX state of the mixer's shapes, filled from a seed (the sLSTM's
    normaliser positive, as the recurrence keeps it)."""
    rng = np.random.default_rng(seed)
    zero = {"mamba": lambda: jssm.init_mamba_state(cfg_j, B, jnp.float32),
            "mlstm": lambda: jssm.init_mlstm_state(cfg_j, B),
            "slstm": lambda: jssm.init_slstm_state(cfg_j, B)}[name]()
    leaves = {f: 0.3 * rng.standard_normal(np.shape(v)).astype(np.float32) for f, v in zero._asdict().items()}
    if name == "slstm":
        leaves["n"] = np.abs(leaves["n"]) + 1.0
    return type(zero)(**{f: jnp.asarray(v) for f, v in leaves.items()})


@pytest.mark.parametrize("S,with_state", [(256, False), (256, True), (1, True), (1, False)],
                         ids=["S256", "S256_from_state", "S1_decode", "S1_from_zero"])
@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_matches_jax(name, S, with_state):
    """One mixer's output and final state against the JAX package's, from
    zeros or from a given state, at two chunks (S = 256) and at a decode
    step (S = 1)."""
    cfg_j, cfg = _cfgs("hybrid" if name == "mamba" else "xlstm")
    p, m = _mixer_pair(name, cfg_j, cfg, seed=3)
    x = np.random.default_rng(4).standard_normal((B, S, cfg.d_model), dtype=np.float32)
    st_j = _random_state(name, cfg_j, 5) if with_state else None
    fwd_j, fwd = MIXERS[name][2], MIXERS[name][3]
    want, want_state = jax.jit(lambda p, x, s: fwd_j(cfg_j, p, x, s))(p, jnp.asarray(x), st_j)
    st = None if st_j is None else getattr(ssm, type(st_j).__name__)(*(torch.from_numpy(np.asarray(a)) for a in st_j))
    got, got_state = fwd(cfg, m, torch.from_numpy(x), st)
    assert type(got_state).__name__ == type(want_state).__name__
    assert got_state._fields == want_state._fields
    errs = {"out": _rel(got, want)}
    for f in want_state._fields:
        errs[f] = _rel(getattr(got_state, f), getattr(want_state, f))
        assert getattr(got_state, f).dtype == torch.float32, f
    assert max(errs.values()) <= MIXER_RTOL, errs


@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_parameters_keep_the_jax_names_and_dtypes_in_bf16(name):
    """Under a bf16 config the gates' and the recurrences' parameters stay
    float32, as the JAX package's do."""
    cfg_j, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs("hybrid" if name == "mamba" else "xlstm"))
    p, _ = MIXERS[name][0](cfg_j, jax.random.PRNGKey(0))
    m = MIXERS[name][1](cfg, torch.Generator().manual_seed(0))
    got = {n: (str(t.dtype).replace("torch.", ""), tuple(t.shape)) for n, t in m.named_parameters()}
    assert got == {k: (str(v.dtype), tuple(v.shape)) for k, v in p.items()}
    assert any(dt == "float32" for dt, _ in got.values()) and any(dt == "bfloat16" for dt, _ in got.values())


def test_doubling_scan_equals_the_sequential_recurrence():
    g = torch.Generator().manual_seed(0)
    a, b = torch.rand(3, 37, 5, generator=g), torch.randn(3, 37, 5, generator=g)
    prods, hs = ssm._doubling_scan(a, b, dim=1)
    h, p = torch.zeros(3, 5), torch.ones(3, 5)
    for t in range(37):
        h, p = a[:, t] * h + b[:, t], p * a[:, t]
        torch.testing.assert_close(hs[:, t], h, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(prods[:, t], p, rtol=1e-5, atol=1e-7)


def test_mlstm_head_dim_is_d_inner_over_heads_and_slstm_starts_at_minus_30():
    """``cfg.head_dim`` (32 in ``reduced()``) is not the mLSTM's: 2·128 / 4."""
    _, cfg = _cfgs("xlstm")
    assert cfg.head_dim == 32
    assert tuple(ssm.MLSTM(cfg, torch.Generator()).wq.shape) == (256, 4, 64)
    st = ssm.init_slstm_state(cfg, 2, "cpu")
    assert tuple(st.m.shape) == (2, 4, 32) and bool((st.m == -30.0).all()) and not bool(st.h.any())


def test_masked_decay_keeps_the_mlstm_backward_finite():
    """The decay matrix is masked with -inf before its exp: the gradient
    through a chunk has no NaN (``inf · 0``) even where the gates are large."""
    _, cfg = _cfgs("xlstm")
    m = ssm.MLSTM(cfg, torch.Generator().manual_seed(1))
    m.b_if.data.fill_(20.0)  # a forget gate near 1: F_t - F_s near 0 everywhere
    x = torch.randn(1, 128, cfg.d_model, generator=torch.Generator().manual_seed(2)).requires_grad_()
    for p in m.parameters():
        p.requires_grad_(True)
    out, _ = ssm.apply_mlstm(cfg, m, x)
    out.sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in [x, *m.parameters()])


# -- the models: config, prefill, decode, training ----------------------------------------


def test_xlstm_config_equals_the_jax_package():
    cfg_j, cfg = jax_get_arch("xlstm-1.3b"), get_arch("xlstm-1.3b")
    mine = dataclasses.asdict(cfg)
    theirs = dataclasses.asdict(cfg_j)
    assert {k: theirs[k] for k in mine} == mine
    assert [(d.mixer, d.ffn) for d in cfg.pattern()[0]] == [(d.mixer, d.ffn) for d in cfg_j.pattern()[0]]
    assert cfg.pattern()[1] == cfg_j.pattern()[1] == 6
    assert [d.mixer for d in cfg.pattern()[0]] == ["mlstm"] * 7 + ["slstm"]
    red, red_j = cfg.reduced(), cfg_j.reduced()
    assert {k: dataclasses.asdict(red_j)[k] for k in dataclasses.asdict(red)} == dataclasses.asdict(red)
    assert red.n_layers == 8 and red.d_state == 8


def test_hybrid_pattern_equals_the_jax_package():
    cfg_j, cfg = (dataclasses.replace(c, **HYBRID) for c in (jax_get_arch("gemma-2b"), get_arch("gemma-2b")))
    assert [(d.mixer, d.ffn) for d in cfg.pattern()[0]] == [(d.mixer, d.ffn) for d in cfg_j.pattern()[0]]
    assert [d.mixer for d in cfg.pattern()[0]] == ["mamba"] * 4 + ["attn_full"] + ["mamba"] * 3
    assert cfg.pattern()[1] == 1 and cfg.d_state == 16 and cfg.d_conv == 4 and cfg.ssm_expand == 2


@pytest.fixture(scope="module")
def models():
    """{name: (JAX config, JAX params, port config, port model)}, shared:
    no test changes the weights."""
    out = {}
    for name, seed in (("xlstm", 0), ("hybrid", 1)):
        cfg_j, cfg = _cfgs(name)
        params = JM.init_params(cfg_j, jax.random.PRNGKey(seed))
        out[name] = (cfg_j, params, cfg, model_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                                                 device="cpu"))
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    """Each model's JAX prefill of a 2 x 256 prompt (two chunks) and 8
    teacher-forced decode steps after it: (tokens, prefill logits, the
    prefill's state as numpy, each step's logits)."""
    out = {}
    for name, (cfg_j, params, _, _) in models.items():
        tok = _tokens(7, (B, 264))
        logits, state = jax.jit(lambda p, t: JM.prefill(cfg_j, p, {"tokens": t}, cache_len=264))(
            params, jnp.asarray(tok[:, :256]))
        caches = jax.tree.map(np.asarray, state.caches)
        step = jax.jit(lambda p, s, t: JM.serve_step(cfg_j, p, s, t))
        steps = []
        for s in range(256, 264):
            lj, state = step(params, state, jnp.asarray(tok[:, s:s + 1]))
            steps.append(np.asarray(lj))
        out[name] = (tok, np.asarray(logits), caches, steps)
    return out


@pytest.mark.parametrize("name", MODELS)
def test_prefill_logits_match_jax(name, models, jax_runs):
    _, _, cfg, model = models[name]
    tok, want, _, _ = jax_runs[name]
    got, st = M.prefill(model, {"tokens": torch.from_numpy(tok[:, :256])}, cache_len=264)
    _close(got, want, LOGIT_ATOL[name])
    kinds = [layer.kind for layer in model.layers]
    assert [type(c).__name__ for c in st.caches] == [
        {"mamba": "MambaState", "mlstm": "MLSTMState", "slstm": "SLSTMState"}.get(k, "LayerCache") for k in kinds]


@pytest.mark.parametrize("name", MODELS)
def test_prefill_state_and_decode_from_the_jax_state_match_jax(name, models, jax_runs):
    """The port's prefill state equals the JAX prefill's (the first
    layer's within ``MIXER_RTOL`` a leaf, every layer's within
    ``STATE_RTOL``), and 8 decode steps started from the converted JAX
    state give the JAX steps' logits."""
    cfg_j, _, cfg, model = models[name]
    tok, _, caches, steps = jax_runs[name]
    _, st = M.prefill(model, {"tokens": torch.from_numpy(tok[:, :256])}, cache_len=264)
    converted = caches_from_numpy(cfg, caches, device="cpu")
    for r, (mine, theirs) in enumerate(zip(st.caches, converted)):
        assert type(mine) is type(theirs) and mine._fields == theirs._fields
        for f in mine._fields:
            tol = MIXER_RTOL if r == 0 else STATE_RTOL
            assert _rel(getattr(mine, f), getattr(theirs, f).numpy()) <= tol, (r, f)
    state = M.ServeState(converted, 256)
    for i, s in enumerate(range(256, 264)):
        logits, state = M.serve_step(model, state, torch.from_numpy(tok[:, s:s + 1]))
        _close(logits, steps[i], LOGIT_ATOL[name])
    assert state.pos == 264


@pytest.mark.parametrize("name", MODELS)
def test_param_tree_is_the_jax_leaf_order_with_the_recurrent_leaves(name, models):
    """``param_tree`` (the order the global norm sums in) walks the JAX
    params' leaves in order; a layer without an FFN has no ``norm2``."""
    _, params, cfg, model = models[name]
    tree = M.param_tree(model)
    period = len(cfg.pattern()[0])
    expected = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        if keys[0] == "unit":
            names = [f"layers.{r}." + ".".join(keys[2:]) for r in range(int(keys[1][1:]), cfg.n_layers, period)]
        else:
            names = [".".join(keys)]
        names = [n + ".gamma" if n + ".gamma" in tree else n for n in names]
        got = np.stack([tree[n].numpy() for n in names]) if keys[0] == "unit" else tree[names[0]].numpy()
        np.testing.assert_array_equal(got, np.asarray(leaf), err_msg=str(keys))
        expected += names
    assert list(tree) == expected
    mixer_leaves = {"xlstm": ["b_if", "down_proj", "up_proj", "w_if", "wk", "wq", "wv"],
                    "hybrid": ["A_log", "D", "conv_w", "dt_bias", "dt_proj", "in_proj", "out_proj", "x_proj"]}
    assert [n[len("layers.0.mixer."):] for n in expected if n.startswith("layers.0.mixer.")] == mixer_leaves[name]
    assert ("layers.0.norm2.gamma" in tree) == (name == "hybrid")


# -- the chunk rule ---------------------------------------------------------------------


@pytest.mark.parametrize("S", [200, 129])
def test_a_sequence_that_breaks_the_chunk_rule_raises(S, models):
    _, _, cfg, model = models["xlstm"]
    tok = torch.from_numpy(_tokens(9, (1, S)))
    with pytest.raises(ValueError, match="chunk rule"):
        M.prefill(model, {"tokens": tok})
    _, _, cfg_h, hybrid = models["hybrid"]
    with pytest.raises(ValueError, match="chunk rule"):
        hybrid(tok)
    for ok in (1, 100, 128, 384):
        assert ssm.chunk_len(ok) == min(128, ok)


def test_the_launchers_refuse_a_prompt_that_breaks_the_chunk_rule():
    with pytest.raises(ValueError, match="chunk rule"):
        serve.main(["--arch", "xlstm-1.3b", "--prompt-len", "200", "--device", "cpu"])
    with pytest.raises(ValueError, match="chunk rule"):
        train.main(["--arch", "xlstm-1.3b", "--seq", "300", "--steps", "1", "--device", "cpu"])
    ssm.check_chunk_rule(get_arch("gemma-2b"), 200)  # no recurrent layer: no rule


def test_serve_runs_reduced_xlstm_on_the_cpu(capsys):
    out = serve.main(["--arch", "xlstm-1.3b", "--batch", "2", "--prompt-len", "256", "--tokens", "4",
                      "--device", "cpu"])
    assert out["tokens"].shape == (2, 5) and out["logits_finite"]
    assert "arch=xlstm-1.3b prefill 2x256 in" in capsys.readouterr().out
