"""The port's MoE layers (``repro_torch/models/moe.py``) and the MoE
architectures (grok-1-314b: 8 experts top-2, ``geglu`` config, logit
softcap 30; llama4-scout-17b-a16e: 16 experts top-1, chunked-local layers
with a NoPE global layer every 4th) on the CPU against the JAX package, at
their ``reduced()`` sizes (float32, d_model 128, 4 experts).

Both sides compute from the same weights (the JAX package initialises
them, ``convert`` carries them across) and the same numpy inputs.
``reduced()`` is drop-free (capacity factor 2·E), so every case that
matters is also run at the published ``capacity_factor=1.25`` with a
router skewed toward expert 0: its router column leans along a direction
every token's hidden state shares (an offset added to the inputs, or to
every embedding row), so most tokens rank expert 0 first; the test checks
that tokens really were dropped there.

Tolerances, float32 on both sides: 2e-5 absolute on MoE outputs (measured
at most 1.9e-6), 1e-5 relative on the aux loss, 1e-4 absolute on logits
(``tests/test_torch_window.py``'s); the loss, grad-norm and parameters
after a step at ``tests/test_torch_train.py``'s (loss 1e-5 relative,
grad-norm 1e-4, parameters 1e-4 absolute).  The prefill-and-decode and
train-step checks are in ``tests/test_torch_moe_model.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch.configs import get_arch
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.layers import unembed

ARCHS = ["grok-1-314b", "llama4-scout-17b-a16e"]
CAPACITY = {"drop_free": None, "cf_1.25_skewed": 1.25}
MOE_ATOL, AUX_RTOL, LOGIT_ATOL = 2e-5, 1e-5, 1e-4
LOSS_RTOL, GNORM_ATOL, PARAM_ATOL = 1e-5, 1e-4, 1e-4
SKEW = 0.02  # added to expert 0's router column, along the shared offset
X_OFFSET, EMBED_OFFSET = 1.0, 0.09  # the offset of apply_moe's inputs, of every embedding row


def _cfgs(name, cf=None):
    cfg_j, cfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    if cf is not None:
        cfg_j, cfg = (dataclasses.replace(c, capacity_factor=cf) for c in (cfg_j, cfg))
    return cfg_j, cfg


def _skew(params, layer_key=None):
    """Expert 0's router column raised by ``SKEW`` in one layer's MoE
    params, or (``layer_key``) in every MoE layer of a model's params, whose
    embedding rows then all get ``EMBED_OFFSET``."""
    if layer_key is None:
        return {**params, "router": params["router"].at[:, 0].add(SKEW)}
    unit = {k: {**v, "ffn": {**v["ffn"], "router": v["ffn"]["router"].at[..., 0].add(SKEW)}}
            for k, v in params["unit"].items()}
    embed = {**params["embed"], "embedding": params["embed"]["embedding"] + EMBED_OFFSET}
    return {**params, "embed": embed, "unit": unit}


@pytest.fixture
def drops(monkeypatch):
    """Counts the (token, choice) pairs every ``apply_moe`` call drops."""
    seen = []
    apply = moe.apply_moe

    def counting(cfg, p, x):
        seen.append(_dropped(cfg, p, x))
        return apply(cfg, p, x)

    monkeypatch.setattr(moe, "apply_moe", counting)
    return seen


def _moe_module(cfg, p):
    m = moe.MoE(cfg, torch.Generator().manual_seed(0))
    for k in ("router", "w_gate", "w_up", "w_down"):
        getattr(m, k).data.copy_(torch.from_numpy(np.array(p[k])))
    return m


def _dropped(cfg, m, x) -> int:
    """(token, choice) pairs past their expert's capacity, from the port's
    router (the JAX package's makes the same choices: the outputs agree)."""
    B, S, d = x.shape
    _, ids, _ = moe.route(cfg, m, x.reshape(1, B * S, d))
    counts = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
    return int(torch.clamp_min(counts - moe.capacity(cfg, B * S), 0).sum())


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=0)


# -- apply_moe ------------------------------------------------------------------------


@pytest.mark.parametrize("cap", list(CAPACITY))
@pytest.mark.parametrize("name", ARCHS)
def test_apply_moe_matches_jax(name, cap):
    cfg_j, cfg = _cfgs(name, CAPACITY[cap])
    p, _ = jmoe.init_moe(cfg_j, jax.random.PRNGKey(1))
    if CAPACITY[cap]:
        p = _skew(p)
    x = np.random.default_rng(2).standard_normal((4, 16, cfg.d_model), dtype=np.float32)
    if CAPACITY[cap]:
        x += X_OFFSET
    want, aux_j = jmoe.apply_moe(cfg_j, p, jnp.asarray(x))
    m = _moe_module(cfg, p)
    got, aux = moe.apply_moe(cfg, m, torch.from_numpy(x))
    _close(got, want, MOE_ATOL)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=AUX_RTOL)
    assert aux.dtype == torch.float32 and got.dtype == torch.float32
    dropped = _dropped(cfg, m, torch.from_numpy(x))
    assert (dropped > 0) == (CAPACITY[cap] is not None), dropped
    if dropped:
        assert moe.capacity(cfg, 64) == {"grok-1-314b": 40, "llama4-scout-17b-a16e": 20}[name]


@pytest.mark.parametrize("name", ARCHS)
def test_grouped_dispatch_matches_global_and_jax(name):
    """``set_dispatch_groups(2)`` against G = 1 (``tests/test_perf_variants.py
    ::test_moe_grouped_dispatch_matches_global``'s tolerances) and against
    the JAX package's G = 2."""
    cfg_j, cfg = _cfgs(name)
    p, _ = jmoe.init_moe(cfg_j, jax.random.PRNGKey(1))
    x = np.random.default_rng(3).standard_normal((4, 16, cfg.d_model), dtype=np.float32)
    m = _moe_module(cfg, p)
    try:
        moe.set_dispatch_groups(1)
        a, aux_a = moe.apply_moe(cfg, m, torch.from_numpy(x))
        moe.set_dispatch_groups(2)
        b, aux_b = moe.apply_moe(cfg, m, torch.from_numpy(x))
        jmoe.set_dispatch_groups(2)
        want, aux_j = jmoe.apply_moe(cfg_j, p, jnp.asarray(x))
    finally:
        moe.set_dispatch_groups(1)
        jmoe.set_dispatch_groups(1)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert abs(float(aux_a) - float(aux_b)) < 1e-5
    _close(b, want, MOE_ATOL)
    np.testing.assert_allclose(float(aux_b), float(aux_j), rtol=AUX_RTOL)


def test_geglu_config_experts_still_run_silu():
    """grok-1's config says ``geglu``; its experts compute silu GLUs all
    the same, in both packages."""
    cfg_j, cfg = _cfgs("grok-1-314b")
    assert cfg.mlp_type == "geglu"
    p, _ = jmoe.init_moe(cfg_j, jax.random.PRNGKey(4))
    m = _moe_module(cfg, p)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 8, cfg.d_model), dtype=np.float32))
    got, _ = moe.apply_moe(cfg, m, x)
    _, ids, gates = moe.route(cfg, m, x.reshape(1, 8, -1))
    xs = x[0]

    def expert(e, act):
        return (act(xs @ m.w_gate[e]) * (xs @ m.w_up[e])) @ m.w_down[e]

    for act, equal in ((torch.nn.functional.silu, True),
                       (lambda h: torch.nn.functional.gelu(h, approximate="tanh"), False)):
        want = torch.zeros_like(xs)
        for t in range(8):
            for j in range(cfg.experts_per_token):
                want[t] += gates[0, t, j] * expert(int(ids[0, t, j]), act)[t]
        assert torch.allclose(got[0], want, atol=1e-5) == equal


def test_top_k_ties_pick_the_lower_index_as_jax_does():
    """Equal probabilities (a zero router) and repeated values: the choices
    are ``jax.lax.top_k``'s, the lower index first."""
    _, cfg = _cfgs("grok-1-314b")
    m = moe.MoE(cfg, torch.Generator().manual_seed(0))
    m.router.data.zero_()
    x = torch.randn(1, 5, cfg.d_model, generator=torch.Generator().manual_seed(1))
    probs, ids, gates = moe.route(cfg, m, x)
    assert ids.tolist() == [[[0, 1]] * 5]
    torch.testing.assert_close(gates, torch.full((1, 5, 2), 0.5))
    row = np.array([[0.1, 0.4, 0.4, 0.1]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(row), 2)
    m.router.data = torch.eye(cfg.d_model, 4)
    xr = torch.zeros(1, 1, cfg.d_model)
    xr[0, 0, :4] = torch.log(torch.from_numpy(row[0]))
    _, ids, _ = moe.route(cfg, m, xr)
    assert ids[0, 0].tolist() == np.asarray(want_i)[0].tolist() == [1, 2]


@pytest.mark.parametrize("name,n,cap", [("grok-1-314b", 8192, 2560), ("llama4-scout-17b-a16e", 16384, 1280),
                                        ("llama4-scout-17b-a16e", 1024, 80), ("grok-1-314b", 1, 2),
                                        ("llama4-scout-17b-a16e", 3, 3)])
def test_capacity_at_the_cards_shapes(name, n, cap):
    """``ceil(n·k/E)·1.25`` truncated, at least ``min(n·k, 8)``: the
    prefills' 2 560 and 1 280 slots, the train step's 80, decode's floor."""
    assert moe.capacity(get_arch(name), n) == cap


# -- the model: prefill, decode, NoPE layers -------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(name, cf=None, seed=0):
    """(JAX config, JAX params, port config, port model) from one JAX
    initialisation; cached, and no test changes the weights."""
    cfg_j, cfg = _cfgs(name, cf)
    params = JM.init_params(cfg_j, jax.random.PRNGKey(seed))
    if cf is not None:
        params = _skew(params, layer_key=True)
    return cfg_j, params, cfg, model_params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")


def test_llama4_layers_are_three_window_layers_then_a_nope_global_one():
    _, _, cfg, model = _pair("llama4-scout-17b-a16e")
    assert [(layer.window, layer.use_rope, layer.moe) for layer in model.layers] == \
        [(64, True, True)] * 3 + [(None, False, True)] + [(64, True, True)] * 3 + [(None, False, True)]
    grok = _pair("grok-1-314b")[3]
    assert [(layer.window, layer.use_rope, layer.moe) for layer in grok.layers] == [(None, True, True)] * 2


def test_nope_global_layer_matches_jax_and_differs_from_rope():
    """The llama4 global layer's attention against the JAX layer's (no
    RoPE), and not equal to the same weights with RoPE applied."""
    from repro.models import attention as JA
    from repro_torch.models import attention as A

    cfg_j, params, cfg, model = _pair("llama4-scout-17b-a16e")
    layer = model.layers[3]
    p3 = jax.tree.map(lambda a: a[0], params["unit"]["L3"]["mixer"])
    x = np.random.default_rng(6).standard_normal((2, 48, 128), dtype=np.float32)
    want, _ = JA.attend_full(cfg_j, p3, jnp.asarray(x), jnp.arange(48), use_rope=False)
    got, _ = A.attend_full(cfg, layer.mixer, torch.from_numpy(x), torch.arange(48), use_rope=layer.use_rope)
    _close(got, want, LOGIT_ATOL)
    roped, _ = A.attend_full(cfg, layer.mixer, torch.from_numpy(x), torch.arange(48), use_rope=True)
    assert float((roped - got).abs().max()) > 1e-3


@pytest.mark.parametrize("name", ARCHS)
def test_decode_equals_a_cache_free_forward(name):
    """Drop-free (``reduced()``): each decode step's logits equal the port's
    own forward over the sequence so far, past llama4's window ring."""
    _, _, cfg, model = _pair(name)
    tok = torch.from_numpy(_tokens(8, (2, 160)))
    _, st = M.prefill(model, {"tokens": tok[:, :128]}, cache_len=160)
    for s in range(128, 160):
        got, st = M.serve_step(model, st, tok[:, s:s + 1])
        if s in (128, 140, 159):
            with torch.no_grad():
                want = unembed(cfg, model.embed, model(tok[:, :s + 1])[:, -1:])[:, 0]
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4, rtol=5e-3)


# -- training: the aux loss in loss_fn, one train step ---------------------------------


@pytest.mark.parametrize("cap", list(CAPACITY))
@pytest.mark.parametrize("name", ARCHS)
def test_loss_fn_with_aux_equals_jax(name, cap, drops):
    cfg_j, params, cfg, model = _pair(name, CAPACITY[cap], seed=1)
    tok = _tokens(9, (2, 129))
    want = float(JM.loss_fn(cfg_j, params, {"tokens": jnp.asarray(tok)}))
    _, aux_j, _ = JM.forward(cfg_j, params, jnp.asarray(tok[:, :-1]))
    with torch.no_grad():
        got = M.loss_fn(cfg, model, {"tokens": torch.from_numpy(tok)})
        _, aux = model(torch.from_numpy(tok[:, :-1]), plain_attention=True, return_aux=True)
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=AUX_RTOL)
    assert float(aux) > 0.5 * cfg.n_layers  # each MoE layer's aux is near 1 or above
    assert (sum(drops) > 0) == (CAPACITY[cap] is not None), drops


def test_param_tree_is_the_jax_leaf_order_with_the_moe_leaves():
    """``param_tree`` (the order the global norm sums in) walks the JAX
    params' leaves in order, each unit leaf's layers in turn, the MoE
    leaves (``router``, ``w_down``, ``w_gate``, ``w_up``) included."""
    cfg_j, params, cfg, model = _pair("llama4-scout-17b-a16e")
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
    assert [n for n in expected if n.startswith("layers.0.ffn")] == \
        ["layers.0.ffn.router", "layers.0.ffn.w_down", "layers.0.ffn.w_gate", "layers.0.ffn.w_up"]


def test_with_layers_cuts_the_depth_and_keeps_the_unit_positions():
    cfg = get_arch("llama4-scout-17b-a16e")
    one = cfg.with_layers(1)
    assert one.n_layers == 1 and one.pattern()[1] == 1
    assert [d.mixer for d in one.pattern()[0]][:1] == ["attn_local"]
    grok = get_arch("grok-1-314b").with_layers(4)
    assert grok.pattern() == (get_arch("grok-1-314b").pattern()[0], 4)
    with pytest.raises(ValueError, match="at least one layer"):
        cfg.with_layers(0)
    with pytest.raises(ValueError, match="do not repeat a unit of 4"):
        dataclasses.replace(cfg, n_layers=6).pattern()
