"""The port's LLM serving path on the CPU against the JAX package, on
reduced gemma-2b (2 layers, d_model 128, 4 query heads over 1 KV head,
head_dim 32, float32).  Both sides compute from the same weights: the JAX
package initialises them and ``convert.model_params_from_numpy`` carries
them across; tokens and activations are numpy arrays made from a seed.

On the JAX side the model runs through its plain attention reference
(``use_pallas=False``), and once through the Pallas kernel in interpret
mode; on the port's side CPU tensors take the plain version of
``flash_attention``.  Tolerances, float32 on both sides: atol 1e-5 on a
building block's output, 1e-4 on hidden states and logits (two layers of
reordered float32 sums), identical greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.transformer import forward as jax_forward
from repro_torch.configs import get_arch
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.transformer import Transformer

ATOL = 1e-4  # hidden states and logits
B, S = 2, 16


def _pair(**changes):
    cfg_j = dataclasses.replace(jax_get_arch("gemma-2b").reduced(), **changes)
    cfg = dataclasses.replace(get_arch("gemma-2b").reduced(), **changes)
    params = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, params, cfg, model_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                                       device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got: torch.Tensor, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


# -- building blocks --------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_the_jax_package_config(reduced):
    cfg, cfg_j = get_arch("gemma-2b"), jax_get_arch("gemma-2b")
    if reduced:
        cfg, cfg_j = cfg.reduced(), cfg_j.reduced()
    names = [f.name for f in dataclasses.fields(cfg)]
    assert {n: getattr(cfg, n) for n in names} == {n: getattr(cfg_j, n) for n in names}
    assert cfg.padded_vocab() == cfg_j.padded_vocab() and cfg.hd == cfg_j.hd
    # the fields the port leaves out describe what it serves: one dense
    # full-attention layer with the config's MLP, repeated n_layers times
    unit_j, R_j = cfg_j.pattern()
    assert R_j == cfg.n_layers
    assert [(u.mixer, u.ffn) for u in unit_j] == [("attn_full", cfg.mlp_type)]


def test_rmsnorm_rope_sinusoidal_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 128), dtype=np.float32) * 3
    gamma = rng.standard_normal(128, dtype=np.float32) * 0.1
    _close(L.rmsnorm(_t(x), _t(gamma), 1e-6), JL.rmsnorm(jnp.asarray(x), jnp.asarray(gamma), 1e-6),
           atol=1e-5)
    h = rng.standard_normal((2, 5, 4, 32), dtype=np.float32)
    pos = np.arange(3, 8)
    _close(L.rope(_t(h), _t(pos), 10000.0), JL.rope(jnp.asarray(h), jnp.asarray(pos), 10000.0),
           atol=1e-5)
    pos2 = np.stack([pos, pos + 40])  # per-row positions [B, S]
    _close(L.rope(_t(h), _t(pos2), 10000.0), JL.rope(jnp.asarray(h), jnp.asarray(pos2), 10000.0),
           atol=1e-5)
    _close(L.sinusoidal(_t(np.arange(7)), 128), JL.sinusoidal(jnp.arange(7), 128), atol=1e-5)


@pytest.mark.parametrize("mlp_type", ["geglu", "swiglu", "gelu"])
def test_apply_mlp_matches(mlp_type):
    cfg = dataclasses.replace(get_arch("gemma-2b").reduced(), mlp_type=mlp_type)
    cfg_j = dataclasses.replace(jax_get_arch("gemma-2b").reduced(), mlp_type=mlp_type)
    p, _ = JL.init_mlp(cfg_j, jax.random.PRNGKey(1))
    if mlp_type == "gelu":  # nonzero biases, so that they are held too
        p = {**p, "b_up": p["b_up"] + 0.1, "b_down": p["b_down"] - 0.2}
    mlp = L.MLP(cfg, torch.Generator().manual_seed(0))
    assert sorted(name for name, _ in mlp.named_parameters()) == sorted(p)
    for name, a in p.items():
        getattr(mlp, name).copy_(_t(a))
    x = np.random.default_rng(1).standard_normal((2, 5, 128), dtype=np.float32)
    _close(L.apply_mlp(cfg, mlp, _t(x)), JL.apply_mlp(cfg_j, p, jnp.asarray(x)), atol=1e-5)


@pytest.mark.parametrize("tied,final_softcap", [(True, None), (True, 30.0), (False, None)])
def test_embed_and_unembed_match(tied, final_softcap):
    changes = {"tie_embeddings": tied, "final_softcap": final_softcap}
    cfg = dataclasses.replace(get_arch("gemma-2b").reduced(), **changes)
    cfg_j = dataclasses.replace(jax_get_arch("gemma-2b").reduced(), **changes)
    p, _ = JL.init_embed(cfg_j, jax.random.PRNGKey(2))
    emb = L.Embed(cfg, torch.Generator().manual_seed(0))
    for name, a in p.items():
        getattr(emb, name).copy_(_t(a))
    tok = _tokens(2, (2, 5))
    _close(L.embed_tokens(cfg, emb, _t(tok).long()), JL.embed_tokens(cfg_j, p, jnp.asarray(tok)),
           atol=1e-5)
    x = np.random.default_rng(2).standard_normal((2, 5, 128), dtype=np.float32)
    got = L.unembed(cfg, emb, _t(x))
    assert got.dtype == torch.float32 and got.shape == (2, 5, cfg.padded_vocab())
    _close(got, JL.unembed(cfg_j, p, jnp.asarray(x)), atol=1e-5)


def test_attend_full_matches(pair):
    cfg_j, params, cfg, model = pair
    p0 = jax.tree.map(lambda a: a[0], params["unit"]["L0"]["mixer"])
    x = np.random.default_rng(3).standard_normal((B, S, 128), dtype=np.float32)
    out_j, (k_j, v_j) = JA.attend_full(cfg_j, p0, jnp.asarray(x), jnp.arange(S))
    out, (k, v) = A.attend_full(cfg, model.layers[0].mixer, _t(x), torch.arange(S))
    _close(out, out_j, atol=1e-5)
    _close(k, k_j, atol=1e-5)
    _close(v, v_j, atol=1e-5)


# -- the stack and the serving API ------------------------------------------------


def test_forward_matches(pair):
    cfg_j, params, cfg, model = pair
    tok = _tokens(4, (B, S))
    hidden_j, _, _ = jax_forward(cfg_j, params, jnp.asarray(tok))
    hidden = model(_t(tok).long())
    assert hidden.shape == (B, S, cfg.d_model)
    _close(hidden, hidden_j)


def test_prefill_logits_and_caches_match(pair):
    cfg_j, params, cfg, model = pair
    tok = _tokens(5, (B, S))
    logits_j, st_j = JM.prefill(cfg_j, params, {"tokens": jnp.asarray(tok)}, cache_len=S + 8)
    logits, st = M.prefill(model, {"tokens": _t(tok).long()}, cache_len=S + 8)
    assert logits.shape == (B, cfg.padded_vocab()) and st.pos == int(st_j.pos) == S
    _close(logits, logits_j)
    assert len(st.caches) == cfg.n_layers
    for i, lc in enumerate(st.caches):
        assert lc.k.shape == lc.v.shape == (B, S + 8, cfg.n_kv_heads, cfg.hd)
        _close(lc.k, st_j.caches["L0"].k[i], atol=1e-5)
        _close(lc.v, st_j.caches["L0"].v[i], atol=1e-5)


def _serve_both(cfg_j, params, model, steps, prompt_seed, feed=None, use_pallas=False):
    """Prefill the same prompts on both sides, then ``steps`` serve steps
    fed the tokens ``feed`` (or each side's own greedy tokens); returns the
    logits of the prefill and of every step on both sides."""
    tok = _tokens(prompt_seed, (B, S))
    lj, stj = JM.prefill(cfg_j, params, {"tokens": jnp.asarray(tok)}, cache_len=S + steps,
                         use_pallas=use_pallas)
    lt, stt = M.prefill(model, {"tokens": _t(tok).long()}, cache_len=S + steps)
    out_j, out_t = [np.asarray(lj)], [lt]
    for s in range(steps):
        nj = jnp.asarray(feed[:, s:s + 1]) if feed is not None else jnp.argmax(lj, -1)[:, None]
        nt = _t(feed[:, s:s + 1]).long() if feed is not None else torch.argmax(lt, -1)[:, None]
        lj, stj = JM.serve_step(cfg_j, params, stj, nj.astype(jnp.int32))
        lt, stt = M.serve_step(model, stt, nt)
        out_j.append(np.asarray(lj))
        out_t.append(lt)
    return out_j, out_t


def test_serve_steps_match_fed_the_same_tokens(pair):
    cfg_j, params, cfg, model = pair
    out_j, out_t = _serve_both(cfg_j, params, model, 8, 6, feed=_tokens(7, (B, 8)))
    for lj, lt in zip(out_j, out_t):
        _close(lt, lj)


def test_greedy_tokens_identical(pair):
    cfg_j, params, cfg, model = pair
    out_j, out_t = _serve_both(cfg_j, params, model, 8, 8)
    tok_j = np.stack([np.argmax(lj, -1) for lj in out_j], 1)
    tok_t = torch.stack([torch.argmax(lt, -1) for lt in out_t], 1).numpy()
    np.testing.assert_array_equal(tok_t, tok_j)


@pytest.mark.parametrize("changes", [
    {"logit_softcap": 30.0, "final_softcap": 30.0},
    {"pos_emb": "sinusoidal"},
    {"tie_embeddings": False, "embed_scale": False},
    {"mlp_type": "swiglu"},
], ids=["softcaps", "sinusoidal", "untied", "swiglu"])
def test_variant_logits_match(changes):
    """Config fields gemma-2b leaves at one value, set through
    ``dataclasses.replace``: prefill and 4 fed decode steps."""
    cfg_j, params, cfg, model = _pair(**changes)
    out_j, out_t = _serve_both(cfg_j, params, model, 4, 9, feed=_tokens(10, (B, 4)))
    for lj, lt in zip(out_j, out_t):
        _close(lt, lj)
        if cfg.final_softcap is not None:
            assert float(lt.abs().max()) < cfg.final_softcap


def test_prefill_matches_the_pallas_route(pair):
    """The JAX prefill through the Pallas flash kernel (interpret mode)."""
    cfg_j, params, cfg, model = pair
    out_j, out_t = _serve_both(cfg_j, params, model, 1, 11, feed=_tokens(12, (B, 1)),
                               use_pallas=True)
    for lj, lt in zip(out_j, out_t):
        _close(lt, lj)


def test_decode_matches_forward(pair):
    """Prefill S + decode 1 equals forward on S + 1 (the port alone, at
    ``tests/test_models_smoke.py``'s tolerances)."""
    _, _, cfg, model = pair
    tok = _t(_tokens(13, (B, S + 1))).long()
    hidden = model(tok)
    want = L.unembed(cfg, model.embed, hidden[:, -1:, :])[:, 0]
    _, st = M.prefill(model, {"tokens": tok[:, :S]}, cache_len=S + 8)
    got, st = M.serve_step(model, st, tok[:, S:S + 1])
    assert st.pos == S + 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4, rtol=5e-3)


def test_init_serve_state_and_cache_bounds(pair):
    _, _, cfg, model = pair
    st = M.init_serve_state(cfg, B, 4, "cpu")
    assert st.pos == 0 and len(st.caches) == cfg.n_layers
    assert all(float(c.k.abs().sum()) == 0 for c in st.caches)
    tok = torch.zeros(B, 1, dtype=torch.long)
    for _ in range(4):
        _, st = M.serve_step(model, st, tok)
    with pytest.raises(ValueError, match="outside the cache"):
        M.serve_step(model, st, tok)


# -- weights carried across, and what is not ported -------------------------------


def test_model_params_from_numpy_checks_the_tree(pair):
    cfg_j, params, cfg, _ = pair
    tree = jax.tree.map(np.asarray, params)
    bad = {**tree, "final_norm": tree["final_norm"][:-1]}
    with pytest.raises(ValueError, match="shape"):
        model_params_from_numpy(cfg, bad, device="cpu")
    unit = {"L0": {k: v for k, v in tree["unit"]["L0"].items() if k != "norm2"}}
    with pytest.raises(ValueError, match="norm2"):
        model_params_from_numpy(cfg, {**tree, "unit": unit}, device="cpu")
