"""Sliding-window layers of the port on the CPU against the JAX package:
``_chunked_local_attention``, windowed prefill caches and ring-buffer
decode past the wrap, on reduced gemma-2b (float32, 4 layers alternating a
64-token window layer and a full one: ``layer_pattern="local_global"``,
gemma2's layout, through ``dataclasses.replace`` as the JAX tests do).

Both sides compute from the same weights (the JAX package initialises
them, ``convert.model_params_from_numpy`` carries them across) and the
same numpy tokens.  The port's prefill runs ``flash_attention``'s plain
version on CPU tensors (its window route); the JAX prefill its plain
route.  Tolerances, float32 on both sides: atol 3e-5 on attention outputs
(``tests/test_perf_variants.py``'s), 1e-5 on cached K/V, 1e-4 on logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs import get_arch
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels import ref
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.layers import unembed
from repro_torch.models.transformer import Transformer

WINDOWED = {"layer_pattern": "local_global", "window": 4096}  # reduced(): window 64
B = 2


def _pair(seed=0, **changes):
    changes = {**WINDOWED, **changes}
    cfg_j = dataclasses.replace(jax_get_arch("gemma-2b"), **changes).reduced()
    cfg = dataclasses.replace(get_arch("gemma-2b"), **changes).reduced()
    params = JM.init_params(cfg_j, jax.random.PRNGKey(seed))
    return cfg_j, params, cfg, model_params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=0)


# -- the attention ------------------------------------------------------------------


@pytest.mark.parametrize("softcap", [50.0, None])
def test_chunked_local_attention_matches_both_references(softcap):
    """Against JAX's ``_chunked_local_attention`` and against masked full
    attention (the port's and JAX's ``attention_ref``), as
    ``tests/test_perf_variants.py`` checks the JAX function."""
    cfg = dataclasses.replace(get_arch("gemma-2b").reduced(), logit_softcap=softcap)
    cfg_j = dataclasses.replace(jax_get_arch("gemma-2b").reduced(), logit_softcap=softcap)
    Bq, S, H, Kv, D, w = 2, 256, 4, 2, 32, 64
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((Bq, S, h, D), dtype=np.float32) for h in (H, Kv, Kv))
    got = A._chunked_local_attention(cfg, *(torch.from_numpy(a) for a in (q, k, v)), w)
    want_j = JA._chunked_local_attention(cfg_j, *(jnp.asarray(a) for a in (q, k, v)), w)
    _close(got, want_j, 3e-5)
    t = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    _close(got, ref.attention_ref(*t, causal=True, window=w, softcap=softcap).transpose(1, 2), 3e-5)
    jt = [jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)]
    _close(got, jref.attention_ref(*jt, causal=True, window=w, softcap=softcap).transpose(0, 2, 1, 3),
           3e-5)


@pytest.mark.parametrize("S", [64, 96, 128], ids=["one_window", "short_of_two", "two_windows"])
def test_attend_full_window_matches_jax(pair, S):
    """A window layer's full-sequence attention on both routes: the plain
    route (``_chunked_local_attention`` where S is a multiple of the window,
    at least 2) and the kernel wrapper's (its plain version on the CPU)."""
    cfg_j, params, cfg, model = pair
    layer = model.layers[0]
    assert layer.window == 64 and model.layers[1].window is None
    p0 = jax.tree.map(lambda a: a[0], params["unit"]["L0"]["mixer"])
    x = np.random.default_rng(1).standard_normal((B, S, 128), dtype=np.float32)
    out_j, (k_j, _) = JA.attend_full(cfg_j, p0, jnp.asarray(x), jnp.arange(S), window=64)
    for plain in (True, False):
        out, (k, _) = A.attend_full(cfg, layer.mixer, torch.from_numpy(x), torch.arange(S),
                                    window=64, plain_attention=plain)
        _close(out, out_j, 1e-4)
        _close(k, k_j, 1e-5)


def test_set_chunked_local_off_takes_the_masked_full_attention(pair, monkeypatch):
    """``set_chunked_local(False)`` routes a window layer's plain attention
    through ``attention_ref`` with the window mask: the same output."""
    _, _, cfg, model = pair
    layer = model.layers[0]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((B, 128, 128), dtype=np.float32))
    calls = []
    chunked = A._chunked_local_attention
    monkeypatch.setattr(A, "_chunked_local_attention", lambda *a: calls.append(1) or chunked(*a))
    on, _ = A.attend_full(cfg, layer.mixer, x, torch.arange(128), window=64, plain_attention=True)
    try:
        A.set_chunked_local(False)
        off, _ = A.attend_full(cfg, layer.mixer, x, torch.arange(128), window=64, plain_attention=True)
    finally:
        A.set_chunked_local(True)
    assert calls == [1] and A.CHUNKED_LOCAL
    _close(on, off.numpy(), 1e-5)


# -- prefill and ring-buffer decode --------------------------------------------------


def _serve_both(cfg_j, params, model, S, steps, seed):
    tok = _tokens(seed, (B, S))
    feed = _tokens(seed + 1, (B, steps))
    lj, stj = JM.prefill(cfg_j, params, {"tokens": jnp.asarray(tok)}, cache_len=S + steps)
    lt, stt = M.prefill(model, {"tokens": torch.from_numpy(tok)}, cache_len=S + steps)
    pre = (stj, stt)
    out = [(np.asarray(lj), lt)]
    step_j = jax.jit(lambda st, t: JM.serve_step(cfg_j, params, st, t))
    for s in range(steps):
        lj, stj = step_j(stj, jnp.asarray(feed[:, s:s + 1]))
        lt, stt = M.serve_step(model, stt, torch.from_numpy(feed[:, s:s + 1]))
        out.append((np.asarray(lj), lt))
    return pre, out, (stj, stt)


@pytest.mark.parametrize("S", [128, 32], ids=["prompt_two_windows", "prompt_half_a_window"])
def test_windowed_prefill_caches_match_jax(pair, S):
    """A window layer's cache holds the last 64 positions (a longer prompt)
    or the prompt padded with zeros (a shorter one); a full layer's all S
    positions, grown to the cache length."""
    cfg_j, params, cfg, model = pair
    (stj, stt), _, _ = _serve_both(cfg_j, params, model, S, 0, 20)
    assert stt.pos == int(stj.pos) == S
    for r, lc in enumerate(stt.caches):
        want = stj.caches[f"L{r % 2}"]
        assert lc.k.shape == want.k.shape[1:], (r, lc.k.shape)
        assert lc.k.shape[1] == (64 if r % 2 == 0 else S)
        _close(lc.k, want.k[r // 2], 1e-5)
        _close(lc.v, want.v[r // 2], 1e-5)


@pytest.mark.parametrize("S,steps", [(128, 80), (32, 48)], ids=["wrap_after_trim", "wrap_after_pad"])
def test_ring_buffer_decode_past_the_wrap_matches_jax(pair, S, steps):
    """Decode fed the same tokens on both sides until each window layer's
    64-slot ring has wrapped (positions past 192, or past 64)."""
    cfg_j, params, cfg, model = pair
    _, out, (stj, stt) = _serve_both(cfg_j, params, model, S, steps, 21)
    assert S + steps > (S // 64 + 1) * 64  # the ring wrapped
    for lj, lt in out:
        _close(lt, lj, 1e-4)
    for r, lc in enumerate(stt.caches):
        _close(lc.k, stj.caches[f"L{r % 2}"].k[r // 2], 1e-5)


def test_decode_equals_a_cache_free_forward(pair):
    """Prefill 128, then 80 decode steps past the wrap: each step's logits
    equal the port's own forward over the whole sequence so far (at
    ``tests/test_models_smoke.py``'s tolerances)."""
    _, _, cfg, model = pair
    tok = torch.from_numpy(_tokens(22, (B, 208)))
    _, st = M.prefill(model, {"tokens": tok[:, :128]}, cache_len=208)
    for s in range(128, 208):
        got, st = M.serve_step(model, st, tok[:, s:s + 1])
        if s in (129, 191, 192, 207):  # before, at and after the wrap
            with torch.no_grad():
                want = unembed(cfg, model.embed, model(tok[:, :s + 1])[:, -1:])[:, 0]
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4, rtol=5e-3)


def test_prefill_refuses_a_window_that_does_not_divide_the_prompt(pair):
    _, _, _, model = pair
    with pytest.raises(ValueError, match="window must divide prefill length"):
        M.prefill(model, {"tokens": torch.from_numpy(_tokens(23, (B, 96)))})


def test_init_caches_are_rings_for_window_layers(pair):
    _, _, cfg, _ = pair
    st = M.init_serve_state(cfg, B, 200, "cpu")
    assert [c.k.shape[1] for c in st.caches] == [64, 200, 64, 200]
    assert [c.k.shape[1] for c in M.init_serve_state(cfg, B, 40, "cpu").caches] == [40, 40, 40, 40]


# -- weights of a two-layer unit, and what still raises -------------------------------


def test_model_params_from_numpy_reads_a_two_layer_unit(pair):
    """Port layer r takes unit["L{r % 2}"] at slice r // 2."""
    _, params, cfg, model = pair
    assert cfg.n_layers == 4 and len(model.layers) == 4
    for r, layer in enumerate(model.layers):
        unit = params["unit"][f"L{r % 2}"]
        np.testing.assert_array_equal(layer.mixer.wq.numpy(), np.asarray(unit["mixer"]["wq"][r // 2]))
        np.testing.assert_array_equal(layer.ffn.w_down.numpy(), np.asarray(unit["ffn"]["w_down"][r // 2]))
        np.testing.assert_array_equal(layer.norm2.gamma.numpy(), np.asarray(unit["norm2"][r // 2]))
        assert layer.window == (64 if r % 2 == 0 else None)


def test_chunked_global_full_layers_drop_rope():
    cfg = dataclasses.replace(get_arch("gemma-2b"), layer_pattern="chunked_global", window=4096,
                              pattern_period=3).reduced()
    model = Transformer(cfg, torch.Generator().manual_seed(0))
    assert [(layer.window, layer.use_rope) for layer in model.layers] == \
        [(64, True), (64, True), (None, False)] * 2
