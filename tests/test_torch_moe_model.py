"""The MoE models' two longest checks, split from ``tests/test_torch_moe.py``
so that ``--dist loadfile`` runs them on a worker of their own: reduced
grok-1 and llama4-scout's prefill and greedy decode, and one train step,
against the JAX package, drop-free and at capacity 1.25 with a skewed
router.  The models, inputs, helpers and tolerances are
``tests/test_torch_moe.py``'s (its docstring says where each tolerance
comes from); nothing here changed in the move.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.optim import optimizers as JO
from repro_torch.convert import train_state_from_numpy
from repro_torch.models import model as M
from repro_torch.optim import optimizers as O
from test_torch_moe import (  # noqa: F401  (drops is a fixture)
    ARCHS,
    CAPACITY,
    GNORM_ATOL,
    LOGIT_ATOL,
    LOSS_RTOL,
    PARAM_ATOL,
    _cfgs,
    _close,
    _pair,
    _skew,
    _tokens,
    drops,
)


@pytest.mark.parametrize("cap", list(CAPACITY))
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_and_greedy_decode_match_jax(name, cap, drops):
    """A 128-token prefill (two of llama4's reduced 64-token windows), then
    24 greedy steps, each side feeding its own argmax: the tokens agree and
    every step's logits within ``LOGIT_ATOL``."""
    cfg_j, params, cfg, model = _pair(name, CAPACITY[cap])
    S, steps = 128, 24
    tok = _tokens(7, (2, S))
    lj, stj = JM.prefill(cfg_j, params, {"tokens": jnp.asarray(tok)}, cache_len=S + steps)
    lt, stt = M.prefill(model, {"tokens": torch.from_numpy(tok)}, cache_len=S + steps)
    _close(lt, lj, LOGIT_ATOL)
    step_j = jax.jit(lambda st, t: JM.serve_step(cfg_j, params, st, t))
    tj, tt = jnp.argmax(lj, -1)[:, None].astype(jnp.int32), torch.argmax(lt, -1)[:, None]
    for _ in range(steps):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        lj, stj = step_j(stj, tj)
        lt, stt = M.serve_step(model, stt, tt)
        _close(lt, lj, LOGIT_ATOL)
        tj, tt = jnp.argmax(lj, -1)[:, None].astype(jnp.int32), torch.argmax(lt, -1)[:, None]
    n_moe = sum(layer.moe for layer in model.layers)
    prefill_drops = drops[:n_moe]
    assert (sum(prefill_drops) > 0) == (CAPACITY[cap] is not None), prefill_drops
    assert sum(drops[n_moe:]) == 0  # a decode step's few tokens fit (the 8-slot floor)


@pytest.mark.parametrize("cap", list(CAPACITY))
@pytest.mark.parametrize("name", ARCHS)
def test_train_step_equals_jax(name, cap, drops):
    """One AdamW step from the same state and tokens: the loss (aux
    included), the grad-norm and every parameter."""
    cfg_j, cfg = _cfgs(name, CAPACITY[cap])
    state_j = JM.init_train_state(cfg_j, jax.random.PRNGKey(2))
    if CAPACITY[cap]:
        state_j = state_j._replace(params=_skew(state_j.params, layer_key=True))
    tree = jax.tree.map(np.asarray, state_j)
    state = train_state_from_numpy(cfg, tree.params, tree.opt, device="cpu")
    opt_j, opt = JO.AdamWConfig(warmup_steps=2, total_steps=10), O.AdamWConfig(warmup_steps=2, total_steps=10)
    tok = _tokens(10, (2, 129))
    state_j, m_j = jax.jit(lambda s, b: JM.train_step(cfg_j, s, b, opt_j))(state_j, {"tokens": jnp.asarray(tok)})
    state, m = M.train_step(cfg, state, {"tokens": torch.from_numpy(tok)}, opt)
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(m_j["grad_norm"]), atol=GNORM_ATOL)
    want = train_state_from_numpy(cfg, *(jax.tree.map(np.asarray, (state_j.params, state_j.opt))),
                                  device="cpu")
    got_p, want_p = M.param_tree(state.params), M.param_tree(want.params)
    assert list(got_p) == list(want_p)
    for k in got_p:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k].numpy(), atol=PARAM_ATOL, rtol=0, err_msg=k)
    assert any(k.endswith("ffn.router") for k in got_p)
    assert (sum(drops) > 0) == (CAPACITY[cap] is not None), drops
