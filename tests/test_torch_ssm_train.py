"""The recurrent models' longest checks, split from ``tests/test_torch_ssm.py``
so that the two files run on two workers: reduced xlstm-1.3b and the
reduced Mamba hybrid decoding against a cache-free forward, and three
AdamW train steps against the JAX package.  The models, inputs and
tolerances are ``tests/test_torch_ssm.py``'s (its docstring says where each
tolerance comes from); nothing here changed in the move.
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
from repro_torch.models.layers import unembed
from repro_torch.optim import optimizers as O
from test_torch_ssm import (  # noqa: F401  (models is a fixture)
    B,
    GNORM_ATOL,
    LOSS_RTOL,
    MODELS,
    MOMENT_SCALED_TOL,
    PARAM_ATOL,
    XLSTM_LATER,
    _cfgs,
    _tokens,
    models,
)


@pytest.mark.parametrize("name", MODELS)
def test_decode_equals_a_cache_free_forward(name, models):
    """Prefill 96 tokens and decode 32 (to 128), and prefill 128 and decode
    128 (to 256): the last step's logits against a forward over the whole
    sequence."""
    _, _, cfg, model = models[name]
    tok = torch.from_numpy(_tokens(8, (B, 256)))
    for S, end in ((96, 128), (128, 256)):
        _, st = M.prefill(model, {"tokens": tok[:, :S]}, cache_len=end)
        for s in range(S, end):
            got, st = M.serve_step(model, st, tok[:, s:s + 1])
        with torch.no_grad():
            want = unembed(cfg, model.embed, model(tok[:, :end])[:, -1:])[:, 0]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4, rtol=5e-3)


def _moment_errors(cfg, state, state_j) -> dict:
    """{"mu:<leaf>" / "nu:<leaf>": the port's largest difference from the
    JAX state's moment over that moment's largest |value|}."""
    want = train_state_from_numpy(cfg, *jax.tree.map(np.asarray, (state_j.params, state_j.opt)), device="cpu")
    errs = {}
    for mom in ("mu", "nu"):
        got, theirs = getattr(state.opt, mom), getattr(want.opt, mom)
        assert list(got) == list(theirs)
        for k, w in theirs.items():
            scale = float(w.abs().max())
            assert scale > 0, (mom, k)
            errs[f"{mom}:{k}"] = float((got[k] - w).abs().max()) / scale
    return errs


@pytest.mark.parametrize("name", MODELS)
def test_three_train_steps_equal_jax(name):
    """Three AdamW steps from one state on both sides: every step's loss
    and grad norm, the first step's moments leaf by leaf (every leaf's
    gradient, before the rounding has grown), and every parameter after
    the third step.  The hybrid
    is held to ``tests/test_torch_train.py``'s tolerances.  Reduced xlstm
    is chaotic at float32 rounding: the JAX package against itself, from
    initial weights perturbed by 1e-7 relative, moves the third step's loss
    by 2.3e-4 relative, its grad norm by 4% and the parameters by 9.8e-4
    (Adam's first update is ``lr · sign(g)``, so a gradient element at the
    float32 noise level flips).  So there the first step is held as the
    hybrid's (its grad norm at ``GNORM_ATOL``), and the later steps to
    ``XLSTM_LATER``: about twice that spread (measured against the port:
    loss 1.6e-5, grad norm 10%, parameters 9.8e-4)."""
    cfg_j, cfg = _cfgs(name)
    state_j = JM.init_train_state(cfg_j, jax.random.PRNGKey(2))
    tree = jax.tree.map(np.asarray, state_j)
    state = train_state_from_numpy(cfg, tree.params, tree.opt, device="cpu")
    opt_j, opt = JO.AdamWConfig(warmup_steps=2, total_steps=10), O.AdamWConfig(warmup_steps=2, total_steps=10)
    step_j = jax.jit(lambda s, b: JM.train_step(cfg_j, s, b, opt_j))
    later = XLSTM_LATER if name == "xlstm" else None
    for i in range(3):
        tok = _tokens(10 + i, (B, 129))
        state_j, m_j = step_j(state_j, {"tokens": jnp.asarray(tok)})
        state, m = M.train_step(cfg, state, {"tokens": torch.from_numpy(tok)}, opt)
        if i == 0:
            errs = _moment_errors(cfg, state, state_j)
            worst = max(errs, key=errs.get)
            assert errs[worst] <= MOMENT_SCALED_TOL[name], (worst, errs[worst])
        if i == 0 or later is None:
            np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=LOSS_RTOL)
            np.testing.assert_allclose(float(m["grad_norm"]), float(m_j["grad_norm"]), atol=GNORM_ATOL[name])
        else:
            np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=later["loss_rtol"])
            np.testing.assert_allclose(float(m["grad_norm"]), float(m_j["grad_norm"]), rtol=later["gnorm_rtol"])
    want = train_state_from_numpy(cfg, *jax.tree.map(np.asarray, (state_j.params, state_j.opt)), device="cpu")
    got_p, want_p = M.param_tree(state.params), M.param_tree(want.params)
    assert list(got_p) == list(want_p)
    atol = PARAM_ATOL if later is None else later["param_atol"]
    for k in got_p:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k].numpy(), atol=atol, rtol=0, err_msg=k)
    assert not any(p.requires_grad for p in state.params.parameters())
