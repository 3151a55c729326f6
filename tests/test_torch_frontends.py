"""The pruned configs' features in the port (gemma2's post-norms, whisper's
audio encoder with a cross-attention sublayer in every decoder layer and
sinusoidal positions, the VLM patch-embedding prefix) on the CPU against
the JAX package.

The models: the reduced variants of whisper-large-v3, gemma2-27b and
internvl2-26b, built from the seed's config literals in both packages'
``ArchConfig`` (neither registry holds them), and gemma-2b with these
features through ``dataclasses.replace``, as the JAX package's tests
reach them: an audio gemma (RoPE in its encoder, one KV head in its
cross-attention) and a VLM gemma with post-norms.  Both sides compute from
the same weights (the JAX package initialises them, ``convert`` carries
them across), the same numpy inputs and, for decode, the same state
(``convert.caches_from_numpy`` of a JAX prefill's).  The JAX side runs
``use_pallas=False`` (its plain attention); the port's CPU tensors take
``flash_attention``'s plain version, ``ref.attention_ref``.

Tolerances, float32 on both sides: logits 1e-4 absolute (forward,
prefill, each of 8 decode steps); decode against a cache-free forward at
the JAX test's ``atol=5e-4, rtol=5e-3``
(``tests/test_models_smoke.py::test_decode_matches_forward``); one train
step: the loss 1e-5 relative, the grad norm 1e-4 absolute, the AdamW
moments leaf by leaf within 1e-4 of each leaf's largest |value|
(``tests/test_torch_train.py``'s and ``tests/test_torch_ssm.py``'s).
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.transformer import forward as jax_forward
from repro.optim import optimizers as JO
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import caches_from_numpy, model_params_from_numpy, train_state_from_numpy
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.layers import unembed
from repro_torch.models.transformer import Transformer
from repro_torch.optim import optimizers as O

LOGIT_ATOL, LOSS_RTOL, GNORM_ATOL, MOMENT_SCALED_TOL = 1e-4, 1e-5, 1e-4, 1e-4
B = 2


def _seed_configs() -> dict:
    """The seed's config literals (``f0c2fc6:src/repro/configs/<file>``,
    less ``fsdp``), as ``chip_smoke.py`` serves them at full width."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.FRONTEND_ARCHS


SEED = _seed_configs()  # whisper-large-v3, gemma2-27b, internvl2-26b

# gemma-2b with the features, as dataclasses.replace reaches them
REPLACED = {
    "gemma_audio": {"arch_type": "audio", "encoder_layers": 2, "encoder_seq": 24},
    "gemma_vlm_post_norm": {"arch_type": "vlm", "prefix_tokens": 16, "post_norm": True},
}
MODELS = list(SEED) + list(REPLACED)
PROMPT = {"whisper": 16, "gemma2": 128, "internvl2": 16, "gemma_audio": 16, "gemma_vlm_post_norm": 16}
STEPS = 8


def _cfgs(name):
    if name in SEED:
        return JaxArchConfig(**SEED[name]).reduced(), ArchConfig(**SEED[name]).reduced()
    return (dataclasses.replace(jax_get_arch("gemma-2b"), **REPLACED[name]).reduced(),
            dataclasses.replace(get_arch("gemma-2b"), **REPLACED[name]).reduced())


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _extras(cfg, seed) -> dict:
    """The batch's prefix or frames, N(0, 1)·0.02 from a seed, as numpy."""
    rng = np.random.default_rng(seed)
    n = {"vlm": ("prefix", cfg.prefix_tokens), "audio": ("frames", cfg.encoder_seq)}.get(cfg.arch_type)
    return {} if n is None else {n[0]: (0.02 * rng.standard_normal((B, n[1], cfg.d_model))).astype(np.float32)}


def _jbatch(tok, extras):
    return {"tokens": jnp.asarray(tok), **{k: jnp.asarray(v) for k, v in extras.items()}}


def _tbatch(tok, extras):
    return {"tokens": torch.from_numpy(tok), **{k: torch.from_numpy(v) for k, v in extras.items()}}


def _close(got, want, atol=LOGIT_ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def models():
    """{name: (JAX config, JAX params, port config, port model)}, shared:
    no test changes the weights."""
    out = {}
    for seed, name in enumerate(MODELS):
        cfg_j, cfg = _cfgs(name)
        params = JM.init_params(cfg_j, jax.random.PRNGKey(seed))
        out[name] = (cfg_j, params, cfg, model_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                                                 device="cpu"))
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    """Each model's JAX run from one prompt: (tokens [B, S + STEPS], the
    extras, the forward's logits over the prompt, the prefill's logits, its
    position and caches as numpy, each teacher-forced decode step's
    logits)."""
    out = {}
    for name, (cfg_j, params, _, _) in models.items():
        S = PROMPT[name]
        tok, extras = _tokens(7, (B, S + STEPS)), _extras(cfg_j, 8)
        P = cfg_j.prefix_tokens if "prefix" in extras else 0
        batch = _jbatch(tok[:, :S], extras)

        @jax.jit
        def run(p, b):
            hidden, _, _ = jax_forward(cfg_j, p, b["tokens"], prefix=b.get("prefix"), frames=b.get("frames"))
            logits, state = JM.prefill(cfg_j, p, b, cache_len=P + S + STEPS)
            return JL.unembed(cfg_j, p["embed"], hidden), logits, state

        fwd, logits, state = run(params, batch)
        caches = jax.tree.map(np.asarray, state.caches)
        step = jax.jit(lambda p, s, t: JM.serve_step(cfg_j, p, s, t))
        steps = []
        for s in range(S, S + STEPS):
            lj, state = step(params, state, jnp.asarray(tok[:, s:s + 1]))
            steps.append(np.asarray(lj))
        out[name] = (tok, extras, np.asarray(fwd), np.asarray(logits), int(state.pos) - STEPS, caches, steps)
    return out


# -- configs ------------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_config_and_reduced_variant_equal_the_jax_package(name):
    cfg_j, cfg = _cfgs(name)
    mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(cfg_j)
    assert {k: theirs[k] for k in mine} == mine
    assert [(d.mixer, d.ffn) for d in cfg.pattern()[0]] == [(d.mixer, d.ffn) for d in cfg_j.pattern()[0]]
    if name in SEED:
        full_j, full = JaxArchConfig(**SEED[name]), ArchConfig(**SEED[name])
        assert {k: dataclasses.asdict(full_j)[k] for k in dataclasses.asdict(full)} == dataclasses.asdict(full)


def test_an_unknown_arch_type_raises():
    cfg = dataclasses.replace(get_arch("gemma-2b").reduced(), arch_type="diffusion")
    with pytest.raises(ValueError, match="unknown arch_type 'diffusion'"):
        Transformer(cfg, torch.Generator().manual_seed(0))


def test_the_front_end_modules_are_built_where_the_config_asks(models):
    """An audio model's every decoder layer has ``cross`` and
    ``norm_cross`` and it has an encoder; post-norms only under
    ``post_norm``, ``post_norm2`` only beside ``norm2``."""
    for name, (_, _, cfg, model) in models.items():
        audio = cfg.arch_type == "audio"
        assert hasattr(model, "encoder") == audio, name
        assert len(model.encoder.layers) == cfg.encoder_layers if audio else True
        for layer in model.layers:
            assert hasattr(layer, "cross") == hasattr(layer, "norm_cross") == audio, name
            assert hasattr(layer, "post_norm1") == hasattr(layer, "post_norm2") == cfg.post_norm, name


# -- cross-attention on its own -------------------------------------------------------------


@pytest.mark.parametrize("name", ["whisper", "gemma_audio"])
def test_cross_attention_and_its_decode_match_jax(name):
    """``attend_full(kv_x=...)``: 12 queries against 20 encoder rows,
    non-causal, no RoPE; ``attend_decode(cross=True)`` against the cache of
    those K/V, which it leaves as it was."""
    cfg_j, cfg = _cfgs(name)
    p, _ = JA.init_attn(cfg_j, jax.random.PRNGKey(3), cross=True)
    m = A.Attention(cfg, torch.Generator().manual_seed(0))
    for k, v in p.items():
        getattr(m, k).data.copy_(torch.from_numpy(np.array(v)))
    rng = np.random.default_rng(4)
    x, enc = (rng.standard_normal((B, n, cfg.d_model)).astype(np.float32) for n in (12, 20))
    want, (wk, wv) = JA.attend_full(cfg_j, p, jnp.asarray(x), jnp.arange(12), causal=False, use_rope=False,
                                    kv_x=jnp.asarray(enc))
    got, (k, v) = A.attend_full(cfg, m, torch.from_numpy(x), torch.arange(12), causal=False, use_rope=False,
                                kv_x=torch.from_numpy(enc))
    _close(got, want, 1e-5)
    _close(k, wk, 1e-5)
    _close(v, wv, 1e-5)
    cache_j = JA.LayerCache(wk, wv)
    cache = A.LayerCache(k.clone(), v.clone())
    want, _ = JA.attend_decode(cfg_j, p, jnp.asarray(x[:, :1]), cache_j, jnp.asarray(5), use_rope=False, cross=True)
    got, same = A.attend_decode(cfg, m, torch.from_numpy(x[:, :1]), cache, 5, use_rope=False, cross=True)
    _close(got, want, 1e-5)
    assert same is cache and torch.equal(cache.k, k) and torch.equal(cache.v, v)


# -- the models: forward, prefill, decode -------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_forward_logits_match_jax(name, models, jax_runs):
    _, _, cfg, model = models[name]
    tok, extras, want, _, _, _, _ = jax_runs[name]
    b = _tbatch(tok[:, :PROMPT[name]], extras)
    with torch.no_grad():
        hidden = model(b["tokens"], prefix=b.get("prefix"), frames=b.get("frames"))
    assert hidden.shape[1] == PROMPT[name] + (cfg.prefix_tokens if "prefix" in b else 0)
    _close(unembed(cfg, model.embed, hidden), want)


@pytest.mark.parametrize("name", MODELS)
def test_prefill_logits_position_and_caches_match_jax(name, models, jax_runs):
    """The prefill's last logits, its position (P + S) and every cache
    (a whisper layer's cross cache too) against the JAX prefill's."""
    _, _, cfg, model = models[name]
    tok, extras, _, want, pos, caches, _ = jax_runs[name]
    S = PROMPT[name]
    logits, st = M.prefill(model, _tbatch(tok[:, :S], extras), cache_len=pos + STEPS)
    _close(logits, want)
    assert st.pos == pos == S + (cfg.prefix_tokens if "prefix" in extras else 0)
    converted = caches_from_numpy(cfg, caches, device="cpu")
    flat = (lambda cs: [c for pair in cs for c in pair]) if cfg.arch_type == "audio" else list
    mine, theirs = flat(st.caches), flat(converted)
    assert len(mine) == len(theirs) == cfg.n_layers * (2 if cfg.arch_type == "audio" else 1)
    for a, b in zip(mine, theirs):
        assert type(a) is type(b) and a.k.shape == b.k.shape
        _close(a.k, b.k.numpy(), 1e-5)
        _close(a.v, b.v.numpy(), 1e-5)
    if cfg.arch_type == "audio":
        assert all(cross.k.shape[1] == cfg.encoder_seq for _, cross in st.caches)


@pytest.mark.parametrize("name", MODELS)
def test_decode_from_the_jax_state_matches_jax(name, models, jax_runs):
    """8 decode steps from the converted JAX prefill state give the JAX
    steps' logits; the cross caches come out as they went in."""
    _, _, cfg, model = models[name]
    tok, _, _, _, pos, caches, steps = jax_runs[name]
    S = PROMPT[name]
    state = M.ServeState(caches_from_numpy(cfg, caches, device="cpu"), pos)
    crosses = [(c[1].k.clone(), c[1].v.clone()) for c in state.caches] if cfg.arch_type == "audio" else []
    for i, s in enumerate(range(S, S + STEPS)):
        logits, state = M.serve_step(model, state, torch.from_numpy(tok[:, s:s + 1]))
        _close(logits, steps[i])
    assert state.pos == pos + STEPS
    for (k, v), (_, cross) in zip(crosses, state.caches if crosses else []):
        assert torch.equal(cross.k, k) and torch.equal(cross.v, v)


@pytest.mark.parametrize("name", MODELS)
def test_decode_equals_a_cache_free_forward(name, models):
    """Prefill S tokens, decode 8 teacher-forced: the last step's logits
    against a forward over the S + 8 tokens with the same extras."""
    _, _, cfg, model = models[name]
    S = PROMPT[name]
    tok = _tokens(9, (B, S + STEPS))
    b = _tbatch(tok, _extras(cfg, 10))
    extras = {k: v for k, v in b.items() if k != "tokens"}
    P = cfg.prefix_tokens if "prefix" in extras else 0
    _, st = M.prefill(model, {**extras, "tokens": b["tokens"][:, :S]}, cache_len=P + S + STEPS)
    for s in range(S, S + STEPS):
        got, st = M.serve_step(model, st, b["tokens"][:, s:s + 1])
    with torch.no_grad():
        want = unembed(cfg, model.embed, model(b["tokens"], **extras)[:, -1:])[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4, rtol=5e-3)


def test_a_front_end_input_of_the_wrong_shape_raises(models):
    _, _, cfg, model = models["internvl2"]
    tok = torch.from_numpy(_tokens(1, (B, 8)))
    with pytest.raises(ValueError, match="prefix"):
        model(tok, prefix=torch.zeros(B, cfg.prefix_tokens - 1, cfg.d_model))
    _, _, cfg, model = models["whisper"]
    with pytest.raises(ValueError, match="frame embeddings"):
        M.prefill(model, {"tokens": tok})


# -- training ------------------------------------------------------------------------------


def _moment_errors(cfg, state, state_j) -> dict:
    want = train_state_from_numpy(cfg, *jax.tree.map(np.asarray, (state_j.params, state_j.opt)), device="cpu")
    errs = {}
    for mom in ("mu", "nu"):
        got, theirs = getattr(state.opt, mom), getattr(want.opt, mom)
        assert list(got) == list(theirs)
        for k, w in theirs.items():
            scale = float(w.abs().max())
            errs[f"{mom}:{k}"] = float((got[k] - w).abs().max()) / scale if scale else float(got[k].abs().max())
    return errs


@pytest.mark.parametrize("name", MODELS)
def test_train_step_equals_jax(name):
    """One AdamW step from one state on both sides, with the batch's
    extras: the loss (a VLM's over its token positions only), the grad
    norm, the moments leaf by leaf (the encoder's and the cross-attention's
    among them) and every parameter after the step."""
    cfg_j, cfg = _cfgs(name)
    state_j = JM.init_train_state(cfg_j, jax.random.PRNGKey(2))
    tree = jax.tree.map(np.asarray, state_j)
    state = train_state_from_numpy(cfg, tree.params, tree.opt, device="cpu")
    opt_j, opt = JO.AdamWConfig(warmup_steps=2, total_steps=10), O.AdamWConfig(warmup_steps=2, total_steps=10)
    tok, extras = _tokens(11, (B, PROMPT[name] + 1)), _extras(cfg, 12)
    state_j, m_j = jax.jit(lambda s, b: JM.train_step(cfg_j, s, b, opt_j))(state_j, _jbatch(tok, extras))
    state, m = M.train_step(cfg, state, _tbatch(tok, extras), opt)
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(m_j["grad_norm"]), atol=GNORM_ATOL)
    errs = _moment_errors(cfg, state, state_j)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= MOMENT_SCALED_TOL, (worst, errs[worst])
    if cfg.arch_type == "audio":
        assert any(k.startswith("mu:encoder.layers.1.") for k in errs) and "mu:layers.0.cross.wk" in errs
    want = train_state_from_numpy(cfg, *jax.tree.map(np.asarray, (state_j.params, state_j.opt)), device="cpu")
    got_p, want_p = M.param_tree(state.params), M.param_tree(want.params)
    for k in got_p:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k].numpy(), atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_param_tree_is_the_jax_leaf_order(name, models):
    """``param_tree`` (the order the global norm sums in) walks the JAX
    params' leaves in order: the encoder's stacked layers, the cross and
    post-norm leaves among them."""
    _, params, cfg, model = models[name]
    tree = M.param_tree(model)
    period = len(cfg.pattern()[0])
    expected = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        if keys[0] == "unit":
            names = [f"layers.{r}." + ".".join(keys[2:]) for r in range(int(keys[1][1:]), cfg.n_layers, period)]
        elif keys[:2] == ["encoder", "unit"]:
            names = [f"encoder.layers.{i}." + ".".join(keys[2:]) for i in range(cfg.encoder_layers)]
        else:
            names = [".".join(keys)]
        names = [n + ".gamma" if n + ".gamma" in tree else n for n in names]
        stacked = keys[0] == "unit" or keys[:2] == ["encoder", "unit"]
        got = np.stack([tree[n].numpy() for n in names]) if stacked else tree[names[0]].numpy()
        np.testing.assert_array_equal(got, np.asarray(leaf), err_msg=str(keys))
        expected += names
    assert list(tree) == expected
    assert ("layers.0.post_norm2.gamma" in tree) == cfg.post_norm
    assert ("encoder.final_norm.gamma" in tree) == ("layers.0.norm_cross.gamma" in tree) == (cfg.arch_type == "audio")


# -- the launcher --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["whisper", "internvl2"])
def test_serve_main_draws_the_front_end_inputs(name, monkeypatch, capsys):
    """``launch.serve`` on an audio and a VLM architecture on the CPU: the
    batch's frames or prefix from the seeded generator after the prompts,
    caches for prefix + prompt + tokens, the JAX launcher's line."""
    full = ArchConfig(**SEED[name])
    monkeypatch.setattr(serve, "get_arch", lambda arch: full)
    out = serve.main(["--arch", full.name, "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--tokens", "3"])
    assert out["tokens"].shape == (2, 4) and out["logits_finite"]
    assert f"arch={full.name} prefill 2x8 in" in capsys.readouterr().out
    cfg = full.reduced()
    gen = torch.Generator().manual_seed(3)
    ex = serve.front_end_inputs(cfg, 2, gen)
    (key, val), = ex.items()
    n = cfg.encoder_seq if name == "whisper" else cfg.prefix_tokens
    assert key == ("frames" if name == "whisper" else "prefix") and tuple(val.shape) == (2, n, cfg.d_model)
    assert val.dtype == torch.float32 and 0.015 < float(val.std()) < 0.025
    assert serve.front_end_inputs(get_arch("gemma-2b").reduced(), 2, gen) == {}


# bf16 whisper: logits 2x the 0.0234 measured (the decoder's bf16 rounding in
# either package, whatever the frames); the cross caches from float32 frames
# are the float32 encoder's, 1.9e-6 apart measured, so 1e-5; from bf16 frames
# both encoders run bf16, 0.031 apart measured, so 0.0625
BF16_LOGIT_ATOL, F32_CROSS_ATOL, BF16_CROSS_ATOL = 0.05, 1e-5, 0.0625


@pytest.mark.parametrize("frames_dtype", ["float32", "bfloat16"])
def test_bf16_whisper_encoder_keeps_the_frames_dtype_as_jax(frames_dtype):
    """The reduced whisper in bf16 through both packages' prefill from the
    same frames: float32 frames keep the encoder in float32 (its output's
    K/V, the cross caches, come back float32 as the JAX prefill's), bf16
    frames keep it in bf16; the logits and every cross cache agree."""
    cfg_j, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs("whisper"))
    params = JM.init_params(cfg_j, jax.random.PRNGKey(11))
    model = model_params_from_numpy(cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), params), device="cpu")
    tok, frames = _tokens(7, (B, PROMPT["whisper"])), _extras(cfg_j, 8)["frames"]
    want, state = jax.jit(lambda p, b: JM.prefill(cfg_j, p, b))(
        params, {"tokens": jnp.asarray(tok), "frames": jnp.asarray(frames).astype(frames_dtype)})
    got, st = M.prefill(model, {"tokens": torch.from_numpy(tok),
                                "frames": torch.from_numpy(frames).to(getattr(torch, frames_dtype))})
    _close(got, want, BF16_LOGIT_ATOL)
    atol = F32_CROSS_ATOL if frames_dtype == "float32" else BF16_CROSS_ATOL
    period = len(cfg.pattern()[0])
    for r, (_, cross) in enumerate(st.caches):
        jc = state.caches[f"L{r % period}"][1]
        assert str(cross.k.dtype) == f"torch.{jc.k.dtype}" == f"torch.{frames_dtype}"
        _close(cross.k, jc.k[r // period], atol)
        _close(cross.v, jc.v[r // period], atol)
