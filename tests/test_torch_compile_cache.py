"""The port's process-wide predict-program cache (``serve/compile_cache.py``)
and the engine and registry counters that hang off it, against the JAX
package's, on the CPU (where a program is the eager predict; the card's
CUDA graphs are ``tests/test_torch_cuda.py``'s).

The same tenants go through both packages, from the same ensembles (the
JAX package's, carried across), and each check compares the pattern:
which lookups build and which hit (``tests/test_serve_fleet.py:40-77``),
the engine's ``compiles``/``cache_hits`` over batches, swaps and foreign
structures (``tests/test_serve.py:208-249``), and the registry's
``stats()`` over tenants, swaps, rebuilds and a quantized twin
(``tests/test_serve_fleet.py:100-187``).  The port's key has the device
where the JAX key has ``use_pallas``.  Votes are compared exactly: the
small ensembles here have no near ties.
"""
import jax
import numpy as np
import pytest

from repro.core import boosting as jboost
from repro.core.hetero import HeterogeneousSpec as JaxHSpec
from repro.learners import LearnerSpec as JaxSpec
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ModelRegistry as JaxRegistry
from repro.serve import ServeEngine as JaxEngine
from repro.serve import compile_cache as jcc
from repro.serve import publish_artifact as jax_publish
from repro_torch import convert
from repro_torch.core.hetero import HeterogeneousSpec
from repro_torch.learners import LearnerSpec, get_learner
from repro_torch.serve import EngineConfig, ModelRegistry, ServeEngine, compile_cache
from test_serve import HPARAMS, _blobs, _small_ensemble


@pytest.fixture(autouse=True)
def _clear():
    jcc.clear_cache()
    compile_cache.clear_cache()
    yield
    jcc.clear_cache()
    compile_cache.clear_cache()


def _port(name, ens):
    d = {**{f: np.asarray(a) for f, a in zip(ens.params._fields, ens.params)},
         "alpha": np.asarray(ens.alpha), "count": np.asarray(ens.count)}
    return convert.ensemble_from_numpy(d, device="cpu", learner=name)


def _pspec(spec):
    return LearnerSpec(spec.name, spec.n_features, spec.n_classes, dict(spec.hparams))


def _counts(e):
    return e.stats.compiles, e.stats.cache_hits


def _stats_view(s):
    keep = ("programs", "hits", "misses")
    return {k: s[k] for k in keep}


def test_identical_tenants_share_one_program_as_jax():
    learner, spec, ens, X = _small_ensemble("decision_tree", jax.random.PRNGKey(0))
    Xn = np.asarray(X, np.float32)
    want = np.asarray(jboost.strong_predict(learner, spec, ens, X))
    pl, ps, pe = get_learner("decision_tree"), _pspec(spec), _port("decision_tree", ens)
    seen, jseen = [], []
    for _ in range(4):
        j = JaxEngine(learner, spec, ens, batch_size=64)
        e = ServeEngine(pl, ps, pe, batch_size=64)
        np.testing.assert_array_equal(j.predict(Xn), want)
        np.testing.assert_array_equal(e.predict(Xn), want)
        jseen.append(_counts(j))
        seen.append(_counts(e))
    assert seen == jseen == [(1, 0), (0, 1), (0, 1), (0, 1)]
    assert _stats_view(compile_cache.cache_stats()) == _stats_view(jcc.cache_stats()) == \
        {"programs": 1, "hits": 3, "misses": 1}


def test_program_key_hit_miss_pattern_equals_jax():
    """Every pair of lookups builds or hits in both packages alike: the key
    separates learner hparams, batch size, committee and the active mask,
    and nothing else."""
    base = dict(name="decision_tree", n_features=6, n_classes=3, hparams=HPARAMS["decision_tree"])
    other = dict(base, hparams={"depth": 2, "n_bins": 8})
    sig = ((), [((3,), "float32")])
    cases = [(base, 64, False, None), (base, 64, False, None), (other, 64, False, None),
             (base, 128, False, None), (base, 64, True, None), (base, 64, False, (True, False)),
             (base, 64, False, (True, False))]
    jkeys = [jcc.program_key(JaxSpec(**s), sig, batch_size=b, committee=c, use_pallas=False, active_mask=a)
             for s, b, c, a in cases]
    keys = [compile_cache.program_key(LearnerSpec(**s), sig, batch_size=b, committee=c, device="cpu",
                                      active_mask=a) for s, b, c, a in cases]
    same = [[a == b for b in keys] for a in keys]
    assert same == [[a == b for b in jkeys] for a in jkeys]
    assert keys[0] == keys[1] and keys[5] == keys[6] and len(set(keys)) == 5
    # the device takes use_pallas's place
    assert compile_cache.program_key(LearnerSpec(**base), sig, batch_size=64, committee=False,
                                     device="cuda") != keys[0]
    a = LearnerSpec("ridge", 6, 3, {"l2": 1.0, "fit_intercept": True})
    b = LearnerSpec("ridge", 6, 3, {"fit_intercept": True, "l2": 1.0})
    assert compile_cache.spec_identity(a) == compile_cache.spec_identity(b)


def test_get_or_build_builds_once_then_hits():
    built = []
    fn, hit = compile_cache.get_or_build(("k",), lambda: built.append(1) or (lambda: 7))
    fn2, hit2 = compile_cache.get_or_build(("k",), lambda: built.append(1) or (lambda: 8))
    assert (hit, hit2, fn is fn2, fn2(), len(built)) == (False, True, True, 7, 1)
    assert compile_cache.cache_stats() == {"programs": 1, "hits": 1, "misses": 1, "hit_rate": 0.5}
    compile_cache.clear_cache()
    assert compile_cache.cache_stats() == {"programs": 0, "hits": 0, "misses": 0, "hit_rate": 0.0}


def test_engine_programs_stay_warm_across_batches_and_swaps_as_jax():
    learner, spec, ens, _ = _small_ensemble("ridge", jax.random.PRNGKey(7))
    X, _ = _blobs(jax.random.PRNGKey(8), n=500)
    Xn = np.asarray(X, np.float32)
    j = JaxEngine(learner, spec, ens, batch_size=128)
    e = ServeEngine(get_learner("ridge"), _pspec(spec), _port("ridge", ens), batch_size=128)
    np.testing.assert_array_equal(e.predict(Xn), j.predict(Xn))
    assert e.stats.batches == j.stats.batches == 4
    assert _counts(e) == _counts(j) == (1, 0)
    # a swapped ensemble of the same structure builds nothing
    shrunk = ens._replace(count=ens.count - 1)
    j.update_ensemble(shrunk)
    e.update_ensemble(_port("ridge", shrunk))
    np.testing.assert_array_equal(e.predict(Xn), j.predict(Xn))
    assert _counts(e) == _counts(j) == (1, 0)
    # a foreign structure is refused, a matching one swaps in warm
    _, _, foreign, _ = _small_ensemble("decision_tree", jax.random.PRNGKey(16))
    with pytest.raises(ValueError, match="structure"):
        e.update_ensemble(_port("decision_tree", foreign))
    doubled = ens._replace(alpha=ens.alpha * 2.0)
    j.update_ensemble(doubled)
    e.update_ensemble(_port("ridge", doubled))
    np.testing.assert_array_equal(e.predict(Xn), j.predict(Xn))
    assert _counts(e) == _counts(j) == (1, 0)
    # a short request pads to the engine's batch size: the same program;
    # an engine of another batch size builds its own
    e.predict(Xn[:100]), j.predict(Xn[:100])
    assert _counts(e) == _counts(j) == (1, 0)
    e2 = ServeEngine(get_learner("ridge"), _pspec(spec), _port("ridge", ens), batch_size=64)
    j2 = JaxEngine(learner, spec, ens, batch_size=64)
    e2.predict(Xn), j2.predict(Xn)
    assert _counts(e2) == _counts(j2) == (1, 0)


def test_the_heterogeneous_engine_keys_its_active_groups_as_jax():
    """A mix whose second group holds no member skips it (its own program,
    keyed by the mask); filling that group is another program."""
    lt, st, et, X = _small_ensemble("decision_tree", jax.random.PRNGKey(20))
    _, sr, er, _ = _small_ensemble("ridge", jax.random.PRNGKey(21))
    Xn = np.asarray(X, np.float32)
    jhs = JaxHSpec((st, sr), (0, 1))
    hs = HeterogeneousSpec((_pspec(st), _pspec(sr)), (0, 1))
    empty = (et, er._replace(count=jax.numpy.zeros((), jax.numpy.int32)))
    j = JaxEngine(None, jhs, empty, batch_size=64)
    e = ServeEngine(None, hs, (_port("decision_tree", et), _port("ridge", empty[1])), batch_size=64)
    np.testing.assert_array_equal(e.predict(Xn), j.predict(Xn))
    assert e._active_key(e.ensemble, e._live[2]) == (True, False)
    assert _counts(e) == _counts(j) == (1, 0)
    j.update_ensemble((et, er))
    e.update_ensemble((_port("decision_tree", et), _port("ridge", er)))
    np.testing.assert_array_equal(e.predict(Xn), j.predict(Xn))
    assert _counts(e) == _counts(j) == (2, 0)
    assert _stats_view(compile_cache.cache_stats()) == _stats_view(jcc.cache_stats())


def _registries(tmp_path, subs):
    jreg = JaxRegistry(config=JaxEngineConfig(batch_size=64))
    reg = ModelRegistry(config=EngineConfig(batch_size=64), device="cpu")
    for sub in subs:
        jreg.add_tenant(sub, tmp_path / sub)
        reg.add_tenant(sub, tmp_path / sub)
    return jreg, reg


def _tenant_counts(s):
    return {n: (t["compiles"], t["cache_hits"], t["swaps"], t["rebuilds"]) for n, t in s["tenants"].items()}


def test_registry_tenants_share_one_program_as_jax(tmp_path):
    learner, spec, ens, X = _small_ensemble("decision_tree", jax.random.PRNGKey(1))
    Xn = np.asarray(X, np.float32)
    for sub in ("fedA", "fedB", "fedC"):
        jax_publish(tmp_path / sub, spec, ens, version=1)
    jreg, reg = _registries(tmp_path, ("fedA", "fedB", "fedC"))
    for sub in ("fedA", "fedB", "fedC"):
        np.testing.assert_array_equal(reg.predict(sub, Xn), jreg.predict(sub, Xn))
    s, js = reg.stats(), jreg.stats()
    assert _tenant_counts(s) == _tenant_counts(js)
    assert sum(t["compiles"] for t in s["tenants"].values()) == 1
    assert sum(t["cache_hits"] for t in s["tenants"].values()) == 2
    assert _stats_view(s["compile_cache"]) == _stats_view(js["compile_cache"])
    assert s["compile_cache"]["programs"] == 1


def test_registry_swap_reuses_the_program_and_a_rebuild_as_jax(tmp_path):
    _, spec, ens, X = _small_ensemble("ridge", jax.random.PRNGKey(2))
    _, _, ens2, _ = _small_ensemble("ridge", jax.random.PRNGKey(3))
    _, spec5, ens5, _ = _small_ensemble("ridge", jax.random.PRNGKey(5), T=5)
    Xn = np.asarray(X, np.float32)
    jax_publish(tmp_path / "fed", spec, ens, version=1)
    jreg, reg = _registries(tmp_path, ("fed",))
    reg.predict("fed", Xn), jreg.predict("fed", Xn)
    jax_publish(tmp_path / "fed", spec, ens2, version=2)
    assert reg.refresh() == jreg.refresh() == {"fed": 2}
    np.testing.assert_array_equal(reg.predict("fed", Xn), jreg.predict("fed", Xn))
    t, jt = reg.stats()["tenants"]["fed"], jreg.stats()["tenants"]["fed"]
    assert (t["swaps"], t["rebuilds"], t["compiles"] + t["cache_hits"]) == \
        (jt["swaps"], jt["rebuilds"], jt["compiles"] + jt["cache_hits"]) == (1, 0, 1)
    jax_publish(tmp_path / "fed", spec5, ens5, version=3)  # capacity 5: a rebuild
    assert reg.refresh() == jreg.refresh() == {"fed": 3}
    np.testing.assert_array_equal(reg.predict("fed", Xn), jreg.predict("fed", Xn))
    assert _tenant_counts(reg.stats()) == _tenant_counts(jreg.stats())
    assert _stats_view(reg.stats()["compile_cache"]) == _stats_view(jreg.stats()["compile_cache"])


def test_registry_quantized_tenant_shares_the_f32_program_as_jax(tmp_path):
    _, spec, ens, X = _small_ensemble("gaussian_nb", jax.random.PRNGKey(6))
    Xn = np.asarray(X, np.float32)
    jax_publish(tmp_path / "f32", spec, ens, version=1)
    jax_publish(tmp_path / "int8", spec, ens, version=1, quantize="int8", calibrate=Xn)
    jreg, reg = _registries(tmp_path, ("f32", "int8"))
    np.testing.assert_array_equal(reg.predict("int8", Xn), reg.predict("f32", Xn))
    np.testing.assert_array_equal(reg.predict("int8", Xn), jreg.predict("int8", Xn))
    jreg.predict("f32", Xn)
    s, js = reg.stats(), jreg.stats()
    assert _tenant_counts(s) == _tenant_counts(js)
    assert sum(t["compiles"] for t in s["tenants"].values()) == 1
    assert sum(t["cache_hits"] for t in s["tenants"].values()) == 1
