"""The port's multi-tenant registry, ``EngineConfig`` and the deadline
scheduler's per-request deadlines against the JAX package's, on the CPU.

Checkpoint streams are published by the JAX package (``publish_artifact``,
its quantized flavours included) or by either package's federations, and
the same bytes are served by both registries: the port's votes must equal
the JAX registry's outside the near-tie gap, and swaps and rebuilds are
counted as in the JAX package, as are the compile-cache counters of
``stats()`` (``tests/test_torch_compile_cache.py`` holds them to the JAX
registry's)."""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import boosting as jboost
from repro.core.plan import adaboost_plan as jax_adaboost_plan
from repro.data import get_dataset as jax_dataset
from repro.fl import elastic as jelastic
from repro.fl.federation import Federation as JaxFederation
from repro.fl.partition import iid_partition as jax_iid_partition
from repro.learners import LearnerSpec as JaxSpec
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ModelRegistry as JaxRegistry
from repro.serve import publish_artifact as jax_publish
from repro_torch.core.plan import adaboost_plan
from repro_torch.fl.elastic import FaultPlan, ParticipationPolicy
from repro_torch.fl.federation import Federation
from repro_torch.learners import LearnerSpec
from repro_torch.serve import (
    EngineConfig,
    ModelRegistry,
    ServeEngine,
    latest_artifact,
    load_artifact,
)
from test_serve import _blobs, _small_ensemble

B = 64
STATS_KEYS = {"version", "artifact", "swaps", "rebuilds", "requests", "batches", "compiles",
              "cache_hits"}


def _votes_agree(got, want, votes, what):
    """``got`` equals ``want`` on every row whose top two JAX votes are
    further apart than the float32 rounding of their sums (the near-tie
    gap); returns how many rows lie inside the gap."""
    v = np.sort(np.asarray(votes, np.float64), axis=-1)
    gap = v[:, -1] - v[:, -2]
    near = gap <= 1e-5 * np.maximum(np.abs(v).sum(-1), 1.0)
    bad = (got != want) & ~near
    assert not bad.any(), f"{what}: {int(bad.sum())} rows differ outside the near-tie gap"
    return int(near.sum())


def _registries(tmp_path, subs, **kw):
    jreg, reg = JaxRegistry(config=JaxEngineConfig(batch_size=B)), \
        ModelRegistry(config=EngineConfig(batch_size=B), device="cpu")
    for sub in subs:
        jreg.add_tenant(sub, tmp_path / sub, **kw)
        reg.add_tenant(sub, tmp_path / sub)
    return jreg, reg


def test_registry_multi_tenant_predict_and_stats(tmp_path):
    learner, spec, ens, X = _small_ensemble("decision_tree", jax.random.PRNGKey(1))
    Xn = np.array(X, np.float32)
    for sub in ("fedA", "fedB", "fedC"):
        jax_publish(tmp_path / sub, spec, ens, version=1)
    jreg, reg = _registries(tmp_path, ("fedA", "fedB", "fedC"))
    assert reg.tenants() == ["fedA", "fedB", "fedC"]
    votes = jboost.ensemble_votes(learner, spec, ens, X)
    for sub in ("fedA", "fedB", "fedC"):
        _votes_agree(reg.predict(sub, Xn), jreg.predict(sub, Xn), votes, sub)
    s = reg.stats()
    assert set(s) == {"tenants", "compile_cache"} == set(jreg.stats())
    assert set(s["compile_cache"]) == set(jreg.stats()["compile_cache"])
    for t in s["tenants"].values():
        assert set(t) == STATS_KEYS
        assert t["version"] == 1 and t["swaps"] == t["rebuilds"] == 0
        assert t["requests"] == len(Xn) and t["batches"] == -(-len(Xn) // B)
    with pytest.raises(KeyError, match="unknown tenant"):
        reg.predict("fedZ", Xn)
    with pytest.raises(ValueError, match="already registered"):
        reg.add_tenant("fedA", tmp_path / "fedA")
    with pytest.raises(ValueError, match="nothing published"):
        reg.add_tenant("empty", tmp_path / "nowhere")
    reg.remove_tenant("fedB")
    assert reg.tenants() == ["fedA", "fedC"]


def test_registry_hot_swap_on_publish(tmp_path):
    learner, spec, ens, X = _small_ensemble("ridge", jax.random.PRNGKey(2))
    Xn = np.array(X, np.float32)
    jax_publish(tmp_path / "fed", spec, ens, version=1)
    jreg, reg = _registries(tmp_path, ("fed",))
    engine = reg.engine("fed")
    reg.predict("fed", Xn)
    assert reg.refresh() == {} == jreg.refresh()  # nothing new published

    _, _, ens2, _ = _small_ensemble("ridge", jax.random.PRNGKey(3))
    jax_publish(tmp_path / "fed", spec, ens2, version=2)
    assert reg.refresh() == {"fed": 2} == jreg.refresh()
    assert reg.engine("fed") is engine  # swapped in place
    votes = jboost.ensemble_votes(learner, spec, ens2, X)
    _votes_agree(reg.predict("fed", Xn), jreg.predict("fed", Xn), votes, "swapped")
    t, jt = reg.stats()["tenants"]["fed"], jreg.stats()["tenants"]["fed"]
    assert (t["swaps"], t["rebuilds"], t["version"]) == (jt["swaps"], jt["rebuilds"], jt["version"]) \
        == (1, 0, 2)


@pytest.mark.parametrize("change", ["capacity", "committee"])
def test_registry_rebuilds_on_structural_change(tmp_path, change):
    """A capacity of 5 (leaf shapes change) or a DistBoost.F committee
    stream: ``update_ensemble`` refuses, and both registries rebuild."""
    learner, spec, ens, X = _small_ensemble("decision_tree", jax.random.PRNGKey(4))
    Xn = np.array(X, np.float32)
    jax_publish(tmp_path / "fed", spec, ens, version=1)
    jreg, reg = _registries(tmp_path, ("fed",))
    reg.predict("fed", Xn)
    kw = {"T": 5} if change == "capacity" else {"committee_size": 3}
    _, spec2, ens2, _ = _small_ensemble("decision_tree", jax.random.PRNGKey(5), **kw)
    jax_publish(tmp_path / "fed", spec2, ens2, version=2, committee_size=kw.get("committee_size"))
    assert reg.refresh() == {"fed": 2} == jreg.refresh()
    t, jt = reg.stats()["tenants"]["fed"], jreg.stats()["tenants"]["fed"]
    assert (t["rebuilds"], t["swaps"]) == (jt["rebuilds"], jt["swaps"]) == (1, 0)
    assert reg.engine("fed").committee == (change == "committee")
    votes = jboost.ensemble_votes(learner, spec2, ens2, X, committee=change == "committee")
    _votes_agree(reg.predict("fed", Xn), jreg.predict("fed", Xn), votes, change)


def test_registry_quantized_tenant_serves_the_f32_votes(tmp_path):
    """Dequantized int8 leaves keep float32 shapes: a quantized tenant
    serves its float32 twin's votes, in the port as in the JAX package."""
    learner, spec, ens, X = _small_ensemble("gaussian_nb", jax.random.PRNGKey(6))
    Xn = np.array(X, np.float32)
    jax_publish(tmp_path / "f32", spec, ens, version=1)
    jax_publish(tmp_path / "int8", spec, ens, version=1, quantize="int8", calibrate=Xn)
    jreg, reg = _registries(tmp_path, ("f32", "int8"))
    np.testing.assert_array_equal(reg.predict("int8", Xn), reg.predict("f32", Xn))
    votes = jboost.ensemble_votes(learner, spec, ens, X)
    _votes_agree(reg.predict("int8", Xn), jreg.predict("int8", Xn), votes, "int8")


@pytest.fixture(scope="module")
def vehicle():
    dspec, (Xtr, ytr, Xte, yte) = jax_dataset("vehicle", jax.random.PRNGKey(0))
    Xs, ys, masks = jax_iid_partition(Xtr, ytr, 4, jax.random.PRNGKey(1))
    return [np.array(a) for a in (Xs, ys, masks, Xte, yte)], dspec


LATE = dict(deadline_s=0.5, staleness_gamma=0.5, max_staleness=2)
LATE_FAULTS = dict(seed=3, delay_p=0.4, delay_range_s=(0.6, 1.4))
HP = {"depth": 3, "n_bins": 8}


def test_jax_elastic_stream_rebuilds_where_a_lockstep_stream_swaps(tmp_path, vehicle):
    """A JAX federation's lockstep stream (publish every 2) hot-swaps in the
    port's registry, refreshed at every checkpoint; the JAX elastic run's
    late-merge budget grows the capacity, so its first checkpoint into the
    same directory rebuilds, and the next swaps again.  Both registries
    count alike and serve the same votes outside the near-tie gap."""
    (Xs, ys, masks, Xte, yte), dspec = vehicle
    spec = JaxSpec("decision_tree", dspec.n_features, dspec.n_classes, HP)
    jreg = reg = None
    pub = tmp_path / "stream"

    def on_checkpoint(path, r):
        nonlocal jreg, reg
        if reg is None:
            jreg, reg = _registries(tmp_path, ("stream",))
        else:
            assert reg.refresh() == jreg.refresh() == {"stream": r}

    args = [jnp.asarray(a) for a in (Xs, ys, masks, Xte, yte)]
    JaxFederation(jax_adaboost_plan(rounds=4), *args, spec, jax.random.PRNGKey(2)).run(
        eval_every=4, publish_every=2, publish_dir=str(pub), on_checkpoint=on_checkpoint)
    assert reg.stats()["tenants"]["stream"]["swaps"] == 1
    fed = JaxFederation(jax_adaboost_plan(rounds=10), *args, spec, jax.random.PRNGKey(2))
    fed.run(eval_every=10, publish_every=5, publish_dir=str(pub), on_checkpoint=on_checkpoint,
            policy=jelastic.ParticipationPolicy(**LATE), faults=jelastic.FaultPlan(**LATE_FAULTS))
    assert fed.elastic.late_log  # the capacity grew
    t, jt = reg.stats()["tenants"]["stream"], jreg.stats()["tenants"]["stream"]
    assert (t["swaps"], t["rebuilds"]) == (jt["swaps"], jt["rebuilds"]) == (2, 1)
    art = load_artifact(latest_artifact(pub), "cpu")
    assert art.ensemble.alpha.shape[0] == 10 + int(np.sum(
        jelastic.FaultPlan(**LATE_FAULTS).schedule(10, 4).delay > 0.5))
    from repro.serve import load_artifact as jax_load

    jart = jax_load(latest_artifact(pub))
    votes = jboost.ensemble_votes(jart.learner, jart.spec, jart.ensemble, jnp.asarray(Xte))
    _votes_agree(reg.predict("stream", Xte), jreg.predict("stream", Xte), votes, "elastic stream")


def test_port_elastic_stream_swaps_without_deadline_and_rebuilds_with_one(tmp_path, vehicle):
    """The port's own federations: an elastic run with no deadline keeps the
    lockstep capacity and swaps; one with a deadline and stragglers grows
    it and rebuilds."""
    (Xs, ys, masks, Xte, yte), dspec = vehicle
    spec = LearnerSpec("decision_tree", dspec.n_features, dspec.n_classes, HP)
    reg = ModelRegistry(config=EngineConfig(batch_size=B), device="cpu")
    pub = tmp_path / "stream"
    seen = []

    def on_checkpoint(path, r):
        if not reg.tenants():
            reg.add_tenant("s", pub)
        else:
            seen.append(reg.refresh("s"))

    for rounds, policy, faults in [(4, ParticipationPolicy(), None),
                                   (8, ParticipationPolicy(**LATE), FaultPlan(**LATE_FAULTS))]:
        fed = Federation(adaboost_plan(rounds=rounds), Xs, ys, masks, Xte, yte, spec, device="cpu")
        fed.run(eval_every=rounds, publish_every=2 if rounds == 4 else 3, publish_dir=str(pub),
                on_checkpoint=on_checkpoint, policy=policy, faults=faults)
    # v2 added, v4 swapped; then v3 (capacity 8 + the late budget) rebuilt,
    # v6 and v8 swapped
    assert seen == [{"s": 4}, {"s": 3}, {"s": 6}, {"s": 8}]
    t = reg.stats()["tenants"]["s"]
    assert (t["swaps"], t["rebuilds"]) == (3, 1)
    want = ServeEngine.from_artifact(load_artifact(latest_artifact(pub), "cpu")).predict(Xte)
    np.testing.assert_array_equal(reg.predict("s", Xte), want)


# -- EngineConfig ------------------------------------------------------------------


def test_engine_config_conflicts_and_mesh_raise(tmp_path):
    learner, spec, ens, X = _small_ensemble("decision_tree", jax.random.PRNGKey(7))
    path = jax_publish(tmp_path / "p", spec, ens, version=1)
    art = load_artifact(path, "cpu")
    cfg = EngineConfig(batch_size=32, t_max_s=0.01)
    engine = ServeEngine.from_artifact(art, config=cfg)
    assert engine.batch_size == 32 and engine.config is cfg and not engine.committee
    assert engine.scheduler().t_max_s == 0.01
    engine.scheduler().close()
    with pytest.raises(ValueError, match="not alongside"):
        ServeEngine(art.learner, art.spec, art.ensemble, batch_size=16, config=cfg)
    with pytest.raises(ValueError, match="not alongside"):
        ServeEngine.from_artifact(art, batch_size=16, config=cfg)
    with pytest.raises(ValueError, match="contradicts the artifact"):
        ServeEngine.from_artifact(art, config=dataclasses.replace(cfg, committee=True))
    # a mesh is a launch/mesh.Mesh (tests/test_torch_sharded.py serves through one)
    with pytest.raises(TypeError, match="launch/mesh.Mesh"):
        ServeEngine.from_artifact(art, config=dataclasses.replace(cfg, mesh=object()))
    with pytest.raises(TypeError, match="launch/mesh.Mesh"):
        ModelRegistry(config=EngineConfig(mesh="data"), device="cpu").add_tenant("m", tmp_path / "p")
    # the defaults are the JAX package's
    jcfg = JaxEngineConfig()
    assert (EngineConfig().batch_size, EngineConfig().committee, EngineConfig().t_max_s) == \
        (jcfg.batch_size, jcfg.committee, jcfg.t_max_s)


# -- per-request deadlines and drain --------------------------------------------------


def _warm_engine():
    from repro_torch import convert
    from repro_torch.learners import get_learner

    learner, spec, ens, X = _small_ensemble("decision_tree", jax.random.PRNGKey(5))
    arrays = {k: np.asarray(getattr(ens.params, k)) for k in ("feature", "threshold", "leaf_logits")}
    arrays.update(alpha=np.asarray(ens.alpha), count=np.asarray(ens.count))
    tspec = LearnerSpec(spec.name, spec.n_features, spec.n_classes, spec.hparams)
    engine = ServeEngine(get_learner("decision_tree"), tspec,
                         convert.ensemble_from_numpy(arrays, device="cpu"), batch_size=B)
    Xn = np.array(X, np.float32)
    return engine, Xn, engine.predict(Xn)


def test_requests_carry_their_own_deadlines():
    engine, X, want = _warm_engine()
    with engine.scheduler(t_max_s=60.0) as sched:
        (rid,) = sched.submit(X[0], deadline_s=0.05)  # urgent override
        assert sched.result(rid, timeout_s=10.0) == want[0]
    # ...and the earliest deadline triggers even when it is NOT the queue head
    with engine.scheduler(t_max_s=60.0) as sched:
        (slow,) = sched.submit(X[0])  # head: 60 s deadline
        (fast,) = sched.submit(X[1], deadline_s=0.05)
        assert sched.result(slow, timeout_s=10.0) == want[0]
        assert sched.result(fast, timeout_s=10.0) == want[1]


def test_drain_waits_for_every_answer():
    engine, X, want = _warm_engine()
    with engine.scheduler(t_max_s=0.02) as sched:
        ids = []
        for i in range(0, X.shape[0], 7):  # a ragged stream, no flush
            ids.extend(sched.submit(X[i:i + 7], deadline_s=0.01 if i % 2 else None))
        t0 = time.perf_counter()
        sched.drain()
        assert time.perf_counter() - t0 < 10.0
        # every answer is in before any result() call, and stays to be read
        assert not sched._queue and not sched._inflight and set(sched._results) == set(ids)
        np.testing.assert_array_equal(sched.results(ids), want)
    assert engine.stats.request_latencies.count == X.shape[0]
