"""The port's serving slice against the JAX package's, on the CPU.

Ensembles are numpy random trees carried into both packages
(``repro_torch.convert``), never trained with ``jax.random``.  Artifacts
go both ways: a JAX-written file (v1, v3 int8 and bf16 with calibration)
loads in the port and its engine, deadline scheduler and vote cache give
exactly the JAX engine's votes; the port writes byte-identical files
that the JAX package loads and serves the same.  Errors carry JAX's
messages; the flavours the port leaves out name the ROADMAP item that
brings them.  Then the port's engine and cache behaviour, checkpoint
publishing (read back by JAX) and the ``serve_fl`` CLI."""
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as jboost
from repro.core.hetero import HeterogeneousSpec, init_hetero_ensemble
from repro.core.serialization import wire_size as jax_wire_size
from repro.learners import LearnerSpec as JaxSpec
from repro.learners import get_learner as jax_learner
from repro.learners.tree import TreeParams as JaxTreeParams
from repro.serve import ServeEngine as JaxEngine
from repro.serve import ShardVoteCache as JaxCache
from repro.serve import load_artifact as jax_load
from repro.serve import save_artifact as jax_save
from repro_torch import convert
from repro_torch.core.plan import adaboost_plan
from repro_torch.fl.federation import Federation
from repro_torch.kernels import ops
from repro_torch.learners import LearnerSpec, get_learner
from repro_torch.serve import (
    ServeEngine,
    ShardVoteCache,
    latest_artifact,
    load_artifact,
    save_artifact,
)
from repro_torch.serve.artifact import LATEST

D, K, DEPTH, T, COUNT = 5, 4, 3, 6, 4
HP = {"depth": DEPTH, "n_bins": 16}
B = 32


def random_ensemble_arrays(seed=0, T=6, count=4, depth=3, d=5, K=4, committee=None):
    """Numpy random trees: ``feature`` in [0, d), Gaussian thresholds and
    leaf logits, alpha on the used slots, zeros beyond ``count``; with
    ``committee`` C, each slot is a DistBoost.F committee of C trees."""
    rng = np.random.default_rng(seed)
    lead = (T,) if committee is None else (T, committee)
    live = (np.arange(T) < count).reshape((T,) + (1,) * (len(lead) - 1))
    return {
        "feature": (rng.integers(0, d, size=lead + (depth,)) * live[..., None]).astype(np.int32),
        "threshold": (rng.normal(size=lead + (depth,)) * live[..., None]).astype(np.float32),
        "leaf_logits": (rng.normal(size=lead + (2**depth, K)) * live[..., None, None]).astype(np.float32),
        "alpha": (rng.uniform(0.2, 2.0, size=T) * (np.arange(T) < count)).astype(np.float32),
        "count": np.asarray(count, np.int32),
    }


def jax_ensemble(a):
    return jboost.Ensemble(
        params=JaxTreeParams(jnp.asarray(a["feature"]), jnp.asarray(a["threshold"]),
                             jnp.asarray(a["leaf_logits"])),
        alpha=jnp.asarray(a["alpha"]),
        count=jnp.asarray(a["count"]),
    )


@pytest.fixture(scope="module")
def model():
    a = random_ensemble_arrays(7, T=T, count=COUNT, depth=DEPTH, d=D, K=K)
    X = np.random.default_rng(8).normal(size=(150, D)).astype(np.float32)
    jspec = JaxSpec("decision_tree", D, K, HP)
    jens = jax_ensemble(a)
    want = np.asarray(JaxEngine(jax_learner("decision_tree"), jspec, jens, batch_size=B).predict(X))
    return {"arrays": a, "X": X, "jspec": jspec, "jens": jens, "want": want,
            "spec": LearnerSpec("decision_tree", D, K, HP)}


def _port_engine(art_or_ens, spec=None, batch_size=B):
    if spec is None:
        return ServeEngine.from_artifact(art_or_ens, batch_size=batch_size)
    return ServeEngine(get_learner("decision_tree"), spec, art_or_ens, batch_size=batch_size)


QUANT = [(None, False), ("int8", True), ("bf16", True)]


@pytest.mark.parametrize("quantize,calibrate", QUANT, ids=["v1", "int8", "bf16"])
def test_jax_artifact_serves_identically_in_the_port(model, tmp_path, quantize, calibrate):
    path = jax_save(tmp_path / "j.mafl", model["jspec"], model["jens"],
                    extra={"dataset": "test"}, quantize=quantize,
                    calibrate=model["X"] if calibrate else None)
    jart = jax_load(path)
    want = np.asarray(JaxEngine.from_artifact(jart, batch_size=B).predict(model["X"]))
    if quantize is None:
        np.testing.assert_array_equal(want, model["want"])
    art = load_artifact(path, "cpu")
    assert art.manifest == jart.manifest and art.ensemble.count == COUNT
    engine = _port_engine(art)
    np.testing.assert_array_equal(engine.predict(model["X"]), want)
    with engine.scheduler(t_max_s=0.002) as sched:
        ids = []
        for i in range(0, 150, 37):  # ragged requests
            ids.extend(sched.submit(model["X"][i : i + 37]))
        np.testing.assert_array_equal(sched.results(ids, timeout_s=60), want)
    cache = ShardVoteCache.from_artifact(art)
    np.testing.assert_array_equal(cache.predict("s", model["X"]), want)
    np.testing.assert_array_equal(
        np.asarray(JaxCache.from_artifact(jart).predict("s", model["X"])), want)


@pytest.mark.parametrize("quantize,calibrate", QUANT, ids=["v1", "int8", "bf16"])
def test_port_artifact_is_byte_identical_and_serves_in_jax(model, tmp_path, quantize, calibrate):
    cal = model["X"] if calibrate else None
    ens = convert.ensemble_from_numpy(model["arrays"], device="cpu")
    p = save_artifact(tmp_path / "t.mafl", model["spec"], ens, extra={"dataset": "test"},
                      quantize=quantize, calibrate=cal)
    j = jax_save(tmp_path / "j.mafl", model["jspec"], model["jens"], extra={"dataset": "test"},
                 quantize=quantize, calibrate=cal)
    assert p.read_bytes() == j.read_bytes()
    jart = jax_load(p)
    got = np.asarray(JaxEngine.from_artifact(jart, batch_size=B).predict(model["X"]))
    np.testing.assert_array_equal(got, _port_engine(load_artifact(p, "cpu")).predict(model["X"]))


@pytest.mark.parametrize("quantize,calibrate", QUANT, ids=["v1", "int8", "bf16"])
def test_committee_artifacts_are_byte_identical_both_ways(model, tmp_path, quantize, calibrate):
    """DistBoost.F committee artifacts (slots of C = 3 trees) in v1 and v3:
    the port writes the JAX package's bytes; each package loads the other's
    file, and the port's engine and vote cache answer what the JAX engine
    and ``strong_predict(committee=True)`` answer."""
    a = random_ensemble_arrays(12, T=T, count=COUNT, depth=DEPTH, d=D, K=K, committee=3)
    cal = model["X"] if calibrate else None
    ens = convert.ensemble_from_numpy(a, device="cpu")
    p = save_artifact(tmp_path / "t.mafl", model["spec"], ens, committee_size=3,
                      extra={"dataset": "test"}, quantize=quantize, calibrate=cal)
    j = jax_save(tmp_path / "j.mafl", model["jspec"], jax_ensemble(a), committee_size=3,
                 extra={"dataset": "test"}, quantize=quantize, calibrate=cal)
    assert p.read_bytes() == j.read_bytes()
    jart, art = jax_load(p), load_artifact(j, "cpu")
    assert jart.committee_size == art.committee_size == 3 and art.manifest == jart.manifest
    want = np.asarray(JaxEngine.from_artifact(jart, batch_size=B).predict(model["X"]))
    if quantize is None:
        np.testing.assert_array_equal(want, np.asarray(jboost.strong_predict(
            jax_learner("decision_tree"), model["jspec"], jax_ensemble(a), jnp.asarray(model["X"]),
            committee=True)))
    np.testing.assert_array_equal(_port_engine(art).predict(model["X"]), want)
    np.testing.assert_array_equal(ShardVoteCache.from_artifact(art).predict("s", model["X"]), want)
    from repro_torch.core import boosting as tboost

    np.testing.assert_array_equal(
        tboost.strong_predict(art.learner, art.spec, art.ensemble, torch.from_numpy(model["X"]),
                              committee=True).numpy(), want)


def test_committee_save_checks_the_committee_size(model, tmp_path):
    a = random_ensemble_arrays(13, T=T, count=COUNT, depth=DEPTH, d=D, K=K, committee=3)
    with pytest.raises(ValueError, match="template"):
        save_artifact(tmp_path / "x.mafl", model["spec"], convert.ensemble_from_numpy(a, device="cpu"),
                      committee_size=2)
    with pytest.raises(ValueError, match="template"):
        save_artifact(tmp_path / "y.mafl", model["spec"], convert.ensemble_from_numpy(a, device="cpu"))


def test_port_calibration_promotes_the_same_slots_as_jax(model, tmp_path):
    """bf16 leaf logits can flip near-tied leaves: the calibration falls
    back to the same plans on both sides."""
    a = dict(model["arrays"])
    logits = a["leaf_logits"].copy()
    logits[:, :, 1] = logits[:, :, 0] + 1e-4  # every leaf row a near-tie bf16 breaks
    a["leaf_logits"] = logits
    spec, jspec = model["spec"], model["jspec"]
    p = save_artifact(tmp_path / "t.mafl", spec, convert.ensemble_from_numpy(a, device="cpu"),
                      quantize="bf16", calibrate=model["X"])
    j = jax_save(tmp_path / "j.mafl", jspec, jax_ensemble(a), quantize="bf16",
                 calibrate=model["X"])
    assert p.read_bytes() == j.read_bytes()
    assert load_artifact(p, "cpu").manifest["leaf_codecs"] == jax_load(j).manifest["leaf_codecs"]


def _corrupt(data: bytes, how: str) -> bytes:
    mlen = struct.unpack("<I", data[8:12])[0]
    manifest = json.loads(data[12 : 12 + mlen])
    if how == "magic":
        return b"NOTMAFL!" + data[8:]
    if how == "header":
        return data[:10]
    if how == "manifest":
        return data[: 12 + mlen // 2]
    if how == "payload":
        return data[:-3]
    if how == "crc":
        return data[:-3] + bytes([data[-3] ^ 0xFF]) + data[-2:]
    manifest["format_version"] = 4 if how == "newer" else manifest["format_version"]
    if how == "learner":
        manifest["learner"] = "mystery_forest"
    if how == "keys":
        del manifest["payload_crc32"]
    blob = json.dumps(manifest, sort_keys=True).encode()
    return data[:8] + struct.pack("<I", len(blob)) + blob + data[12 + mlen :]


@pytest.mark.parametrize("how", ["magic", "header", "manifest", "payload", "crc", "newer",
                                 "keys", "learner"])
def test_artifact_errors_match_jax(model, tmp_path, how):
    data = jax_save(tmp_path / "j.mafl", model["jspec"], model["jens"]).read_bytes()
    bad = tmp_path / "bad.mafl"
    bad.write_bytes(_corrupt(data, how))
    with pytest.raises(ValueError) as port_err:
        load_artifact(bad, "cpu")
    with pytest.raises(ValueError) as jax_err:
        jax_load(bad)
    if how == "learner":  # the registries differ; the message's head does not
        head = f"{bad}: unknown learner key 'mystery_forest'; registered: "
        assert str(port_err.value).startswith(head) and str(jax_err.value).startswith(head)
    else:
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("flavour", ["heterogeneous", "committee"])
def test_artifact_rejects_unported_flavours_naming_the_item(model, tmp_path, flavour):
    """The two flavours once refused, naming their items, now load:
    heterogeneous (v2) artifacts since item 10 (each group's ensemble as
    saved), committee (DistBoost.F) artifacts since item 7, predicting
    what the JAX package's ``strong_predict(committee=True)`` predicts."""
    key = jax.random.PRNGKey(0)
    if flavour == "heterogeneous":
        hspec = HeterogeneousSpec.cycle(["decision_tree", "ridge"], 2, D, K,
                                        hparams={"decision_tree": HP, "ridge": {}})
        path = jax_save(tmp_path / "h.mafl", hspec, init_hetero_ensemble(hspec, 3, key))
        art = load_artifact(path, "cpu")
        assert art.hetero and art.learner is None and art.spec.names == hspec.names
        assert [e.alpha.shape[0] for e in art.ensemble] == [3, 3]
        assert art.spec.assignment == hspec.assignment
        return
    a = random_ensemble_arrays(11, T=T, count=COUNT, depth=DEPTH, d=D, K=K, committee=3)
    path = jax_save(tmp_path / "c.mafl", model["jspec"], jax_ensemble(a), committee_size=3)
    art = load_artifact(path, "cpu")
    assert art.committee and art.committee_size == 3
    want = np.asarray(jboost.strong_predict(jax_learner("decision_tree"), model["jspec"],
                                            jax_ensemble(a), jnp.asarray(model["X"]), committee=True))
    np.testing.assert_array_equal(_port_engine(art).predict(model["X"]), want)


def test_save_artifact_rejects_a_foreign_structure(model, tmp_path):
    a = random_ensemble_arrays(9, T=T, count=2, depth=DEPTH + 1, d=D, K=K)
    with pytest.raises(ValueError, match="template"):
        save_artifact(tmp_path / "x.mafl", model["spec"], convert.ensemble_from_numpy(a, device="cpu"))


# -- engine and cache behaviour ----------------------------------------------


def test_engine_pads_the_ragged_tail(model):
    engine = _port_engine(convert.ensemble_from_numpy(model["arrays"], device="cpu"), model["spec"])
    got = engine.predict(model["X"][:70])
    np.testing.assert_array_equal(got, model["want"][:70])
    assert (engine.stats.batches, engine.stats.padded_rows, engine.stats.requests) == (3, 26, 70)
    ids = engine.submit(model["X"][:40])  # one full batch runs at once
    assert engine.stats.batches == 4 and len(engine.results) == 32
    engine.flush()
    assert engine.stats.batches == 5 and engine.stats.padded_rows == 26 + 24
    np.testing.assert_array_equal([engine.take(i) for i in ids], model["want"][:40])
    assert engine.results == {} and engine.stats.request_latencies.count == 40


def test_engine_counts_no_launch_on_the_cpu(model):
    engine = _port_engine(convert.ensemble_from_numpy(model["arrays"], device="cpu"), model["spec"])
    before = ops.launch_counts()["vote_argmax"]
    engine.warmup()
    engine.predict(model["X"])
    assert ops.launch_counts()["vote_argmax"] == before
    assert engine.stats.warmup_batches == 1 and engine.stats.batches == 5


def test_update_ensemble_accepts_an_append_and_rejects_a_foreign_structure(model):
    a = dict(model["arrays"])
    small = dict(a, alpha=a["alpha"] * (np.arange(T) < 2), count=np.asarray(2, np.int32))
    engine = _port_engine(convert.ensemble_from_numpy(small, device="cpu"), model["spec"])
    before = engine.predict(model["X"])
    engine.update_ensemble(convert.ensemble_from_numpy(a, device="cpu"))  # members 2, 3 appended
    np.testing.assert_array_equal(engine.predict(model["X"]), model["want"])
    assert not np.array_equal(before, model["want"])
    deeper = random_ensemble_arrays(3, T=T, count=COUNT, depth=DEPTH + 1, d=D, K=K)
    with pytest.raises(ValueError, match="structure"):
        engine.update_ensemble(convert.ensemble_from_numpy(deeper, device="cpu"))
    wider = random_ensemble_arrays(3, T=T + 1, count=COUNT, depth=DEPTH, d=D, K=K)
    with pytest.raises(ValueError, match="structure"):
        engine.update_ensemble(convert.ensemble_from_numpy(wider, device="cpu"))


def test_scheduler_records_each_request_queue_wait(model):
    engine = _port_engine(convert.ensemble_from_numpy(model["arrays"], device="cpu"), model["spec"])
    with engine.scheduler(t_max_s=0.02) as sched:
        ids = sched.submit(model["X"][:5])  # a partial batch: it waits out its deadline
        np.testing.assert_array_equal(sched.results(ids, timeout_s=60), model["want"][:5])
        assert sched.queue_wait.count == 5 and sched.queue_wait.quantile(0.0) >= 0.02
        ids = sched.submit(model["X"][:B])  # a full batch dispatches at once
        np.testing.assert_array_equal(sched.results(ids, timeout_s=60), model["want"][:B])
    assert sched.queue_wait.count == 5 + B
    assert engine.stats.request_latencies.count == 5 + B


def _grown(a, count):
    return dict(a, alpha=a["alpha"] * (np.arange(T) < count), count=np.asarray(count, np.int32))


def test_cache_counts_match_jax_for_one_request_sequence(model):
    a = random_ensemble_arrays(11, T=T, count=T, depth=DEPTH, d=D, K=K)
    X, X2 = model["X"][:60], model["X"][60:100]
    port = ShardVoteCache(*_learner_spec(model), convert.ensemble_from_numpy(_grown(a, 2), device="cpu"))
    jcache = JaxCache(jax_learner("decision_tree"), model["jspec"], jax_ensemble(_grown(a, 2)))
    steps = [("predict", "s", X), ("predict", "s", None), ("grow", 4), ("predict", "s", None),
             ("predict", "t", X2), ("predict", "s", X2), ("grow", 6), ("predict", "s", None),
             ("predict", "t", None), ("predict", "t", None)]
    for step in steps:
        if step[0] == "grow":
            port.update_ensemble(convert.ensemble_from_numpy(_grown(a, step[1]), device="cpu"))
            jcache.update_ensemble(jax_ensemble(_grown(a, step[1])))
            continue
        _, key, rows = step
        np.testing.assert_array_equal(port.predict(key, rows), np.asarray(jcache.predict(key, rows)))
        assert port.stats() == jcache.stats()
    assert port.stats() == {"shards": 2, "hits": 2, "partial_hits": 3, "misses": 3,
                            "members_folded": 16, "reregistrations": 1}


def _learner_spec(model):
    return get_learner("decision_tree"), model["spec"]


def test_cache_rejects_a_changed_tallied_member(model):
    a = model["arrays"]
    cache = ShardVoteCache(*_learner_spec(model), convert.ensemble_from_numpy(a, device="cpu"))
    cache.predict("s", model["X"])
    changed = dict(a, alpha=a["alpha"].copy())
    changed["alpha"][0] += 0.25
    with pytest.raises(ValueError, match="append-only"):
        cache.update_ensemble(convert.ensemble_from_numpy(changed, device="cpu"))
    with pytest.raises(ValueError, match="shrank"):
        cache.update_ensemble(convert.ensemble_from_numpy(_grown(a, 2), device="cpu"))


# -- publishing ---------------------------------------------------------------


def _shards(seed=0, C=3, n=60, d=D, n_test=50):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, K)).astype(np.float32)

    def draw(m):
        X = rng.normal(size=(m, d)).astype(np.float32)
        return X, np.argmax(X @ W + 0.5 * rng.normal(size=(m, K)), -1).astype(np.int32)

    Xs, ys = zip(*(draw(n) for _ in range(C)))
    Xte, yte = draw(n_test)
    return np.stack(Xs), np.stack(ys), np.ones((C, n), np.float32), Xte, yte


def test_federation_publishes_a_stream_jax_reads(model, tmp_path):
    Xs, ys, masks, Xte, yte = _shards()
    fed = Federation(adaboost_plan(rounds=5), Xs, ys, masks, Xte, yte, model["spec"], device="cpu")
    seen = []
    hist = fed.run(eval_every=5, publish_every=2, publish_dir=tmp_path,
                   on_checkpoint=lambda p, r: seen.append((p.name, r)))
    names = ["ensemble_v000002.mafl", "ensemble_v000004.mafl", "ensemble_v000005.mafl"]
    assert seen == list(zip(names, [2, 4, 5]))
    assert latest_artifact(tmp_path).name == names[-1] == (tmp_path / LATEST).read_text()
    for name, r in zip(names, [2, 4, 5]):
        art = jax_load(tmp_path / name)
        assert art.manifest["ensemble_count"] == r == int(art.ensemble.count)
        assert art.manifest["round"] == r and art.manifest["algorithm"] == "adaboost_f"
        assert art.manifest["publish_version"] == r
    # the last checkpoint is the final ensemble, and serves as JAX's engine does
    final = load_artifact(tmp_path / names[-1], "cpu")
    want = np.asarray(JaxEngine.from_artifact(jax_load(tmp_path / names[-1]), batch_size=B)
                      .predict(Xte))
    np.testing.assert_array_equal(_port_engine(final).predict(Xte), want)
    # comm_bytes: the JAX fused path's AdaBoost.F model (fl/federation.py)
    C = 3
    jtemplate = jboost.init_ensemble(jax_learner("decision_tree"), model["jspec"], 5,
                                     jax.random.PRNGKey(0))
    h = jax_wire_size(jtemplate.params) // 5
    per_round = C * h + C * h * (C - 1) + (h + 8) * C
    assert fed.comm_bytes == 5 * per_round and hist[-1]["comm_bytes"] == 5 * per_round


def test_distboost_publishes_committee_artifacts_that_serve_fl_serves(tmp_path):
    """``fl_run --algorithm distboost_f --publish-every`` writes committee
    artifacts (``committee_size`` C) that the JAX package reads and serves
    as the port does, and ``serve_fl --artifact ... --load`` serves them:
    the engine, the vote cache and the federation's own last F1 agree."""
    from repro_torch.data import get_dataset
    from repro_torch.launch import fl_run, serve_fl

    pub = tmp_path / "pub"
    hist = fl_run.main(["--dataset", "vehicle", "--collaborators", "3", "--rounds", "4",
                        "--eval-every", "4", "--depth", "3", "--algorithm", "distboost_f",
                        "--publish-every", "4", "--publish-dir", str(pub), "--device", "cpu"])
    path = latest_artifact(pub)
    jart = jax_load(path)
    assert jart.committee_size == 3 and jart.manifest["algorithm"] == "distboost_f"
    assert tuple(jart.ensemble.params.feature.shape) == (4, 3, 3)
    out = serve_fl.main(["--dataset", "vehicle", "--artifact", str(path), "--load", "--batch", "64",
                         "--cache-repeats", "2", "--device", "cpu"])
    _, (_, _, X_test, _) = get_dataset("vehicle", torch.Generator().manual_seed(0))
    want = np.asarray(JaxEngine.from_artifact(jart, batch_size=64).predict(X_test.numpy()))
    np.testing.assert_array_equal(out["pred"], want)
    assert out["f1"] == hist[-1]["f1"]


def test_publish_every_needs_a_directory(model):
    Xs, ys, masks, Xte, yte = _shards()
    fed = Federation(adaboost_plan(rounds=2), Xs, ys, masks, Xte, yte, model["spec"], device="cpu")
    with pytest.raises(ValueError, match="publish_dir"):
        fed.run(publish_every=1)
    with pytest.raises(ValueError, match="positive"):
        fed.run(publish_every=0, publish_dir="x")


# -- the CLI --------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["sync", "deadline"])
def test_serve_fl_cli_trains_saves_loads_and_serves(tmp_path, policy):
    from repro_torch.launch import serve_fl

    common = ["--dataset", "vehicle", "--rounds", "3", "--depth", "3", "--batch", "64",
              "--cache-repeats", "2", "--device", "cpu", "--policy", policy]
    path = tmp_path / "v.mafl"
    first = serve_fl.main(common + ["--artifact", str(path)])
    loaded = serve_fl.main(common + ["--artifact", str(path), "--load",
                                     "--metrics-out", str(tmp_path / "m.txt")])
    np.testing.assert_array_equal(first["pred"], loaded["pred"])
    assert first["f1"] == loaded["f1"] and 0.0 < first["f1"] <= 1.0
    assert loaded["stats"].batches == -(-169 // 64) and loaded["stats"].requests == 169
    assert "mafl_engine_batches_total" in (tmp_path / "m.txt").read_text()
    art = jax_load(path)  # the JAX package reads what the port's CLI wrote
    assert art.manifest["dataset"] == "vehicle" and art.manifest["ensemble_count"] == 3


def test_serve_fl_cli_publish_loop(tmp_path):
    from repro_torch.launch import serve_fl
    from repro_torch.obs import trace

    try:
        out = serve_fl.main(["--dataset", "vehicle", "--rounds", "4", "--depth", "3",
                             "--publish-every", "2", "--publish-dir", str(tmp_path),
                             "--device", "cpu", "--policy", "deadline",
                             "--trace", str(tmp_path / "t.json")])
    finally:  # --trace turns the process tracer on; leave it as found
        trace.disable()
        trace.reset()
    assert [c[:2] for c in out["checkpoints"]] == [(2, 2), (4, 4)]
    assert out["cache"]["members_folded"] == 4 and out["cache"]["partial_hits"] == 1
    spans = {e["name"] for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]}
    assert {"round", "round.publish", "serve.batch", "serve.dispatch", "serve.hot_swap",
            "vote_cache.refresh", "vote_cache.register"} <= spans


def test_serve_fl_cli_quantized_artifact_serves_the_f32_votes(tmp_path):
    from repro_torch.launch import serve_fl

    common = ["--dataset", "vehicle", "--rounds", "3", "--depth", "3", "--device", "cpu",
              "--cache-repeats", "1"]
    f32 = serve_fl.main(common + ["--artifact", str(tmp_path / "a.mafl")])
    q = serve_fl.main(common + ["--artifact", str(tmp_path / "q.mafl"), "--quantize", "int8"])
    np.testing.assert_array_equal(f32["pred"], q["pred"])
    assert (tmp_path / "q.mafl").stat().st_size < (tmp_path / "a.mafl").stat().st_size


@pytest.mark.parametrize("policy", ["sync", "deadline"])
def test_serve_fl_cli_serves_the_split_again_for_a_window(tmp_path, policy):
    from repro_torch.launch import serve_fl

    out = serve_fl.main(["--dataset", "vehicle", "--rounds", "2", "--depth", "3", "--batch", "64",
                         "--cache-repeats", "1", "--device", "cpu", "--policy", policy,
                         "--serve-seconds", "0.3"])
    assert out["requests"] % 169 == 0 and out["requests"] > 169 and out["seconds"] >= 0.3
    assert out["stats"].request_latencies.count == out["requests"]
    assert ("wait_p99_ms" in out) == (policy == "deadline")
