"""The port's SPMD round and mesh engine (``repro_torch/fl/sharded.py``,
``launch/mesh.py``, ``serve/engine.py``'s mesh backend, ``fl_run
--sharded``) against the JAX package's ``shard_map`` round, on the CPU.

The JAX side runs in a subprocess under
``--xla_force_host_platform_device_count=8``, as ``tests/test_sharded.py``
runs it: vehicle, 4 collaborators, depth-4 trees, 6 rounds, meshes
``(4, 2)`` and ``(4, 1)``.  The port's side runs the same numpy inputs on N
gloo ranks, one subprocess a rank (8 for ``(4, 2)``, 4 for ``(4, 1)``).

Tolerances.  Against the JAX round: the chosen sequence equal, alpha
within ``rtol=1e-5`` (the parity harness's weight-update tolerance) and F1
equal on the shard-truncated test set.  Against the port's own fused round
the reduction order differs, so the bits may too: the sharded round fits
on the shard's weights rescaled to its sample count (the JAX round's
``w_fit``), sums the errors across ranks in gloo's all-reduce order and
renormalises by a sum of per-shard sums, where the fused round fits on the
global weights and its ``weight_update`` sums all C·n weights in one
reduction.  So it is held at the same tolerances (weights at
``rtol=1e-4``, as ``tests/test_sharded.py`` holds the JAX pair), not bit
for bit.  ``packed_broadcast`` on and off, and every rank of the mesh,
give the same bits.  The mesh engine's answers equal the local engine's
bit for bit.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import boosting
from repro_torch.core.metrics import f1_macro
from repro_torch.fl import sharded
from repro_torch.launch import fl_run
from repro_torch.launch.fl_spawn import free_port
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.learners import LearnerSpec, get_learner
from repro_torch.serve import EngineConfig, ServeEngine

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
T, C, BATCH = 6, 4, 64
MESHES = {"4x2": (4, 2), "4x1": (4, 1)}

JAX_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.core import boosting
    from repro.core.metrics import f1_macro
    from repro.data import get_dataset
    from repro.fl.partition import iid_partition
    from repro.fl.sharded import sharded_adaboost_round, sharded_strong_predict
    from repro.learners import LearnerSpec, get_learner
    from repro.serve import EngineConfig, ServeEngine

    out, T, C, B = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    spec_d, (Xtr, ytr, Xte, yte) = get_dataset("vehicle", jax.random.PRNGKey(0))
    Xs, ys, masks = iid_partition(Xtr, ytr, C, jax.random.PRNGKey(1))
    lspec = LearnerSpec("decision_tree", spec_d.n_features, spec_d.n_classes, {"depth": 4})
    learner = get_learner("decision_tree")
    n = Xte.shape[0] - Xte.shape[0] % C
    res = {"Xs": Xs, "ys": ys, "masks": masks, "Xte": Xte, "yte": yte,
           "n_features": spec_d.n_features, "n_classes": spec_d.n_classes}
    for tag, shape in (("4x2", (C, 2)), ("4x1", (C, 1))):
        mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:shape[0] * shape[1]])
        with compat.set_mesh(mesh):
            state = boosting.init_boost_state(learner, lspec, T, masks, jax.random.PRNGKey(2), X=Xs)
            rfn = jax.jit(lambda s, X, y, m: sharded_adaboost_round(learner, lspec, mesh, s, X, y, m))
            rows = []
            for _ in range(T):
                state, metrics = rfn(state, Xs, ys, masks)
                rows.append([metrics["chosen"], metrics["alpha"], metrics["epsilon"]])
            # to the host: a mesh-sharded result leaves the mesh's context as numpy
            pred = np.asarray(sharded_strong_predict(learner, lspec, mesh, state.ensemble, Xte[:n]))
            Xn = np.asarray(Xte[:n])
            local = ServeEngine(learner, lspec, state.ensemble, batch_size=B).predict(Xn)
            served = ServeEngine(learner, lspec, state.ensemble,
                                 config=EngineConfig(batch_size=B, mesh=mesh)).predict(Xn)
        res[tag + "/rounds"] = np.asarray(rows, np.float64)
        res[tag + "/weights"] = state.weights
        res[tag + "/f1"] = f1_macro(yte[:n], jnp.asarray(pred), lspec.n_classes)
        res[tag + "/pred"] = pred
        res[tag + "/local"] = local
        res[tag + "/served"] = served
        for k, v in state.ensemble.params._asdict().items():
            res[tag + "/ens/" + k] = v
        res[tag + "/ens/alpha"] = state.ensemble.alpha
        res[tag + "/ens/count"] = state.ensemble.count
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    print("JAX_SHARDED_OK")
    """
)

# One rank of the port's mesh: every rank loads the JAX package's inputs,
# runs the round with the packed broadcast and per leaf, scores the test
# split batch-sharded, serves it through the mesh engine (sync and under
# the deadline scheduler) and serves the JAX package's own ensemble; each
# rank writes what it got.
RANK_SCRIPT = textwrap.dedent(
    """
    import sys
    import numpy as np, torch
    from repro_torch import convert
    from repro_torch.core import boosting
    from repro_torch.core.metrics import f1_macro
    from repro_torch.fl import distributed, sharded
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.learners import LearnerSpec, get_learner
    from repro_torch.serve import EngineConfig, ServeEngine

    rank, world, port, inp, out, tag = sys.argv[1:7]
    rank, world = int(rank), int(world)
    T, C, B = 6, 4, 64
    d = np.load(inp)
    distributed.initialize(f"127.0.0.1:{port}", world, rank)
    mesh = make_mesh((C, world // C), ("data", "model"))
    lspec = LearnerSpec("decision_tree", int(d["n_features"]), int(d["n_classes"]), {"depth": 4})
    learner = get_learner("decision_tree")
    Xs, masks = torch.from_numpy(d["Xs"]), torch.from_numpy(d["masks"])
    ys = torch.from_numpy(d["ys"]).to(torch.int32)
    Xte, yte = torch.from_numpy(d["Xte"]), torch.from_numpy(d["yte"]).to(torch.int32)
    n = Xte.shape[0] - Xte.shape[0] % C
    X1, y1, m1 = (sharded.shard_rows(mesh, t) for t in (Xs, ys, masks))
    res = {"coords": np.asarray([mesh.coords["data"], mesh.coords["model"]]),
           "index": sharded.collaborator_index(mesh)}
    for packed in (True, False):
        full = boosting.init_boost_state(learner, lspec, T, masks, X=Xs)
        state = boosting.BoostState(full.ensemble, sharded.shard_rows(mesh, full.weights),
                                    sharded.shard_rows(mesh, full.fit_cache))
        rows = []
        for _ in range(T):
            state, m = sharded.sharded_adaboost_round(learner, lspec, mesh, state, X1, y1, m1,
                                                      packed_broadcast=packed)
            rows.append([float(m["chosen"]), float(m["alpha"]), float(m["epsilon"])])
        key = "packed" if packed else "per_leaf"
        res[key + "/rounds"] = np.asarray(rows, np.float64)
        res[key + "/weights"] = state.weights.numpy()
        for k, v in convert.ensemble_to_numpy(state.ensemble).items():
            res[key + "/ens/" + k] = v
    ens = state.ensemble
    pred = sharded.sharded_strong_predict(learner, lspec, mesh, ens, Xte[:n])
    res["pred"] = pred.numpy()
    res["f1"] = float(f1_macro(yte[:n], pred, lspec.n_classes))
    Xn = Xte[:n].numpy()
    engine = ServeEngine(learner, lspec, ens, config=EngineConfig(batch_size=B, mesh=mesh))
    res["served"] = engine.predict(Xn)
    with engine.scheduler(t_max_s=0.05) as sched:  # the deadline loop on top
        ids = sched.submit(Xn[:5])
        res["scheduled"] = sched.results(ids, timeout_s=60.0)
    try:  # admission: B must divide over the federation shards
        ServeEngine(learner, lspec, ens, config=EngineConfig(batch_size=30, mesh=mesh))
        res["refused_30"] = False
    except ValueError:
        res["refused_30"] = True
    jens = convert.ensemble_from_numpy(
        {k[len(tag) + 5:]: d[k] for k in d.files if k.startswith(tag + "/ens/")}, device="cpu")
    res["served_jax"] = ServeEngine(learner, lspec, jens,
                                    config=EngineConfig(batch_size=B, mesh=mesh)).predict(Xn)
    np.savez(out + f".{rank}.npz", **res)
    distributed.shutdown()
    """
)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_sharded") / "jax.npz"
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(path), str(T), str(C), str(BATCH)],
                          env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_SHARDED_OK" in proc.stdout
    return dict(np.load(path))


def _spawn_ranks(world: int, inp: Path, out: Path, tag: str) -> list:
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(world), str(port),
                               str(inp), str(out), tag],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def port_runs(jax_run, tmp_path_factory):
    """{mesh tag: [each rank's results]}, from the JAX package's inputs."""
    d = tmp_path_factory.mktemp("port_sharded")
    np.savez(d / "inputs.npz", **jax_run)
    return {tag: _spawn_ranks(shape[0] * shape[1], d / "inputs.npz", d / tag, tag)
            for tag, shape in MESHES.items()}


def _inputs(jax_run):
    lspec = LearnerSpec("decision_tree", int(jax_run["n_features"]), int(jax_run["n_classes"]),
                        {"depth": 4})
    return (lspec, torch.from_numpy(jax_run["Xs"]), torch.from_numpy(jax_run["ys"]).to(torch.int32),
            torch.from_numpy(jax_run["masks"]))


@pytest.fixture(scope="module")
def fused_run(jax_run):
    """The port's fused round on the same inputs, T rounds."""
    lspec, Xs, ys, masks = _inputs(jax_run)
    learner = get_learner("decision_tree")
    state = boosting.init_boost_state(learner, lspec, T, masks, X=Xs)
    rows = []
    for _ in range(T):
        state, m = boosting.adaboost_f_round(learner, lspec, state, Xs, ys, masks)
        rows.append([float(m["chosen"]), float(m["alpha"]), float(m["epsilon"])])
    return np.asarray(rows), state


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_sharded_round_matches_the_jax_sharded_round(jax_run, port_runs, tag):
    got, want = port_runs[tag][0], jax_run[tag + "/rounds"]
    np.testing.assert_array_equal(got["packed/rounds"][:, 0], want[:, 0])  # the chosen sequence
    np.testing.assert_allclose(got["packed/rounds"][:, 1], want[:, 1], rtol=1e-5)  # alpha
    np.testing.assert_allclose(got["packed/rounds"][:, 2], want[:, 2], rtol=1e-5)  # epsilon
    assert got["f1"] == pytest.approx(float(jax_run[tag + "/f1"]), abs=1e-6)
    np.testing.assert_array_equal(got["pred"], jax_run[tag + "/pred"])
    # every rank's weights row is the JAX round's row at its collaborator index
    for res in port_runs[tag]:
        np.testing.assert_allclose(res["packed/weights"][0], jax_run[tag + "/weights"][int(res["index"])],
                                   rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_sharded_round_matches_the_ports_fused_round(port_runs, fused_run, tag):
    rows, state = fused_run
    got = port_runs[tag][0]["packed/rounds"]
    np.testing.assert_array_equal(got[:, 0], rows[:, 0])
    np.testing.assert_allclose(got[:, 1], rows[:, 1], rtol=1e-5)
    for res in port_runs[tag]:
        np.testing.assert_allclose(res["packed/weights"][0], state.weights[int(res["index"])].numpy(),
                                   rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_packed_and_per_leaf_broadcast_give_the_same_round(port_runs, tag):
    for res in port_runs[tag]:
        for k in [k for k in res if k.startswith("packed/")]:
            np.testing.assert_array_equal(res[k], res["per_leaf/" + k[len("packed/"):]], err_msg=k)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_every_rank_holds_the_same_ensemble_and_answers(port_runs, tag):
    ranks = port_runs[tag]
    shape = MESHES[tag]
    assert sorted(tuple(r["coords"]) for r in ranks) == \
        [(i, j) for i in range(shape[0]) for j in range(shape[1])]
    assert [int(r["index"]) for r in ranks] == [r // shape[1] for r in range(len(ranks))]
    for res in ranks[1:]:
        for k in [k for k in res if "/ens/" in k or k in ("pred", "served", "packed/rounds")]:
            np.testing.assert_array_equal(res[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_mesh_engine_equals_the_local_engine_under_the_scheduler(jax_run, port_runs, tag):
    """``EngineConfig(mesh=)`` on every rank answers what the local engine
    answers, bit for bit, with the deadline scheduler on top (the port's
    ``tests/test_sharded.py`` serving half), and serves the JAX package's
    ensemble as the JAX package's engines do."""
    lspec = _inputs(jax_run)[0]
    learner = get_learner("decision_tree")
    n = jax_run["Xte"].shape[0] - jax_run["Xte"].shape[0] % C
    Xn = jax_run["Xte"][:n]
    for res in port_runs[tag]:
        ens = convert.ensemble_from_numpy({k[len("packed/ens/"):]: v for k, v in res.items()
                                           if k.startswith("packed/ens/")}, device="cpu")
        want = ServeEngine(learner, lspec, ens, batch_size=BATCH).predict(Xn)
        np.testing.assert_array_equal(res["served"], want)
        np.testing.assert_array_equal(res["scheduled"], want[:5])
        np.testing.assert_array_equal(res["pred"], want)
        np.testing.assert_array_equal(res["served_jax"], jax_run[tag + "/served"])
        np.testing.assert_array_equal(res["served_jax"], jax_run[tag + "/local"])
        assert bool(res["refused_30"])  # 30 rows do not divide over 4 shards


def test_host_mesh_engine_matches_local(jax_run):
    """The degenerate ``(1, 1)`` mesh in one process, as
    ``tests/test_serve_async.py::test_engine_config_mesh_backend_matches_local``
    serves it: bit-equal to the local engine, with the deadline loop on
    top, and the knobs inside the config or as keywords, never both."""
    lspec, Xs, ys, masks = _inputs(jax_run)
    learner = get_learner("decision_tree")
    state = boosting.init_boost_state(learner, lspec, 4, masks, X=Xs)
    for _ in range(4):
        state, _ = boosting.adaboost_f_round(learner, lspec, state, Xs, ys, masks)
    Xn = jax_run["Xte"][:200]
    want = ServeEngine(learner, lspec, state.ensemble, batch_size=64).predict(Xn)
    mesh = make_host_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    with pytest.raises(ValueError, match="inside the EngineConfig"):
        ServeEngine(learner, lspec, state.ensemble, batch_size=64,
                    config=EngineConfig(batch_size=64, mesh=mesh))
    eng = ServeEngine(learner, lspec, state.ensemble, config=EngineConfig(batch_size=64, mesh=mesh))
    np.testing.assert_array_equal(eng.predict(Xn), want)
    with eng.scheduler(t_max_s=0.05) as sched:
        ids = sched.submit(Xn[:5])
        np.testing.assert_array_equal(sched.results(ids, timeout_s=10.0), want[:5])
    np.testing.assert_array_equal(
        sharded.sharded_strong_predict(learner, lspec, mesh, state.ensemble,
                                       torch.from_numpy(Xn)).numpy(), want)


def test_mesh_engine_admission_refuses_heterogeneous_ensembles():
    from repro_torch.core import hetero

    hs = hetero.HeterogeneousSpec.cycle(["ridge", "gaussian_nb"], 2, 3, 2)
    with pytest.raises(ValueError, match="homogeneous-only"):
        ServeEngine(None, hs, hetero.init_hetero_ensemble(hs, 2, "cpu"),
                    config=EngineConfig(batch_size=8, mesh=make_host_mesh()))


def test_host_mesh_round_equals_one_collaborators_sharded_arithmetic(jax_run):
    """At ``(1, 1)`` no collective runs: the round is the shard's own
    arithmetic, and ``shard_rows`` is the identity on one collaborator."""
    lspec, Xs, ys, masks = _inputs(jax_run)
    learner = get_learner("decision_tree")
    X1, y1, m1 = Xs[:1], ys[:1], masks[:1]
    mesh = make_host_mesh()
    assert sharded.collaborator_index(mesh) == 0 and sharded.fl_shards(mesh) == 1
    assert sharded.shard_rows(mesh, X1) is not None and torch.equal(sharded.shard_rows(mesh, X1), X1)
    state = boosting.init_boost_state(learner, lspec, 3, m1, X=X1)
    fused = boosting.init_boost_state(learner, lspec, 3, m1, X=X1)
    for _ in range(3):
        state, m = sharded.sharded_adaboost_round(learner, lspec, mesh, state, X1, y1, m1)
        fused, mf = boosting.adaboost_f_round(learner, lspec, fused, X1, y1, m1)
        assert int(m["chosen"]) == int(mf["chosen"]) == 0
        # one collaborator: w_fit is the fused round's weights times n (the
        # tree's split choice and leaves do not depend on that scale here)
        torch.testing.assert_close(m["alpha"], mf["alpha"], rtol=1e-5, atol=0)
    torch.testing.assert_close(state.weights, fused.weights, rtol=1e-5, atol=1e-9)


def test_shard_rows_and_mesh_refusals():
    mesh = make_host_mesh()
    with pytest.raises(ValueError, match="holds 1 collaborators"):
        sharded.shard_rows(mesh, torch.zeros(4, 3))
    with pytest.raises(ValueError, match="needs 8 ranks"):
        Mesh((4, 2), ("data", "model"))
    with pytest.raises(ValueError, match="disagree"):
        Mesh((1, 1), ("data",))
    assert sharded.fl_axes(Mesh((1, 1, 1), ("pod", "data", "model"))) == ("pod", "data")
    with pytest.raises(ValueError, match="this rank's block"):
        learner = get_learner("decision_tree")
        spec = LearnerSpec("decision_tree", 3, 2, {"depth": 2})
        X = torch.zeros(2, 4, 3)
        state = boosting.init_boost_state(learner, spec, 1, torch.ones(2, 4), X=X)
        sharded.sharded_adaboost_round(learner, spec, mesh, state, X, torch.zeros(2, 4, dtype=torch.int32),
                                       torch.ones(2, 4))


@pytest.mark.parametrize("argv,msg", [
    (["--distributed", "--sharded"], "replaces --faithful/--sharded"),
    (["--sharded", "--collaborators", "4", "--num-processes", "2"], "needs >= 4 ranks"),
    (["--sharded", "--collaborators", "2", "--num-processes", "3"], "does not divide"),
    (["--sharded", "--learners", "decision_tree,ridge"], "fused-mode only"),
    (["--sharded", "--algorithm", "distboost_f"], "AdaBoost.F round alone"),
], ids=["distributed", "too_few_ranks", "ragged_mesh", "learners", "algorithm"])
def test_fl_run_sharded_refusals(argv, msg, capsys):
    with pytest.raises(SystemExit):
        fl_run.main(["--device", "cpu", "--dataset", "vehicle", "--rounds", "1", *argv])
    assert msg in capsys.readouterr().err


def test_fl_run_sharded_under_fl_spawn_chooses_the_fused_runs_members(tmp_path):
    """``fl_spawn -n 4 -- --sharded --collaborators 2``: a ``(2, 2)`` mesh
    of gloo ranks; the chosen sequence is the port's fused run's, alpha
    within ``rtol=1e-5``, and the F1 printed is the truncated split's."""
    hist = tmp_path / "sharded.json"
    env = dict(_env())
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fl_spawn", "-n", "4", "--timeout", "240", "--",
         "--sharded", "--collaborators", "2", "--device", "cpu", "--dataset", "vehicle",
         "--rounds", "4", "--history-out", str(hist)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "sharded (2 collaborators on 4 ranks)" in proc.stdout
    got = json.loads(hist.read_text())
    assert got["mesh"] == {"data": 2, "model": 2} and got["ranks"] == 4
    fed = fl_run.build_federation("vehicle", 2, 4, 4, 0, "cpu")
    fed.run(eval_every=4)
    want = fed.per_round()
    assert [r["chosen"] for r in got["rounds"]] == [r["chosen"] for r in want]
    np.testing.assert_allclose([r["alpha"] for r in got["rounds"]], [r["alpha"] for r in want],
                               rtol=1e-5)
    _, _, _, _, Xte, yte, lspec = fl_run.build_inputs("vehicle", 2, 4, 4, 0)
    n = Xte.shape[0] - Xte.shape[0] % 2
    pred = boosting.strong_predict(fed.learner, fed.spec, fed.state.ensemble, Xte[:n])
    assert got["f1"] == pytest.approx(float(f1_macro(yte[:n], pred, lspec.n_classes)), abs=1e-6)
