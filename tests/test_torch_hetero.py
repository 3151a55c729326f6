"""The ported heterogeneous federations, v2 artifacts and mixed serving
against the JAX package and the homogeneous port, on the CPU, from the
same numpy inputs (``tests/test_hetero.py``'s geometry: C = 6 shards of 40
rows, d = 6, K = 3; labels from a noisy nonlinear score, so different
learner families win different rounds).

Tolerances: a one-group federation equals the homogeneous port bit for
bit.  A mixed federation over learners that draw nothing (the trees,
ridge, naive Bayes, centroids) chooses the JAX package's sequence; alpha
within rtol 1e-4 and F1 within 1e-3 (float32 sums in other orders).
Artifacts are byte for byte in both directions; served votes equal the
JAX package's ``hetero_strong_predict``."""
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hetero as jhetero
from repro.core.hetero import HeterogeneousSpec as JaxHSpec
from repro.core.plan import LearnerPlan as JaxLearnerPlan
from repro.core.plan import adaboost_plan as jax_adaboost_plan
from repro.fl.federation import Federation as JaxFederation
from repro.learners import LearnerSpec as JaxSpec
from repro.serve import load_artifact as jax_load
from repro.serve import save_artifact as jax_save
from repro_torch import convert
from repro_torch.core import hetero
from repro_torch.core.boosting import Ensemble
from repro_torch.core.hetero import HeterogeneousSpec
from repro_torch.core.plan import LearnerPlan, adaboost_plan, bagging_plan
from repro_torch.fl.federation import Federation
from repro_torch.learners import LearnerSpec
from repro_torch.serve import ServeEngine, ShardVoteCache, load_artifact, save_artifact

C, N, D, K = 6, 40, 6, 3
HPARAMS = {
    "decision_tree": {"depth": 3, "n_bins": 8},
    "extra_tree": {"depth": 3, "n_bins": 8, "max_candidates": 16},
    "ridge": {"l2": 1.0},
    "mlp": {"hidden": 16, "steps": 30, "lr": 0.05},
    "gaussian_nb": {},
    "nearest_centroid": {},
}
DETERMINISTIC = ["decision_tree", "ridge", "gaussian_nb", "nearest_centroid"]


def _shards(seed=0, n_test=120):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(D, K)).astype(np.float32)

    def draw(m):
        X = rng.normal(size=(m, D)).astype(np.float32)
        score = np.tanh(X) @ W + 0.7 * np.abs(X[:, :K]) + 0.8 * rng.normal(size=(m, K))
        return X, np.argmax(score, axis=-1).astype(np.int32)

    X, y = draw(C * N)
    Xte, yte = draw(n_test)
    masks = np.ones((C, N), np.float32)
    masks[-1, -5:] = 0.0  # a padded tail on one shard
    return X.reshape(C, N, D), y.reshape(C, N), masks, Xte, yte


def _hspec(names, n=C):
    return HeterogeneousSpec.cycle(names, n, D, K, {m: HPARAMS[m] for m in names})


def _jax_hspec(names, n=C):
    return JaxHSpec.cycle(names, n, D, K, {m: HPARAMS[m] for m in names})


def _jax_train(names, algorithm="adaboost_f", rounds=4, seed=0):
    """A JAX-trained mixed ensemble (any learners: the port receives the
    trained ensemble, not the draws)."""
    Xs, ys, masks, _, _ = _shards(seed)
    hs = _jax_hspec(names)
    committee = algorithm == "distboost_f"
    state = jhetero.init_hetero_boost_state(hs, rounds, jnp.asarray(masks), jax.random.PRNGKey(seed),
                                            committee=committee, X=jnp.asarray(Xs))
    fn = jhetero.HETERO_ROUND_FNS[algorithm]
    rfn = jax.jit(lambda s: fn(hs, s, jnp.asarray(Xs), jnp.asarray(ys), jnp.asarray(masks)))
    for _ in range(rounds):
        state, _ = rfn(state)
    return hs, state.ensemble


def _to_port(hs_jax, hens):
    groups = [{**{f: np.asarray(a) for f, a in zip(e.params._fields, e.params)},
               "alpha": np.asarray(e.alpha), "count": np.asarray(e.count)} for e in hens]
    return convert.hetero_ensemble_from_numpy(groups, hs_jax.names, device="cpu")


def _port_hspec(hs_jax):
    return HeterogeneousSpec(tuple(LearnerSpec(s.name, s.n_features, s.n_classes, dict(s.hparams))
                                   for s in hs_jax.specs), hs_jax.assignment)


# ---------------------------------------------------------------------------
# The spec and the group-blocked order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("names,n", [
    (["decision_tree", "ridge", "decision_tree"], 6),
    (["decision_tree", "extra_tree", "ridge", "gaussian_nb", "nearest_centroid", "mlp"], 8),
    (["ridge"], 5),
])
def test_cycle_and_hypothesis_order_match_jax(names, n):
    port, jax_ = _hspec(names, n), _jax_hspec(names, n)
    assert port.assignment == jax_.assignment and port.names == jax_.names
    assert [s.hparams for s in port.specs] == [dict(s.hparams) for s in jax_.specs]
    for g in range(port.n_groups):
        assert port.members(g) == jax_.members(g)
    for per in (1, 3):
        for a, b in zip(hetero._hyp_maps(port, per), jhetero._hyp_maps(jax_, per)):
            np.testing.assert_array_equal(a, b)


def test_six_names_over_eight_collaborators_order_the_hypotheses_group_by_group():
    """Group 0 (collaborators 0 and 6), group 1 (1 and 7), then one member
    each: the argmin's ties and the chosen index follow this order."""
    hs = _hspec(["decision_tree", "extra_tree", "ridge", "gaussian_nb", "nearest_centroid",
                 "mlp"], 8)
    owner, local, collab = hetero._hyp_maps(hs)
    assert collab.tolist() == [0, 6, 1, 7, 2, 3, 4, 5]
    assert owner.tolist() == [0, 0, 1, 1, 2, 3, 4, 5] and local.tolist() == [0, 1, 0, 1, 0, 0, 0, 0]


def test_spec_rejects_bad_geometry_and_orphan_groups():
    a, b = LearnerSpec("ridge", D, K), LearnerSpec("gaussian_nb", D + 1, K)
    with pytest.raises(ValueError, match="geometry"):
        HeterogeneousSpec((a, b), (0, 1))
    with pytest.raises(ValueError, match="no collaborators"):
        HeterogeneousSpec((a, LearnerSpec("mlp", D, K)), (0, 0))
    with pytest.raises(ValueError, match="unknown groups"):
        HeterogeneousSpec((a,), (0, 1))
    with pytest.raises(KeyError, match="unknown learner"):
        Xs, ys, masks, Xte, yte = _shards()
        Federation(adaboost_plan(rounds=1), Xs, ys, masks, Xte, yte,
                   HeterogeneousSpec((LearnerSpec("no_such", D, K),), (0,) * C), device="cpu")


# ---------------------------------------------------------------------------
# One group == the homogeneous port, bit for bit
# ---------------------------------------------------------------------------


def _plan(algorithm, rounds, **kw):
    return (bagging_plan(rounds=rounds, **kw) if algorithm == "bagging"
            else adaboost_plan(rounds=rounds, algorithm=algorithm, **kw))


@pytest.mark.parametrize("learner", ["decision_tree", "extra_tree", "mlp"])
@pytest.mark.parametrize("algorithm", ["adaboost_f", "distboost_f", "preweak_f", "bagging"])
def test_one_group_equals_the_homogeneous_port_bit_for_bit(algorithm, learner):
    """History rows, every round's metrics, the weights, every ensemble
    slot and the modelled bytes; the random learners draw the same numbers
    (a group draws for all C collaborators, here all of them)."""
    Xs, ys, masks, Xte, yte = _shards(seed=1)
    hp = {**HPARAMS[learner], "steps": 8} if learner == "mlp" else HPARAMS[learner]
    plan = _plan(algorithm, 3)
    hom = Federation(plan, Xs, ys, masks, Xte, yte, LearnerSpec(learner, D, K, hp),
                     device="cpu", seed=5)
    het = Federation(plan, Xs, ys, masks, Xte, yte,
                     HeterogeneousSpec.cycle([learner], C, D, K, {learner: hp}),
                     device="cpu", seed=5)
    drop_clock = lambda hist: [{k: v for k, v in h.items() if k != "round_seconds"} for h in hist]
    assert drop_clock(hom.run(eval_every=1)) == drop_clock(het.run(eval_every=1))
    assert hom.per_round() == het.per_round() and hom.comm_bytes == het.comm_bytes
    assert torch.equal(hom.state.weights, het.state.weights)
    (ens,) = het.state.ensemble
    assert ens.count == hom.state.ensemble.count == 3
    assert torch.equal(ens.alpha, hom.state.ensemble.alpha)
    for a, b in zip(ens.params, hom.state.ensemble.params):
        assert torch.equal(a, b)


def test_one_group_engine_serves_the_homogeneous_votes():
    Xs, ys, masks, Xte, yte = _shards(seed=2)
    hs = _hspec(["ridge"])
    fed = Federation(adaboost_plan(rounds=4), Xs, ys, masks, Xte, yte, hs, device="cpu")
    fed.run(eval_every=4)
    (ens,) = fed.state.ensemble
    hom = ServeEngine(hetero.resolve(hs)[0], hs.specs[0], ens, batch_size=32).predict(Xte)
    het = ServeEngine(None, hs, fed.state.ensemble, batch_size=32).predict(Xte)
    np.testing.assert_array_equal(hom, het)


# ---------------------------------------------------------------------------
# Mixed federations against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["adaboost_f", "distboost_f"])
def test_mixed_federation_matches_jax(algorithm):
    """decision_tree, ridge, gaussian_nb and nearest_centroid cycled over 6
    collaborators (no draws on either side): the same member chosen each
    round, alpha within rtol 1e-4 (DistBoost.F: atol 1e-5, as its later
    alphas pass near 0, where a float32 rounding of epsilon is a large
    share), F1 within 1e-3, the same group counts and modelled bytes."""
    Xs, ys, masks, Xte, yte = _shards(seed=0)
    rounds = 8
    jplan = jax_adaboost_plan(rounds=rounds, algorithm=algorithm,
                              learners=tuple(JaxLearnerPlan(m, HPARAMS[m]) for m in DETERMINISTIC))
    jfed = JaxFederation(jplan, jnp.asarray(Xs), jnp.asarray(ys), jnp.asarray(masks),
                         jnp.asarray(Xte), jnp.asarray(yte), JaxSpec("decision_tree", D, K, {}),
                         jax.random.PRNGKey(0))
    jhist = jfed.run(eval_every=1)
    tfed = Federation(adaboost_plan(rounds=rounds, algorithm=algorithm,
                                    learners=tuple(LearnerPlan(m, HPARAMS[m]) for m in DETERMINISTIC)),
                      Xs, ys, masks, Xte, yte, LearnerSpec("decision_tree", D, K, {}), device="cpu")
    thist = tfed.run(eval_every=1)
    assert tfed.hetero and tfed.spec.names == tuple(DETERMINISTIC)
    assert [h["chosen"] for h in thist] == [round(h["chosen"]) for h in jhist]
    tol = dict(rtol=1e-4) if algorithm == "adaboost_f" else dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose([h["alpha"] for h in thist], [h["alpha"] for h in jhist], **tol)
    assert max(abs(a["f1"] - b["f1"]) for a, b in zip(thist, jhist)) < 1e-3
    jens = jfed._fused_state.ensemble
    assert [e.count for e in tfed.state.ensemble] == [int(e.count) for e in jens]
    assert tfed.comm_bytes == jfed.comm_bytes
    if algorithm == "adaboost_f":  # the mixture is real: more than one family won
        assert sum(e.count > 0 for e in tfed.state.ensemble) >= 2


def test_mixed_preweak_rounds_on_the_jax_space_match_jax():
    """PreWeak.F over the same mixture, its rounds run on the JAX package's
    pre-trained space (carried across): the same ``[C, Σ C_g·T, n]``
    prediction cache, the same member chosen each round in the
    group-blocked order, alpha within atol 1e-5 and the same group counts.
    (The set-up's local rounds are the homogeneous port's, group by group:
    held bit for bit by the one-group test; on 40-row shards a local tree
    fit meets exact ties between splits that the two packages' histogram
    sums break apart, so spaces trained on each side differ.)"""
    from repro.core.boosting import run_stages as jax_run_stages
    from repro_torch.core.boosting import run_stages

    Xs, ys, masks, _, _ = _shards(seed=0)
    rounds = 8
    jhs, hs = _jax_hspec(DETERMINISTIC), _hspec(DETERMINISTIC)
    jX, jy, jm = jnp.asarray(Xs), jnp.asarray(ys), jnp.asarray(masks)
    jstate = jhetero.init_hetero_boost_state(jhs, rounds, jm, jax.random.PRNGKey(0), X=jX)
    jspaces, jstate = jhetero.hetero_preweak_f_setup(jhs, jstate, jX, jy, jm, rounds)
    jcache = jhetero.hetero_preweak_f_predictions(jhs, jspaces, jX)
    spaces = tuple(convert.params_from_numpy(name, {f: np.asarray(a) for f, a in
                                                    zip(sp._fields, sp)}, device="cpu")
                   for name, sp in zip(jhs.names, jspaces))
    X, y, m = torch.from_numpy(Xs), torch.from_numpy(ys), torch.from_numpy(masks)
    cache = hetero.hetero_preweak_f_predictions(hs, spaces, X)
    np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))
    state = hetero.init_hetero_boost_state(hs, rounds, m, X=X)
    stages = hetero.hetero_preweak_f_stages(hs, spaces, cache)
    jstages = jhetero.hetero_preweak_f_stages(jhs, jspaces, pred_cache=jcache)
    for _ in range(rounds):
        state, tm = run_stages(stages, state, X, y, m)
        jstate, jmx = jax_run_stages(jstages, jstate, jX, jy, jm)
        assert int(tm["chosen"]) == int(jmx["chosen"])
        np.testing.assert_allclose(float(tm["alpha"]), float(jmx["alpha"]), rtol=0, atol=1e-5)
    assert [e.count for e in state.ensemble] == [int(e.count) for e in jstate.ensemble]
    assert sum(e.count > 0 for e in state.ensemble) >= 2


def test_grouped_draws_do_not_depend_on_the_grouping():
    """A randomised group draws for all C collaborators and keeps its
    members' rows: collaborator 0's extra_tree and collaborator 1's mlp fit
    the same whether the others train ridge or the same family."""
    Xs, ys, masks, _, _ = _shards(seed=3)
    X, y = torch.from_numpy(Xs), torch.from_numpy(ys)
    w = torch.from_numpy(masks / masks.sum())
    fits = {}
    for names in (["extra_tree", "mlp"], ["extra_tree", "mlp", "ridge"]):
        hs = _hspec(names)
        state = hetero.init_hetero_boost_state(hs, 1, w, X=X)
        fits[len(names)] = (hs, hetero._grouped_local_fits(
            hs, hetero.resolve(hs), w, X, y, state.fit_cache, torch.Generator().manual_seed(9)))
    (hs2, f2), (hs3, f3) = fits[2], fits[3]
    for g, name in enumerate(["extra_tree", "mlp"]):
        for i in set(hs2.members(g)) & set(hs3.members(g)):
            r2, r3 = hs2.members(g).index(i), hs3.members(g).index(i)
            for a, b in zip(f2[g], f3[g]):
                assert torch.equal(a[r2], b[r3]), (name, i)


def _scalar_reads(fn) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ == "_local_scalar_dense":
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


@pytest.mark.parametrize("names,reads", [(["decision_tree"], 0),
                                         (["decision_tree", "ridge", "gaussian_nb"], 1)])
def test_a_mixed_round_reads_its_winner_on_the_host_once(names, reads):
    """The owner group's host-int count moves with the device argmin, so a
    mixed AdaBoost.F round reads the winner once; one group, never."""
    Xs, ys, masks, _, _ = _shards(seed=4)
    X, y, m = torch.from_numpy(Xs), torch.from_numpy(ys), torch.from_numpy(masks)
    hs = _hspec(names)
    state = hetero.init_hetero_boost_state(hs, 2, m, X=X)
    stages = hetero.hetero_adaboost_f_stages(hs)
    from repro_torch.core.boosting import run_stages

    assert _scalar_reads(lambda: run_stages(stages, state, X, y, m)) == reads


# ---------------------------------------------------------------------------
# v2 artifacts, byte for byte both ways, and mixed serving
# ---------------------------------------------------------------------------

FULL = sorted(HPARAMS)  # every registered learner in one federation
FLAVOURS = [("v2", "adaboost_f", None), ("committee", "distboost_f", None),
            ("int8", "adaboost_f", "int8"), ("bf16", "adaboost_f", "bf16"),
            ("committee_int8", "distboost_f", "int8")]


@pytest.fixture(scope="module", params=FLAVOURS, ids=[f[0] for f in FLAVOURS])
def trained(request):
    name, algorithm, quantize = request.param
    hs, hens = _jax_train(FULL, algorithm, rounds=4, seed=6)
    return {"hs": hs, "hens": hens, "committee": algorithm == "distboost_f", "quantize": quantize,
            "port": _to_port(hs, hens), "phs": _port_hspec(hs), "Xte": _shards(seed=6)[3]}


def test_v2_artifacts_are_byte_identical_both_ways(trained, tmp_path):
    """The port writes the JAX package's bytes for the same mixed ensemble
    (plain, committee, quantized with calibration), reads the JAX file back
    to the same tensors, and the JAX package reads the port's."""
    t = trained
    cs = C if t["committee"] else None
    calib = t["Xte"] if t["quantize"] == "int8" else None
    jpath = jax_save(tmp_path / "j.mafl", t["hs"], t["hens"], committee_size=cs,
                     extra={"dataset": "blobs"}, quantize=t["quantize"], calibrate=calib)
    ppath = save_artifact(tmp_path / "p.mafl", t["phs"], t["port"], committee_size=cs,
                          extra={"dataset": "blobs"}, quantize=t["quantize"], calibrate=calib)
    assert ppath.read_bytes() == jpath.read_bytes()
    art = load_artifact(jpath, "cpu")
    assert art.hetero and art.learner is None and art.spec == t["phs"]
    assert art.committee_size == cs
    want_version = 3 if t["quantize"] else 2
    assert art.manifest["format_version"] == want_version
    back = save_artifact(tmp_path / "back.mafl", art.spec, art.ensemble, committee_size=cs,
                         extra={"dataset": "blobs"}, quantize=t["quantize"], calibrate=calib)
    assert back.read_bytes() == jpath.read_bytes()
    jart = jax_load(ppath)
    np.testing.assert_array_equal(
        np.asarray(jhetero.hetero_strong_predict(jart.spec, jart.ensemble, jnp.asarray(t["Xte"]),
                                                 committee=t["committee"])),
        np.asarray(jhetero.hetero_strong_predict(t["hs"], jax_load(jpath).ensemble,
                                                 jnp.asarray(t["Xte"]),
                                                 committee=t["committee"])))


def test_engine_and_cache_serve_the_jax_hetero_strong_predict(trained, tmp_path):
    """Served votes from the port's engine (one vote_argmax a batch over the
    stacked groups, a ragged tail) and vote cache on the JAX package's
    artifact equal its ``hetero_strong_predict``."""
    t = trained
    cs = C if t["committee"] else None
    path = jax_save(tmp_path / "j.mafl", t["hs"], t["hens"], committee_size=cs,
                    quantize=t["quantize"])
    jart = jax_load(path)
    want = np.asarray(jhetero.hetero_strong_predict(jart.spec, jart.ensemble,
                                                    jnp.asarray(t["Xte"]), committee=t["committee"]))
    art = load_artifact(path, "cpu")
    engine = ServeEngine.from_artifact(art, batch_size=32)  # 120 rows: a ragged tail
    engine.warmup()
    np.testing.assert_array_equal(engine.predict(t["Xte"]), want)
    cache = ShardVoteCache.from_artifact(art)
    np.testing.assert_array_equal(cache.predict("test", t["Xte"]), want)
    np.testing.assert_array_equal(cache.predict("test"), want)  # a pure hit
    assert cache.stats()["hits"] == 1
    assert cache.stats()["members_folded"] == art.manifest["ensemble_count"]
    np.testing.assert_array_equal(
        hetero.hetero_strong_predict(art.spec, art.ensemble, torch.from_numpy(t["Xte"]),
                                     committee=t["committee"]).numpy(), want)


def test_engine_skips_a_group_with_no_member():
    """A group with count 0 adds nothing to the vote: its members are left
    out of the stack, and the votes are those of the whole ensemble."""
    Xs, ys, masks, Xte, yte = _shards(seed=7)
    hs = _hspec(["decision_tree", "ridge", "gaussian_nb"])
    fed = Federation(adaboost_plan(rounds=3), Xs, ys, masks, Xte, yte, hs, device="cpu")
    fed.run(eval_every=3)
    # group 1 emptied: its slots keep their values, but none is used
    hens = tuple(Ensemble(e.params, e.alpha, 0) if g == 1 else e
                 for g, e in enumerate(fed.state.ensemble))
    active = hetero.active_groups(hens)
    assert active is not None and not all(active)
    engine = ServeEngine(None, hs, hens, batch_size=32)
    used = engine._live[1]
    assert used.shape[0] == 3 * sum(active)
    want = hetero.hetero_strong_predict(hs, hens, torch.from_numpy(Xte)).numpy()
    np.testing.assert_array_equal(engine.predict(Xte), want)


def test_cache_grows_append_only_and_rejects_a_changed_member():
    Xs, ys, masks, Xte, yte = _shards(seed=8)
    hs = _hspec(["decision_tree", "ridge", "gaussian_nb"])
    from repro_torch.core.boosting import run_stages

    X, y, m = torch.from_numpy(Xs), torch.from_numpy(ys), torch.from_numpy(masks)
    state = hetero.init_hetero_boost_state(hs, 6, m, X=X)
    stages = hetero.hetero_adaboost_f_stages(hs)
    snaps = []
    for _ in range(6):
        state, _ = run_stages(stages, state, X, y, m)
        snaps.append(hetero.hetero_ensemble_to(state.ensemble, "cpu"))  # copies: slots grow in place
    cache = ShardVoteCache(None, hs, snaps[2])
    cache.predict("s", Xte)
    cache.update_ensemble(snaps[5])  # a pure append: 3 more members
    np.testing.assert_array_equal(cache.predict("s"),
                                  hetero.hetero_strong_predict(hs, snaps[5], torch.from_numpy(Xte)).numpy())
    assert cache.stats()["members_folded"] == 6 and cache.stats()["partial_hits"] == 1
    with pytest.raises(ValueError, match="only grow"):
        cache.update_ensemble(snaps[1])
    g = next(g for g, e in enumerate(snaps[5]) if e.count)
    changed = list(snaps[5])
    changed[g] = Ensemble(changed[g].params, changed[g].alpha + 1.0, changed[g].count)
    with pytest.raises(ValueError, match="append-only"):
        cache.update_ensemble(tuple(changed))


def test_engine_update_rejects_a_foreign_structure():
    hs3 = _hspec(["decision_tree", "ridge", "gaussian_nb"])
    hs2 = _hspec(["decision_tree", "ridge"])
    engine = ServeEngine(None, hs3, hetero.init_hetero_ensemble(hs3, 3, "cpu"), batch_size=32)
    with pytest.raises(ValueError, match="structure"):
        engine.update_ensemble(hetero.init_hetero_ensemble(hs2, 3, "cpu"))
    with pytest.raises(ValueError, match="learner=None"):
        ServeEngine(hetero.resolve(hs3)[0], hs3, hetero.init_hetero_ensemble(hs3, 3, "cpu"))


def test_committee_save_checks_the_committee_size(tmp_path):
    hs = _hspec(["ridge", "gaussian_nb"])
    hens = hetero.init_hetero_ensemble(hs, 2, "cpu", committee=True)
    with pytest.raises(ValueError, match="committee_size"):
        save_artifact(tmp_path / "bad.mafl", hs, hens, committee_size=C + 1)


def test_load_rejects_an_unknown_member_learner(tmp_path):
    hs = _hspec(["decision_tree", "ridge"])
    path = save_artifact(tmp_path / "mix.mafl", hs, hetero.init_hetero_ensemble(hs, 2, "cpu"))
    raw = path.read_bytes()
    (mlen,) = struct.unpack("<I", raw[8:12])
    manifest = json.loads(raw[12 : 12 + mlen])
    manifest["groups"][1]["learner"] = "definitely_not_registered"
    blob = json.dumps(manifest, sort_keys=True).encode()
    bad = tmp_path / "bad.mafl"
    bad.write_bytes(raw[:8] + struct.pack("<I", len(blob)) + blob + raw[12 + mlen:])
    with pytest.raises(ValueError, match="unknown learner key"):
        load_artifact(bad, "cpu")


@pytest.mark.parametrize("algorithm", ["adaboost_f", "distboost_f"])
def test_federation_publishes_a_v2_stream_jax_reads(tmp_path, algorithm):
    """A mixed port federation publishes every 2 rounds; the JAX package
    loads each checkpoint and votes what the port's engine serves."""
    Xs, ys, masks, Xte, yte = _shards(seed=9)
    hs = _hspec(["decision_tree", "ridge", "gaussian_nb"])
    fed = Federation(adaboost_plan(rounds=4, algorithm=algorithm), Xs, ys, masks, Xte, yte, hs,
                     device="cpu")
    fed.run(eval_every=4, publish_every=2, publish_dir=str(tmp_path))
    assert len(fed.published) == 2
    committee = algorithm == "distboost_f"
    for path in fed.published:
        jart = jax_load(path)
        assert jart.hetero and jart.committee == committee
        want = np.asarray(jhetero.hetero_strong_predict(jart.spec, jart.ensemble, jnp.asarray(Xte),
                                                        committee=committee))
        art = load_artifact(path, "cpu")
        np.testing.assert_array_equal(ServeEngine.from_artifact(art).predict(Xte), want)


# ---------------------------------------------------------------------------
# Plan plumbing and the command lines
# ---------------------------------------------------------------------------


def test_plan_learners_and_their_refusals(capsys):
    from repro_torch.launch import fl_run

    plan = adaboost_plan(rounds=2, learners=(LearnerPlan("ridge"), LearnerPlan("mlp", {"steps": 3})))
    assert [lp.name for lp in plan.learners] == ["ridge", "mlp"]
    with pytest.raises(ValueError, match="fedavg"):
        adaboost_plan(algorithm="fedavg", learners=(LearnerPlan("ridge"),))
    with pytest.raises(ValueError, match="LearnerPlan"):
        adaboost_plan(learners=("ridge",))
    for argv, msg in ((["--learners", "ridge,mlp", "--algorithm", "fedavg"], "cannot mix"),
                      (["--learners", "ridge,forest"], "choose from")):
        with pytest.raises(SystemExit):
            fl_run.main(argv + ["--device", "cpu"])
        assert msg in capsys.readouterr().err


@pytest.mark.parametrize("algorithm", ["adaboost_f", "distboost_f", "preweak_f", "bagging"])
def test_fl_run_learners_cpu_rehearsal(algorithm, capsys):
    from repro_torch.launch import fl_run

    hist = fl_run.main(["--dataset", "vehicle", "--collaborators", "6", "--rounds", "3",
                        "--eval-every", "3", "--device", "cpu", "--algorithm", algorithm,
                        "--learners", "decision_tree,ridge,gaussian_nb,nearest_centroid",
                        "--split", "dirichlet"])
    assert "heterogeneous federation:" in capsys.readouterr().out
    assert [h["round"] for h in hist] == [2] and 0.0 < hist[-1]["f1"] <= 1.0


def test_serve_fl_learners_and_learner_cpu_rehearsal(tmp_path):
    """``serve_fl --learners``: train, publish v2 checkpoints, serve each
    (the cache equals the engine: serve_fl raises otherwise), then serve
    the last with ``--load``; ``--learner ridge`` trains and serves."""
    from repro_torch.launch import serve_fl

    pub = tmp_path / "pub"
    out = serve_fl.main(["--dataset", "vehicle", "--learners", "decision_tree,ridge,gaussian_nb",
                         "--collaborators", "6", "--rounds", "4", "--publish-every", "2",
                         "--publish-dir", str(pub), "--device", "cpu"])
    assert len(out["published"]) == 2 and 0.0 < out["f1"] <= 1.0
    loaded = serve_fl.main(["--dataset", "vehicle", "--artifact", str(out["published"][-1]),
                            "--load", "--device", "cpu"])
    np.testing.assert_array_equal(loaded["pred"], out["pred"])
    ridge = serve_fl.main(["--dataset", "vehicle", "--learner", "ridge", "--rounds", "3",
                           "--artifact", str(tmp_path / "r.mafl"), "--device", "cpu"])
    assert load_artifact(tmp_path / "r.mafl", "cpu").spec.name == "ridge"
    assert 0.0 < ridge["f1"] <= 1.0
