"""The port's elastic federation runtime (``repro_torch/fl/elastic.py``) and
masked scoring helpers against the JAX package's, on the CPU.

The inputs are the JAX package's own (``tests/test_elastic.py``: vehicle,
C = 4, depth 3, 8 bins), handed to both packages as numpy arrays.  The
fault schedule and the membership windows are numpy in both packages and
must be equal; responders, dropouts and late merges follow from them and
must be equal too; alpha, weights and F1 are held at the parity
tolerances (weights rtol 1e-5, errors rtol 1e-4).  Bagging's picks are
``jax.random`` draws and are injected from the JAX run.  The port's own
contract is stricter: with no faults and no deadline the elastic run IS
the fused run, bit for bit, for all four algorithms."""
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as jboost
from repro.core import scoring as jscoring
from repro.core.hetero import HeterogeneousSpec as JaxHeteroSpec
from repro.core.plan import adaboost_plan as jax_adaboost_plan
from repro.core.plan import bagging_plan as jax_bagging_plan
from repro.data import get_dataset as jax_dataset
from repro.fl import elastic as jelastic
from repro.fl.federation import Federation as JaxFederation
from repro.fl.partition import iid_partition as jax_iid_partition
from repro.learners import LearnerSpec as JaxSpec
from repro.learners import get_learner as jax_learner
from repro_torch import convert
from repro_torch.core import boosting as tboost
from repro_torch.core import scoring
from repro_torch.core.hetero import HeterogeneousSpec
from repro_torch.core.plan import OptimizationFlags, adaboost_plan, bagging_plan
from repro_torch.fl import elastic
from repro_torch.fl.elastic import FaultPlan, ParticipationPolicy
from repro_torch.fl.federation import Federation
from repro_torch.learners import LearnerSpec, get_learner

ALGOS = ["adaboost_f", "distboost_f", "preweak_f", "bagging"]
C, T = 4, 3
HP = {"depth": 3, "n_bins": 8}
# all-ones, one absent, all but one absent
PARTS = {"all": [1, 1, 1, 1], "one_absent": [1, 0, 1, 1], "one_left": [0, 0, 1, 0]}
CHAOS = dict(policy=dict(deadline_s=1.0), faults=dict(seed=7, drop_p=0.2, kills=((2, 3),)))
LATE = dict(policy=dict(deadline_s=0.5, staleness_gamma=0.5, max_staleness=2),
            faults=dict(seed=3, delay_p=0.4, delay_range_s=(0.6, 1.4)))


@pytest.fixture(scope="module")
def data():
    dspec, (Xtr, ytr, Xte, yte) = jax_dataset("vehicle", jax.random.PRNGKey(0))
    Xs, ys, masks = jax_iid_partition(Xtr, ytr, C, jax.random.PRNGKey(1))
    arrays = [np.array(a) for a in (Xs, ys, masks, Xte, yte)]  # writable copies
    return (*arrays, dspec.n_features, dspec.n_classes)


def _plan(plan_fns, alg, rounds):
    adaboost, bagging = plan_fns
    return bagging(rounds=rounds) if alg == "bagging" else adaboost(rounds=rounds, algorithm=alg)


def _jax_run(data, alg, rounds, policy=None, faults=None):
    Xs, ys, masks, Xte, yte, d, K = data
    fed = JaxFederation(_plan((jax_adaboost_plan, jax_bagging_plan), alg, rounds),
                        *(jnp.asarray(a) for a in (Xs, ys, masks, Xte, yte)),
                        JaxSpec("decision_tree", d, K, HP), jax.random.PRNGKey(2))
    kw = {}
    if policy is not None:
        kw = dict(policy=jelastic.ParticipationPolicy(**policy),
                  faults=jelastic.FaultPlan(**faults))
    hist = fed.run(eval_every=1, **kw)
    return fed, hist


def _port_fed(data, alg, rounds, **kw):
    Xs, ys, masks, Xte, yte, d, K = data
    return Federation(_plan((adaboost_plan, bagging_plan), alg, rounds), Xs, ys, masks, Xte, yte,
                      LearnerSpec("decision_tree", d, K, HP), device="cpu", **kw)


def _port_elastic(data, alg, rounds, policy, faults, picks=None):
    """An ElasticFederation on the CPU (built directly, so bagging's picks
    can be injected)."""
    Xs, ys, masks, Xte, yte, d, K = data
    fed = elastic.ElasticFederation(
        _plan((adaboost_plan, bagging_plan), alg, rounds), Xs, ys, masks, Xte, yte,
        LearnerSpec("decision_tree", d, K, HP), policy=ParticipationPolicy(**policy),
        faults=FaultPlan(**faults), device="cpu", picks=picks)
    fed.run(rounds, eval_every=1)
    return fed


# -- the masked helpers against repro.core.scoring's --------------------------


def _part(name):
    return scoring.participation(np.asarray(PARTS[name]), "cpu"), jnp.asarray(PARTS[name], jnp.float32)


@pytest.mark.parametrize("name", sorted(PARTS))
def test_masked_reductions_match_jax(name):
    """masked_error_sum (rtol 1e-4), masked_argmin (equal),
    participation_denom and masked_update_weights (rtol 1e-5), for all-ones,
    one-absent and all-but-one participation."""
    part, jpart = _part(name)
    assert part.full == (name == "all")
    rng = np.random.default_rng(0)
    errs = rng.random((C, 7)).astype(np.float32)
    w = rng.random((C, 11)).astype(np.float32)
    w /= w.sum()
    mis = rng.integers(0, 2, (C, 11)).astype(np.float32)
    mask = np.ones((C, 11), np.float32)
    mask[1, -2:] = 0.0
    t = torch.from_numpy

    eps = scoring.masked_error_sum(t(errs), part)
    np.testing.assert_allclose(eps.numpy(), np.asarray(jscoring.masked_error_sum(jnp.asarray(errs), jpart)),
                               rtol=1e-4)
    hyp = np.asarray(PARTS[name])
    eps4 = errs[:, :C].sum(0)
    got = scoring.masked_argmin(t(eps4), scoring.participation(hyp, "cpu"))
    assert int(got) == int(jscoring.masked_argmin(jnp.asarray(eps4), jnp.asarray(hyp, jnp.float32)))
    np.testing.assert_allclose(float(scoring.participation_denom(t(w), part)),
                               float(jscoring.participation_denom(jnp.asarray(w), jpart)), rtol=1e-5)
    got = scoring.masked_update_weights(t(w), t(mis), t(mask), part, torch.tensor(0.7))
    want = jscoring.masked_update_weights(jnp.asarray(w), jnp.asarray(mis), jnp.asarray(mask), jpart,
                                          jnp.float32(0.7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert abs(float(got.sum()) - 1.0) < 1e-5
    # the absent rows are frozen: divided by the one total, their ratios kept
    if not part.full:
        ratio = got.numpy()[hyp == 0] / w[hyp == 0]
        np.testing.assert_allclose(ratio, ratio.flat[0], rtol=1e-6)


def test_full_participation_is_the_lockstep_reduction_bit_for_bit():
    """Under full participation each helper runs the unmasked reduction's
    literal operations: the same bits, and one renormalising launch."""
    part, _ = _part("all")
    rng = np.random.default_rng(1)
    errs = torch.from_numpy(rng.random((C, 9)).astype(np.float32))
    w = torch.from_numpy(rng.random((C, 13)).astype(np.float32))
    w = w / w.sum()
    mis = torch.from_numpy(rng.integers(0, 2, (C, 13)).astype(np.float32))
    mask = torch.ones(C, 13)
    assert torch.equal(scoring.masked_error_sum(errs, part), torch.sum(errs, dim=0))
    eps = torch.sum(errs, dim=0)
    assert torch.equal(scoring.masked_argmin(eps, scoring.participation(np.ones(9), "cpu")),
                       torch.argmin(eps))
    assert float(scoring.participation_denom(w, part)) == 1.0
    a = torch.tensor(0.7)
    assert torch.equal(scoring.masked_update_weights(w, mis, mask, part, a),
                       scoring.update_weights(w, mis, mask, a))


def _committee(data):
    """DistBoost.F committee slots fitted by the JAX package: [T, C] trees."""
    Xs, ys, masks, Xte, yte, d, K = data
    jl, js = jax_learner("decision_tree"), JaxSpec("decision_tree", d, K, HP)
    state = jboost.init_boost_state(jl, js, T, jnp.asarray(masks), jax.random.PRNGKey(0),
                                    committee_size=C, X=jnp.asarray(Xs))
    rnd = jax.jit(lambda s: jboost.distboost_f_round(jl, js, s, jnp.asarray(Xs), jnp.asarray(ys),
                                                     jnp.asarray(masks)))
    for _ in range(T):
        state, _ = rnd(state)
    ens = state.ensemble
    arrays = {k: np.asarray(getattr(ens.params, k)) for k in ("feature", "threshold", "leaf_logits")}
    arrays.update(alpha=np.asarray(ens.alpha), count=np.asarray(ens.count))
    return jl, js, ens, convert.ensemble_from_numpy(arrays, device="cpu")


@pytest.mark.parametrize("name", sorted(PARTS))
def test_masked_committee_vote_and_tally_match_jax(data, name):
    """masked_member_prediction on every shard and tally_new_votes_masked
    over the test split equal the JAX package's; all-ones masks give the
    unmasked committee vote bit for bit."""
    Xs, ys, masks, Xte, yte, d, K = data
    jl, js, jens, tens = _committee(data)
    tl, ts = get_learner("decision_tree"), LearnerSpec("decision_tree", d, K, HP)
    cm = np.asarray(PARTS[name], np.float32)
    slot0 = scoring.take_slot(tens.params, 0)
    got = scoring.masked_member_prediction(tl, ts, slot0, torch.from_numpy(cm), torch.from_numpy(Xs))
    jslot0 = jax.tree.map(lambda x: x[0], jens.params)
    want = jax.vmap(lambda Xi: jscoring.masked_member_prediction(jl, js, jslot0, jnp.asarray(cm), Xi))(
        jnp.asarray(Xs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    cmasks = np.tile(cm, (T, 1))
    cmasks[0] = 1.0  # slots with their own masks
    tally = scoring.tally_new_votes_masked(tl, ts, tens, torch.from_numpy(cmasks),
                                           scoring.init_tally(len(yte), K, "cpu"), torch.from_numpy(Xte))
    jtally = jscoring.tally_new_votes_masked(jl, js, jens, jnp.asarray(cmasks),
                                             jscoring.init_tally(len(yte), K), jnp.asarray(Xte))
    np.testing.assert_allclose(tally.votes.numpy(), np.asarray(jtally.votes), atol=1e-5)
    votes = elastic.masked_ensemble_votes(tl, ts, tens, torch.from_numpy(cmasks), torch.from_numpy(Xte))
    np.testing.assert_allclose(votes.numpy(), tally.votes.numpy(), atol=1e-5)
    if name == "all":
        plain = scoring.tally_new_votes(tl, ts, tens, scoring.init_tally(len(yte), K, "cpu"),
                                        torch.from_numpy(Xte), committee=True)
        assert torch.equal(tally.votes, plain.votes)
        assert torch.equal(votes, tboost.ensemble_votes(tl, ts, tens, torch.from_numpy(Xte),
                                                        committee=True))


def test_responder_pick_is_the_jax_rank_select():
    """Bagging's pick under partial participation: the JAX package's
    rank-select (``elastic.py``'s aggregate), for every raw draw."""
    rng = np.random.default_rng(2)
    for _ in range(20):
        part = (rng.random(6) < 0.6).astype(np.float32)
        for c_raw in range(6):
            resp = (jnp.asarray(part) > 0).astype(jnp.int32)
            j = jnp.mod(c_raw, jnp.maximum(jnp.sum(resp), 1))
            rank = jnp.cumsum(resp) - 1
            want = int(jnp.argmax((resp > 0) & (rank == j)))
            assert elastic.responder_pick(c_raw, part > 0) == want
    assert elastic.responder_pick(4, np.ones(6, bool)) == 4


# -- the host side: schedules, policies, discount ------------------------------


@pytest.mark.parametrize("seed", [0, 3, 7, 42])
def test_fault_schedule_and_membership_equal_jax(seed):
    kw = dict(seed=seed, delay_p=0.3, delay_range_s=(0.1, 0.5), drop_p=0.2,
              kills=((1, 3), (0, 9)), flaky=((2, 1, 4),))
    a, b = FaultPlan(**kw).schedule(6, 4), jelastic.FaultPlan(**kw).schedule(6, 4)
    for field in ("delay", "drop", "alive", "offline"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    pol = dict(joins=((1, 2), (3, -1)), leaves=((0, 4), (2, 9)))
    np.testing.assert_array_equal(ParticipationPolicy(**pol).membership(6, 4),
                                  jelastic.ParticipationPolicy(**pol).membership(6, 4))


def test_staleness_discount_and_policy_validation_match_jax():
    for gamma in (0.25, 0.5, 0.9, 1.0):
        ds = [elastic.staleness_discount(gamma, k) for k in range(6)]
        assert ds == [jelastic.staleness_discount(gamma, k) for k in range(6)]
        assert ds[0] == 1.0 and all(a >= b for a, b in zip(ds, ds[1:]))
    for bad in (dict(gamma=0.0, lateness=1), dict(gamma=0.5, lateness=-1)):
        with pytest.raises(ValueError):
            elastic.staleness_discount(**bad)
    for bad in (dict(deadline_s=-1.0), dict(staleness_gamma=1.5), dict(min_responders=0),
                dict(max_staleness=-1)):
        with pytest.raises(ValueError):
            ParticipationPolicy(**bad).validate()


# -- the no-op policy IS the fused run -----------------------------------------


@pytest.mark.parametrize("alg", ALGOS)
def test_noop_policy_equals_the_fused_run_bit_for_bit(data, alg):
    """No faults and no deadline: history, every round's metrics, weights
    and every ensemble leaf equal the port's fused run to the bit, and
    every round is one renormalising weight_update, no product."""
    fused = _port_fed(data, alg, T, seed=5)
    h1 = fused.run(eval_every=1)
    elas = _port_fed(data, alg, T, seed=5)
    h2 = elas.run(eval_every=1, policy=ParticipationPolicy())
    assert elas.elastic is not None and elas.elastic.responders_log == [C] * T
    assert [{k: r[k] for k in ("round", "f1", "epsilon", "alpha", "chosen")} for r in h2] == \
        [{k: r[k] for k in ("round", "f1", "epsilon", "alpha", "chosen")} for r in h1]
    assert elas.per_round() == fused.per_round()
    assert torch.equal(elas.state.weights, fused.state.weights)
    e1, e2 = fused.state.ensemble, elas.state.ensemble
    assert e1.count == e2.count == T and torch.equal(e1.alpha, e2.alpha)
    for a, b in zip(e1.params, e2.params):
        assert torch.equal(a, b)
    assert elas.comm_bytes == fused.comm_bytes


# -- chaos and late merges against the JAX package ------------------------------


def _compare_with_jax(jfed, jhist, port, rounds):
    je = jfed.elastic
    assert port.responders_log == je.responders_log
    assert dict(port.dropouts) == dict(je.dropouts)
    assert [h["round"] for h in port.history] == [h["round"] for h in jhist]
    for th, jh in zip(port.history, jhist):
        assert th["chosen"] == round(jh["chosen"]), th["round"]
        assert th["responders"] == jh["responders"] and th["late_merges"] == jh["late_merges"]
        np.testing.assert_allclose(th["epsilon"], jh["epsilon"], rtol=1e-4)
        np.testing.assert_allclose(th["alpha"], jh["alpha"], rtol=1e-5)
        assert abs(th["f1"] - jh["f1"]) < 1e-3
    js = jfed._fused_state
    np.testing.assert_allclose(port.state.weights.numpy(), np.asarray(js.weights), rtol=1e-5)
    assert port.state.ensemble.count == int(js.ensemble.count)
    np.testing.assert_allclose(port.state.ensemble.alpha.numpy(), np.asarray(js.ensemble.alpha),
                               rtol=1e-5)
    np.testing.assert_array_equal(port.state.ensemble.params.feature.numpy(),
                                  np.asarray(js.ensemble.params.feature))


@pytest.mark.parametrize("alg", ALGOS)
def test_chaos_kills_and_drops_match_jax(data, alg):
    """``deadline 1 s, drop_p 0.2, kill 2 at round 3`` over 6 rounds: the
    same responders and dropouts as the JAX package, the same members
    (bagging's injected), alpha, weights and F1 at tolerance; partial rounds
    launch the product, never the renormalising update."""
    rounds = 6
    jfed, jhist = _jax_run(data, alg, rounds, **CHAOS)
    picks = [round(h["chosen"]) for h in jhist] if alg == "bagging" else None
    port = _port_elastic(data, alg, rounds, **CHAOS, picks=picks)
    _compare_with_jax(jfed, jhist, port, rounds)
    assert port.dropouts["dead"] == 1 and all(r <= C - 1 for r in port.responders_log[3:])
    assert port.history[-1]["f1"] > 0.6
    if alg == "distboost_f":
        np.testing.assert_array_equal(port.cmasks.numpy(), np.asarray(jfed.elastic.cmasks))


def test_late_merges_match_jax(data):
    """Delay-only stragglers (deadline 0.5 s, delays 0.6-1.4 s): the same
    late merges as the JAX package (round, collaborator, lateness,
    discount), alpha and base alpha at rtol 1e-5, alpha <= base alpha, and
    the ensemble count = rounds - skipped + merges."""
    rounds = 6
    jfed, jhist = _jax_run(data, "adaboost_f", rounds, **LATE)
    port = _port_elastic(data, "adaboost_f", rounds, **LATE)
    key = ("src_round", "merged_round", "collaborator", "lateness", "discount")
    assert port.late_log, "expected stragglers to merge late"
    assert [{k: r[k] for k in key} for r in port.late_log] == \
        [{k: r[k] for k in key} for r in jfed.elastic.late_log]
    for row, jrow in zip(port.late_log, jfed.elastic.late_log):
        assert row["alpha"] <= row["base_alpha"]
        assert row["discount"] == elastic.staleness_discount(0.5, row["lateness"])
        np.testing.assert_allclose(row["alpha"], jrow["alpha"], rtol=1e-5)
        np.testing.assert_allclose(row["base_alpha"], jrow["base_alpha"], rtol=1e-5)
    skipped = sum(1 for r in port.responders_log if r == 0)
    assert port.state.ensemble.count == rounds - skipped + len(port.late_log)
    _compare_with_jax(jfed, jhist, port, rounds)


def test_bagging_late_merges_append_discounted_unit_votes(data):
    rounds = 6
    jfed, jhist = _jax_run(data, "bagging", rounds, **LATE)
    picks = [round(h["chosen"]) for h in jhist]
    port = _port_elastic(data, "bagging", rounds, **LATE, picks=picks)
    assert port.late_log and [r["alpha"] for r in port.late_log] == \
        [r["alpha"] for r in jfed.elastic.late_log]
    assert all(r["base_alpha"] == 1.0 for r in port.late_log)
    _compare_with_jax(jfed, jhist, port, rounds)


def test_membership_churn_matches_jax(data):
    rounds = 5
    churn = dict(policy=dict(deadline_s=1.0, joins=((1, 2),), leaves=((3, 3),)), faults={})
    jfed, jhist = _jax_run(data, "adaboost_f", rounds, **churn)
    port = _port_elastic(data, "adaboost_f", rounds, **churn)
    assert port.responders_log == [3, 3, 4, 3, 3]
    _compare_with_jax(jfed, jhist, port, rounds)


def test_partial_rounds_launch_the_product_kernel(data, monkeypatch):
    """The renormalising update runs on full rounds only, the product on
    partial ones: counted through the wrappers the CPU dispatch goes
    through."""
    from repro_torch.kernels import ops

    calls = {"full": 0, "product": 0}
    real_full, real_product = ops.weight_update, ops.weight_update_product
    monkeypatch.setattr(ops, "weight_update",
                        lambda *a: (calls.__setitem__("full", calls["full"] + 1), real_full(*a))[1])
    monkeypatch.setattr(ops, "weight_update_product",
                        lambda *a: (calls.__setitem__("product", calls["product"] + 1),
                                    real_product(*a))[1])
    port = _port_elastic(data, "adaboost_f", 6, **CHAOS)
    partial = sum(1 for r in port.responders_log if 0 < r < C)
    full = sum(1 for r in port.responders_log if r == C)
    assert partial > 0 and calls == {"full": full, "product": partial}


# -- realtime mode --------------------------------------------------------------


def test_arrival_board_respects_deadline_and_floor():
    board = elastic._ArrivalBoard()
    board.post(0, 0)
    t0 = time.monotonic()
    resp, late, wait, hit = board.close_round(0, {0, 1}, 0.2, 1)
    assert resp == {0} and hit and wait >= 0.2
    assert time.monotonic() - t0 < 2.0
    # the floor stretches the deadline until an arrival lands
    threading.Timer(0.3, board.post, (1, 1)).start()
    resp, late, wait, hit = board.close_round(1, {1}, 0.05, 1)
    assert resp == {1} and wait >= 0.25
    # a straggler posting for an old round surfaces as a late post
    board.post(1, 0)
    resp, late, _, _ = board.close_round(2, set(), None, 1)
    assert late == [(1, 0)]


def test_realtime_mode_keeps_the_responder_floor(data):
    port = _port_elastic(data, "adaboost_f", 3,
                         policy=dict(deadline_s=0.15, realtime=True, min_responders=2),
                         faults=dict(seed=5, delay_p=0.5, delay_range_s=(0.3, 0.5)))
    assert len(port.history) == 3 and all(r >= 2 for r in port.responders_log)


# -- what the elastic runtime refuses --------------------------------------------


def test_elastic_rejects_heterogeneous_and_interpreted_runs(data):
    Xs, ys, masks, Xte, yte, d, K = data
    hs = HeterogeneousSpec.cycle(["decision_tree", "gaussian_nb"], C, d, K,
                                 hparams={"decision_tree": HP})
    fed = Federation(adaboost_plan(rounds=T), Xs, ys, masks, Xte, yte, hs, device="cpu")
    with pytest.raises(NotImplementedError, match="homogeneous"):
        fed.run(policy=ParticipationPolicy())
    jhs = JaxHeteroSpec.cycle(["decision_tree", "gaussian_nb"], C, d, K,
                              hparams={"decision_tree": HP})
    jfed = JaxFederation(jax_adaboost_plan(rounds=T), *(jnp.asarray(a) for a in (Xs, ys, masks, Xte, yte)),
                         jhs, jax.random.PRNGKey(2))
    with pytest.raises(NotImplementedError):
        jfed.run(policy=jelastic.ParticipationPolicy())
    faithful = OptimizationFlags(packed_serialization=False, bounded_tensordb=False,
                                 fast_barrier=False, fused_round=False, cache_predictions=False)
    import dataclasses

    plan = dataclasses.replace(adaboost_plan(rounds=T), optimizations=faithful)
    fed = Federation(plan, Xs, ys, masks, Xte, yte, LearnerSpec("decision_tree", d, K, HP),
                     device="cpu")
    with pytest.raises(ValueError, match="fused round path"):
        fed.run(faults=FaultPlan())


# -- the CLI ---------------------------------------------------------------------


def test_fl_run_elastic_cli_on_the_cpu(tmp_path):
    """``fl_run --elastic`` end to end: with no fault flag it prints the
    fused run's history; under faults its summary carries responders,
    dropouts by reason and the late merges."""
    from repro_torch.launch import fl_run

    base = ["--device", "cpu", "--dataset", "vehicle", "--collaborators", "4", "--rounds", "4",
            "--depth", "3", "--eval-every", "1"]
    fused = fl_run.main(base)
    noop = fl_run.main(base + ["--elastic"])
    key = ("round", "f1", "epsilon", "alpha", "chosen")
    assert [{k: r[k] for k in key} for r in noop] == [{k: r[k] for k in key} for r in fused]
    out = tmp_path / "e.json"
    fl_run.main(base + ["--elastic", "--deadline-ms", "500", "--fault-seed", "3", "--fault-delay-p",
                        "0.4", "--fault-delay-ms", "600:1400", "--fault-drop-p", "0.1",
                        "--fault-kill", "1:2", "--history-out", str(out)])
    summary = json.loads(out.read_text())
    assert summary["deadline_s"] == 0.5 and len(summary["responders"]) == 4
    assert summary["dropouts"]["dead"] == 1 and summary["late"]
    assert summary["late"][0]["alpha"] <= summary["late"][0]["base_alpha"]
    assert [r["round"] for r in summary["history"]] == [r["round"] for r in summary["rounds"]]
