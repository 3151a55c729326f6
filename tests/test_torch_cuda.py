"""The port's CUDA kernels on the card: each against its plain version at
the main path's shapes, and a short federation that must go through the
kernels.  Imports no JAX, so it runs on a machine with a card:

  python -m pytest -q -m cuda tests/test_torch_cuda.py

Where ``torch.cuda.is_available()`` is False every test here skips.
Tolerances are the card's: the histogram kernel sums in fixed point per
CTA, the plain version in float32 in another order (atol 1e-4, on cells
of mass up to about 1, as on the main path), errors rtol 1e-4,
weights rtol 1e-5 (the renormalising total in another order), the
un-renormalised product rtol 1e-6.
``vote_argmax`` is exact: on half-integer alphas the vote sums are exact
in f32, so any summation order gives the same argmax, and on any alphas
it sums the members in ascending order, as a member-by-member tally does.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

SHAPES = [(4070, 14, 2), (2000, 16, 26), (6250, 54, 2)]  # adult, letter, forestcover


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels compile and run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,K", SHAPES)
@pytest.mark.parametrize("L", [1, 2, 4, 8])
def test_tree_hist_kernel_matches_plain(dev, n, d, K, L):
    g = torch.Generator().manual_seed(L)
    bins = torch.randint(0, 17, (8, n, d), generator=g, dtype=torch.int32).to(dev)
    leaf = torch.randint(0, L, (8, n), generator=g, dtype=torch.int32).to(dev)
    # a cell holds a mass of order 1, as with the main path's normalised
    # weights, so its float32 rounding stays far below atol 1e-4
    wy = (torch.rand(8, n, K, generator=g) * (L * 17 / n)).to(dev)
    before = ops.launch_counts()["tree_hist"]
    got = ops.tree_hist(bins, leaf, wy, n_leaves=L, n_bins_p1=17)
    want = ref.tree_hist_batched_ref(bins, leaf, wy, L, 17)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert ops.launch_counts()["tree_hist"] == before + 1


@pytest.mark.parametrize("C,H,n", [(8, 8, 4070), (4, 33, 4097), (2, 3, 1)])
def test_weighted_errors_kernel_matches_plain(dev, C, H, n):
    g = torch.Generator().manual_seed(H)
    preds = torch.randint(0, 3, (C, H, n), generator=g, dtype=torch.int32).to(dev)
    y = torch.randint(0, 3, (C, n), generator=g, dtype=torch.int32).to(dev)
    w = torch.rand(C, n, generator=g).to(dev)
    got = ops.weighted_errors(preds, y, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.weighted_errors_ref(preds, y, w), rtol=1e-4, atol=0)


def _poisoned(dev, shape, call):
    """``call()`` right after a NaN-filled block of ``shape`` was freed, so
    that the caching allocator hands that block to the call's output: a
    cell the kernel never writes stays NaN."""
    junk = torch.full(shape, float("nan"), device=dev)
    ptr = junk.data_ptr()
    del junk
    out = call()
    assert out.data_ptr() == ptr, "the allocator did not hand back the NaN-filled block"
    return out


@pytest.mark.parametrize("H,n,d,K,L", [
    (1, 3, 3, 2, 1),  # n < cs: CTAs of a cluster with no sample
    (2, 1, 4, 2, 2),  # n = 1
    (33, 1001, 5, 3, 8),  # H = 33, odd n
    (8, 2000, 16, 26, 8),  # letter at L = 8: the widest histogram
])
def test_tree_hist_kernel_writes_every_cell(dev, H, n, d, K, L):
    """Edge shapes of the cluster kernel, its output on a NaN-filled
    block: every cell must be written, agree with the plain version, and
    come out the same bits from two calls."""
    from repro_torch.kernels.tree_hist import launch_plan

    g = torch.Generator().manual_seed(n)
    bins = torch.randint(0, 17, (H, n, d), generator=g, dtype=torch.int32).to(dev)
    leaf = torch.randint(0, L, (H, n), generator=g, dtype=torch.int32).to(dev)
    wy = (torch.rand(H, n, K, generator=g) * (L * 17 / n)).to(dev)
    got = _poisoned(dev, (H, L, d, 17, K), lambda: ops.tree_hist(bins, leaf, wy, n_leaves=L, n_bins_p1=17))
    again = ops.tree_hist(bins, leaf, wy, n_leaves=L, n_bins_p1=17)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.tree_hist_batched_ref(bins, leaf, wy, L, 17), rtol=0, atol=1e-4)
    assert torch.equal(got, again)  # integer sums in each CTA, a fixed order across the cluster
    if n < 8:
        assert launch_plan(H, n, d, L, 17, K).cs > n  # the case leaves CTAs of a cluster empty


@pytest.mark.parametrize("C,H,n", [(8, 8, 1), (8, 8, 5), (4, 33, 4097), (3, 8, 1001), (8, 8, 6250)])
def test_weighted_errors_kernel_writes_every_element_the_same_bits_twice(dev, C, H, n):
    """Edge shapes of the cluster kernel, its output on a NaN-filled
    block: every element written, the same bits from two calls, and
    exactly 0 on a zero-weight shard."""
    g = torch.Generator().manual_seed(n)
    preds = torch.randint(0, 3, (C, H, n), generator=g, dtype=torch.int32).to(dev)
    y = torch.randint(0, 3, (C, n), generator=g, dtype=torch.int32).to(dev)
    w = torch.rand(C, n, generator=g)
    w[0] = 0.0
    w = w.to(dev)
    got = _poisoned(dev, (C, H), lambda: ops.weighted_errors(preds, y, w))
    again = ops.weighted_errors(preds, y, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.weighted_errors_ref(preds, y, w), rtol=1e-4, atol=0)
    assert torch.equal(got, again)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("C,H,n", [
    (8, 8, 4070), (8, 80, 4070), (8, 800, 4070), (64, 6400, 509),  # AdaBoost.F's and PreWeak.F's
    (4, 12800, 2000),  # past the 11 776 rows a per-row shared-memory total could hold
    (2, 17, 1), (3, 33, 7), (5, 41, 1001),  # empty slices, a ragged last chunk, odd n
])
def test_weighted_errors_kernel_at_preweak_shapes(dev, C, H, n):
    """PreWeak.F's C*T rows: each shape against the plain version (rtol
    1e-4), its output on a NaN-filled block, the same bits from two calls,
    exactly 0 on a zero-weight shard and one launch a call."""
    g = torch.Generator().manual_seed(H)
    preds = torch.randint(0, 3, (C, H, n), generator=g, dtype=torch.int32).to(dev)
    y = torch.randint(0, 3, (C, n), generator=g, dtype=torch.int32).to(dev)
    w = torch.rand(C, n, generator=g)
    w[0] = 0.0
    w = (w / w.sum().clamp_min(1e-30)).to(dev)
    before = ops.launch_counts()["weighted_errors"]
    got = _poisoned(dev, (C, H), lambda: ops.weighted_errors(preds, y, w))
    again = ops.weighted_errors(preds, y, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["weighted_errors"] == before + 2
    torch.testing.assert_close(got, ref.weighted_errors_ref(preds, y, w), rtol=1e-4, atol=0)
    assert torch.equal(got, again)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_hist_kernel_skewed_weights_pick_the_same_split(dev, seed):
    """AdaBoost's skewed weights (log-normal, sigma 4, summing to 1) at
    adult's deepest level: a CTA's fixed-point step is set by its heaviest
    sample, yet the histogram stays within atol 1e-4 and every
    collaborator's split is the plain version's."""
    from repro_torch.learners.tree import _split_scores

    C, n, d, K, L = 8, 4070, 14, 2, 8
    g = torch.Generator().manual_seed(100 + seed)
    bins = torch.randint(0, 17, (C, n, d), generator=g, dtype=torch.int32).to(dev)
    leaf = torch.randint(0, L, (C, n), generator=g, dtype=torch.int32).to(dev)
    w = torch.exp(4.0 * torch.randn(C, n, generator=g, dtype=torch.float64))
    w = (w / w.sum()).float()
    y = torch.randint(0, K, (C, n), generator=g)
    wy = (torch.nn.functional.one_hot(y, K).float() * w.unsqueeze(-1)).contiguous().to(dev)
    got = ops.tree_hist(bins, leaf, wy, n_leaves=L, n_bins_p1=17)
    want = ref.tree_hist_batched_ref(bins, leaf, wy, L, 17)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert torch.equal(torch.argmax(_split_scores(got).flatten(1), dim=1),
                       torch.argmax(_split_scores(want).flatten(1), dim=1))


def _update_inputs(dev, N, seed, zero_mask=False):
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(N, generator=g).to(dev)
    mis = (torch.rand(N, generator=g) < 0.4).float().to(dev)
    mask = torch.zeros(N) if zero_mask else (torch.rand(N, generator=g) > 0.1).float()
    return w, mis, mask.to(dev)


# adult, letter, forestcover at C = 8, adult at the paper's 64 collaborators, edges
UPDATE_N = [32560, 16000, 50000, 260480, 1, 4097]


@pytest.mark.parametrize("N", UPDATE_N)
def test_weight_update_kernel_matches_plain(dev, N):
    """The fused update (product, then division by the clamped total)
    against its plain version: rtol 1e-5, the sum taken in another order."""
    w, mis, mask = _update_inputs(dev, N, N)
    alpha = torch.tensor(0.7, device=dev)
    before = ops.launch_counts()["weight_update"]
    got = ops.weight_update(w, mis, mask, alpha)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.renormalised_weight_update_ref(w, mis, mask, alpha),
                               rtol=1e-5, atol=0)
    assert ops.launch_counts()["weight_update"] == before + 1


@pytest.mark.parametrize("N", UPDATE_N)
def test_weight_update_kernel_writes_every_element_the_same_bits_twice(dev, N):
    """The output on a NaN-filled block: every element written, and the
    same bits from a second call (the cluster sums in a fixed order)."""
    w, mis, mask = _update_inputs(dev, N, N + 1)
    alpha = torch.tensor(-1.3, device=dev)
    got = _poisoned(dev, (N,), lambda: ops.weight_update(w, mis, mask, alpha))
    again = ops.weight_update(w, mis, mask, alpha)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)


@pytest.mark.parametrize("N", [32560, 260480, 1])
def test_weight_update_kernel_all_zero_mask_gives_zeros(dev, N):
    w, mis, mask = _update_inputs(dev, N, N + 2, zero_mask=True)
    got = ops.weight_update(w, mis, mask, torch.tensor(2.0, device=dev))
    torch.cuda.synchronize()
    assert bool((got == 0).all())  # 0 / 1e-30, never 0 / 0


@pytest.mark.parametrize("N", [4070, 32560, 4097, 0])
def test_weight_update_product_kernel_matches_plain(dev, N):
    """The interpreted round's un-renormalised update (the Pallas body
    alone) against its plain version at rtol 1e-6: adult's shard, adult's
    whole federation, an odd N and N = 0; every element written (a
    NaN-filled block) and one launch a non-empty call."""
    w, mis, mask = _update_inputs(dev, N, N + 3)
    w = w / max(N, 1)
    for a in (0.37, -2.0, 10.0):
        alpha = torch.tensor(a, device=dev)
        before = ops.launch_counts()["weight_update_product"]
        got = (_poisoned(dev, (N,), lambda: ops.weight_update_product(w, mis, mask, alpha)) if N
               else ops.weight_update_product(w, mis, mask, alpha))
        torch.cuda.synchronize()
        assert ops.launch_counts()["weight_update_product"] == before + (1 if N else 0)
        assert got.shape == (N,) and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, ref.boost_weight_update_ref(w, mis, mask, alpha),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("L", [1, 2, 4, 8])
def test_tree_hist_kernel_one_fit_skewed_weights(dev, L):
    """The interpreted round's per-collaborator fit: H = 1 at adult's
    shard (``[1, 4070, 14]``), under AdaBoost's skewed weights, within
    atol 1e-4 and choosing the plain version's split."""
    from repro_torch.learners.tree import _split_scores

    n, d, K = 4070, 14, 2
    g = torch.Generator().manual_seed(200 + L)
    bins = torch.randint(0, 17, (1, n, d), generator=g, dtype=torch.int32).to(dev)
    leaf = torch.randint(0, L, (1, n), generator=g, dtype=torch.int32).to(dev)
    w = torch.exp(4.0 * torch.randn(1, n, generator=g, dtype=torch.float64))
    w = (w / w.sum()).float()
    y = torch.randint(0, K, (1, n), generator=g)
    wy = (torch.nn.functional.one_hot(y, K).float() * w.unsqueeze(-1)).contiguous().to(dev)
    got = _poisoned(dev, (1, L, d, 17, K), lambda: ops.tree_hist(bins, leaf, wy, n_leaves=L,
                                                                 n_bins_p1=17))
    want = ref.tree_hist_batched_ref(bins, leaf, wy, L, 17)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert torch.equal(torch.argmax(_split_scores(got).flatten(1), dim=1),
                       torch.argmax(_split_scores(want).flatten(1), dim=1))


def test_weighted_errors_kernel_one_shard(dev):
    """The interpreted round scores each shard alone: ``[1, 8, 4070]``."""
    g = torch.Generator().manual_seed(8)
    preds = torch.randint(0, 2, (1, 8, 4070), generator=g, dtype=torch.int32).to(dev)
    y = torch.randint(0, 2, (1, 4070), generator=g, dtype=torch.int32).to(dev)
    w = (torch.rand(1, 4070, generator=g) / 4070).to(dev)
    got = _poisoned(dev, (1, 8), lambda: ops.weighted_errors(preds, y, w))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.weighted_errors_ref(preds, y, w), rtol=1e-4, atol=0)


def test_interpreted_round_launches_per_collaborator(dev):
    """One interpreted AdaBoost.F round at C = 4: a tree fit per
    collaborator (4 tree_hist each), a weighted_errors per shard and a
    product per collaborator, no renormalising update, no plain version
    on the card; the chosen member is the CPU's."""
    from repro_torch.launch import fl_run

    chosen = {}
    for device in ("cuda", "cpu"):
        ops.reset_launches()
        calls = dict(ref.device_calls)
        fed = fl_run.build_federation("vehicle", 4, 1, 4, 0, device,
                                      optimizations=fl_run.FAITHFUL)
        fed.run()
        if device == "cuda":
            assert ops.launch_counts() == {"tree_hist": 16, "weighted_errors": 4, "weight_update": 0,
                                           "weight_update_product": 4, "vote_argmax": 0,
                                           "flash_attention": 0}
            assert ref.device_calls == calls
        chosen[device] = fed.per_round()[0]["chosen"]
    assert chosen["cuda"] == chosen["cpu"]


def test_round_never_waits_for_the_card(dev):
    """Rounds run with CUDA's sync debug mode set to raise: the chosen
    index and alpha stay on the device, so no operation of a round
    copies to the host or synchronises."""
    from repro_torch.core import boosting
    from repro_torch.launch import fl_run

    fed = fl_run.build_federation("vehicle", 4, 3, 4, 0, dev)
    state = boosting.init_boost_state(fed.learner, fed.spec, 3, fed.masks, X=fed.Xs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, metrics = boosting.adaboost_f_round(
                fed.learner, fed.spec, state, fed.Xs, fed.ys, fed.masks)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert state.ensemble.count == 3 and 0 <= int(metrics["chosen"]) < 4


def test_a_round_launches_each_level_and_the_errors_once(dev):
    """One AdaBoost.F round of depth-4 trees: one tree_hist launch per
    level for all collaborators, one weighted_errors and one weight_update."""
    from repro_torch.core import boosting
    from repro_torch.launch import fl_run

    fed = fl_run.build_federation("vehicle", 4, 1, 4, 0, dev)
    state = boosting.init_boost_state(fed.learner, fed.spec, 1, fed.masks, X=fed.Xs)
    ops.reset_launches()
    boosting.adaboost_f_round(fed.learner, fed.spec, state, fed.Xs, fed.ys, fed.masks)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"tree_hist": 4, "weighted_errors": 1, "weight_update": 1,
                                   "weight_update_product": 0, "vote_argmax": 0,
                                   "flash_attention": 0}


def test_federation_on_the_card_goes_through_the_kernels(dev):
    from repro_torch.launch import fl_run

    ops.reset_launches()
    calls = dict(ref.device_calls)
    hist = fl_run.main(["--dataset", "vehicle", "--collaborators", "4", "--rounds", "3",
                        "--eval-every", "3"])
    assert ops.launch_counts() == {"tree_hist": 12, "weighted_errors": 3, "weight_update": 3,
                                   "weight_update_product": 0, "vote_argmax": 0,
                                   "flash_attention": 0}
    assert ref.device_calls == calls
    assert 0.0 < hist[-1]["f1"] <= 1.0


@pytest.mark.parametrize("algorithm,learner,want", [
    ("distboost_f", "decision_tree", {"tree_hist": 12, "weighted_errors": 0, "weight_update": 3}),
    ("preweak_f", "decision_tree", {"tree_hist": 12, "weighted_errors": 3, "weight_update": 3}),
    ("bagging", "decision_tree", {"tree_hist": 12, "weighted_errors": 0, "weight_update": 0}),
    ("adaboost_f", "extra_tree", {"tree_hist": 12, "weighted_errors": 3, "weight_update": 3}),
])
def test_new_federations_on_the_card_go_through_the_kernels(dev, algorithm, learner, want):
    """DistBoost.F, PreWeak.F (its T local rounds at set-up), bagging and
    extra_tree: each level one tree_hist, PreWeak.F's rounds one
    weighted_errors over the C*T cache, no plain version on the card, and
    the card's round-0 choice, epsilon and F1 are the CPU's (the same draws)."""
    from repro_torch.launch import fl_run

    runs = {}
    for device in ("cuda", "cpu"):
        ops.reset_launches()
        calls = dict(ref.device_calls)
        fed = fl_run.build_federation("vehicle", 4, 3, 4, 0, device, algorithm=algorithm,
                                      learner=learner)
        hist = fed.run(eval_every=3)
        if device == "cuda":
            assert ops.launch_counts() == {**want, "weight_update_product": 0, "vote_argmax": 0,
                                           "flash_attention": 0}
            assert ref.device_calls == calls
        runs[device] = (fed.per_round()[0], hist[-1]["f1"])
    (card, f1_card), (cpu, f1_cpu) = runs["cuda"], runs["cpu"]
    assert card["chosen"] == cpu["chosen"]
    assert abs(card["epsilon"] - cpu["epsilon"]) <= 1e-4 * abs(cpu["epsilon"])
    assert 0.0 < f1_card <= 1.0 and abs(f1_card - f1_cpu) <= 0.02


@pytest.mark.parametrize("T,n,K", [(10, 256, 10), (100, 256, 26), (100, 4096, 26),
                                   (0, 7, 3), (13, 1001, 5), (4, 300, 400),
                                   (300, 333, 7), (1000, 256, 26),  # past one 128-member tile
                                   (6, 77, 1808)])  # 16 classes a thread
def test_vote_argmax_kernel_matches_plain(dev, T, n, K):
    g = torch.Generator().manual_seed(T + n + K)
    # out-of-range predictions vote for nothing; half-integer alphas with
    # many equal values put exact ties in the sums
    preds = torch.randint(-1, K + 1, (T, n), generator=g, dtype=torch.int32).to(dev)
    alpha = (torch.randint(0, 4, (T,), generator=g).float() * 0.5).to(dev)
    before = ops.launch_counts()["vote_argmax"]
    got = _poisoned(dev, (n,), lambda: ops.vote_argmax(preds, alpha, n_classes=K))
    want = ref.vote_argmax_ref(preds, alpha, K)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ops.launch_counts()["vote_argmax"] == before + 1


def test_vote_argmax_kernel_nan_votes_rank_as_the_plain_version_ranks_them(dev):
    """A NaN or infinite alpha makes NaN votes (alpha * 0); the kernel
    ranks them as torch.argmax does, so it answers what the plain version
    answers."""
    g = torch.Generator().manual_seed(5)
    preds = torch.randint(-1, 7, (20, 203), generator=g, dtype=torch.int32).to(dev)
    alpha = torch.randint(0, 4, (20,), generator=g).float() * 0.5
    alpha[3], alpha[11] = float("nan"), float("inf")
    alpha = alpha.to(dev)
    assert torch.equal(ops.vote_argmax(preds, alpha, n_classes=6), ref.vote_argmax_ref(preds, alpha, 6))


@pytest.mark.parametrize("spread", ["arbitrary", "ulps apart"])
def test_vote_argmax_kernel_equals_a_member_by_member_tally(dev, spread):
    """At letter's serving shape, with float alphas whose sums depend on
    the order of the adds, the kernel answers bit for bit what a
    ``VoteTally`` built one member at a time in ascending order answers
    (the vote cache's rule)."""
    import dataclasses
    from typing import NamedTuple

    from repro_torch.core import boosting, scoring
    from repro_torch.learners.base import LearnerSpec, WeakLearner

    class Votes(NamedTuple):
        preds: torch.Tensor

    @dataclasses.dataclass(frozen=True)
    class Stub(WeakLearner):
        def predict(self, spec, params, X):
            return params.preds

    T, n, K = 100, 256, 26
    g = torch.Generator().manual_seed(26)
    preds = torch.randint(0, K, (T, n), generator=g, dtype=torch.int32).to(dev)
    if spread == "arbitrary":
        alpha = torch.rand(T, generator=g) * 3.0
    else:  # equal counts of members tell classes apart only by the order of rounding
        alpha = 1.0 + torch.randint(0, 4, (T,), generator=g) * 2.0**-23
    alpha = alpha.to(dev)
    ens = boosting.Ensemble(Votes(preds), alpha, T)
    tally = scoring.tally_new_votes(Stub("stub", None, None, None), LearnerSpec("stub", 1, K), ens,
                                    scoring.init_tally(n, K, dev), torch.zeros(n, 1, device=dev))
    got = ops.vote_argmax(preds, alpha, n_classes=K)
    torch.cuda.synchronize()
    assert torch.equal(got, scoring.tally_predict(tally))


def test_engine_on_the_card_launches_the_kernel_once_per_batch(dev):
    from repro_torch.core import boosting
    from repro_torch.learners import LearnerSpec, get_learner
    from repro_torch.serve import ServeEngine

    g = torch.Generator().manual_seed(0)
    spec = LearnerSpec("decision_tree", 6, 5, {"depth": 3, "n_bins": 16})
    learner = get_learner("decision_tree")
    ens = boosting.init_ensemble(learner, spec, 8, dev)
    ens.params.feature.copy_(torch.randint(0, 6, (8, 3), generator=g, dtype=torch.int32))
    ens.params.threshold.copy_(torch.randn(8, 3, generator=g))
    ens.params.leaf_logits.copy_(torch.randn(8, 8, 5, generator=g))
    ens.alpha.copy_(torch.randint(1, 9, (8,), generator=g) * 0.5)  # exact vote sums
    ens = boosting.Ensemble(ens.params, ens.alpha, 6)
    X = torch.randn(300, 6, generator=g).numpy()
    engine = ServeEngine(learner, spec, ens, batch_size=64)
    calls = dict(ref.device_calls)
    before = ops.launch_counts()["vote_argmax"]
    got = engine.predict(X)
    assert engine.stats.batches == 5
    assert ops.launch_counts()["vote_argmax"] == before + engine.stats.batches
    assert ref.device_calls == calls
    cpu = ServeEngine(learner, spec, boosting.ensemble_to(ens, "cpu"), batch_size=64)
    assert (got == cpu.predict(X)).all()


def test_serving_on_the_card_goes_through_the_kernel(dev, tmp_path):
    """One vote_argmax launch per served batch (and one for the warmup),
    no plain version on the card, and the cache answers what the engine
    answers: both sum the members in ascending order."""
    from repro_torch.launch import serve_fl

    ops.reset_launches()
    calls = dict(ref.device_calls)
    out = serve_fl.main(["--dataset", "vehicle", "--rounds", "3", "--batch", "64",
                         "--artifact", str(tmp_path / "v.mafl"), "--policy", "deadline"])
    stats = out["stats"]
    assert stats.batches == 3 and stats.warmup_batches == 1
    assert ops.launch_counts()["vote_argmax"] == stats.batches + stats.warmup_batches
    assert ref.device_calls == calls
    assert 0.0 < out["f1"] <= 1.0


# flash_attention: tests/test_kernels.py's sweep, the fully-masked-tiles case
# and gemma-2b's head shapes, each in float32 (the CUDA-core kernel) and in
# bfloat16 (the TMA/wgmma kernel); atol 2e-5 in float32; in bfloat16 one ulp
# of rounding apart (rtol 1e-2) plus atol 4e-3, as chip_smoke.py holds it
_FLASH_SHAPES = [  # B, H, Hkv, S, T, D, causal, window, softcap
    (2, 4, 2, 128, 128, 64, True, None, None),
    (1, 4, 1, 128, 128, 64, True, 64, None),
    (1, 2, 2, 96, 160, 32, True, None, 30.0),
    (1, 2, 2, 128, 128, 64, False, None, None),
    (1, 2, 2, 100, 100, 64, True, None, None),
    (1, 2, 2, 256, 256, 32, True, 16, None),
    (2, 8, 1, 65, 65, 256, True, None, None),
]
FLASH = [  # B, H, Hkv, S, T, D, causal, window, softcap, dtype
    *((*case, torch.float32) for case in _FLASH_SHAPES),
    *((*case, torch.bfloat16) for case in _FLASH_SHAPES),
    (1, 8, 2, 128, 128, 128, True, None, None, torch.bfloat16),
    (4, 8, 1, 64, 64, 256, True, None, None, torch.bfloat16),
    (2, 2, 1, 130, 130, 128, True, None, None, torch.bfloat16),
    (1, 4, 1, 40, 200, 128, True, None, None, torch.bfloat16),
]


@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal,window,softcap,dtype", FLASH)
def test_flash_attention_kernel_matches_plain(dev, B, H, Hkv, S, T, D, causal, window, softcap,
                                              dtype):
    g = torch.Generator().manual_seed(S + T + D)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(dev)
               for shape in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    want = ref.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2 if bf16 else 0.0,
                               atol=4e-3 if bf16 else 2e-5)


def test_flash_attention_kernel_takes_transposed_views(dev):
    """The model hands the kernel [B, S, H, D] tensors transposed to
    [B, H, S, D]: strided views, no copy; the output keeps that layout."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 70, 8, 256, generator=g).to(dev).transpose(1, 2)
    k, v = (torch.randn(2, 70, 1, 256, generator=g).to(dev).transpose(1, 2) for _ in range(2))
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.stride() == q.stride()
    torch.testing.assert_close(got, ref.attention_ref(q, k, v), rtol=0, atol=2e-5)


def test_flash_attention_bf16_kernel_takes_transposed_views(dev):
    """The same in bfloat16, the model's dtype: the tensor maps are built
    from the views' strides, so nothing is copied."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 70, 8, 256, generator=g).to(torch.bfloat16).to(dev).transpose(1, 2)
    k, v = (torch.randn(2, 70, 1, 256, generator=g).to(torch.bfloat16).to(dev).transpose(1, 2)
            for _ in range(2))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.stride() == q.stride() and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.attention_ref(q, k, v).float(), rtol=1e-2, atol=4e-3)


@pytest.mark.parametrize("bad", ["address", "row_stride"])
def test_flash_attention_bf16_kernel_raises_on_views_tma_cannot_describe(dev, bad):
    """A bf16 view whose address or strides are not multiples of 16 bytes
    raises; it is neither copied nor handed to another kernel."""
    if bad == "address":  # 2 bytes into an aligned buffer
        q = torch.zeros(1, 2, 64, 72, dtype=torch.bfloat16, device=dev)[..., 1:65]
    else:  # 136 bytes between rows
        q = torch.zeros(1, 2, 64, 68, dtype=torch.bfloat16, device=dev)[..., :64]
    k = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16, device=dev)
    before = ops.launch_counts()["flash_attention"]
    calls = dict(ref.device_calls)
    with pytest.raises(ValueError, match="TMA"):
        ops.flash_attention(q, k, k)
    assert ops.launch_counts()["flash_attention"] == before
    assert ref.device_calls == calls


def test_llm_serving_on_the_card_goes_through_the_kernel(dev):
    """Reduced gemma-2b: one flash_attention launch per layer of the
    prefill, none per decode step, no plain version on the card; and from
    the same weights and prompts, the card's greedy tokens equal the CPU's."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve

    ops.reset_launches()
    calls = dict(ref.device_calls)
    out = serve.main(["--batch", "2", "--prompt-len", "40", "--tokens", "6"])
    assert ops.launch_counts()["flash_attention"] == 2  # reduced: 2 layers
    assert ref.device_calls == calls
    assert out["logits_finite"] and out["tokens"].shape == (2, 7)

    cfg = get_arch("gemma-2b").reduced()
    card = serve.build(cfg, 0, dev)
    cpu = serve.build(cfg, 0, torch.device("cpu"))
    cpu.load_state_dict(card.state_dict())
    prompts = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    got = serve.generate(card, prompts.to(dev), 6)["tokens"]
    assert torch.equal(got.cpu(), serve.generate(cpu, prompts, 6)["tokens"])


# -- the other learners, the Dirichlet split, heterogeneous federations -------------


def _dirichlet_mask():
    """adult's Dirichlet split as fl_run draws it (C = 8, alpha 0.5, seed 0):
    [8, n_max], most of each row's tail padding."""
    from repro_torch.launch import fl_run

    return fl_run.build_federation("adult", 8, 1, 4, 0, "cpu", split="dirichlet").masks


def test_weight_update_kernel_under_a_dirichlet_mask(dev):
    """Rows padded to the largest shard: the padding stays exactly 0 after
    the renormalisation, the total is 1, rtol 1e-5 against the plain
    version, the same bits twice."""
    mask = _dirichlet_mask()
    g = torch.Generator().manual_seed(18)
    w = torch.rand(mask.numel(), generator=g) * mask.reshape(-1)
    w, m = (w / w.sum()).to(dev), mask.reshape(-1).to(dev)
    mis = (torch.rand(mask.numel(), generator=g) < 0.3).float().to(dev)
    for a in (0.37, -2.0, 10.0):
        alpha = torch.tensor(a, device=dev)
        got = ops.weight_update(w, mis, m, alpha)
        again = ops.weight_update(w, mis, m, alpha)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.renormalised_weight_update_ref(w, mis, m, alpha),
                                   rtol=1e-5, atol=0)
        assert torch.equal(got, again)
        assert bool((got[m == 0] == 0).all())
        assert abs(float(got.double().sum()) - 1.0) < 1e-5


def test_weighted_errors_kernel_with_zero_weight_tails(dev):
    mask = _dirichlet_mask()
    C, n = mask.shape
    g = torch.Generator().manual_seed(19)
    w = torch.rand(C, n, generator=g) * mask
    w = (w / w.sum()).to(dev)
    preds = torch.randint(0, 2, (C, C, n), generator=g, dtype=torch.int32).to(dev)
    y = torch.randint(0, 2, (C, n), generator=g, dtype=torch.int32).to(dev)
    got = ops.weighted_errors(preds, y, w)
    again = ops.weighted_errors(preds, y, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.weighted_errors_ref(preds, y, w), rtol=1e-4, atol=0)
    assert torch.equal(got, again)


def test_vote_argmax_kernel_at_the_hetero_engine_shape_equals_a_member_by_member_tally(dev):
    """pendigits, 3 groups of T = 10 stacked: [30, 256], K = 10."""
    from repro_torch.core import scoring

    g = torch.Generator().manual_seed(30)
    preds = torch.randint(0, 10, (30, 256), generator=g, dtype=torch.int32).to(dev)
    alpha = (torch.rand(30, generator=g) * 3.0).to(dev)
    got = ops.vote_argmax(preds, alpha, n_classes=10)
    votes = scoring.init_tally(256, 10, dev).votes
    for t in range(30):  # one fp32 add a member, ascending, as scoring.tally_new_votes
        votes = votes + alpha[t] * ref.one_hot(preds[t], 10, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, scoring.tally_predict(scoring.VoteTally(votes, 30)))


def test_a_mixed_round_on_the_card_matches_the_cpu(dev):
    """One AdaBoost.F round of six families over 8 collaborators on the
    adult Dirichlet split: 8 tree_hist (two tree groups x depth 4), one
    weighted_errors, one weight_update, no plain version on the card, and
    the CPU's winner, epsilon (rtol 1e-4) and group counts."""
    from repro_torch.core import boosting, hetero
    from repro_torch.launch import fl_run

    learners = ("decision_tree", "extra_tree", "ridge", "gaussian_nb", "nearest_centroid", "mlp")
    out = {}
    for device in ("cuda", "cpu"):
        fed = fl_run.build_federation("adult", 8, 1, 4, 0, device, learners=learners,
                                      split="dirichlet")
        state = hetero.init_hetero_boost_state(fed.spec, 1, fed.masks, X=fed.Xs)
        stages = hetero.hetero_adaboost_f_stages(fed.spec, generator=fed.generator)
        ops.reset_launches()
        calls = dict(ref.device_calls)
        state, metrics = boosting.run_stages(stages, state, fed.Xs, fed.ys, fed.masks)
        if device == "cuda":
            torch.cuda.synchronize()
            assert ops.launch_counts() == {"tree_hist": 8, "weighted_errors": 1,
                                           "weight_update": 1, "weight_update_product": 0,
                                           "vote_argmax": 0, "flash_attention": 0}
            assert ref.device_calls == calls
        out[device] = (int(metrics["chosen"]), float(metrics["epsilon"]),
                       [e.count for e in state.ensemble])
    (c_gpu, e_gpu, n_gpu), (c_cpu, e_cpu, n_cpu) = out["cuda"], out["cpu"]
    assert c_gpu == c_cpu and n_gpu == n_cpu
    assert abs(e_gpu - e_cpu) <= 1e-4 * abs(e_cpu)


# -- the elastic runtime and the registry on the card --------------------------------

ELASTIC_CHAOS = dict(deadline_s=1.0, seed=7, drop_p=0.2, kills=((2, 3),))
ELASTIC_LATE = dict(deadline_s=0.5, seed=3, delay_p=0.4, delay_range_s=(0.6, 1.4))


def _elastic_run(device, algorithm, deadline_s=None, **faults):
    from repro_torch.fl.elastic import FaultPlan, ParticipationPolicy
    from repro_torch.launch import fl_run

    fed = fl_run.build_federation("vehicle", 4, 6, 4, 0, device, algorithm=algorithm)
    ops.reset_launches()
    calls = dict(ref.device_calls)
    hist = fed.run(eval_every=1, policy=ParticipationPolicy(deadline_s=deadline_s),
                   faults=FaultPlan(**faults) if faults else None)
    if device == "cuda":
        torch.cuda.synchronize()
        assert ref.device_calls == calls
    return fed, hist, ops.launch_counts()


def test_two_fused_runs_on_the_card_are_the_same_bits(dev):
    """The same run twice on the card gives the same ensemble to the bit: the
    trees' leaf counts are a sum over the samples, not a float scatter-add
    (whose atomics add in arrival order)."""
    from repro_torch.launch import fl_run

    runs = []
    for _ in range(2):
        fed = fl_run.build_federation("adult", 8, 3, 4, 0, "cuda")
        fed.run(eval_every=3)
        runs.append(fed.state)
    assert torch.equal(runs[0].weights, runs[1].weights)
    for a, b in zip(runs[0].ensemble.params, runs[1].ensemble.params):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algorithm", ["adaboost_f", "distboost_f", "preweak_f", "bagging"])
def test_elastic_noop_on_the_card_is_the_fused_run_bit_for_bit(dev, algorithm):
    """No faults, no deadline: the fused run's launches (no product) and its
    bits: history, weights and every ensemble leaf."""
    from repro_torch.launch import fl_run

    fused = fl_run.build_federation("vehicle", 4, 6, 4, 0, "cuda", algorithm=algorithm)
    ops.reset_launches()
    h1 = fused.run(eval_every=1)
    want = ops.launch_counts()
    elastic, h2, got = _elastic_run("cuda", algorithm)
    assert got == want and got["weight_update_product"] == 0
    key = ("round", "f1", "epsilon", "alpha", "chosen")
    assert [{k: r[k] for k in key} for r in h2] == [{k: r[k] for k in key} for r in h1]
    assert elastic.per_round() == fused.per_round()
    assert torch.equal(elastic.state.weights, fused.state.weights)
    for a, b in zip(elastic.state.ensemble.params, fused.state.ensemble.params):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algorithm", ["adaboost_f", "distboost_f"])
def test_elastic_partial_rounds_on_the_card_launch_the_product(dev, algorithm):
    """Drops and a kill: one weight_update_product a partial round, one
    weight_update a full one; the CPU's responders and dropouts, its
    round-0 member and F1 within 0.02."""
    out = {d: _elastic_run(d, algorithm, **ELASTIC_CHAOS) for d in ("cuda", "cpu")}
    (card, h_card, launches), (cpu, h_cpu, _) = out["cuda"], out["cpu"]
    e = card.elastic
    partial = sum(1 for n in e.responders_log if 0 < n < 4)
    full = sum(1 for n in e.responders_log if n == 4)
    assert partial > 0
    assert launches["weight_update_product"] == partial and launches["weight_update"] == full
    assert e.responders_log == cpu.elastic.responders_log
    assert dict(e.dropouts) == dict(cpu.elastic.dropouts)
    assert card.per_round()[0]["chosen"] == cpu.per_round()[0]["chosen"]
    assert abs(h_card[-1]["f1"] - h_cpu[-1]["f1"]) <= 0.02


def test_elastic_late_merges_on_the_card_match_the_cpu(dev):
    out = {d: _elastic_run(d, "adaboost_f", **ELASTIC_LATE) for d in ("cuda", "cpu")}
    card, cpu = out["cuda"][0].elastic, out["cpu"][0].elastic
    key = ("src_round", "merged_round", "collaborator", "lateness", "discount")
    assert card.late_log and [{k: r[k] for k in key} for r in card.late_log] == \
        [{k: r[k] for k in key} for r in cpu.late_log]
    for r in card.late_log:
        assert r["alpha"] == r["base_alpha"] * r["discount"]
        assert abs(r["alpha"]) <= abs(r["base_alpha"])
    skipped = sum(1 for n in card.responders_log if n == 0)
    assert card.state.ensemble.count == 6 - skipped + len(card.late_log)


def test_masked_update_weights_on_the_card_matches_the_cpu(dev):
    from repro_torch.core import scoring

    g = torch.Generator().manual_seed(0)
    w = torch.rand(8, 4070, generator=g)
    w = w / w.sum()
    mis = (torch.rand(8, 4070, generator=g) < 0.3).float()
    mask = torch.ones(8, 4070)
    part = [1, 0, 1, 1, 0, 1, 1, 1]
    alpha = torch.tensor(0.37)
    before = ops.launch_counts()
    got = scoring.masked_update_weights(w.to(dev), mis.to(dev), mask.to(dev),
                                        scoring.participation(part, dev), alpha.to(dev))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["weight_update_product"] == before["weight_update_product"] + 1
    assert after["weight_update"] == before["weight_update"]
    want = scoring.masked_update_weights(w, mis, mask, scoring.participation(part, "cpu"), alpha)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)


def test_registry_on_the_card_swaps_rebuilds_and_serves_through_the_kernel(dev, tmp_path):
    """A lockstep stream swaps, a DistBoost.F committee stream rebuilds; one
    vote_argmax launch a served batch; the CPU's votes."""
    from repro_torch.core import boosting
    from repro_torch.launch import fl_run
    from repro_torch.serve import EngineConfig, ModelRegistry, ServeEngine, latest_artifact, load_artifact

    reg = ModelRegistry(config=EngineConfig(batch_size=64))

    def follow(path, version):
        if not reg.tenants():
            reg.add_tenant("v", tmp_path)
        else:
            reg.refresh()

    for rounds, every, alg in [(4, 2, "adaboost_f"), (6, 6, "distboost_f")]:
        fed = fl_run.build_federation("vehicle", 4, rounds, 4, 0, "cuda", algorithm=alg)
        fed.run(eval_every=rounds, publish_every=every, publish_dir=str(tmp_path), on_checkpoint=follow)
    t = reg.stats()["tenants"]["v"]
    assert (t["swaps"], t["rebuilds"], t["version"]) == (1, 1, 6)
    X = torch.randn(300, fed.spec.n_features, generator=torch.Generator().manual_seed(1)).numpy()
    calls = dict(ref.device_calls)
    before = ops.launch_counts()["vote_argmax"]
    got = reg.predict("v", X)
    assert ops.launch_counts()["vote_argmax"] == before + reg.engine("v").stats.batches == before + 5
    assert ref.device_calls == calls
    art = load_artifact(latest_artifact(tmp_path), "cpu")
    cpu = ServeEngine.from_artifact(art).predict(X)
    votes = boosting.ensemble_votes(art.learner, art.spec, art.ensemble, torch.from_numpy(X),
                                    committee=True)
    top2 = votes.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1] <= 1e-5 * float(art.ensemble.alpha.abs().sum())).numpy()
    assert not ((got != cpu) & ~near).any()  # the CPU's votes outside the near-tie gap


# -- the multi-process federation on the card ------------------------------------------


def _spawn_on_the_card(P, argv, tmp_path):
    """``fl_spawn -n P -- argv`` on the card (fl_run's default device);
    returns process 0's history file."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    hist = tmp_path / "h.json"
    src = str(Path(__file__).resolve().parent.parent / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in [src, os.environ.get("PYTHONPATH", "")] if p))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.fl_spawn", "-n", str(P),
                           "--timeout", "150", "--", *argv, "--eval-every", "1",
                           "--history-out", str(hist)],
                          env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(hist.read_text())


def test_two_processes_on_the_card_choose_the_fused_members(dev, tmp_path):
    """``fl_spawn -n 2`` on the card: the fused card run's chosen member
    every round and its F1 within 0.02; 3 collectives a round."""
    from repro_torch.launch import fl_run

    run = _spawn_on_the_card(2, ["--dataset", "vehicle", "--rounds", "4"], tmp_path)
    assert run["device"].startswith("cuda") and run["collective_calls"] == 3 * 4
    fed = fl_run.build_federation("vehicle", 2, 4, 4, 0, "cuda")
    hist = fed.run(eval_every=1)
    assert [r["chosen"] for r in run["rounds"]] == [r["chosen"] for r in fed.per_round()]
    assert abs(run["history"][-1]["f1"] - hist[-1]["f1"]) <= 0.02


def test_pack_and_unpack_cuda_tensors(dev):
    """The packed buffer of CUDA tensors is the CPU's bytes and unpacks on
    the card, a gathered [P, L] buffer too."""
    from repro_torch.fl.sharded import _pack_leaves, _unpack_leaves
    from repro_torch.learners.tree import TreeParams

    g = torch.Generator().manual_seed(0)
    tree = TreeParams(torch.randint(-9, 2**20, (5, 4), generator=g, dtype=torch.int32),
                      torch.randn(5, 4, generator=g), torch.randn(5, 16, 2, generator=g))
    buf, fmt = _pack_leaves(TreeParams(*(x.to(dev) for x in tree)))
    assert buf.is_cuda
    assert buf.cpu().numpy().tobytes() == _pack_leaves(tree)[0].numpy().tobytes()
    out = _unpack_leaves(torch.stack([buf, buf]), fmt, lead=(2,))
    for a, b in zip(out, tree):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a[1].cpu(), b)


def test_elastic_kill_on_the_card(dev, tmp_path):
    """Three processes of the socket star on the card, collaborator 2
    killed at round 2: evicted, every round recorded."""
    run = _spawn_on_the_card(3, ["--elastic", "--dataset", "vehicle", "--rounds", "4",
                                 "--deadline-ms", "3000", "--fault-kill", "2:2"], tmp_path)
    assert run["evicted"] == [2] and run["dropouts"].get("dead") == 1
    assert len(run["history"]) == 4 and all(n <= 2 for n in run["responders"][2:])
    assert run["device"].startswith("cuda")
