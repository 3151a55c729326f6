"""The port's CUDA kernels on the card: each against its plain version at
the main path's shapes, and a short federation that must go through the
kernels.  Imports no JAX, so it runs on a machine with a card:

  python -m pytest -q -m cuda tests/test_torch_cuda.py

Where ``torch.cuda.is_available()`` is False every test here skips.
Tolerances are the card's: atomics reorder the histogram sum (atol 1e-4,
on cells of mass up to about 1, as on the main path), errors rtol 1e-4,
weights rtol 1e-5.
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


@pytest.mark.parametrize("N", [32560, 16000, 50000, 1])
def test_weight_update_kernel_matches_plain(dev, N):
    g = torch.Generator().manual_seed(N)
    w = torch.rand(N, generator=g).to(dev)
    mis = (torch.rand(N, generator=g) < 0.4).float().to(dev)
    mask = torch.ones(N, device=dev)
    alpha = torch.tensor(0.7, device=dev)
    got = ops.weight_update(w, mis, mask, alpha)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.boost_weight_update_ref(w, mis, mask, alpha), rtol=1e-5, atol=0)


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


def test_federation_on_the_card_goes_through_the_kernels(dev):
    from repro_torch.launch import fl_run

    ops.reset_launches()
    calls = dict(ref.device_calls)
    hist = fl_run.main(["--dataset", "vehicle", "--collaborators", "4", "--rounds", "3",
                        "--eval-every", "3"])
    assert ops.launch_counts() == {"tree_hist": 12, "weighted_errors": 3, "weight_update": 3}
    assert ref.device_calls == calls
    assert 0.0 < hist[-1]["f1"] <= 1.0
