"""The port's kernels on the CPU: plain versions against the JAX oracles
(and the Pallas kernels in interpret mode), the CPU dispatch of the
wrappers, and the launch plan.  The CUDA kernels themselves are held to
their plain versions in tests/test_torch_cuda.py, which imports no JAX so
that it runs on a machine with a card.

Inputs are numpy arrays made from a seed and handed to both sides.
CPU against CPU leaves little to explain, so the tolerances here are
tighter than the card's: histograms atol 1e-5, errors rtol 1e-5,
weights rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.boost_update import weight_update as pallas_weight_update
from repro.kernels.boost_update import weighted_errors as pallas_weighted_errors
from repro.kernels.tree_hist import tree_hist as pallas_tree_hist
from repro_torch.kernels import ops, ref
from repro_torch.kernels.tree_hist import MAX_SHARED_BYTES, launch_plan


def _hist_inputs(seed, shape, L, B1, K):
    rng = np.random.default_rng(seed)
    *lead, n, d = shape
    bins = rng.integers(0, B1, size=(*lead, n, d), dtype=np.int32)
    leaf = rng.integers(0, L, size=(*lead, n), dtype=np.int32)
    wy = rng.random((*lead, n, K), dtype=np.float32)
    return bins, leaf, wy


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# -- tree_hist ---------------------------------------------------------------


@pytest.mark.parametrize("n,d,L,B1,K", [
    (257, 5, 2, 9, 2),
    (1024, 14, 8, 17, 3),
    (512, 54, 16, 17, 7),
])
def test_tree_hist_ref_sweep(n, d, L, B1, K):
    bins, leaf, wy = _hist_inputs(0, (n, d), L, B1, K)
    got = ref.tree_hist_ref(*_t(bins, leaf, wy), L, B1)
    want = jref.tree_hist_ref(jnp.asarray(bins), jnp.asarray(leaf), jnp.asarray(wy), L, B1)
    assert got.shape == (L, d, B1, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("C,n,d,L,B1,K", [
    (3, 257, 5, 2, 9, 2),
    (5, 130, 7, 8, 17, 3),
    (8, 200, 16, 8, 17, 26),  # letter's class count
])
def test_tree_hist_batched_ref_sweep(C, n, d, L, B1, K):
    bins, leaf, wy = _hist_inputs(5, (C, n, d), L, B1, K)
    got = ref.tree_hist_batched_ref(*_t(bins, leaf, wy), L, B1)
    want = jref.tree_hist_batched_ref(jnp.asarray(bins), jnp.asarray(leaf), jnp.asarray(wy), L, B1)
    assert got.shape == (C, L, d, B1, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the batched plain version is the stack of single-slice ones, bit for bit
    per_slice = torch.stack([ref.tree_hist_ref(*_t(bins[c], leaf[c], wy[c]), L, B1) for c in range(C)])
    torch.testing.assert_close(got, per_slice, rtol=0, atol=0)


def test_tree_hist_ref_matches_pallas_interpret():
    C, n, d, L, B1, K = 3, 130, 7, 4, 9, 3
    bins, leaf, wy = _hist_inputs(7, (C, n, d), L, B1, K)
    got = ref.tree_hist_batched_ref(*_t(bins, leaf, wy), L, B1)
    want = pallas_tree_hist(jnp.asarray(bins), jnp.asarray(leaf), jnp.asarray(wy),
                            n_leaves=L, n_bins_p1=B1, block_s=64, block_d=4, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_tree_hist_zero_weight_rows_are_noops():
    C, n, d, L, B1, K = 2, 200, 6, 4, 9, 3
    bins, leaf, wy = _hist_inputs(6, (C, n, d), L, B1, K)
    m = n - 37
    masked = wy.copy()
    masked[:, m:] = 0.0
    got = ops.tree_hist(*_t(bins, leaf, masked), n_leaves=L, n_bins_p1=B1)
    want = ops.tree_hist(*_t(bins[:, :m].copy(), leaf[:, :m].copy(), wy[:, :m].copy()),
                         n_leaves=L, n_bins_p1=B1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    zero = ops.tree_hist(*_t(bins, leaf, np.zeros_like(wy)), n_leaves=L, n_bins_p1=B1)
    assert float(zero.abs().max()) == 0.0


@pytest.mark.parametrize("n,d,K", [(4070, 14, 2), (2000, 16, 26), (6250, 54, 2)])
@pytest.mark.parametrize("L", [1, 2, 4, 8])
def test_tree_hist_launch_plan_fits_the_card(n, d, K, L):
    """The main path's shapes (adult, letter, forestcover; C = 8, 16 bins)
    get a block that fits in shared memory and sample chunks that cover
    every sample with none empty."""
    plan = launch_plan(8, n, d, L, 17, K)
    assert 1 <= plan.dblk <= min(d, 8)
    assert plan.shared_bytes == L * plan.dblk * 17 * K * 4 <= MAX_SHARED_BYTES
    chunks = plan.n_chunks
    assert chunks >= 1
    chunk = -(-n // chunks)
    assert chunk * chunks >= n and (chunks - 1) * chunk < n  # no empty trailing chunk


def test_tree_hist_launch_plan_rejects_oversized_histogram():
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(1, 100, 4, 1024, 17, 26)


# -- weighted_errors -----------------------------------------------------------


@pytest.mark.parametrize("H,n", [(3, 100), (8, 1000), (33, 4096)])
def test_weighted_errors_ref_sweep(H, n):
    rng = np.random.default_rng(1)
    preds = rng.integers(0, 5, size=(H, n), dtype=np.int32)
    y = rng.integers(0, 5, size=n, dtype=np.int32)
    w = rng.random(n, dtype=np.float32)
    got = ref.weighted_errors_ref(*_t(preds, y, w))
    want = jref.weighted_errors_ref(jnp.asarray(preds), jnp.asarray(y), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("C,H,n", [(8, 8, 4070), (4, 33, 257)])
def test_weighted_errors_batched_is_rowwise(C, H, n):
    """One [C, H, n] call equals C per-shard JAX oracle calls."""
    rng = np.random.default_rng(2)
    preds = rng.integers(0, 3, size=(C, H, n), dtype=np.int32)
    y = rng.integers(0, 3, size=(C, n), dtype=np.int32)
    w = rng.random((C, n), dtype=np.float32)
    w[0] = 0.0  # a zero-weight shard
    got = ops.weighted_errors(*_t(preds, y, w))
    want = np.stack([
        np.asarray(jref.weighted_errors_ref(jnp.asarray(preds[c]), jnp.asarray(y[c]), jnp.asarray(w[c])))
        for c in range(C)
    ])
    assert got.shape == (C, H)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert float(got[0].abs().max()) == 0.0


def test_weighted_errors_ref_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    H, n = 5, 300
    preds = rng.integers(0, 4, size=(H, n), dtype=np.int32)
    y = rng.integers(0, 4, size=n, dtype=np.int32)
    w = rng.random(n, dtype=np.float32)
    got = ref.weighted_errors_ref(*_t(preds, y, w))
    want = pallas_weighted_errors(jnp.asarray(preds), jnp.asarray(y), jnp.asarray(w),
                                  block_h=4, block_s=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


# -- weight_update ---------------------------------------------------------------


def _update_inputs(n, seed=2):
    rng = np.random.default_rng(seed)
    w = rng.random(n, dtype=np.float32)
    mis = (rng.random(n) < 0.4).astype(np.float32)
    mask = (np.arange(n) < n - 3).astype(np.float32)
    return w, mis, mask


@pytest.mark.parametrize("n,alpha", [(100, 0.5), (4097, 2.0), (64, -1.0)])
def test_weight_update_ref_sweep(n, alpha):
    w, mis, mask = _update_inputs(n)
    got = ref.boost_weight_update_ref(*_t(w, mis, mask), torch.tensor(alpha, dtype=torch.float32))
    want = jref.boost_weight_update_ref(jnp.asarray(w), jnp.asarray(mis), jnp.asarray(mask),
                                        jnp.float32(alpha))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_weight_update_ref_matches_pallas_interpret():
    w, mis, mask = _update_inputs(300, seed=4)
    got = ops.weight_update(*_t(w, mis, mask), torch.tensor(1.5))
    want = pallas_weight_update(jnp.asarray(w), jnp.asarray(mis), jnp.asarray(mask),
                                jnp.float32(1.5), block_s=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- dispatch ----------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    ops.reset_launches()
    before = dict(ref.device_calls)
    bins, leaf, wy = _hist_inputs(8, (2, 50, 3), 2, 5, 2)
    ops.tree_hist(*_t(bins, leaf, wy), n_leaves=2, n_bins_p1=5)
    ops.weighted_errors(*_t(np.zeros((2, 3, 4), np.int32), np.zeros((2, 4), np.int32),
                            np.ones((2, 4), np.float32)))
    ops.weight_update(*_t(*_update_inputs(10)), torch.tensor(0.3))
    assert ops.launch_counts() == {"tree_hist": 0, "weighted_errors": 0, "weight_update": 0}
    assert ref.device_calls == before  # device_calls counts CUDA tensors only


def test_wrappers_check_dtypes():
    bins, leaf, wy = _hist_inputs(9, (2, 40, 3), 2, 5, 2)
    with pytest.raises(TypeError):
        ops.tree_hist(*_t(bins.astype(np.int64), leaf, wy), n_leaves=2, n_bins_p1=5)
    with pytest.raises(ValueError):
        ops.tree_hist(*_t(bins, leaf[:, :-1].copy(), wy), n_leaves=2, n_bins_p1=5)
    with pytest.raises(ValueError, match="batched"):  # the unbatched form is not taken
        ops.tree_hist(*_t(bins[0], leaf[0], wy[0]), n_leaves=2, n_bins_p1=5)
    with pytest.raises(ValueError):
        ops.weighted_errors(*_t(np.zeros((3, 4), np.int32), np.zeros(4, np.int32),
                                np.ones(4, np.float32)))
