"""The port's ``vote_argmax`` on the CPU: its plain version against the JAX
oracle and the Pallas kernel in interpret mode, exactly, from the same
numpy inputs; constructed ties, out-of-range predictions and empty
shapes; the wrapper's CPU dispatch and launch plan.  The CUDA kernel is
held to the plain version on the card (tests/test_torch_cuda.py).

Half-integer alphas make every vote sum exact in f32, so the order in
which either side sums the members cannot flip an argmax: equality is
exact, as in tests/test_serve.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.vote_argmax import vote_argmax as pallas_vote_argmax
from repro_torch.kernels import ops, ref
from repro_torch.kernels.vote_argmax import MAX_CLASSES, SHARED_BYTES, launch_plan


def _inputs(seed, T, n, K, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    preds = rng.integers(lo, K if hi is None else hi, size=(T, n), dtype=np.int32)
    alpha = (rng.integers(1, 9, size=T) * 0.5).astype(np.float32)
    alpha[max(T - 2, 0):] = 0.0  # unused tail slots vote 0
    return preds, alpha


def _port(preds, alpha, K):
    return ops.vote_argmax(torch.from_numpy(preds), torch.from_numpy(alpha), n_classes=K).numpy()


def _jax(preds, alpha, K):
    return np.asarray(jref.vote_argmax_ref(jnp.asarray(preds), jnp.asarray(alpha), K))


@pytest.mark.parametrize("T,n,K,block_t,block_n", [
    (13, 1000, 7, 8, 256),   # T % block_t != 0, n % block_n != 0
    (5, 31, 3, 32, 1024),    # everything smaller than one block
    (33, 2049, 10, 16, 512), # n one past a block boundary
])
def test_vote_argmax_ref_matches_jax_and_pallas(T, n, K, block_t, block_n):
    preds, alpha = _inputs(T * n, T, n, K)
    got = _port(preds, alpha, K)
    assert got.dtype == np.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got, _jax(preds, alpha, K))
    pallas = pallas_vote_argmax(jnp.asarray(preds), jnp.asarray(alpha), n_classes=K,
                                block_t=block_t, block_n=block_n, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_vote_argmax_ties_go_to_the_lowest_class():
    # sample 0: classes 3 and 1 tie at 1.0; sample 1: classes 2 and 0 tie
    # at 0.5 (5 is out of range); sample 2: no class gets any weight
    preds = np.array([[3, 5, -1], [1, 2, 7], [1, 0, 5], [4, 1, 3]], np.int32)
    alpha = np.array([1.0, 0.5, 0.5, 0.0], np.float32)
    got = _port(preds, alpha, 5)
    np.testing.assert_array_equal(got, [1, 0, 0])
    np.testing.assert_array_equal(got, _jax(preds, alpha, 5))


def test_vote_argmax_out_of_range_predictions_vote_for_nothing():
    preds, alpha = _inputs(3, 9, 300, 6, lo=-3, hi=10)
    got = _port(preds, alpha, 6)
    np.testing.assert_array_equal(got, _jax(preds, alpha, 6))
    inside = np.where((preds >= 0) & (preds < 6), preds, 0)
    masked_alpha = alpha[:, None] * ((preds >= 0) & (preds < 6))
    votes = np.zeros((300, 6), np.float32)
    for t in range(9):
        np.add.at(votes, (np.arange(300), inside[t]), masked_alpha[t])
    np.testing.assert_array_equal(got, votes.argmax(-1))


@pytest.mark.parametrize("T,n", [(0, 17), (6, 17)])
def test_vote_argmax_no_votes_gives_class_zero(T, n):
    preds, _ = _inputs(T + n, T, n, 4)
    alpha = np.zeros(T, np.float32)  # T = 0, or every member with alpha 0
    got = _port(preds, alpha, 4)
    np.testing.assert_array_equal(got, np.zeros(n, np.int32))
    np.testing.assert_array_equal(got, _jax(preds, alpha, 4))


def test_vote_argmax_empty_batch():
    preds, alpha = _inputs(1, 5, 0, 3)
    got = _port(preds, alpha, 3)
    assert got.shape == (0,) and got.dtype == np.int32


def test_vote_argmax_cpu_dispatch_takes_the_plain_version():
    preds, alpha = _inputs(2, 4, 50, 3)
    before, calls = ops.launch_counts()["vote_argmax"], dict(ref.device_calls)
    _port(preds, alpha, 3)
    assert ops.launch_counts()["vote_argmax"] == before  # CPU calls never count
    assert ref.device_calls == calls  # nor as plain versions on the card


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "classes"])
def test_vote_argmax_rejects_what_the_kernel_does_not_take(bad):
    preds = torch.zeros(4, 8, dtype=torch.int32)
    alpha = torch.ones(4)
    K = 3
    if bad == "dtype":
        preds = preds.long()
    elif bad == "shape":
        alpha = torch.ones(5)
    elif bad == "contiguous":
        preds = torch.zeros(8, 4, dtype=torch.int32).t()
    else:
        K = 0
    with pytest.raises((TypeError, ValueError)):
        ops.vote_argmax(preds, alpha, n_classes=K)


@pytest.mark.parametrize("K,cpt,threads", [
    (2, 1, 32), (10, 1, 96), (26, 1, 224),  # a thread per (sample, class), whole warps
    (400, 4, 800), (1808, 16, 928),  # K * strip past one block: several classes a thread
])
def test_vote_argmax_launch_plan(K, cpt, threads):
    """An 8-sample strip a block; classes per thread the fewest of 1, 2,
    4, 8, 16 that keep the block at 1024 threads; every class owned by
    one thread; the static shared memory (two member tiles and the argmax
    pairs) under the 48 KB a block has without opting in, whatever K."""
    plan = launch_plan(K)
    assert (plan.strip, plan.classes_per_thread, plan.threads) == (8, cpt, threads)
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.threads // plan.strip * plan.classes_per_thread >= K
    assert plan.shared_bytes == SHARED_BYTES == 2 * 128 * (8 + 1) * 4 + 32 * 8 * 8
    assert plan.shared_bytes <= 48 * 1024


def test_vote_argmax_launch_plan_raises_past_the_shared_memory():
    """Every K up to 2048 has a plan (the old limit, set by shared memory,
    was 1808); past it the wrapper raises, naming the limit."""
    assert MAX_CLASSES == 2048 and launch_plan(MAX_CLASSES).classes_per_thread == 16
    with pytest.raises(ValueError, match="2049 classes exceed the 2048"):
        launch_plan(MAX_CLASSES + 1)
