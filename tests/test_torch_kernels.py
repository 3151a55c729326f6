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
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scoring as jscoring
from repro.kernels import ref as jref
from repro.kernels.boost_update import weight_update as pallas_weight_update
from repro.kernels.boost_update import weighted_errors as pallas_weighted_errors
from repro.kernels.tree_hist import tree_hist as pallas_tree_hist
from repro_torch.kernels import _build, ops, ref
from repro_torch.core import scoring
from repro_torch.kernels.boost_update import (
    UPDATE_REGISTERS, errors_plan, product_plan, update_plan,
)
from repro_torch.kernels.tree_hist import (
    MAX_FEATURES_PER_BLOCK, MAX_SHARED_BYTES, MAX_THREADS, MIN_THREADS, SMS,
    blocks_per_sm, launch_plan,
)


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


def _sample_ranges(n, cs):
    """The contiguous sample range each CTA of a cluster takes: rank r
    gets [r*n // cs, (r+1)*n // cs), as both kernels compute it."""
    return [(r * n // cs, (r + 1) * n // cs) for r in range(cs)]


def _assert_ranges_tile(n, cs):
    ranges = _sample_ranges(n, cs)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    empty = sum(lo == hi for lo, hi in ranges)
    assert empty == max(0, cs - n)  # no empty CTA except where n < cs


@pytest.mark.parametrize("n,d,K", [(4070, 14, 2), (2000, 16, 26), (6250, 54, 2)])
@pytest.mark.parametrize("L", [1, 2, 4, 8])
def test_tree_hist_launch_plan_fits_the_card(n, d, K, L):
    """The main path's shapes (adult, letter, forestcover; C = 8, 16 bins)
    get clusters of 1, 2, 4 or 8 CTAs whose sample ranges tile [0, n),
    a histogram that fits in shared memory, whole warps (a thread for
    each sample, or at least 256), and a grid that fits in one wave on
    132 SMs."""
    H = 8
    plan = launch_plan(H, n, d, L, 17, K)
    assert 1 <= plan.dblk <= min(d, MAX_FEATURES_PER_BLOCK)
    grid = (H, -(-d // plan.dblk), plan.cs)
    assert plan.cs in (1, 2, 4, 8) and grid[2] % plan.cs == 0
    _assert_ranges_tile(n, plan.cs)
    cells = L * plan.dblk * 17 * K
    # the int32 histogram padded to 16 bytes, and a float for each of up to 32 warps
    assert plan.shared_bytes == 16 * -(-cells // 4) + 4 * 32 <= MAX_SHARED_BYTES
    assert plan.threads % 32 == 0 and plan.threads * plan.cs >= min(n, 256 * plan.cs)
    assert grid[0] * grid[1] * grid[2] <= SMS * blocks_per_sm(plan.threads, plan.shared_bytes)


@pytest.mark.parametrize("H,n,d,L,K", [(33, 1001, 5, 8, 3), (3, 257, 19, 8, 26), (1, 3, 3, 1, 2),
                                       (2, 1, 4, 2, 2), (8, 0, 14, 1, 2), (64, 20000, 54, 8, 2)])
def test_tree_hist_launch_plan_ragged_shapes(H, n, d, L, K):
    """Ragged shapes: the cluster stays a power of two up to 8 and does
    not shrink with n (so that n < cs leaves CTAs empty), the features are
    covered, and only a grid too large for one wave has clusters of 1."""
    plan = launch_plan(H, n, d, L, 17, K)
    assert plan.cs in (1, 2, 4, 8) and 1 <= plan.dblk <= min(d, MAX_FEATURES_PER_BLOCK)
    assert -(-d // plan.dblk) * plan.dblk >= d > (-(-d // plan.dblk) - 1) * plan.dblk
    _assert_ranges_tile(n, plan.cs)
    assert MIN_THREADS <= plan.threads <= MAX_THREADS and plan.threads % 32 == 0
    grid = H * -(-d // plan.dblk) * plan.cs
    assert plan.cs == 1 or grid <= SMS * blocks_per_sm(plan.threads, plan.shared_bytes)


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
    """``ops.weight_update`` (its CPU dispatch, the fused plain version)
    against the Pallas kernel in interpret mode followed by the
    renormalisation of ``repro/core/scoring.py:update_weights``."""
    w, mis, mask = _update_inputs(300, seed=4)
    got = ops.weight_update(*_t(w, mis, mask), torch.tensor(1.5))
    flat = pallas_weight_update(jnp.asarray(w), jnp.asarray(mis), jnp.asarray(mask),
                                jnp.float32(1.5), block_s=128, interpret=True)
    want = flat / jnp.maximum(jnp.sum(flat), 1e-30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("C,n,alpha,zero_mask", [
    (8, 407, 0.37, False), (4, 1000, -2.0, False), (3, 129, 10.0, False), (2, 50, 1.0, True),
])
def test_update_weights_matches_jax_pallas(C, n, alpha, zero_mask):
    """The port's ``update_weights`` (one fused ``weight_update``) against
    the JAX package's with ``use_pallas=True`` (the Pallas kernel in
    interpret mode off the TPU, then the renormalisation); an all-zero
    mask gives zeros through the 1e-30 clamp on both sides."""
    w, mis, mask = (x.reshape(C, n) for x in _update_inputs(C * n, seed=C + n))
    if zero_mask:
        mask = np.zeros_like(mask)
    got = scoring.update_weights(*_t(w, mis, mask), torch.tensor(alpha))
    want = jscoring.update_weights(jnp.asarray(w), jnp.asarray(mis), jnp.asarray(mask),
                                   jnp.float32(alpha), use_pallas=True)
    assert got.shape == (C, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    assert np.isfinite(got.numpy()).all()
    if not zero_mask:
        assert abs(float(got.sum()) - 1.0) < 1e-5


@pytest.mark.parametrize("n,alpha", [(300, 1.5), (4070, -2.0), (129, 10.0)])
def test_weight_update_product_matches_pallas_interpret(n, alpha):
    """``ops.weight_update_product`` (its CPU dispatch: the plain version)
    against the Pallas ``weight_update`` in interpret mode: the same
    product, with no renormalisation after it."""
    w, mis, mask = _update_inputs(n, seed=n)
    got = ops.weight_update_product(*_t(w, mis, mask), torch.tensor(alpha))
    want = pallas_weight_update(jnp.asarray(w), jnp.asarray(mis), jnp.asarray(mask),
                                jnp.float32(alpha), block_s=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("N,blocks", [(4070, 16), (32560, 128), (1, 1), (10**7, 1056)])
def test_weight_update_product_plan(N, blocks):
    """A thread an element in CTAs of 256, at most 8 CTAs an SM (132 SMs);
    past that the threads stride."""
    plan = product_plan(N)
    assert plan == (blocks, 256)
    assert plan.blocks * plan.threads >= min(N, 8 * 132 * 256)


def test_weight_update_product_checks_its_inputs():
    w, mis, mask = _update_inputs(10)
    with pytest.raises(TypeError):
        ops.weight_update_product(*_t(w.astype(np.float64), mis, mask), torch.tensor(0.3))
    with pytest.raises(ValueError):
        ops.weight_update_product(*_t(w, mis[:-1].copy(), mask), torch.tensor(0.3))
    with pytest.raises(ValueError):
        ops.weight_update_product(*_t(w, mis, mask), torch.tensor([0.3, 0.4]))


@pytest.mark.parametrize("N,threads,per_thread", [
    (32560, 1024, 2), (16000, 1024, 1), (50000, 1024, 4),  # adult, letter, forestcover at C = 8
    (260480, 1024, 16),  # adult at 64 collaborators: 8 a thread through the output
    (1, 64, 1), (4097, 288, 1),
])
def test_weight_update_plan(N, threads, per_thread):
    """One cluster of 16 CTAs (the non-portable size, within the 1-16 the
    C entry takes) of whole warps, 64 to 1024 threads, covering N; the main
    path's N keep every product in registers."""
    plan = update_plan(N)
    assert (plan.cs, plan.threads) == (16, threads)
    assert plan.threads % 32 == 0 and 64 <= plan.threads <= 1024
    assert -(-N // (plan.cs * plan.threads)) == per_thread
    assert plan.threads == 1024 or plan.cs * plan.threads >= N
    assert (per_thread <= UPDATE_REGISTERS) == (N <= 50000)


@pytest.mark.parametrize("C,H,n", [
    (8, 8, 4070), (8, 8, 2000), (8, 8, 6250),  # adult, letter, forestcover
    (4, 33, 4097), (8, 8, 1), (8, 8, 5), (3, 8, 1001), (2, 3, 100), (300, 8, 4070), (8, 8, 100000),
])
def test_weighted_errors_plan_fits_the_card(C, H, n):
    """A cluster of 1, 2, 4 or 8 CTAs per chunk of 8 rows, a warp a row,
    sample slices that tile [0, n) (empty slices only where n < cs), and
    the fewest slices that give the grid 32 warps an SM."""
    plan = errors_plan(C, H, n)
    assert plan.cs in (1, 2, 4, 8)
    _assert_ranges_tile(n, plan.cs)
    assert plan.rows == 8  # a warp a row: 256 threads
    assert C * H * plan.cs >= SMS * 32 or plan.cs == 8
    assert plan.cs == 1 or C * H * (plan.cs // 2) < SMS * 32


@pytest.mark.parametrize("C,H,n", [
    (8, 8, 4070),  # AdaBoost.F, adult
    (8, 80, 4070), (8, 800, 4070),  # PreWeak.F, adult, T = 10 and 100
    (64, 6400, 509),  # adult over 64 collaborators, T = 100
    (4, 12800, 2000), (1, 20000, 64),  # past 11 776 rows
])
def test_weighted_errors_plan_fills_a_wave_and_fits_its_shared_memory(C, H, n):
    """The grid covers every row and has a CTA for every SM wherever the
    rows allow it (AdaBoost.F's 64 rows at adult take the most slices, 8 a
    row, in 64 CTAs; smaller CTAs measured slower there); shared memory is
    one float a warp, whatever H."""
    plan = errors_plan(C, H, n)
    grid = (plan.cs, -(-H // plan.rows), C)  # csrc: the launch's gridDim; every row covered
    ctas = plan.cs * grid[1] * C
    assert ctas >= SMS or plan.cs == 8
    if H >= 800:
        assert ctas >= SMS
    assert grid[1] <= 65535 and C <= 65535  # the grid's y and z limits
    shared = 4 * plan.rows  # one float a warp, whatever H: no cap on H
    assert shared * blocks_per_sm(32 * plan.rows, 0) <= 227 * 1024


# -- dispatch ----------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    ops.reset_launches()
    before = dict(ref.device_calls)
    bins, leaf, wy = _hist_inputs(8, (2, 50, 3), 2, 5, 2)
    ops.tree_hist(*_t(bins, leaf, wy), n_leaves=2, n_bins_p1=5)
    ops.weighted_errors(*_t(np.zeros((2, 3, 4), np.int32), np.zeros((2, 4), np.int32),
                            np.ones((2, 4), np.float32)))
    ops.weight_update(*_t(*_update_inputs(10)), torch.tensor(0.3))
    ops.weight_update_product(*_t(*_update_inputs(10)), torch.tensor(0.3))
    ops.vote_argmax(*_t(np.zeros((3, 4), np.int32), np.ones(3, np.float32)), n_classes=2)
    q = np.ones((1, 2, 4, 32), np.float32)
    ops.flash_attention(*_t(q, q[:, :1], q[:, :1]))
    assert ops.launch_counts() == {"tree_hist": 0, "weighted_errors": 0, "weight_update": 0,
                                   "weight_update_product": 0, "vote_argmax": 0,
                                   "flash_attention": 0}
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


# -- the ctypes bindings -----------------------------------------------------------

_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}
_EXTERN_C = re.compile(r'extern "C"\s+([\w\s]+?\**)\s*(\w+)\s*\(([^)]*)\)')


def _extern_c_declarations():
    """{function: (return type, [argument declarations])} over every
    ``extern "C"`` function in the port's CUDA sources."""
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, args in _EXTERN_C.findall(path.read_text()):
            assert name not in found, f"{name} is declared twice"
            found[name] = (" ".join(ret.split()), [" ".join(a.split()) for a in args.split(",")])
    return found


def _ctype(decl: str):
    """The ctypes type an argument or return declaration must be bound
    with: ``c_void_p`` for any pointer (ctypes would pass a 32-bit int and
    cut it), the matching scalar otherwise."""
    if "*" in decl:
        return ctypes.c_char_p if decl.replace(" ", "") == "constchar*" else ctypes.c_void_p
    words = [w for w in decl.split() if w != "const"]  # type, then the name (none on a return)
    return _C_TYPES[" ".join(words[:-1]) if len(words) > 1 else words[0]]


def test_every_source_is_built():
    assert sorted(_build.SOURCES) == sorted(p.name for p in _build.CSRC.glob("*.cu"))


def test_ctypes_signatures_match_the_extern_c_declarations():
    declared = _extern_c_declarations()
    assert sorted(declared) == sorted(_build._SIGNATURES)
    for name, (ret, args) in declared.items():
        restype, argtypes = _build._SIGNATURES[name]
        assert restype is _ctype(ret), f"{name}: returns {ret}, bound as {restype}"
        assert len(argtypes) == len(args), f"{name}: {len(args)} arguments, {len(argtypes)} bound"
        for i, (decl, bound) in enumerate(zip(args, argtypes)):
            assert bound is _ctype(decl), f"{name} argument {i} `{decl}` bound as {bound}"


@pytest.mark.parametrize("decl,want", [
    ("const void* q", ctypes.c_void_p), ("void* stream", ctypes.c_void_p),
    ("const long long* strides", ctypes.c_void_p), ("long long N", ctypes.c_longlong),
    ("int causal", ctypes.c_int), ("float softcap", ctypes.c_float), ("const char*", ctypes.c_char_p),
])
def test_signature_parser_maps_declarations(decl, want):
    assert _ctype(decl) is want
