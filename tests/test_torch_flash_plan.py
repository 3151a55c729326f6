"""The ``flash_attention`` kernels' launch plans and view check, on the
CPU: ``f32_plan`` (the rule ``csrc/flash_attention.cu`` also computes;
the card's tests hold the two equal), ``visible_tiles`` and ``key_split``
(which key tiles each CTA of a cluster walks), ``check_cp_async_views``
(what 16-byte copies can load); the bf16 route's ``bf16_plan`` (which
kernel a head dim takes, its tiles, each query block's key tiles) and the
softcap arithmetic of its warp-specialised kernel.  Pure Python
on shapes: the kernels themselves are held to the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    F32_BQ, F32_MAX_SPLIT, SMS, F32Plan, bf16_plan, block_tiles, check_cp_async_views, f32_key_tile,
    f32_plan, key_split, visible_tiles,
)

LOG2E = 1.4426950408889634

SHAPES = [  # B, H, S, T, D, causal, window
    (4, 20, 1500, 1500, 64, False, None),  # whisper's encoder
    (4, 20, 64, 1500, 64, False, None),  # whisper's cross-attention
    (4, 20, 64, 64, 64, True, None),  # whisper's decoder self-attention
    (1, 4, 40, 1000, 64, False, None),  # a key split over a ragged T
    (1, 4, 96, 1000, 64, True, 256),  # a causal chunk with S < T and a window
    (2, 8, 200, 200, 128, True, None),
    (1, 4, 130, 130, 256, True, None),
    (2, 8, 65, 65, 256, True, None),
    (1, 2, 100, 100, 64, True, None),  # chip_smoke.py's "ragged"
    (1, 2, 256, 256, 32, True, 16),  # every tile before the window skipped
    (1, 2, 96, 160, 32, True, None),
    (1, 1, 1, 1, 32, True, None),
    (1, 1, 1, 5000, 128, False, 100),
    (3, 44, 64, 4096, 64, True, None),  # 132 blocks: exactly one wave, no split
]


def _visible(S, T, causal, window, row, key):
    pos = row + T - S
    return key < T and (not causal or key <= pos) and (window is None or pos - key < window)


@pytest.mark.parametrize("B,H,S,T,D,causal,window", SHAPES)
def test_each_cluster_rank_walks_a_share_and_the_shares_cover_every_visible_tile_once(
        B, H, S, T, D, causal, window):
    """For every block of query rows: the ranks' shares are contiguous and
    disjoint and cover ``[first, last)`` exactly once; every visible
    (row, key) pair lies in those tiles; the first and the last tile hold a
    visible pair (a tile masked for every row is never walked)."""
    plan = f32_plan(B, H, S, T, D, causal, window)
    for q0 in range(0, S, plan.bq):
        first, last = visible_tiles(S, T, q0, plan.bk, causal, window)
        shares = key_split(first, last, plan.splits)
        assert len(shares) == plan.splits
        walked = [tile for lo, hi in shares for tile in range(lo, hi)]
        assert walked == list(range(first, last))
        rows = range(q0, min(q0 + plan.bq, S))
        keys = {j for i in rows for j in range(T) if _visible(S, T, causal, window, i, j)}
        assert keys and first * plan.bk <= min(keys) and max(keys) < last * plan.bk
        for tile in (first, last - 1):
            assert any(tile * plan.bk <= j < (tile + 1) * plan.bk for j in keys)


@pytest.mark.parametrize("B,H,S,T,D,causal,window", SHAPES)
def test_a_split_appears_only_where_the_grid_is_under_the_sm_count(B, H, S, T, D, causal, window):
    """Clusters of at most 8, only where ``B·H·ceil(S / 64)`` CTAs would not
    fill the 132 SMs; each rank then gets at least two tiles of the longest
    range."""
    plan = f32_plan(B, H, S, T, D, causal, window)
    assert plan.bq == F32_BQ and plan.bk == f32_key_tile(D) and 1 <= plan.splits <= F32_MAX_SPLIT
    blocks = B * H * -(-S // plan.bq)
    if blocks >= SMS:
        assert plan.splits == 1
    most = max(hi - lo for lo, hi in (visible_tiles(S, T, q0, plan.bk, causal, window)
                                      for q0 in range(0, S, plan.bq)))
    assert plan.splits == 1 or most >= 2 * plan.splits


def test_whisper_gets_the_plans_of_the_design():
    """The encoder's 1920 blocks fill the card unsplit; the cross-attention's
    80 blocks of 64 queries against 47 tiles of 1500 keys split 8 ways (640
    CTAs, 5 or 6 tiles each)."""
    assert f32_plan(4, 20, 1500, 1500, 64, False, None) == F32Plan(1, 64, 32)
    assert f32_plan(4, 20, 64, 1500, 64, False, None) == F32Plan(8, 64, 32)
    assert key_split(*visible_tiles(64, 1500, 0, 32, False, None), 8)[:2] == [(0, 5), (5, 11)]
    assert f32_plan(1, 4, 40, 1000, 64, False, None) == F32Plan(8, 64, 32)
    assert f32_plan(1, 4, 40, 1000, 32, False, None) == F32Plan(8, 64, 64)
    assert f32_plan(1, 8, 2048, 2048, 256, True, None) == F32Plan(1, 64, 32)


def _f32(*shape):
    return torch.zeros(*shape, dtype=torch.float32)


@pytest.mark.parametrize("view", ["dense", "transposed", "broadcast_row", "size_one_axes"])
def test_cp_async_check_takes_the_model_views(view):
    """16-byte copies load dense tensors, the model's [B, S, H, D]
    projections transposed to [B, H, S, D], a row broadcast along an axis
    (stride 0), and axes of one element whatever their stride."""
    if view == "dense":
        q, k = _f32(2, 8, 70, 64), _f32(2, 1, 70, 64)
    elif view == "transposed":
        q, k = _f32(4, 64, 20, 64).transpose(1, 2), _f32(4, 1500, 20, 64).transpose(1, 2)
    elif view == "broadcast_row":
        q, k = _f32(1, 2, 64, 32), _f32(1, 2, 1, 32).expand(1, 2, 64, 32)
    else:
        q = _f32(1, 1, 64, 33)[..., :32].as_strided((1, 1, 1, 32), (3, 5, 7, 1))
        k = _f32(1, 1, 64, 32)
    check_cp_async_views(q, k, k)


@pytest.mark.parametrize("bad", ["address", "row_stride", "head_stride"])
def test_cp_async_check_refuses_views_16_byte_copies_cannot_load(bad):
    k = _f32(1, 1, 64, 64)
    if bad == "address":  # starts 4 bytes into an aligned buffer
        q = _f32(1, 1, 64, 72)[..., 1:65]
    elif bad == "row_stride":  # 66 values = 264 bytes between rows
        q = _f32(1, 1, 64, 66)[..., :64]
    else:  # 64·64 + 2 values between heads
        q = _f32(2 * 64 * 64 + 8).as_strided((1, 2, 64, 64), (0, 64 * 64 + 2, 64, 1))
    with pytest.raises(ValueError, match="cp.async"):
        check_cp_async_views(q, k, k)
    with pytest.raises(ValueError, match="cp.async"):
        check_cp_async_views(k, q, k)


# the bf16 route's plan (``bf16_plan``; ``repro_flash_attention_bf16_plan``
# computes the same, and the card's tests hold the two equal): the six D = 128
# model shapes, ragged edges of the 128-row, 128-key tiles, then the other
# head dims
BF16_SHAPES = [  # B, H, Hkv, S, T, D, causal, window
    (1, 48, 8, 8192, 8192, 128, True, None),  # grok-1 (softcap 30)
    (1, 40, 8, 16384, 16384, 128, True, 8192),  # llama4-scout's chunked-local layers
    (1, 40, 8, 16384, 16384, 128, True, None),  # llama4-scout's NoPE global layer
    (1, 32, 16, 8192, 8192, 128, True, 4096),  # gemma2-27b's local layers (softcap 50)
    (1, 32, 16, 8192, 8192, 128, True, None),  # gemma2-27b's global layers
    (4, 48, 8, 1088, 1088, 128, True, None),  # internvl2-26b (1024 patches + 64 tokens)
    (2, 2, 1, 130, 130, 128, True, None),  # a 2-row tail
    (1, 2, 1, 257, 257, 128, True, None),
    (1, 4, 1, 40, 300, 128, True, None),  # a chunk, S < T
    (1, 4, 2, 96, 1000, 128, True, 256),
    (1, 4, 2, 300, 300, 128, True, 100),  # window edges inside a tile
    (1, 4, 2, 300, 300, 128, True, 200),
    (1, 6, 1, 500, 500, 128, True, 200),
    (1, 5, 1, 200, 200, 128, False, None),
    (1, 4, 1, 200, 700, 128, False, 100),  # non-causal with a window
    (1, 8, 8, 1, 1, 128, True, None),  # S <= 64: the second warpgroup holds no row
    (1, 8, 1, 1, 77, 128, True, None),
    (1, 4, 1, 64, 64, 128, True, None),
    (1, 8, 1, 2048, 2048, 256, True, None),  # the first design's D = 256 and 32
    (4, 8, 1, 64, 64, 256, True, None),
    (1, 2, 2, 256, 256, 32, True, 16),
    (1, 2, 2, 96, 160, 32, True, None),
    (4, 20, 20, 64, 64, 64, True, None),  # whisper's decoder self-attention
    (4, 20, 20, 1500, 1500, 64, False, None),  # its encoder and cross-attention
    (4, 20, 20, 64, 1500, 64, False, None),
]


def _row_intervals(S, T, causal, window):
    """Each query row's visible keys ``[lo, hi]`` (empty where lo > hi)."""
    pos = np.arange(S) + T - S
    hi = np.minimum(T - 1, pos) if causal else np.full(S, T - 1)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(S, dtype=int)
    return lo, hi


@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal,window", BF16_SHAPES)
def test_bf16_plan_tiles_cover_every_visible_pair_once_and_load_no_invisible_tile(
        B, H, Hkv, S, T, D, causal, window):
    """Per query block: every visible (row, key) pair lies in one of its key
    tiles (the tiles partition the keys, so it lies in exactly one), and
    every tile it loads holds a pair some row of the block can see."""
    plan = bf16_plan(B, H, Hkv, S, T, D, causal, window)
    assert len(plan.tiles) == -(-S // plan.bm)
    lo, hi = _row_intervals(S, T, causal, window)
    for i, (first, last) in enumerate(plan.tiles):
        rows = slice(i * plan.bm, min((i + 1) * plan.bm, S))
        blo, bhi = lo[rows], hi[rows]
        seen = blo <= bhi
        if not seen.any():
            assert first == last
            continue
        blo, bhi = blo[seen], bhi[seen]
        inside = (np.minimum(bhi, last * plan.bn - 1) - np.maximum(blo, first * plan.bn) + 1).clip(0)
        assert inside.sum() == (bhi - blo + 1).sum()  # every visible pair inside [first, last)
        for tile in range(first, last):  # each loaded tile is seen by some row
            k0, k1 = tile * plan.bn, (tile + 1) * plan.bn - 1
            assert ((blo <= k1) & (bhi >= k0)).any(), (i, tile)


@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal,window", BF16_SHAPES)
def test_bf16_plan_picks_the_kernel_by_head_dim(B, H, Hkv, S, T, D, causal, window):
    """D = 64 and 128 take the warp-specialised kernel (128 query rows a
    block, 128-key tiles); D = 32 and 256 keep the first design (64-key
    tiles, 64 rows a block where S <= 64, else 128)."""
    plan = bf16_plan(B, H, Hkv, S, T, D, causal, window)
    if D in (64, 128):
        assert (plan.kernel, plan.bm, plan.bn) == ("ws", 128, 128)
    else:
        assert (plan.kernel, plan.bm, plan.bn) == ("sm90", 64 if S <= 64 else 128, 64)


def test_bf16_plan_at_the_model_shapes():
    """The D = 128 prefills' tile walks: grok-1's last query block (rows
    8064-8191) walks all 64 key tiles, its first only tile 0; llama4-scout's
    windowed block at rows 16256-16383 starts at tile 63 (key 8065 lies in
    it) and walks 65 tiles; internvl2's last block holds 64 rows and walks 9."""
    grok = bf16_plan(1, 48, 8, 8192, 8192, 128, True, None)
    assert grok.tiles[-1] == (0, 64) and grok.tiles[0] == (0, 1)
    llama = bf16_plan(1, 40, 8, 16384, 16384, 128, True, 8192)
    assert llama.tiles[-1] == (63, 128)
    assert bf16_plan(4, 48, 8, 1088, 1088, 128, True, None).tiles[-1] == (0, 9)
    assert block_tiles(16384, 16384, 16256, 128, 128, True, 8192) == (63, 128)


def softcap_log2(s: torch.Tensor, scale: float, softcap: float) -> torch.Tensor:
    """``softcap·tanh(scale·s / softcap)·log2(e)`` in float32 as the
    warp-specialised kernel (``csrc/flash_attention_sm90.cu:ws_softmax``)
    computes it: ``tanh(t) = 1 - 2 / (1 + 2^(2·log2(e)·t))``, the constants
    folded on the host in double and rounded, one ``exp2`` and one
    reciprocal, where the kernel uses the card's ``ex2.approx`` and
    ``rcp.approx``."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    a, c, m2c = f32(2 * LOG2E * scale / softcap), f32(softcap * LOG2E), f32(-2 * softcap * LOG2E)
    return torch.addcmul(c, m2c, torch.reciprocal(1 + torch.exp2(s.float() * a)))


@pytest.mark.parametrize("softcap", [30.0, 50.0])
def test_softcap_arithmetic_of_the_ws_kernel_is_within_1e5_of_the_cap(softcap):
    """The kernel's ``c - 2c / (1 + 2^(a·s))`` in float32 against
    ``softcap·tanh`` in float64 over t = scale·s / softcap in [-30, 30]:
    within 1e-5·softcap.  The card's ``ex2.approx`` and ``rcp.approx`` add
    about 2^-22 of relative error each, 1e-7 of the cap."""
    scale = 1 / math.sqrt(128)
    t = torch.linspace(-30, 30, 200_001, dtype=torch.float64)
    s = (t * softcap / scale).float()
    got = softcap_log2(s, scale, softcap).double() / LOG2E
    want = softcap * torch.tanh(s.double() * scale / softcap)
    assert float((got - want).abs().max()) <= 1e-5 * softcap
    assert float(got.abs().max()) <= softcap * (1 + 1e-6)  # saturates, no overflow at |t| = 30
