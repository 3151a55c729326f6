"""The float32 ``flash_attention`` kernel's launch plan and view check, on
the CPU: ``f32_plan`` (the rule ``csrc/flash_attention.cu`` also computes;
the card's tests hold the two equal), ``visible_tiles`` and
``key_split`` (which key tiles each CTA of a cluster walks), and
``check_cp_async_views`` (what 16-byte copies can load).  Pure Python on
shapes: the kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    F32_BQ, F32_MAX_SPLIT, SMS, F32Plan, check_cp_async_views, f32_key_tile, f32_plan, key_split,
    visible_tiles,
)

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
