"""The port's attention on the CPU: ``ops.flash_attention`` (which runs the
plain version, ``ref.attention_ref``, for CPU tensors) against the JAX
package's Pallas kernel in interpret mode and its ``attention_ref``, over
the sweep of ``tests/test_kernels.py`` and its fully-masked-tiles case.
The CUDA kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs are numpy arrays made from a seed; bfloat16 inputs are rounded from
the same float32 arrays on both sides.  Tolerances are those of
``tests/test_kernels.py``: atol 2e-5 in float32, 2e-2 in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import check_kernel_inputs, check_tma_views

SWEEP = [  # B, Hq, Hkv, S, T, D, causal, window, softcap, bf16 (tests/test_kernels.py)
    (2, 4, 2, 128, 128, 64, True, None, None, False),
    (1, 4, 1, 128, 128, 64, True, 64, None, False),  # MQA + window
    (1, 2, 2, 96, 160, 32, True, None, 30.0, False),  # S < T + softcap
    (1, 2, 2, 128, 128, 64, False, None, None, False),  # non-causal
    (1, 8, 2, 128, 128, 128, True, None, None, True),  # bf16
    (1, 2, 2, 100, 100, 64, True, None, None, False),  # ragged S
]
IDS = ["gqa", "mqa_window", "s_lt_t_softcap", "noncausal", "bf16", "ragged"]


def _inputs(seed, B, H, Hkv, S, T, D, bf16):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32)
              for shape in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D))]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got: torch.Tensor, want, atol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal,window,softcap,bf16", SWEEP, ids=IDS)
def test_attention_matches_jax_ref(B, H, Hkv, S, T, D, causal, window, softcap, bf16):
    (jq, jk, jv), (q, k, v) = _inputs(3, B, H, Hkv, S, T, D, bf16)
    got = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window, softcap=softcap)
    assert got.shape == (B, H, S, D) and got.dtype == q.dtype
    _close(got, want, 2e-2 if bf16 else 2e-5)


@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal,window,softcap,bf16", SWEEP, ids=IDS)
def test_attention_matches_pallas_interpret(B, H, Hkv, S, T, D, causal, window, softcap, bf16):
    (jq, jk, jv), (q, k, v) = _inputs(3, B, H, Hkv, S, T, D, bf16)
    got = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    want = pallas_flash_attention(jq, jk, jv, causal=causal, window=window, softcap=softcap,
                                  block_q=64, block_k=64, interpret=True)
    _close(got, want, 2e-2 if bf16 else 2e-5)


def test_fully_masked_tiles_are_safe():
    """Window 16 under 64-wide tiles: early KV tiles are wholly masked for
    most rows, which must give no NaN (the -1e30, not -inf, running max)."""
    (jq, jk, jv), (q, k, v) = _inputs(4, 1, 2, 2, 256, 256, 32, False)
    got = ops.flash_attention(q, k, v, causal=True, window=16)
    assert bool(torch.isfinite(got).all())
    _close(got, pallas_flash_attention(jq, jk, jv, causal=True, window=16, block_q=64,
                                       block_k=64, interpret=True), 2e-5)
    _close(got, jref.attention_ref(jq, jk, jv, causal=True, window=16), 2e-5)


def test_scale_argument_is_honoured():
    (jq, jk, jv), (q, k, v) = _inputs(5, 1, 2, 1, 32, 48, 32, False)
    got = ops.flash_attention(q, k, v, scale=0.3)
    _close(got, jref.attention_ref(jq, jk, jv, scale=0.3), 2e-5)


def test_cpu_call_counts_no_launch():
    _, (q, k, v) = _inputs(6, 1, 2, 1, 16, 16, 32, False)
    ops.reset_launches()
    before = dict(ref.device_calls)
    ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 0
    assert ref.device_calls == before


def test_wrapper_raises_on_causal_rows_that_see_no_key():
    _, (q, k, v) = _inputs(7, 1, 2, 2, 20, 16, 32, False)
    with pytest.raises(ValueError, match="see no key"):
        ops.flash_attention(q, k, v, causal=True)
    assert ops.flash_attention(q, k, v, causal=False).shape == q.shape  # non-causal is fine


@pytest.mark.parametrize("bad", ["heads", "dtype", "window", "softcap", "no_keys"])
def test_wrapper_checks_its_inputs(bad):
    _, (q, k, v) = _inputs(8, 1, 4, 2, 16, 16, 32, False)
    kw = {}
    if bad == "heads":
        k, v = k.repeat(1, 2, 1, 1)[:, :3], v.repeat(1, 2, 1, 1)[:, :3]  # 4 % 3 != 0
    elif bad == "dtype":
        k = k.double()
    elif bad == "window":
        kw["window"] = 0
    elif bad == "softcap":
        kw["softcap"] = 0.0
    else:
        k, v = k[:, :, :0], v[:, :, :0]
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v, causal=False, **kw)


def test_kernel_input_checks():
    """What the CUDA kernel refuses, checked on shapes and strides alone."""
    _, (q, k, v) = _inputs(9, 1, 2, 1, 64, 64, 64, False)
    check_kernel_inputs(q, k, v)
    check_kernel_inputs(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)  # strided views
    with pytest.raises(ValueError, match="head_dim"):
        check_kernel_inputs(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="contiguous"):
        check_kernel_inputs(q.transpose(2, 3), k, v)
    with pytest.raises(TypeError):
        check_kernel_inputs(q.half(), k.half(), v.half())
    with pytest.raises(RuntimeError, match="backward"):
        check_kernel_inputs(q.requires_grad_(), k, v)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("view", ["dense", "transposed", "size_one_axes"])
def test_tma_check_takes_the_model_views(view):
    """TMA can describe dense tensors, the model's [B, S, H, D] projections
    transposed to [B, H, S, D], and axes of one element whatever their
    stride (the kernel never steps along them)."""
    if view == "dense":
        q, k = _bf16(2, 8, 70, 256), _bf16(2, 1, 70, 256)
    elif view == "transposed":
        q, k = _bf16(2, 70, 8, 256).transpose(1, 2), _bf16(2, 70, 1, 256).transpose(1, 2)
    else:
        q = _bf16(1, 1, 64, 257)[..., :256].as_strided((1, 1, 1, 256), (3, 5, 7, 1))
        k = _bf16(1, 1, 64, 256)
    check_tma_views(q, k, k)


@pytest.mark.parametrize("bad", ["address", "row_stride", "head_stride", "zero_stride"])
def test_tma_check_refuses_views_tma_cannot_describe(bad):
    k = _bf16(1, 1, 64, 64)
    if bad == "address":  # starts 2 bytes into an aligned buffer
        q = _bf16(1, 1, 64, 72)[..., 1:65]
    elif bad == "row_stride":  # 68 values = 136 bytes between rows
        q = _bf16(1, 1, 64, 68)[..., :64]
    elif bad == "head_stride":  # 64·64 + 4 values between heads
        q = _bf16(2 * 64 * 64 + 8).as_strided((1, 2, 64, 64), (0, 64 * 64 + 4, 64, 1))
    else:  # one row broadcast to every query position
        q = _bf16(1, 1, 1, 64).expand(1, 1, 64, 64)
    with pytest.raises(ValueError, match="TMA"):
        check_tma_views(q, k, k)
