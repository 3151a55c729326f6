"""The port's roofline (``roofline.py``) against the JAX package's, on the
CPU: parameter counts and model FLOPs exactly equal for every registered
architecture (and input shape), the three terms and the ring wire factors
equal on equal inputs and constants, and the collective recorder's bytes
for a DTensor redistribution over a fake mesh equal to
``tests/test_system.py``'s HLO sample numbers.
"""
import jax
import pytest
import torch

from repro import roofline as JR
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.models.transformer import shapes_and_axes
from repro_torch import roofline as R
from repro_torch.configs import INPUT_SHAPES, all_archs, get_arch
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import model as M

ARCHS = sorted(all_archs())
_CACHE = {}


def _both(name):
    if name not in _CACHE:
        model = M.abstract_model(get_arch(name))
        _CACHE[name] = (shapes_and_axes(jax_get_arch(name)), (M.param_tree(model), M.param_axes(model)))
    return _CACHE[name]


@pytest.mark.parametrize("name", ARCHS)
def test_param_counts_equal_jax_as_integers(name):
    (shapes, axes), (params, port_axes) = _both(name)
    want = JR.param_counts(jax_get_arch(name), shapes, axes)
    got = R.param_counts(get_arch(name), params, port_axes)
    assert got == want and all(type(v) is int for v in got)
    if name == "grok-1-314b":
        assert 3.1e11 < got[0] < 3.2e11 and got[1] < 0.45 * got[0]


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("name", ARCHS)
def test_model_flops_equal_jax(name, shape):
    (shapes, axes), (params, port_axes) = _both(name)
    want = JR.model_flops(jax_get_arch(name), shapes, axes, JAX_SHAPES[shape])
    assert R.model_flops(get_arch(name), params, port_axes, INPUT_SHAPES[shape]) == want


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 256])
def test_wire_factors_equal_jax(n):
    assert set(R._WIRE_FACTORS) == set(JR._WIRE_FACTORS)
    for op, f in R._WIRE_FACTORS.items():
        assert f(n) == JR._WIRE_FACTORS[op](n), (op, n)


@pytest.mark.parametrize("inputs", [(1e15, 1e9, 1e9), (1e12, 1e13, 1e9), (1e12, 1e9, 1e12), (0.0, 0.0, 0.0)])
def test_roofline_terms_equal_jax_on_the_same_constants(monkeypatch, inputs):
    for k in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(JR, k, getattr(R, k))
    assert R.roofline_terms(*inputs) == JR.roofline_terms(*inputs)


def test_the_constants_are_the_h100_datasheet_figures():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)


def test_a_partial_to_replicate_over_four_ranks_is_one_all_reduce():
    """``tests/test_system.py``'s sample: an all-reduce of a ``[512, 2048]``
    float32 over a group of 4 is 512·2048·4 raw bytes and 2·3/4 of them on
    the wire."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate

    with fake_mesh((2, 4), ("data", "model")) as mesh:
        dm = mesh.device_mesh
        fm = FakeTensorMode()
        with fm:
            local = torch.empty(512, 2048)
        x = DTensor.from_local(local, dm, [Replicate(), Partial()], run_check=False)
        rec = R.CollectiveRecorder()
        with fm, rec:
            y = x.redistribute(dm, [Replicate(), Replicate()])
        assert tuple(y.placements) == (Replicate(), Replicate())
    stats = rec.stats()
    assert stats.ops == {"all-reduce": 1}
    assert stats.raw_bytes == {"all-reduce": 512 * 2048 * 4}
    assert stats.wire_bytes == 2 * 3 / 4 * 512 * 2048 * 4


def test_device_cost_counts_a_devices_share_of_a_sharded_matmul():
    """A ``[16, 256] @ [256, 32]`` with rows over ``data`` (2) and the
    contraction over ``model`` (4): the global FLOPs over 8 devices, the
    same as the local product's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with fake_mesh((2, 4), ("data", "model")) as mesh:
        dm = mesh.device_mesh
        fm = FakeTensorMode()
        a = DTensor.from_local(fm.from_tensor(torch.empty(8, 64)), dm, [Shard(0), Shard(1)], run_check=False)
        b = DTensor.from_local(fm.from_tensor(torch.empty(64, 32)), dm, [Replicate(), Shard(0)], run_check=False)
        cost, rec = R.DeviceCostMode(), R.CollectiveRecorder()
        with fm, rec, cost:
            a @ b
    assert cost.flops == 2 * 8 * 64 * 32 == 2 * 16 * 256 * 32 / 8
    assert cost.bytes_accessed == (8 * 64 + 64 * 32 + 8 * 32) * 4
    assert rec.calls == []  # the partial sum stays partial
