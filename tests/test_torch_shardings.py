"""The port's production-mesh sharding resolution (``models/shardings.py``),
the logical axes of its parameters (``models/model.py:param_axes``), its
dry-run input stand-ins (``input_specs``) and ``make_production_mesh``
against the JAX package, on the CPU.

The JAX side resolves its specs on ``tests/test_system.py``'s shape-only
``FakeMesh({"data": 16, "model": 16})`` (and a multi-pod one with
``"pod": 2``); the port's on the same stand-in.  A JAX leaf is a unit's
layers stacked ``[R, ...]`` with a leading ``"layers"`` axis that no pass
shards; the port's leaf is one layer of it (``model._jax_key``), so its
spec is the JAX spec without its first entry.  Every comparison is exact.
"""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro.models import model as JM
from repro.models import shardings as JS
from repro.models.transformer import shapes_and_axes
from repro_torch.configs import INPUT_SHAPES, all_archs, get_arch
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import shardings as S

ARCHS = sorted(all_archs())
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:  # tests/test_system.py's: a shape and nothing else
    def __init__(self, shape):
        self.shape = shape


_CACHE = {}


def _both(name):
    """(JAX shapes, JAX axes, port params, port axes) of the full config."""
    if name not in _CACHE:
        shapes, axes = shapes_and_axes(jax_get_arch(name))
        model = M.abstract_model(get_arch(name))
        _CACHE[name] = (shapes, axes, M.param_tree(model), M.param_axes(model), model)
    return _CACHE[name]


def _by_path(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): v for path, v in flat}


def _is_spec(x):
    return isinstance(x, P)


def _jax_leaf(tree, key):
    """The JAX leaf of a port parameter's ``_jax_key`` path, and whether it
    is stacked (a unit's or the encoder's)."""
    return tree[key], key[0] in ("unit", "encoder")


def test_the_registered_archs_and_input_shapes_equal_the_jax_package():
    assert ARCHS == sorted(jax_all_archs())
    for name in ARCHS:
        assert get_arch(name).fsdp == jax_get_arch(name).fsdp
    assert set(INPUT_SHAPES) == set(JAX_SHAPES)
    for k, s in INPUT_SHAPES.items():
        j = JAX_SHAPES[k]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (j.name, j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("name", ARCHS)
def test_param_axes_are_the_jax_axes_without_the_layers_axis(name):
    shapes, axes, params, port_axes, model = _both(name)
    jax_axes = _by_path(axes, is_leaf=lambda x: isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x))
    jax_shapes = _by_path(shapes)
    period = len(model.cfg.pattern()[0])
    assert list(port_axes) == list(params)
    assert len(port_axes) == sum(
        (s.shape[0] if k[0] in ("unit", "encoder") else 1) for k, s in jax_shapes.items())
    for k, ax in port_axes.items():
        key, _ = M._jax_key(k, period)
        want, stacked = _jax_leaf(jax_axes, key)
        assert ax == (tuple(want)[1:] if stacked else tuple(want)), k
        shape, _ = _jax_leaf(jax_shapes, key)
        assert tuple(params[k].shape) == (tuple(shape.shape)[1:] if stacked else tuple(shape.shape)), k
        assert str(params[k].dtype) == f"torch.{shape.dtype}", k
        assert params[k].device.type == "cpu" and type(params[k]).__name__ in ("FakeTensor", "Parameter")


@pytest.mark.parametrize("zero1", [False, True], ids=["params", "zero1"])
@pytest.mark.parametrize("policy", ["baseline", "gather2d"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_param_specs_equal_jax_leaf_by_leaf(name, mesh, policy, zero1):
    shapes, axes, params, port_axes, model = _both(name)
    cfg = get_arch(name)
    fake = FakeMesh(MESHES[mesh])
    jspecs = _by_path(JS.param_specs(jax_get_arch(name), shapes, axes, fake, policy=policy, zero1=zero1),
                      is_leaf=_is_spec)
    specs = S.param_specs(cfg, params, port_axes, fake, policy=policy, zero1=zero1)
    period = len(cfg.pattern()[0])
    sharded = 0
    for k, spec in specs.items():
        key, _ = M._jax_key(k, period)
        want, stacked = _jax_leaf(jspecs, key)
        want = tuple(want)
        if stacked:
            assert want[0] is None, (k, want)  # the scan dim is never sharded
            want = want[1:]
        assert spec == want, (k, spec, want)
        sharded += any(e is not None for e in spec)
    assert sharded > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_per_device_parameter_bytes_equal_the_jax_specs(name, mesh):
    shapes, axes, params, port_axes, _ = _both(name)
    fake = FakeMesh(MESHES[mesh])
    ms = MESHES[mesh]

    def local(shape, spec):
        n = 1
        for dim, e in zip(shape, tuple(spec) + (None,) * len(shape)):
            names = (e,) if isinstance(e, str) else (e or ())
            n *= dim // math.prod(ms[a] for a in names)
        return n

    jspecs = JS.param_specs(jax_get_arch(name), shapes, axes, fake)
    want = sum(local(s.shape, sp) * np.dtype(s.dtype).itemsize
               for s, sp in zip(jax.tree.leaves(shapes), jax.tree.leaves(jspecs, is_leaf=_is_spec)))
    specs = S.param_specs(get_arch(name), params, port_axes, fake)
    got = sum(math.prod(S.local_shape(tuple(p.shape), specs[k], fake)) * p.element_size()
              for k, p in params.items())
    assert got == want


def _state_leaves(state):
    return [t for t in jax.tree.leaves(state)]


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_and_their_spec_tree_equal_jax(name, shape):
    """Every stand-in's shape and dtype, and its spec, as the JAX
    package's (a decode state leaf per layer: the JAX ``[R, ...]`` leaf
    without its scan dim)."""
    cfg_j, cfg = jax_get_arch(name), get_arch(name)
    js, ps = JAX_SHAPES[shape], INPUT_SHAPES[shape]
    fake = FakeMesh(MESHES["single"])
    jin = JM.input_specs(cfg_j, js)
    jspec = JS.input_spec_tree(cfg_j, js, jin, fake)
    pin = M.input_specs(cfg, ps)
    pspec = S.input_spec_tree(cfg, ps, pin, fake)
    assert set(pin) == set(jin) and set(pspec) == set(jspec)
    for k in pin:
        if k == "state":
            continue
        assert tuple(pin[k].shape) == tuple(jin[k].shape) and str(pin[k].dtype) == f"torch.{jin[k].dtype}"
        assert pspec[k] == tuple(jspec[k]), k
    if "state" not in pin:
        return
    period = len(cfg.pattern()[0])
    assert pin["state"].pos == 0
    jcaches, jcspecs = jin["state"].caches, jspec["state"].caches
    assert tuple(jspec["state"].pos) == ()
    for r, (c, cs) in enumerate(zip(pin["state"].caches, pspec["state"].caches)):
        jl = _state_leaves(jcaches[f"L{r % period}"])
        jsl = jax.tree.leaves(jcspecs[f"L{r % period}"], is_leaf=_is_spec)
        leaves = [t for t in jax.tree.leaves(c) if isinstance(t, torch.Tensor)]
        specs = jax.tree.leaves(cs, is_leaf=lambda x: isinstance(x, tuple) and all(
            e is None or isinstance(e, (str, tuple)) for e in x) and not hasattr(x, "_fields"))
        assert len(leaves) == len(jl) == len(specs) == len(jsl)
        for t, j, s, js_ in zip(leaves, jl, specs, jsl):
            assert tuple(t.shape) == tuple(j.shape)[1:] and str(t.dtype) == f"torch.{j.dtype}"
            assert tuple(js_)[0] is None
            assert s == tuple(js_)[1:], (r, s, js_)
    if shape == "long_500k" and cfg.layer_pattern != "xlstm":
        # the tiny batch puts a KV cache's 524 288 slots over ("data", "model");
        # xlstm's constant states are too small to split
        assert any(("data", "model") in s for s in jax.tree.leaves(
            pspec["state"].caches, is_leaf=lambda x: isinstance(x, tuple) and not hasattr(x, "_fields")))


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard

    with fake_mesh((2, 4), ("data", "model")) as mesh:
        dm = mesh.device_mesh
        assert S.placements(("model", None), dm) == (Replicate(), Shard(0))
        assert S.placements((None, ("model", "data")), dm) == (Shard(1), Shard(1))
        assert S.placements((None, None), dm) == (Replicate(), Replicate())
        assert S.local_shape((16, 8), (("model", "data"), None), dm) == (2, 8)
        with pytest.raises(ValueError):
            S.placements(("model", "model"), dm)
        with pytest.raises(ValueError):
            S.placements(("pod",), dm)
        with pytest.raises(ValueError):
            S.local_shape((6,), ("model",), dm)
    assert not torch.distributed.is_initialized()


def test_constraints_are_the_identity_on_plain_tensors_and_redistribute_dtensors():
    x = torch.randn(4, 6, 8)
    w = torch.randn(8, 4)
    assert S.constrain_group_dim(x) is x and S.constrain_microbatch(x) is x and S.constrain_batch(x) is x
    S.set_fsdp_weight_gather(True)
    try:
        assert S.maybe_gather_weight(w, ("embed", "ff")) is w
    finally:
        S.set_fsdp_weight_gather(False)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_mesh((2, 2), ("data", "model")) as mesh:
        dm = mesh.device_mesh
        d = distribute_tensor(torch.randn(4, 6, 8), dm, [Replicate(), Shard(2)])
        assert tuple(S.constrain_group_dim(d).placements) == (Shard(0), Replicate())
        assert tuple(S.constrain_microbatch(d).placements) == (Shard(1), Replicate())
        dw = distribute_tensor(torch.randn(8, 4), dm, [Shard(0), Shard(1)])
        assert S.maybe_gather_weight(dw, ("embed", "ff")) is dw  # off by default
        S.set_fsdp_weight_gather(True)
        try:
            assert tuple(S.maybe_gather_weight(dw, ("embed", "ff")).placements) == (Replicate(), Shard(1))
        finally:
            S.set_fsdp_weight_gather(False)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_builds_and_destroys_its_group(multi_pod):
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        want = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
        assert mesh.shape == want and mesh.size == math.prod(want.values())
        assert S.mesh_shape(mesh.device_mesh) == want
        assert torch.distributed.get_world_size() == mesh.size
        with pytest.raises(RuntimeError, match="already initialised"):
            with make_production_mesh():
                pass
    assert not torch.distributed.is_initialized()
