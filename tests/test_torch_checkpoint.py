"""The port's ``checkpoint.py``: the JAX package's round trip
(``tests/test_fl_end2end.py``), a bfloat16 ``TrainState`` bit for bit (the
JAX package cannot restore a bfloat16 leaf: it writes numpy's ``V2``), the
shape check, and a JAX float32 ``TrainState`` checkpoint read back through
``convert.train_state_from_numpy``.  Exact comparisons throughout."""
import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_arch as jax_get_arch
from repro.models import model as JM
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.convert import train_state_from_numpy
from repro_torch.models import model as M


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_states_equal(a: M.TrainState, b: M.TrainState) -> None:
    pa, pb = M.param_tree(a.params), M.param_tree(b.params)
    assert list(pa) == list(pb)
    for k in pa:
        assert pa[k].dtype == pb[k].dtype
        np.testing.assert_array_equal(_bits(pa[k]), _bits(pb[k]), err_msg=k)
        np.testing.assert_array_equal(_bits(a.opt.mu[k]), _bits(b.opt.mu[k]), err_msg=k)
        np.testing.assert_array_equal(_bits(a.opt.nu[k]), _bits(b.opt.nu[k]), err_msg=k)
    assert a.opt.step.dtype == b.opt.step.dtype == torch.int32 and int(a.opt.step) == int(b.opt.step)
    assert a.opt.step.shape == b.opt.step.shape == ()


def test_checkpoint_roundtrip(tmp_path):
    """``tests/test_fl_end2end.py::test_checkpoint_roundtrip`` on the port."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    save_checkpoint(tree, tmp_path / "ckpt")
    back = load_checkpoint({"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.int32)}},
                           tmp_path / "ckpt")
    np.testing.assert_array_equal(back["a"].numpy(), tree["a"].numpy())
    np.testing.assert_array_equal(back["b"]["c"].numpy(), tree["b"]["c"].numpy())
    assert back["b"]["c"].dtype == torch.int32


class _Pair(NamedTuple):
    x: torch.Tensor
    y: list


def test_nested_containers_and_leaves_roundtrip(tmp_path):
    tree = {"z": _Pair(torch.tensor([1.5, -2.0], dtype=torch.bfloat16), [np.arange(3), 7]),
            "a": (torch.zeros((), dtype=torch.int32), 2.5)}
    save_checkpoint(tree, tmp_path / "t")
    like = {"z": _Pair(torch.zeros(2, dtype=torch.bfloat16), [np.zeros(3, np.int64), 0]),
            "a": (torch.ones((), dtype=torch.int32), 0.0)}
    back = load_checkpoint(like, tmp_path / "t")
    assert isinstance(back["z"], _Pair) and isinstance(back["a"], tuple)
    np.testing.assert_array_equal(_bits(back["z"].x), _bits(tree["z"].x))
    np.testing.assert_array_equal(back["z"].y[0], np.arange(3))
    assert back["z"].y[1] == 7 and back["a"][1] == 2.5 and int(back["a"][0]) == 0


def test_bf16_train_state_roundtrips_bit_for_bit(tmp_path):
    """Reduced gemma-2b in bfloat16 after two steps (moments and step set),
    saved, then loaded into a state drawn from another seed."""
    cfg = dataclasses.replace(get_arch("gemma-2b").reduced(), dtype="bfloat16")
    state = M.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 33)).astype(np.int32))
    for _ in range(2):
        state, _ = M.train_step(cfg, state, {"tokens": tok})
    save_checkpoint(state, tmp_path / "bf16")
    assert "bfloat16" in (tmp_path / "bf16.json").read_text()
    fresh = M.init_train_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    back = load_checkpoint(fresh, tmp_path / "bf16")
    assert back.params is fresh.params  # the module takes the values in place
    _assert_states_equal(back, state)
    # and the restored state trains on as the original does
    s1, m1 = M.train_step(cfg, state, {"tokens": tok})
    s2, m2 = M.train_step(cfg, back, {"tokens": tok})
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_states_equal(s1, s2)


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint({"w": torch.zeros(3, 4)}, tmp_path / "s")
    with pytest.raises(ValueError, match=r"leaf 0: checkpoint \(3, 4\) != expected \(4, 3\)"):
        load_checkpoint({"w": torch.zeros(4, 3)}, tmp_path / "s")
    cfg = get_arch("gemma-2b").reduced()
    save_checkpoint(M.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu"),
                    tmp_path / "small")
    wider = M.init_train_state(dataclasses.replace(cfg, d_ff=128), torch.Generator().manual_seed(0),
                               device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        load_checkpoint(wider, tmp_path / "small")


def test_jax_float32_train_state_checkpoint_reads_through_the_converter(tmp_path):
    """The JAX package saves its float32 ``TrainState``; the port reads the
    ``.npz`` with numpy, rebuilds the JAX tree and converts it."""
    cfg_j = dataclasses.replace(jax_get_arch("gemma-2b"), layer_pattern="local_global",
                                window=4096).reduced()
    cfg = dataclasses.replace(get_arch("gemma-2b"), layer_pattern="local_global", window=4096).reduced()
    state_j = JM.init_train_state(cfg_j, jax.random.PRNGKey(0))
    tok = jnp.asarray(np.random.default_rng(1).integers(0, 512, (2, 129)).astype(np.int32))
    state_j, _ = jax.jit(lambda s, b: JM.train_step(cfg_j, s, b))(state_j, {"tokens": tok})
    jax_save_checkpoint(state_j, tmp_path / "jax")
    data = np.load(tmp_path / "jax.npz")
    leaves, treedef = jax.tree.flatten(state_j)
    tree = jax.tree.unflatten(treedef, [data[f"leaf_{i}"] for i in range(len(leaves))])
    got = train_state_from_numpy(cfg, tree.params, tree.opt, device="cpu")
    want = train_state_from_numpy(cfg, jax.tree.map(np.asarray, state_j.params),
                                  jax.tree.map(np.asarray, state_j.opt), device="cpu")
    _assert_states_equal(got, want)
    assert int(got.opt.step) == 1 and any(float(m.abs().max()) > 0 for m in got.opt.mu.values())
