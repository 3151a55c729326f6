"""The port's wire format and leaf codecs against the JAX package's, byte
for byte, on the CPU: the same ensemble (carried across from numpy with
``repro_torch.convert``) serializes to the same bytes, every codec
encodes a leaf to the same bytes, and ``wire_size`` counts the same.
The port computes bf16 through ``torch.bfloat16``; this test holds it to
``ml_dtypes``, which only the JAX side may import."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import boosting as jboost
from repro.core import serialization as jser
from repro.learners.tree import TreeParams as JaxTreeParams
from repro_torch import convert
from repro_torch.core import boosting as tboost
from repro_torch.core import serialization as tser
from repro_torch.learners import LearnerSpec, get_learner


def random_ensemble_arrays(seed=0, T=6, count=4, depth=3, d=5, K=4):
    """Numpy random trees: ``feature`` in [0, d), Gaussian thresholds and
    leaf logits, alpha on the used slots, zeros beyond ``count``."""
    rng = np.random.default_rng(seed)
    live = (np.arange(T) < count)
    return {
        "feature": (rng.integers(0, d, size=(T, depth)) * live[:, None]).astype(np.int32),
        "threshold": (rng.normal(size=(T, depth)) * live[:, None]).astype(np.float32),
        "leaf_logits": (rng.normal(size=(T, 2**depth, K)) * live[:, None, None]).astype(np.float32),
        "alpha": (rng.uniform(0.2, 2.0, size=T) * live).astype(np.float32),
        "count": np.asarray(count, np.int32),
    }


def jax_ensemble(a):
    return jboost.Ensemble(
        params=JaxTreeParams(jnp.asarray(a["feature"]), jnp.asarray(a["threshold"]),
                             jnp.asarray(a["leaf_logits"])),
        alpha=jnp.asarray(a["alpha"]),
        count=jnp.asarray(a["count"]),
    )


@pytest.mark.parametrize("packed", [True, False])
def test_serialize_bytes_match_jax(packed):
    a = random_ensemble_arrays(1)
    assert tser.serialize(convert.ensemble_from_numpy(a, device="cpu"), packed) == \
        jser.serialize(jax_ensemble(a), packed)


def test_wire_format_and_size_match_jax():
    a = random_ensemble_arrays(2)
    ens, jens = convert.ensemble_from_numpy(a, device="cpu"), jax_ensemble(a)
    fmt, jfmt = tser.wire_format(ens), jser.wire_format(jens)
    assert fmt.shapes == jfmt.shapes and fmt.dtypes == jfmt.dtypes
    assert tser.wire_size(ens) == jser.wire_size(jens)
    assert tser.wire_size(ens.params) == jser.wire_size(jens.params)


@pytest.mark.parametrize("packed", [True, False])
def test_deserialize_jax_bytes_roundtrip(packed):
    a = random_ensemble_arrays(3)
    ens = convert.ensemble_from_numpy(a, device="cpu")
    back = tser.deserialize(jser.serialize(jax_ensemble(a), packed), tser.wire_format(ens), packed)
    assert isinstance(back, tboost.Ensemble) and back.count == 4
    for k, v in convert.ensemble_to_numpy(back).items():
        np.testing.assert_array_equal(v, a[k])
        assert v.dtype == a[k].dtype
    assert tser.roundtrip_equal(ens, packed)


def test_count_is_a_0dim_int32_leaf():
    spec = LearnerSpec("decision_tree", 5, 3, {"depth": 2, "n_bins": 16})
    ens = tboost.init_ensemble(get_learner("decision_tree"), spec, 3, "cpu")
    structure, specs = tser.leaf_specs(ens)
    assert specs[-1] == ((), "int32")
    assert tser.flatten_leaves(ens)[-1].dtype == np.int32


def _plans(a):
    lo = a["leaf_logits"]
    return [
        ("feature", {"codec": "u8"}),
        ("threshold", {"codec": "raw"}),
        ("leaf_logits", {"codec": "bf16"}),
        ("leaf_logits", {"codec": "int8", "outlier_rows": [], "promoted_slots": []}),
        ("leaf_logits", {"codec": "int8", "outlier_rows": jser.outlier_rows(lo),
                         "promoted_slots": [1, 3]}),
        ("outliers", {"codec": "int8", "outlier_rows": [0, 5], "promoted_slots": [2]}),
        ("alpha", {"codec": "raw"}),
    ]


@pytest.mark.parametrize("case", range(7))
def test_encode_leaf_matches_jax(case):
    a = random_ensemble_arrays(4, T=5, count=5, K=6)
    # a leaf whose rows 0 and 5 dwarf the rest: the outlier-row section
    a["outliers"] = a["leaf_logits"].copy()
    a["outliers"][:, [0, 5]] *= 40.0
    assert jser.outlier_rows(a["outliers"]) == [0, 5]
    key, plan = _plans(a)[case]
    leaf = a[key]
    got = tser.encode_leaf(leaf, plan)
    assert got == jser.encode_leaf(leaf, plan)
    assert len(got) == tser.encoded_nbytes(plan, leaf.shape, leaf.dtype) \
        == jser.encoded_nbytes(plan, leaf.shape, leaf.dtype)
    back = tser.decode_leaf(got, plan, leaf.shape, leaf.dtype)
    np.testing.assert_array_equal(back, jser.decode_leaf(got, plan, leaf.shape, leaf.dtype))
    if plan["codec"] == "int8":  # argmax repair: every leaf row keeps its winner
        np.testing.assert_array_equal(back.argmax(-1), leaf.argmax(-1))


def test_bf16_codec_rounds_as_ml_dtypes():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(-30, 30, size=4096),
        # halfway cases: round to nearest even, both directions
        np.array([1.00390625, 1.01171875, -1.00390625, 0.0, -0.0, np.inf, -np.inf], np.float32),
    ]).astype(np.float32)
    plan = {"codec": "bf16"}
    assert tser.encode_leaf(x, plan) == x.astype(ml_dtypes.bfloat16).tobytes()
    back = tser.decode_leaf(tser.encode_leaf(x, plan), plan, x.shape, np.float32)
    np.testing.assert_array_equal(back, x.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_codec_errors_match_jax():
    for leaf, plan in [(np.arange(4, dtype=np.float32), {"codec": "u8"}),
                       (np.array([300], np.int32), {"codec": "u8"}),
                       (np.arange(4, dtype=np.int32), {"codec": "bf16"}),
                       (np.zeros(4, np.float32), {"codec": "zip"})]:
        with pytest.raises(ValueError) as port_err:
            tser.encode_leaf(leaf, plan)
        with pytest.raises(ValueError) as jax_err:
            jser.encode_leaf(leaf, plan)
        assert str(port_err.value) == str(jax_err.value)


def test_flatten_orders_like_jax_tree_flatten():
    t = (torch.ones(2), (3, torch.zeros(1, dtype=torch.int32)))
    j = (jnp.ones(2), (jnp.asarray(3, jnp.int32), jnp.zeros(1, jnp.int32)))
    leaves, structure = tser.flatten(t)
    want = jax.tree.flatten(j)[0]
    assert [l.tolist() for l in leaves] == [np.asarray(l).tolist() for l in want]
    back = tser.unflatten(structure, leaves)
    assert back[1][0] == 3 and back[1][1].dtype == torch.int32
