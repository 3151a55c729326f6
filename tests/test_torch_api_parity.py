"""Calls that work on the JAX package and now work on the port too, on the
CPU: the ``obs/metrics.py`` read-outs (``Histogram.merge`` / ``min`` /
``max`` / ``mean`` / ``len``, ``Gauge.inc`` / ``dec``, the registry's
``get`` and ``reset``), the by-name ``partition`` dispatcher,
``publish_artifact(quantize=, calibrate=)``; and the kernel build's file
lock, under which processes starting together build the library once."""
import threading
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.partition import partition as jax_partition
from repro.learners import LearnerSpec as JaxSpec
from repro.serve import publish_artifact as jax_publish
from repro_torch import convert
from repro_torch.fl.partition import dirichlet_partition, iid_partition, partition
from repro_torch.learners import LearnerSpec
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import Gauge, Histogram, MetricsRegistry
from repro_torch.serve import latest_artifact
from test_torch_serve import QUANT, jax_ensemble, random_ensemble_arrays

# -- obs/metrics: tests/test_obs.py's histogram contract, on the port ----------------


def test_histogram_quantiles_match_exact_within_error_bound():
    rng = np.random.default_rng(0)
    xs = rng.lognormal(mean=-6.0, sigma=1.0, size=5000)  # latency-shaped
    h = Histogram()
    for x in xs:
        h.observe(x)
    for p in (10, 50, 90, 99):
        exact = float(np.percentile(xs, p))
        assert abs(h.percentile(p) - exact) / exact < 0.06, p
    assert h.quantile(0.0) == float(xs.min()) == h.min
    assert h.quantile(1.0) == float(xs.max()) == h.max
    assert h.count == len(h) == len(xs)
    assert abs(h.mean - xs.mean()) < 1e-9 * xs.mean()


def test_histogram_is_deque_compatible():
    h = Histogram()
    assert len(h) == 0
    assert np.isnan(h.percentile(50)) and np.isnan(h.mean)
    h.append(0.25)
    h.append(0.5)
    assert len(h) == 2
    assert h.min == 0.25 and h.max == 0.5 and h.mean == 0.375


def test_histogram_merge_combines_distributions():
    a, b = Histogram(), Histogram()
    xs = np.linspace(1e-3, 1e-2, 500)
    ys = np.linspace(1e-1, 1.0, 1500)
    for x in xs:
        a.observe(x)
    for y in ys:
        b.observe(y)
    assert a.merge(b) is a
    assert a.count == 2000 and a.min == xs.min() and a.max == ys.max()
    both = np.concatenate([xs, ys])
    p50 = np.percentile(both, 50)
    assert abs(a.percentile(50) - p50) / p50 < 0.06
    with pytest.raises(ValueError, match="bucket shapes"):
        a.merge(Histogram(growth=1.5))  # a shape mismatch must be loud


def test_gauge_goes_up_and_down():
    g = Gauge("g")
    g.set(2.0)
    g.inc()
    g.dec(0.5)
    assert g.value == 2.5


def test_registry_get_and_reset():
    reg = MetricsRegistry()
    c = reg.counter("mafl_test_total", "a counter")
    h = reg.histogram("mafl_test_seconds", "a histogram")
    fam = reg.counter("mafl_test_labeled_total", "labeled", labels=("reason",))
    c.inc(3)
    h.observe(0.5)
    fam.labels(reason="dead").inc()
    assert reg.get("mafl_test_total").solo is c
    assert reg.get("mafl_nope") is None
    reg.reset()
    assert c.value == 0.0 and h.count == 0 and np.isnan(h.mean)
    assert fam.labels(reason="dead").value == 0.0
    assert reg.get("mafl_test_seconds").solo is h  # families stay registered
    c.inc()
    assert "mafl_test_total 1.0" in reg.prometheus_text()


def test_module_reset_zeroes_the_process_registry():
    c = obs_metrics.counter("mafl_federation_rounds_total")
    c.inc(2)
    obs_metrics.reset()
    assert c.value == 0.0
    assert obs_metrics.REGISTRY.get("mafl_federation_rounds_total") is not None


# -- fl/partition.py: the dispatcher ---------------------------------------------------


def _data(n=300, d=4, K=5):
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, K, size=n).astype(np.int32)), K)


def test_partition_dispatches_by_name():
    X, y, K = _data()
    for got, want in zip(partition("iid", X, y, 4, torch.Generator().manual_seed(5)),
                         iid_partition(X, y, 4, torch.Generator().manual_seed(5))):
        assert torch.equal(got, want)
    kw = dict(alpha=0.5, n_classes=K)
    for got, want in zip(partition("dirichlet", X, y, 4, torch.Generator().manual_seed(5), **kw),
                         dirichlet_partition(X, y, 4, generator=torch.Generator().manual_seed(5),
                                             **kw)):
        assert torch.equal(got, want)
    with pytest.raises(KeyError, match="unknown partitioner 'skewed'"):
        partition("skewed", X, y, 4, torch.Generator())


def test_partition_dirichlet_equals_the_jax_dispatcher_for_its_seed():
    X, y, K = _data()
    key = jax.random.PRNGKey(3)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    want = jax_partition("dirichlet", jnp.asarray(X.numpy()), jnp.asarray(y.numpy()), 5, key,
                         alpha=0.3, n_classes=K)
    got = partition("dirichlet", X, y, 5, torch.Generator(), alpha=0.3, n_classes=K, seed=seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- serve/artifact.py: publish_artifact's quantized checkpoints -------------------------


@pytest.mark.parametrize("quantize,calibrate", QUANT, ids=["v1", "int8", "bf16"])
def test_publish_artifact_quantized_is_byte_identical(tmp_path, quantize, calibrate):
    """The published file and the LATEST pointer are the JAX package's
    bytes, quantized and calibrated or not."""
    from repro_torch.serve.artifact import publish_artifact

    a = random_ensemble_arrays(3, T=6, count=4, depth=3, d=5, K=4)
    X = np.random.default_rng(4).normal(size=(64, 5)).astype(np.float32)
    hp = {"depth": 3, "n_bins": 16}
    cal = X if calibrate else None
    p = publish_artifact(tmp_path / "t", LearnerSpec("decision_tree", 5, 4, hp),
                         convert.ensemble_from_numpy(a, device="cpu"), version=7,
                         extra={"round": 7}, quantize=quantize, calibrate=cal)
    j = jax_publish(tmp_path / "j", JaxSpec("decision_tree", 5, 4, hp), jax_ensemble(a),
                    version=7, extra={"round": 7}, quantize=quantize, calibrate=cal)
    assert p.name == j.name == "ensemble_v000007.mafl"
    assert p.read_bytes() == j.read_bytes()
    assert latest_artifact(tmp_path / "t") == p


# -- kernels/_build.py: one build under concurrent first use ----------------------------


def test_concurrent_first_use_builds_the_library_once(tmp_path, monkeypatch):
    """Two ``library()`` calls racing on a missing library: one takes the
    lock and builds, the other waits on it and loads what was built."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    builds = []

    def fake_build(target):
        builds.append(target)
        time.sleep(0.3)  # long enough for the other caller to reach the lock
        target.write_bytes(b"built")

    monkeypatch.setattr(_build, "_build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", mock.MagicMock())
    start = threading.Barrier(2)
    errors = []

    def call():
        try:
            start.wait()
            _build.library()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors
    assert len(builds) == 1 and builds[0].read_bytes() == b"built"
    assert (tmp_path / "build.lock").exists()
