"""The port's process-per-collaborator runtime (``repro_torch/fl/
distributed.py``, ``launch/fl_spawn.py``) and its packed wire buffer
(``fl/sharded.py``) against the JAX package's, on the CPU.

Four OS processes exchange rounds over real gloo collectives, every
algorithm in turn (vehicle, C = 4, T = 3, depth 3, 8 bins; the inputs are
the JAX package's, written to an ``.npz`` for the children).  The run
equals the port's fused ``Federation`` bit for bit (weights, ensemble,
alpha, every history row) and, for AdaBoost.F, DistBoost.F and PreWeak.F
(``decision_tree`` draws nothing), the JAX package's fused federation at
the parity tolerances with the same chosen members.  The packed buffer is
the JAX package's byte for byte.  Children run with one thread each and
every subprocess has its own timeout."""
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import adaboost_plan as jax_adaboost_plan
from repro.core.plan import bagging_plan as jax_bagging_plan
from repro.data import get_dataset as jax_dataset
from repro.fl.federation import Federation as JaxFederation
from repro.fl.partition import iid_partition as jax_iid_partition
from repro.fl.sharded import _pack_leaves as jax_pack
from repro.learners import LearnerSpec as JaxSpec
from repro.learners.tree import TreeParams as JaxTreeParams
from repro_torch.core.plan import adaboost_plan, bagging_plan, fedavg_plan
from repro_torch.fl.federation import Federation
from repro_torch.fl.sharded import _pack_leaves, _unpack_leaves
from repro_torch.learners import LearnerSpec
from repro_torch.learners.tree import TreeParams

SRC = Path(__file__).resolve().parent.parent / "src"
ALGOS = ["adaboost_f", "distboost_f", "bagging", "preweak_f"]
C, T = 4, 3
HP = {"depth": 3, "n_bins": 8}
TIMEOUT_S = 170  # every subprocess's own limit


def child_env():
    """The children's environment: ``src`` on the path, one thread each
    (six test workers times four processes share the cores)."""
    path = os.pathsep.join(p for p in [str(SRC), os.environ.get("PYTHONPATH", "")] if p)
    return dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _plan(alg, fns=(adaboost_plan, bagging_plan)):
    adaboost, bagging = fns
    return bagging(rounds=T) if alg == "bagging" else adaboost(rounds=T, algorithm=alg)


# every process runs each algorithm (packed), then AdaBoost.F per leaf;
# process 0 writes the run, every process its final weights
_CHILD = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    from repro_torch.core.plan import adaboost_plan, bagging_plan
    from repro_torch.fl import distributed as dist
    from repro_torch.learners import LearnerSpec

    pid, nproc, coord, inp, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    dist.initialize(coord, nproc, pid)
    d = np.load(inp)
    spec = LearnerSpec("decision_tree", int(d["d"]), int(d["K"]), {"depth": 3, "n_bins": 8})
    res = {}
    for alg, packed in [("adaboost_f", True), ("distboost_f", True), ("bagging", True),
                        ("preweak_f", True), ("adaboost_f", False)]:
        plan = (bagging_plan(rounds=int(d["T"])) if alg == "bagging"
                else adaboost_plan(rounds=int(d["T"]), algorithm=alg))
        fed = dist.DistributedFederation(plan, d["Xs"], d["ys"], d["masks"], d["Xte"], d["yte"],
                                         spec, device="cpu", seed=0, packed_broadcast=packed)
        hist = fed.run(eval_every=1)
        tag = alg if packed else alg + "_per_leaf"
        st = fed.state
        res[f"{tag}_weights_{pid}"] = st.weights.numpy()
        res[f"{tag}_alpha"] = st.ensemble.alpha.numpy()
        res[f"{tag}_count"] = np.asarray(st.ensemble.count)
        for i, leaf in enumerate(st.ensemble.params):
            res[f"{tag}_ens_{i}"] = leaf.numpy()
        for k in ("f1", "epsilon", "alpha", "chosen"):
            if k in hist[0]:
                res[f"{tag}_hist_{k}"] = np.asarray([row[k] for row in hist])
        res[f"{tag}_comm_bytes"] = np.asarray(fed.comm_bytes)
        res[f"{tag}_collectives"] = np.asarray(fed.collective_calls)
    np.savez(f"{out}_{pid}.npz", **res)
    dist.shutdown()
    print("CHILD_OK", flush=True)
    """
)


@pytest.fixture(scope="module")
def data():
    dspec, (Xtr, ytr, Xte, yte) = jax_dataset("vehicle", jax.random.PRNGKey(0))
    Xs, ys, masks = jax_iid_partition(Xtr, ytr, C, jax.random.PRNGKey(1))
    arrays = {k: np.array(a) for k, a in zip(("Xs", "ys", "masks", "Xte", "yte"),
                                              (Xs, ys, masks, Xte, yte))}
    return {**arrays, "d": dspec.n_features, "K": dspec.n_classes}


@pytest.fixture(scope="module")
def gloo_run(data, tmp_path_factory):
    """One 4-process gloo run of every algorithm; ``{pid: results}``."""
    tmp = tmp_path_factory.mktemp("dist")
    inp, out = tmp / "inputs.npz", tmp / "results"
    np.savez(inp, **data, T=T)
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(i), str(C), coord, str(inp),
                               str(out)], env=child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(C)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "CHILD_OK" in o, f"process {i} failed:\n{o[-3000:]}"
    return {i: dict(np.load(f"{out}_{i}.npz")) for i in range(C)}


def _port_fused(data, alg):
    fed = Federation(_plan(alg), data["Xs"], data["ys"], data["masks"], data["Xte"], data["yte"],
                     LearnerSpec("decision_tree", data["d"], data["K"], HP), device="cpu", seed=0)
    return fed, fed.run(eval_every=1)


@pytest.mark.parametrize("alg", ALGOS)
def test_four_processes_equal_the_fused_run_bit_for_bit(gloo_run, data, alg):
    """Weights, ensemble leaves and alpha, and every history row (f1,
    epsilon, alpha, chosen) are the port's fused run's to the bit."""
    got = gloo_run[0]
    fed, hist = _port_fused(data, alg)
    st = fed.state
    np.testing.assert_array_equal(got[f"{alg}_weights_0"], st.weights.numpy())
    np.testing.assert_array_equal(got[f"{alg}_alpha"], st.ensemble.alpha.numpy())
    assert int(got[f"{alg}_count"]) == st.ensemble.count == T
    for i, leaf in enumerate(st.ensemble.params):
        np.testing.assert_array_equal(got[f"{alg}_ens_{i}"], leaf.numpy(), err_msg=f"leaf {i}")
    for k in ("f1", "epsilon", "alpha", "chosen"):
        np.testing.assert_array_equal(got[f"{alg}_hist_{k}"], [row[k] for row in hist], err_msg=k)


@pytest.mark.parametrize("alg", ["adaboost_f", "distboost_f", "preweak_f"])
def test_four_processes_match_the_jax_fused_federation(gloo_run, data, alg):
    """The same chosen member every round as the JAX package's fused run;
    epsilon, alpha and weights within rtol 1e-5, F1 within 1e-3."""
    got = gloo_run[0]
    jfed = JaxFederation(_plan(alg, (jax_adaboost_plan, jax_bagging_plan)),
                         *(jnp.asarray(data[k]) for k in ("Xs", "ys", "masks", "Xte", "yte")),
                         JaxSpec("decision_tree", data["d"], data["K"], HP), jax.random.PRNGKey(2))
    jhist = jfed.run(eval_every=1)
    np.testing.assert_array_equal(got[f"{alg}_hist_chosen"], [round(h["chosen"]) for h in jhist])
    for k in ("epsilon", "alpha"):
        np.testing.assert_allclose(got[f"{alg}_hist_{k}"], [h[k] for h in jhist], rtol=1e-5)
    np.testing.assert_allclose(got[f"{alg}_hist_f1"], [h["f1"] for h in jhist], atol=1e-3)
    np.testing.assert_allclose(got[f"{alg}_weights_0"], np.asarray(jfed._fused_state.weights),
                               rtol=1e-5, atol=1e-9)


def test_every_process_holds_the_replicated_state(gloo_run):
    """The aggregation is replicated: each process ends with the same
    weights to the bit, and only process 0 evaluates."""
    for alg in ALGOS:
        for i in range(1, C):
            np.testing.assert_array_equal(gloo_run[i][f"{alg}_weights_{i}"],
                                          gloo_run[0][f"{alg}_weights_0"], err_msg=alg)
            np.testing.assert_array_equal(gloo_run[i][f"{alg}_hist_chosen"],
                                          gloo_run[0][f"{alg}_hist_chosen"], err_msg=alg)
            assert f"{alg}_hist_f1" not in gloo_run[i]


def test_collectives_and_comm_bytes_per_algorithm(gloo_run, data):
    """3 collectives a round for AdaBoost.F, 2 DistBoost.F, 1 bagging,
    2 PreWeak.F plus its set-up gather; the bytes are the gathered
    payloads: hypotheses [C, 29] (feature 3 + threshold 3 + leaf_logits
    8 x K float32 words), errors [C, H] and mispredictions [C, n]."""
    got = gloo_run[0]
    n, K = data["ys"].shape[1], data["K"]
    h = (3 + 3 + 8 * K) * 4  # one tree's bytes
    want_calls = {"adaboost_f": 3 * T, "distboost_f": 2 * T, "bagging": T, "preweak_f": 2 * T + 1}
    want_bytes = {
        "adaboost_f": T * (C * h + C * C * 4 + C * n * 4),
        "distboost_f": T * (C * h + C * n * 4),
        "bagging": T * C * h,
        "preweak_f": C * T * h + T * (C * C * T * 4 + C * n * 4),
    }
    for alg in ALGOS:
        assert int(got[f"{alg}_collectives"]) == want_calls[alg], alg
        assert int(got[f"{alg}_comm_bytes"]) == want_bytes[alg], alg


def test_per_leaf_broadcast_gives_the_same_run_in_five_collectives(gloo_run):
    """``packed_broadcast=False`` gathers the three leaves one by one: 5
    collectives a round instead of 3, the same bytes and the same bits."""
    got = gloo_run[0]
    assert int(got["adaboost_f_collectives"]) == 3 * T
    assert int(got["adaboost_f_per_leaf_collectives"]) == 5 * T
    assert int(got["adaboost_f_per_leaf_comm_bytes"]) == int(got["adaboost_f_comm_bytes"])
    for key in [k for k in got if k.startswith("adaboost_f_") and "per_leaf" not in k
                and not k.endswith(("collectives", "comm_bytes"))]:
        np.testing.assert_array_equal(got[key.replace("adaboost_f_", "adaboost_f_per_leaf_")],
                                      got[key], err_msg=key)


# -- the packed wire buffer ------------------------------------------------------


def _tree_arrays(seed, lead=()):
    rng = np.random.default_rng(seed)
    return (rng.integers(-5, 40, size=lead + (4,)).astype(np.int32),
            rng.normal(size=lead + (4,)).astype(np.float32),
            rng.normal(size=lead + (16, 3)).astype(np.float32))


@pytest.mark.parametrize("lead", [(), (5,)], ids=["one tree", "a T=5 space"])
def test_packed_buffer_is_the_jax_buffer_byte_for_byte(lead):
    f, t, l = _tree_arrays(0, lead)
    buf, fmt = _pack_leaves(TreeParams(torch.from_numpy(f), torch.from_numpy(t), torch.from_numpy(l)))
    jbuf, _ = jax_pack(JaxTreeParams(jnp.asarray(f), jnp.asarray(t), jnp.asarray(l)))
    assert buf.dtype == torch.float32
    assert buf.numpy().tobytes() == np.asarray(jbuf).tobytes()
    back = _unpack_leaves(buf, fmt)
    assert isinstance(back, TreeParams) and back.feature.dtype == torch.int32
    for a, b in zip(back, (f, t, l)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_pack_round_trip_is_exact_for_every_bit_pattern():
    """int32 leaves travel bitcast (negative ints, ones that read as
    denormal floats or NaNs); float leaves keep -0.0, inf and denormals;
    a gathered [P, L] buffer unpacks with a leading dimension."""
    ints = torch.tensor([[-1, 0, 1, 7], [0x7FC00001, 3, -(2**31), 2**31 - 1]], dtype=torch.int32)
    floats = torch.tensor([1.5, -0.0, float("inf"), 2.0**-140], dtype=torch.float32)
    tree = TreeParams(ints, floats, torch.arange(6, dtype=torch.float32).reshape(3, 2))
    buf, fmt = _pack_leaves(tree)
    out = _unpack_leaves(buf, fmt)
    for a, b in zip(out, tree):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.numpy().tobytes() == b.numpy().tobytes()
    stacked = torch.stack([buf, buf])  # what a 2-process gather returns
    out2 = _unpack_leaves(stacked, fmt, lead=(2,))
    for a, b in zip(out2, tree):
        assert a.shape == (2,) + b.shape
        assert a[1].numpy().tobytes() == b.numpy().tobytes()


# -- refusals, launchers ----------------------------------------------------------


def test_constructor_refuses_what_the_jax_package_refuses(data):
    """FedAvg and a heterogeneous spec are refused; 2 collaborators in a
    process group of 1 (this process) are too."""
    from repro_torch.core.hetero import HeterogeneousSpec
    from repro_torch.fl.distributed import DistributedFederation

    args = [data["Xs"][:2], data["ys"][:2], data["masks"][:2], data["Xte"], data["yte"]]
    spec = LearnerSpec("decision_tree", data["d"], data["K"], HP)
    with pytest.raises(NotImplementedError, match="fedavg"):
        DistributedFederation(fedavg_plan(rounds=3), *args, spec, device="cpu")
    hs = HeterogeneousSpec.cycle(["decision_tree", "ridge"], 2, data["d"], data["K"])
    with pytest.raises(NotImplementedError, match="homogeneous-only"):
        DistributedFederation(adaboost_plan(rounds=3), *args, hs, device="cpu")
    with pytest.raises(ValueError, match="process-per-collaborator"):
        DistributedFederation(adaboost_plan(rounds=3), *args, spec, device="cpu")


def _spawn(min_f1, tmp_path):
    hist = tmp_path / "h.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.fl_spawn", "-n", "2", "--timeout", "150",
           "--min-f1", str(min_f1), "--", "--device", "cpu", "--dataset", "vehicle",
           "--rounds", "2", "--eval-every", "2", "--depth", "3", "--history-out", str(hist)]
    proc = subprocess.run(cmd, env=child_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    return proc, (json.loads(hist.read_text()) if hist.exists() else None)


@pytest.mark.parametrize("min_f1,rc", [(0.4, 0), (0.999, 4)], ids=["floor met", "floor missed"])
def test_fl_spawn_min_f1(tmp_path, min_f1, rc):
    """``fl_spawn --min-f1``: rc 0 when process 0's final F1 meets the
    floor, 4 when it misses it; the history holds the measured comm."""
    proc, summary = _spawn(min_f1, tmp_path)
    assert proc.returncode == rc, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "final F1" in proc.stdout
    assert summary["processes"] == 2 and summary["packed_broadcast"] is True
    assert summary["collective_calls"] == 3 * 2 and summary["comm_bytes"] > 0
    assert summary["device"] == "cpu"


def test_join_all_kills_a_hung_group_with_rc_124():
    """A process group that outlives the deadline is killed and every hung
    slot reports 124, within the deadline plus the grace."""
    from repro_torch.launch.fl_spawn import _join_all

    logs, procs = [], []
    for i, code in enumerate(["import sys; sys.exit(0)", "import time; time.sleep(120)"]):
        f = tempfile.NamedTemporaryFile("w+", suffix=".log", delete=False)
        logs.append(f.name)
        procs.append(subprocess.Popen([sys.executable, "-c", code], stdout=f,
                                      stderr=subprocess.STDOUT))
    t0 = time.monotonic()
    try:
        rcs = _join_all(procs, [None] + logs[1:], timeout=20.0, grace=2.0)
    finally:
        for p in procs:
            p.kill()
        for name in logs:
            os.unlink(name)
    assert rcs == [0, 124]
    assert time.monotonic() - t0 < 20.0 + 15.0
    assert procs[1].poll() is not None  # killed, not left behind
