"""The port's elastic multi-process runtime (``repro_torch/fl/
elastic_dist.py``, ``fl_run --distributed --elastic``) against the JAX
package's, on the CPU.

The socket framing puts the JAX package's bytes on the wire, both ways.
``_Shard``'s fit, scoring, weight step and renormalisation are held
in-process against the JAX ``_Shard`` from the same numpy inputs
(vehicle, C = 4, depth 3, 8 bins; errors rtol 1e-4, weights rtol 1e-5).
Then the chaos scenarios of ``tests/test_elastic_chaos.py`` through the
port's ``fl_spawn --device cpu``: a collaborator killed mid-round is
evicted and the federation finishes; delayed uploads merge late with
``|alpha| <= |base|`` (a late tree worse than chance under the current
weights has a negative base, which the discount shrinks toward 0)."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data import get_dataset as jax_dataset
from repro.fl import elastic_dist as jdist
from repro.fl.partition import iid_partition as jax_iid_partition
from repro.learners import LearnerSpec as JaxSpec
from repro_torch.fl import elastic_dist as tdist
from repro_torch.kernels import ops
from repro_torch.learners import LearnerSpec

SRC = Path(__file__).resolve().parent.parent / "src"
C = 4
HP = {"depth": 3, "n_bins": 8}
TIMEOUT_S = 170  # every subprocess's own limit

MESSAGES = [
    ("hello", {"pid": 3}, b""),
    ("hyp", {"round": 2, "pid": 1}, bytes(range(256)) * 3),
    ("errs", {"round": 0, "pid": 2, "wsum": 0.24999999403953552},
     np.array([0.1, 0.7, 1e-300], np.float64).tobytes()),
    ("space", {"round": 4, "pids": [0, 1, 3], "late": [{"pid": 2, "src_round": 3}]}, b"\x00\x01"),
    ("update", {"round": 1, "chosen": 2, "alpha": -1.2345678901234567}, b""),
    ("done", {}, b""),
]


def _wire(send, kind, meta, payload):
    """The bytes ``send`` puts on one end of a socketpair."""
    a, b = socket.socketpair()
    try:
        n = send(a, kind, meta, payload)
        a.close()
        chunks = []
        while True:
            c = b.recv(65536)
            if not c:
                break
            chunks.append(c)
        return n, b"".join(chunks)
    finally:
        b.close()


@pytest.mark.parametrize("kind,meta,payload", MESSAGES, ids=[m[0] for m in MESSAGES])
def test_framing_bytes_equal_the_jax_package(kind, meta, payload):
    n, got = _wire(tdist._send_msg, kind, meta, payload)
    jn, want = _wire(jdist._send_msg, kind, meta, payload)
    assert got == want and n == jn == len(got)
    # each side reads the other's message back
    for send, recv in ((tdist._send_msg, jdist._recv_msg), (jdist._send_msg, tdist._recv_msg)):
        a, b = socket.socketpair()
        with a, b:
            send(a, kind, dict(meta), payload)
            assert recv(b) == (kind, meta, payload)


def test_buffer_list_packing_equals_the_jax_package():
    bufs = [b"", b"abc", bytes(1000), b"\xff" * 7]
    assert tdist._pack_bufs(bufs) == jdist._pack_bufs(bufs)
    assert tdist._unpack_bufs(jdist._pack_bufs(bufs)) == bufs
    a, b = socket.socketpair()
    with a, b:
        a.close()
        with pytest.raises(ConnectionError):
            tdist._recv_exact(b, 4)


# -- _Shard against the JAX _Shard ----------------------------------------------------


@pytest.fixture(scope="module")
def data():
    dspec, (Xtr, ytr, Xte, yte) = jax_dataset("vehicle", jax.random.PRNGKey(0))
    Xs, ys, masks = jax_iid_partition(Xtr, ytr, C, jax.random.PRNGKey(1))
    return (np.array(Xs), np.array(ys), np.array(masks), dspec.n_features, dspec.n_classes)


@pytest.mark.parametrize("pid", [0, 2])
def test_shard_matches_the_jax_shard(data, pid, monkeypatch):
    """Two rounds of fit_round, score_space over every shard's hypothesis,
    apply_update (through ``weight_update_product``) and renormalize."""
    Xs, ys, masks, d, K = data
    jshards = [jdist._Shard(i, JaxSpec("decision_tree", d, K, HP), jnp.asarray(Xs),
                            jnp.asarray(ys), jnp.asarray(masks), jax.random.PRNGKey(2))
               for i in range(C)]
    shard = tdist._Shard(pid, LearnerSpec("decision_tree", d, K, HP), Xs, ys, masks, device="cpu")
    products = []
    real = ops.weight_update_product
    monkeypatch.setattr(ops, "weight_update_product",
                        lambda *a: products.append(1) or real(*a))
    np.testing.assert_allclose(shard.w.numpy(), np.asarray(jshards[pid].w), rtol=1e-6)
    for r in range(2):
        mine = shard.fit_round(r)
        theirs = jshards[pid].fit_round(r)
        np.testing.assert_array_equal(mine.feature.numpy(), np.asarray(theirs.feature))
        np.testing.assert_allclose(mine.threshold.numpy(), np.asarray(theirs.threshold),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(mine.leaf_logits.numpy(), np.asarray(theirs.leaf_logits),
                                   atol=1e-5)
        bufs = [j.serialize_hyp(j.fit_round(r)) for j in jshards]  # the JAX package's bytes
        errs, wsum, mis = shard.score_space(bufs)
        jerrs, jwsum, jmis = jshards[pid].score_space(bufs)
        np.testing.assert_allclose(errs, jerrs, rtol=1e-4)
        np.testing.assert_allclose(wsum, jwsum, rtol=1e-6)
        np.testing.assert_array_equal(mis.numpy(), np.stack([np.asarray(m) for m in jmis]))
        c, alpha = int(np.argmin(jerrs)), 1.25 - 0.5 * r
        new = shard.apply_update(mis[c], alpha)
        jnew = jshards[pid].apply_update(jmis[c], alpha)
        np.testing.assert_allclose(shard.w.numpy(), np.asarray(jshards[pid].w), rtol=1e-5)
        np.testing.assert_allclose(new, jnew, rtol=1e-5)
        total = 4.0 * jnew
        shard.renormalize(total)
        jshards[pid].renormalize(total)
        np.testing.assert_allclose(shard.w.numpy(), np.asarray(jshards[pid].w), rtol=1e-5)
    assert len(products) == 2  # one un-renormalised product a round


def test_elastic_distributed_refuses_other_algorithms():
    from argparse import Namespace

    args = Namespace(algorithm="distboost_f", process_id=0)
    with pytest.raises(NotImplementedError, match="adaboost_f"):
        tdist.run_elastic_distributed(args, None, None, None, None, None, None, None, None,
                                      device="cpu")


# -- chaos through fl_spawn -------------------------------------------------------------


def _spawn_elastic(extra_args, tmp_path, *, min_f1=None):
    hist = tmp_path / "elastic.json"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in [str(SRC), os.environ.get("PYTHONPATH", "")] if p))
    cmd = [sys.executable, "-m", "repro_torch.launch.fl_spawn", "-n", str(C),
           "--timeout", str(TIMEOUT_S - 30),
           *(["--min-f1", str(min_f1)] if min_f1 is not None else []),
           "--", "--device", "cpu", "--elastic", "--dataset", "vehicle", "--rounds", "5",
           "--eval-every", "1", "--history-out", str(hist), *extra_args]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    return proc, (json.loads(hist.read_text()) if hist.exists() else None)


def test_kill_mid_round_closes_over_responders(tmp_path):
    """``--fault-kill 2:2``: collaborator 2's process exits at round 2; the
    coordinator evicts it instead of hanging, federates over the
    survivors, finishes all 5 rounds and clears the F1 floor."""
    proc, summary = _spawn_elastic(["--deadline-ms", "3000", "--fault-kill", "2:2"], tmp_path,
                                   min_f1=0.5)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert summary["evicted"] == [2]
    assert summary["dropouts"].get("dead") == 1
    assert len(summary["history"]) == 5
    assert all(r <= C - 1 for r in summary["responders"][2:])
    assert all(r >= 1 for r in summary["responders"])
    assert summary["final_f1"] >= 0.5 and summary["device"] == "cpu"
    assert "evicted 1" in proc.stdout


def test_delay_only_stragglers_merge_late_and_discounted(tmp_path):
    """Stragglers past an 800 ms deadline are deadline-dropped from their
    round, and their uploads merge late with the staleness discount:
    alpha = base * gamma**lateness, so |alpha| <= |base|."""
    proc, summary = _spawn_elastic(["--deadline-ms", "800", "--fault-delay-p", "0.4",
                                    "--fault-delay-ms", "1500:2000", "--fault-seed", "3"],
                                   tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert summary["dropouts"].get("deadline", 0) > 0
    assert summary["late"], "expected late merges, got none"
    for row in summary["late"]:
        assert row["lateness"] >= 1
        assert abs(row["alpha"]) <= abs(row["base_alpha"])
        assert row["alpha"] == pytest.approx(row["base_alpha"] * 0.5 ** row["lateness"])
    assert len(summary["history"]) == 5
