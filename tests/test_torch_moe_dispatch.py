"""The port's data-parallel MoE dispatch (``models/moe.py``: the
counterpart of ``apply_moe``'s ``shard_map`` branch) on 2 gloo ranks of a
``(2, 1)`` ``("data", "model")`` mesh on the CPU, against the JAX package.

Each rank holds its ``B / 2`` rows and runs ``apply_moe`` under
``set_dispatch_groups(2)`` inside ``shardings.use_mesh``: its output must
equal its rows of the JAX package's ``_moe_dense(x, G=2)`` on the whole
batch, and its aux loss the mean of the JAX ``_moe_dense(x_g, 1)`` aux
losses over the two slices (the JAX branch takes that mean outside the
map; it is not ``_moe_dense(x, G=2)``'s global aux).  The same weights
(the JAX package's, carried across) and inputs; float32 at
``tests/test_torch_moe.py``'s tolerances: 2e-5 absolute on outputs, 1e-5
relative on the aux loss.  The skewed case runs the published capacity
factor 1.25 with a router leaning to expert 0, so each rank drops tokens
within its own group.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jax_get_arch
from repro.models import moe as jmoe
from repro_torch.launch.fl_spawn import free_port

SRC = Path(__file__).resolve().parent.parent / "src"
MOE_ATOL, AUX_RTOL = 2e-5, 1e-5  # tests/test_torch_moe.py's
ARCHS = ["grok-1-314b", "llama4-scout-17b-a16e"]
CASES = {"drop_free": None, "cf_1.25_skewed": 1.25}
SKEW, X_OFFSET = 0.02, 1.0  # tests/test_torch_moe.py's skewed router

RANK_SCRIPT = textwrap.dedent(
    """
    import dataclasses, sys
    import numpy as np, torch
    from repro_torch.configs import get_arch
    from repro_torch.fl import distributed
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe, shardings

    rank, port, inp, out, name, cf = sys.argv[1:7]
    rank = int(rank)
    d = np.load(inp)
    cfg = get_arch(name).reduced()
    if cf != "none":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cf))
    distributed.initialize(f"127.0.0.1:{port}", 2, rank)
    mesh = make_mesh((2, 1), ("data", "model"))
    m = moe.MoE(cfg, torch.Generator().manual_seed(0))
    for k in ("router", "w_gate", "w_up", "w_down"):
        getattr(m, k).data.copy_(torch.from_numpy(d[k]))
    x = torch.from_numpy(d["x"])
    rows = x.shape[0] // 2
    mine = x[mesh.coords["data"] * rows:(mesh.coords["data"] + 1) * rows]
    moe.set_dispatch_groups(2)
    with shardings.use_mesh(mesh):
        y, aux = moe.apply_moe(cfg, m, mine)
    np.savez(out + f".{rank}.npz", y=y.numpy(), aux=aux.numpy(), coord=mesh.coords["data"])
    distributed.shutdown()
    """
)


def _env():
    import os

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    return env


def _run_ranks(inp: Path, out: Path, name: str, cf) -> list:
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(port), str(inp), str(out),
                               name, "none" if cf is None else str(cf)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", ARCHS)
def test_data_parallel_dispatch_on_two_ranks_equals_jax(tmp_path, name, case):
    cf = CASES[case]
    cfg_j = jax_get_arch(name).reduced()
    if cf is not None:
        cfg_j = dataclasses.replace(cfg_j, capacity_factor=cf)
    p, _ = jmoe.init_moe(cfg_j, jax.random.PRNGKey(1))
    x = np.random.default_rng(2).standard_normal((4, 16, cfg_j.d_model), dtype=np.float32)
    if cf is not None:
        p = {**p, "router": p["router"].at[:, 0].add(SKEW)}
        x += X_OFFSET
    want, _ = jmoe._moe_dense(cfg_j, p, jnp.asarray(x), 2)
    auxes = [float(jmoe._moe_dense(cfg_j, p, jnp.asarray(x[g * 2:(g + 1) * 2]), 1)[1]) for g in range(2)]
    np.savez(tmp_path / "in.npz", x=x, **{k: np.asarray(v) for k, v in p.items()})
    ranks = _run_ranks(tmp_path / "in.npz", tmp_path / "out", name, cf)
    want = np.asarray(want)
    for r in ranks:
        g = int(r["coord"])
        np.testing.assert_allclose(r["y"], want[g * 2:(g + 1) * 2], atol=MOE_ATOL, rtol=0)
        np.testing.assert_allclose(float(r["aux"]), np.mean(auxes), rtol=AUX_RTOL)
    if cf is not None:  # the local aux losses differ, so the mean is a real all-reduce
        assert abs(auxes[0] - auxes[1]) > 1e-6
