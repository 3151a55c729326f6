"""The port's production-mesh dry-run (``launch/dryrun.py``) on the CPU.

* ``lower_one`` of reduced gemma-2b and grok-1 on a fake ``(2, 2)`` mesh,
  train and prefill: the JAX dry-run's JSON fields, and the depth
  extrapolation (passes at 2 and 1 units) equal to a full-depth pass.
* FLOPs against the JAX package's ``cost_analysis()`` of the same reduced
  config on one CPU device (``transformer.set_dryrun_unroll(True)``, as the
  JAX dry-run counts; in a subprocess, as the flag is process-wide state that
  JAX's trace caches keep): ``FlopCounterMode`` counts products only (matmuls,
  attention) and counts a rematerialised forward again, XLA counts
  elementwise work too and may fuse a recomputation away.  Measured: the
  port at 0.981-1.095 of JAX's count (gemma-2b train 1.095, prefill 0.981;
  grok-1 train 0.995, prefill 0.991); the bound is 15%.
* A ``(1, 1)`` dry-run of a prefill against the same prefill run for real
  on the CPU: the argument bytes equal the real parameters' and inputs'
  bytes, and the FLOPs the real run's count under the same mode, exactly.
* The CLI: ``--fl-round`` and ``--arch grok-1-314b --shape train_4k`` at
  full width on the ``(16, 16)`` production mesh, and a skipped combo.

Each dry-run creates its fake process group and destroys it on exit.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import roofline
from repro_torch.configs import get_arch
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.models import model as M

# the JAX lower_one's result fields (repro/launch/dryrun.py)
JAX_FIELDS = {"arch", "shape", "mesh", "n_devices", "compile_seconds", "cost_from_unrolled",
              "cost_extrapolated", "unit_repeats", "unroll_used", "variant", "memory", "cost",
              "collectives", "roofline", "model_flops_total", "model_flops_per_device",
              "useful_flops_ratio", "params_total", "params_active"}
MEMORY_FIELDS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                 "generated_code_size_in_bytes"}
FL_FIELDS = {"arch", "shape", "mesh", "packed_broadcast", "n_devices", "collaborators", "local_samples",
             "compile_seconds", "cost", "collectives", "roofline"}
FLOPS_RTOL = 0.15
MESH = ((2, 2), ("data", "model"))


def _shape(kind, S=64, B=4):
    return InputShape(f"{kind}_{S}", S, B, kind)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("name", ["gemma-2b", "grok-1-314b"])
def test_lower_one_on_a_fake_2x2_mesh(name, kind):
    cfg = get_arch(name).reduced()
    r = dryrun.lower_one(name, kind, "single", cfg=cfg, input_shape=_shape(kind), mesh_dims=MESH)
    assert JAX_FIELDS <= set(r) and set(r["memory"]) == MEMORY_FIELDS
    assert r["n_devices"] == 4 and r["memory"]["temp_size_in_bytes"] is None
    assert r["cost"]["flops_per_device"] > 0 and r["cost"]["bytes_per_device"] > 0
    assert r["memory"]["argument_size_in_bytes"] > 0 and r["memory"]["output_size_in_bytes"] > 0
    assert r["collectives"]["ops"] and r["collectives"]["wire_bytes"] > 0
    assert r["roofline"]["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    model = M.abstract_model(cfg)
    assert (r["params_total"], r["params_active"]) == roofline.param_counts(
        cfg, M.param_tree(model), M.param_axes(model))
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("name", ["gemma-2b", "grok-1-314b"])
def test_the_depth_extrapolation_equals_a_full_depth_pass(name):
    cfg = get_arch(name).reduced().with_layers(4)
    kw = dict(cfg=cfg, input_shape=_shape("train"), mesh_dims=MESH)
    a = dryrun.lower_one(name, "t", "single", unrolled=True, **kw)
    b = dryrun.lower_one(name, "t", "single", unrolled=False, **kw)
    assert a["cost_extrapolated"] and not b["cost_extrapolated"] and a["unit_repeats"] == 4
    for key in ("flops_per_device", "bytes_per_device"):
        np.testing.assert_allclose(a["cost"][key], b["cost"][key], rtol=1e-12)
    assert a["collectives"]["ops"] == b["collectives"]["ops"]
    assert a["collectives"]["raw_bytes"] == b["collectives"]["raw_bytes"]
    np.testing.assert_allclose(a["collectives"]["wire_bytes"], b["collectives"]["wire_bytes"], rtol=1e-12)
    assert a["memory"] == b["memory"]


# the JAX package's cost_analysis() FLOPs of the reduced configs, unrolled
JAX_FLOPS_SCRIPT = textwrap.dedent(
    """
    import json
    import jax
    from repro.configs import get_arch
    from repro.configs.base import InputShape
    from repro.models import model as JM
    from repro.models import transformer as JT
    from repro.optim.optimizers import init_adamw

    JT.set_dryrun_unroll(True)
    out = {}
    for name in ("gemma-2b", "grok-1-314b"):
        cfg = get_arch(name).reduced()
        shapes, _ = JM.shapes_and_axes(cfg)
        for kind in ("train", "prefill"):
            ins = JM.input_specs(cfg, InputShape("s", 64, 4, kind))
            if kind == "train":
                state = JM.TrainState(shapes, jax.eval_shape(init_adamw, shapes))
                c = jax.jit(lambda s, b: JM.train_step(cfg, s, b)).lower(state, ins).compile()
            else:
                c = jax.jit(lambda p, b: JM.prefill(cfg, p, b)).lower(shapes, ins).compile()
            out[f"{name}/{kind}"] = c.cost_analysis()["flops"]
    print("JAXFLOPS " + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def jax_flops():
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_FLOPS_SCRIPT], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("JAXFLOPS ")]
    return json.loads(line[0][len("JAXFLOPS "):])


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("name", ["gemma-2b", "grok-1-314b"])
def test_flops_within_the_measured_bound_of_jax(name, kind, jax_flops):
    got = dryrun.lower_one(name, "s", "single", cfg=get_arch(name).reduced(), input_shape=_shape(kind),
                           mesh_dims=((1, 1), ("data", "model")))["cost"]["flops_per_device"]
    np.testing.assert_allclose(got, jax_flops[f"{name}/{kind}"], rtol=FLOPS_RTOL)


@pytest.mark.parametrize("name", ["gemma-2b", "grok-1-314b"])
def test_a_1x1_prefill_dry_run_equals_the_real_prefill(name):
    cfg = get_arch(name).reduced()
    r = dryrun.lower_one(name, "p", "single", cfg=cfg, input_shape=_shape("prefill"),
                         mesh_dims=((1, 1), ("data", "model")))
    model = M.Transformer(cfg, torch.Generator().manual_seed(0))
    tokens = torch.zeros((4, 64), dtype=torch.int32)
    held = sum(p.numel() * p.element_size() for p in model.parameters()) + tokens.numel() * 4
    assert r["memory"]["argument_size_in_bytes"] == held
    cost = roofline.DeviceCostMode()
    with cost:
        M.prefill(model, {"tokens": tokens})
    assert r["cost"]["flops_per_device"] == cost.flops > 0


def test_the_cli_runs_the_production_mesh(tmp_path):
    dryrun.main(["--fl-round", "--out", str(tmp_path)])
    fl = json.loads((tmp_path / "mafl-adaboost-f__fl_round__single.json").read_text())
    assert FL_FIELDS <= set(fl) and fl["n_devices"] == 256 and fl["collaborators"] == 16
    assert fl["collectives"]["ops"]["all-reduce"] == 2 and fl["roofline"]["bottleneck"]
    dryrun.main(["--arch", "grok-1-314b", "--shape", "train_4k", "--out", str(tmp_path)])
    r = json.loads((tmp_path / "grok-1-314b__train_4k__single.json").read_text())
    assert "error" not in r, r.get("error")
    assert JAX_FIELDS <= set(r) and r["n_devices"] == 256 and r["cost_extrapolated"]
    assert 3.1e11 < r["params_total"] < 3.2e11
    assert r["roofline"]["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    dryrun.main(["--arch", "gemma-2b", "--shape", "long_500k", "--out", str(tmp_path)])
    skipped = json.loads((tmp_path / "gemma-2b__long_500k__single.json").read_text())
    assert "skipped" in skipped
    assert not torch.distributed.is_initialized()
