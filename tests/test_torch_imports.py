"""The port stands alone: it imports neither JAX nor the JAX package (nor
``ml_dtypes``, which the machine with the card lacks), and its entry
points run on the card unless the caller asks for the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


def test_port_imports_neither_jax_nor_the_jax_package_nor_ml_dtypes():
    assert len(PORT_FILES) > 10
    walked = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for mod in ("fl/distributed.py", "fl/elastic_dist.py", "fl/sharded.py", "launch/fl_spawn.py",
                "checkpoint.py", "optim/optimizers.py", "data/pipeline.py", "launch/train.py",
                "launch/mesh.py", "models/moe.py", "configs/grok_1_314b.py",
                "configs/llama4_scout_17b_a16e.py", "models/ssm.py", "configs/xlstm_1_3b.py"):
        assert f"src/repro_torch/{mod}" in walked, mod
    bad = [
        f"{p.relative_to(REPO)}:{line}: import {mod}"
        for p in PORT_FILES
        for line, mod in _imported_modules(p)
        if _forbidden(mod)
    ]
    assert not bad, "\n".join(bad)


def test_forbidden_import_detector():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("repro.core.plan")
    assert _forbidden("ml_dtypes") and _forbidden("repro.core.serialization")
    assert not _forbidden("repro_torch.core.plan") and not _forbidden("torch")
    assert not _forbidden("repro_torch.core.serialization") and not _forbidden("numpy")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")


def test_fl_run_defaults_to_cuda_and_raises_without_a_card():
    _no_card()
    from repro_torch.launch import fl_run

    with pytest.raises(RuntimeError, match="cuda"):
        fl_run.main(["--dataset", "vehicle", "--rounds", "1"])


@pytest.mark.parametrize("argv", [["--algorithm", "distboost_f"], ["--algorithm", "preweak_f"],
                                  ["--algorithm", "bagging"], ["--learner", "extra_tree"],
                                  ["--learner", "ridge"], ["--learner", "gaussian_nb"],
                                  ["--learner", "nearest_centroid"], ["--learner", "mlp"],
                                  ["--split", "dirichlet"],
                                  ["--learners", "decision_tree,ridge,gaussian_nb"],
                                  ["--learners", "decision_tree,ridge", "--algorithm", "preweak_f"],
                                  ["--faithful"], ["--faithful", "--algorithm", "preweak_f"],
                                  ["--algorithm", "fedavg", "--learner", "mlp"],
                                  ["--elastic"],
                                  ["--elastic", "--deadline-ms", "100", "--fault-drop-p", "0.2",
                                   "--fault-kill", "1:1"],
                                  ["--elastic", "--elastic-realtime", "--deadline-ms", "20"],
                                  ["--distributed", "--collaborators", "1"],
                                  ["--distributed", "--no-packed-broadcast", "--collaborators", "1",
                                   "--algorithm", "preweak_f"],
                                  ["--distributed", "--elastic", "--collaborators", "1"],
                                  ["--sharded", "--collaborators", "1"],
                                  ["--sharded", "--no-packed-broadcast", "--collaborators", "1"]])
def test_fl_run_new_paths_default_to_cuda_and_raise_without_a_card(argv):
    _no_card()
    from repro_torch.launch import fl_run

    with pytest.raises(RuntimeError, match="cuda"):
        fl_run.main(["--dataset", "vehicle", "--rounds", "1", *argv])


def test_federation_defaults_to_cuda_and_raises_without_a_card():
    _no_card()
    from repro_torch.core.plan import adaboost_plan
    from repro_torch.fl.federation import Federation
    from repro_torch.learners import LearnerSpec

    X = torch.zeros(2, 4, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        Federation(adaboost_plan(rounds=1), X, torch.zeros(2, 4, dtype=torch.int32),
                   torch.ones(2, 4), X[0], torch.zeros(4, dtype=torch.int32),
                   LearnerSpec("decision_tree", 3, 2))


def test_elastic_federation_and_registry_default_to_cuda_and_raise_without_a_card():
    _no_card()
    from repro_torch.core.plan import adaboost_plan
    from repro_torch.fl.elastic import ElasticFederation, ParticipationPolicy
    from repro_torch.learners import LearnerSpec
    from repro_torch.serve import ModelRegistry

    X = torch.zeros(2, 4, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        ElasticFederation(adaboost_plan(rounds=1), X, torch.zeros(2, 4, dtype=torch.int32),
                          torch.ones(2, 4), X[0], torch.zeros(4, dtype=torch.int32),
                          LearnerSpec("decision_tree", 3, 2), policy=ParticipationPolicy())
    with pytest.raises(RuntimeError, match="cuda"):
        ModelRegistry()
    assert ModelRegistry(device="cpu").device.type == "cpu"


def test_multiprocess_runtime_defaults_to_cuda_and_raises_without_a_card():
    """``DistributedFederation`` and an elastic shard land on the card unless
    the caller asks for the CPU."""
    _no_card()
    from repro_torch.core.plan import adaboost_plan
    from repro_torch.fl.distributed import DistributedFederation
    from repro_torch.fl.elastic_dist import _Shard
    from repro_torch.learners import LearnerSpec

    X, y, m = torch.zeros(1, 4, 3), torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, 4)
    spec = LearnerSpec("decision_tree", 3, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        DistributedFederation(adaboost_plan(rounds=1), X, y, m, X[0], y[0], spec)
    assert DistributedFederation(adaboost_plan(rounds=1), X, y, m, X[0], y[0], spec,
                                 device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        _Shard(0, spec, X, y, m)


def test_fl_spawn_passes_the_default_device_through_and_fails_without_a_card():
    """``fl_spawn`` adds no ``--device``: its processes take fl_run's default,
    the card, and without one every process exits non-zero."""
    _no_card()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in [str(REPO / "src"), os.environ.get("PYTHONPATH", "")] if p))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.fl_spawn", "-n", "1",
                           "--timeout", "90", "--", "--dataset", "vehicle", "--rounds", "1"],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stdout + proc.stderr
    assert "final F1" not in proc.stdout


def test_serve_fl_defaults_to_cuda_and_raises_without_a_card():
    _no_card()
    from repro_torch.launch import serve_fl

    with pytest.raises(RuntimeError, match="cuda"):
        serve_fl.main(["--dataset", "vehicle", "--rounds", "1"])


@pytest.mark.parametrize("argv", [["--learner", "ridge"], ["--learners", "decision_tree,ridge"]])
def test_serve_fl_new_flags_default_to_cuda_and_raise_without_a_card(argv):
    _no_card()
    from repro_torch.launch import serve_fl

    with pytest.raises(RuntimeError, match="cuda"):
        serve_fl.main(["--dataset", "vehicle", "--rounds", "1", *argv])


def test_heterogeneous_federation_and_artifact_default_to_cuda(tmp_path):
    """A heterogeneous Federation and a v2 artifact land on the card unless
    the caller asks for the CPU."""
    _no_card()
    from repro_torch.core import hetero
    from repro_torch.core.plan import adaboost_plan
    from repro_torch.fl.federation import Federation
    from repro_torch.serve import load_artifact, save_artifact

    hs = hetero.HeterogeneousSpec.cycle(["ridge", "gaussian_nb"], 2, 3, 2)
    X = torch.zeros(2, 4, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        Federation(adaboost_plan(rounds=1), X, torch.zeros(2, 4, dtype=torch.int32),
                   torch.ones(2, 4), X[0], torch.zeros(4, dtype=torch.int32), hs)
    path = save_artifact(tmp_path / "h.mafl", hs, hetero.init_hetero_ensemble(hs, 2, "cpu"))
    assert load_artifact(path, "cpu").ensemble[0].alpha.device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        load_artifact(path)


def test_load_artifact_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    _no_card()
    from repro_torch.core import boosting
    from repro_torch.learners import LearnerSpec, get_learner
    from repro_torch.serve import load_artifact, save_artifact

    spec = LearnerSpec("decision_tree", 3, 2, {"depth": 2, "n_bins": 16})
    path = save_artifact(tmp_path / "a.mafl", spec,
                         boosting.init_ensemble(get_learner("decision_tree"), spec, 2, "cpu"))
    assert load_artifact(path, "cpu").ensemble.alpha.device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        load_artifact(path)


def _numpy_ensemble():
    import numpy as np

    return {"feature": np.zeros((2, 2), np.int32), "threshold": np.zeros((2, 2), np.float32),
            "leaf_logits": np.zeros((2, 4, 3), np.float32), "alpha": np.ones(2, np.float32),
            "count": np.asarray(2, np.int32)}


def _numpy_boost_state():
    import numpy as np

    return {**_numpy_ensemble(), "weights": np.ones((2, 5), np.float32),
            "edges": np.zeros((2, 3, 15), np.float32), "bin_idx": np.zeros((2, 5, 3), np.int32)}


def _numpy_model(cfg):
    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, torch.Generator().manual_seed(0))
    flat = {name: p.detach().numpy() for name, p in model.named_parameters()}
    unit = {}
    for name, a in flat.items():
        if name.startswith("layers.0."):
            key = name[len("layers.0."):].replace(".gamma", "").split(".")
            stacked = torch.stack([torch.from_numpy(flat[f"layers.{r}.{name[len('layers.0.'):]}"])
                                   for r in range(cfg.n_layers)]).numpy()
            node = unit
            for part in key[:-1]:
                node = node.setdefault(part, {})
            node[key[-1]] = stacked
    embed = {k.split(".")[1]: v for k, v in flat.items() if k.startswith("embed.")}
    return {"embed": embed, "final_norm": flat["final_norm.gamma"], "unit": {"L0": unit}}


def _numpy_params(name):
    import numpy as np

    return {
        "ridge": {"W": np.zeros((4, 3), np.float32)},
        "gaussian_nb": {"log_prior": np.zeros(3, np.float32), "mean": np.zeros((3, 3), np.float32),
                        "var": np.ones((3, 3), np.float32)},
        "nearest_centroid": {"centroid": np.zeros((3, 3), np.float32),
                             "log_prior": np.zeros(3, np.float32)},
        "mlp": {"W1": np.zeros((3, 5), np.float32), "b1": np.zeros(5, np.float32),
                "W2": np.zeros((5, 3), np.float32), "b2": np.zeros(3, np.float32)},
    }[name]


@pytest.mark.parametrize("name", ["tree_params_from_numpy", "ensemble_from_numpy",
                                  "boost_state_from_numpy", "model_params_from_numpy",
                                  "params_from_numpy:ridge", "params_from_numpy:gaussian_nb",
                                  "params_from_numpy:nearest_centroid", "params_from_numpy:mlp",
                                  "hetero_ensemble_from_numpy"])
def test_convert_defaults_to_cuda_and_raises_without_a_card(name):
    """The carry-over functions place state on the card unless the caller
    asks for the CPU, as every other entry point of the port does."""
    _no_card()
    from repro_torch import convert
    from repro_torch.configs import get_arch

    if name == "model_params_from_numpy":
        cfg = get_arch("gemma-2b").reduced()
        args = (cfg, _numpy_model(cfg))
    elif name.startswith("params_from_numpy:"):
        name, learner = name.split(":")
        args = (learner, _numpy_params(learner))
    elif name == "hetero_ensemble_from_numpy":
        import numpy as np

        ridge = {**_numpy_params("ridge"), "alpha": np.ones(1, np.float32),
                 "count": np.asarray(1, np.int32)}
        args = ([_numpy_ensemble(), ridge], ["decision_tree", "ridge"])
    else:
        args = (_numpy_boost_state(),)
    fn = getattr(convert, name)
    with pytest.raises(RuntimeError, match=r"'cuda' requested.*pass device='cpu'"):
        fn(*args)
    out = fn(*args, device="cpu")
    tensors = [p for p in out.parameters()] if name == "model_params_from_numpy" else \
        [t for t in torch.utils._pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_fl_run_cpu_rehearsal_runs():
    from repro_torch.launch import fl_run

    hist = fl_run.main(["--dataset", "vehicle", "--collaborators", "4", "--rounds", "3",
                        "--eval-every", "3", "--device", "cpu"])
    assert [h["round"] for h in hist] == [2] and 0.0 <= hist[-1]["f1"] <= 1.0


def _run_chip_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    _no_card()
    proc = _run_chip_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_llm_serve_defaults_to_cuda_and_raises_without_a_card():
    _no_card()
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--tokens", "1"])


@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-scout-17b-a16e"])
def test_moe_serve_and_train_default_to_cuda_and_raise_without_a_card(arch):
    """``serve`` and ``train --arch`` of the MoE architectures (with a depth
    cut, and at full width) land on the card unless asked for the CPU."""
    _no_card()
    from repro_torch.launch import serve, train

    for argv in (["--tokens", "1"], ["--tokens", "1", "--full", "--layers", "1"]):
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--arch", arch, *argv])
    for argv in (["--steps", "1"], ["--steps", "1", "--full", "--layers", "1"]):
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", arch, *argv])


@pytest.mark.parametrize("path", ["src/repro_torch/models/ssm.py", "src/repro_torch/configs/xlstm_1_3b.py"])
def test_recurrent_modules_import_neither_jax_nor_the_jax_package(path):
    mods = [mod for _, mod in _imported_modules(REPO / path)]
    assert "torch" in mods or "repro_torch.configs.base" in mods
    assert not [mod for mod in mods if _forbidden(mod)], mods


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_xlstm_serve_and_train_default_to_cuda_and_raise_without_a_card(entry):
    """``--arch xlstm-1.3b``, reduced and at full width (all 48 layers, or
    a depth cut), lands on the card unless asked for the CPU."""
    _no_card()
    from repro_torch.launch import serve, train

    main, first = (serve.main, ["--tokens", "1"]) if entry == "serve" else (train.main, ["--steps", "1"])
    for argv in ([], ["--full"], ["--full", "--layers", "8"]):
        with pytest.raises(RuntimeError, match=r"'cuda' requested.*pass device='cpu'"):
            main(["--arch", "xlstm-1.3b", *first, *argv])


def test_xlstm_serve_and_train_run_the_reduced_config_on_the_cpu(capsys):
    from repro_torch.launch import serve, train

    out = serve.main(["--arch", "xlstm-1.3b", "--device", "cpu", "--batch", "2", "--prompt-len", "128",
                      "--tokens", "3"])
    assert out["arch"] == "xlstm-1.3b" and out["layers"] == 8 and out["logits_finite"]
    assert out["tokens"].shape == (2, 4) and out["tokens"].device.type == "cpu"
    # a 6-step run inside the launcher's 20-step warm-up: lr 1e-2 lets its
    # own check (the loss fell) see a fall
    losses = train.main(["--arch", "xlstm-1.3b", "--device", "cpu", "--steps", "6", "--seq", "32",
                         "--batch", "2", "--log-every", "3", "--lr", "1e-2"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert "arch=xlstm-1.3b params=" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-scout-17b-a16e"])
def test_moe_serve_and_train_run_the_reduced_config_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve, train

    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "128",
                      "--tokens", "3", "--layers", "4"])
    assert out["arch"] == arch and out["layers"] == 4 and out["logits_finite"]
    assert out["tokens"].shape == (2, 4) and out["tokens"].device.type == "cpu"
    losses = train.main(["--arch", arch, "--device", "cpu", "--layers", "1", "--steps", "4",
                         "--seq", "32", "--batch", "2", "--log-every", "2"])
    assert len(losses) == 4 and all(np.isfinite(losses))
    printed = capsys.readouterr().out
    assert f"arch={arch} layers=4/" in printed and f"arch={arch} layers=1/" in printed
    assert "(depth cut)" in printed


def test_mesh_engine_registry_defaults_to_cuda_and_raises_without_a_card():
    _no_card()
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import EngineConfig, ModelRegistry

    with pytest.raises(RuntimeError, match="cuda"):
        ModelRegistry(config=EngineConfig(batch_size=8, mesh=make_host_mesh()))
    reg = ModelRegistry(config=EngineConfig(batch_size=8, mesh=make_host_mesh()), device="cpu")
    assert reg.device.type == "cpu"


def test_llm_serve_cpu_runs_the_reduced_config_end_to_end(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "24", "--tokens", "5"])
    assert out["arch"] == "gemma-2b" and out["logits_finite"]
    assert out["tokens"].shape == (2, 6) and out["tokens"].device.type == "cpu"
    assert int(out["tokens"].min()) >= 0 and int(out["tokens"].max()) < 2048  # reduced padded vocab
    assert "arch=gemma-2b prefill 2x24 in" in capsys.readouterr().out


def _train_entry(name):
    """(call with the default device, the same call asking for the CPU)."""
    import jax
    import numpy as np

    from repro.configs import get_arch as jax_get_arch
    from repro.models import model as JM
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.models import model as M

    cfg = get_arch("gemma-2b").reduced()
    stream = pipeline.TokenStreamConfig(512, 8, 2)
    if name == "launch.train":
        argv = ["--preset", "lm10m", "--steps", "2", "--seq", "16", "--log-every", "1"]
        return (lambda: train.main(argv)), (lambda: train.main(argv + ["--device", "cpu"]))
    if name == "token_batches":
        return (lambda: next(pipeline.token_batches(stream))["tokens"]), \
            (lambda: next(pipeline.token_batches(stream, device="cpu"))["tokens"])
    if name == "federated_token_batches":
        return (lambda: pipeline.federated_token_batches(stream, 2)), \
            (lambda: next(pipeline.federated_token_batches(stream, 2, device="cpu")[1])["tokens"])
    if name == "init_train_state":
        return (lambda: M.init_train_state(cfg, torch.Generator().manual_seed(0))), \
            (lambda: M.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu"))
    tree = jax.tree.map(np.asarray, JM.init_train_state(jax_get_arch("gemma-2b").reduced(),
                                                        jax.random.PRNGKey(0)))
    return (lambda: convert.train_state_from_numpy(cfg, tree.params, tree.opt)), \
        (lambda: convert.train_state_from_numpy(cfg, tree.params, tree.opt, device="cpu"))


@pytest.mark.parametrize("name", ["launch.train", "token_batches", "federated_token_batches",
                                  "init_train_state", "train_state_from_numpy"])
def test_lm_training_entry_points_default_to_cuda_and_raise_without_a_card(name):
    """The training driver, the token streams and the train state land on
    the card unless the caller asks for the CPU."""
    _no_card()
    default, on_cpu = _train_entry(name)
    with pytest.raises(RuntimeError, match=r"'cuda' requested.*pass device='cpu'"):
        default()
    out = on_cpu()
    tensors = [out] if isinstance(out, torch.Tensor) else \
        list(out.params.parameters()) + [out.opt.step] if hasattr(out, "opt") else []
    assert all(t.device.type == "cpu" for t in tensors)


def test_get_arch_of_an_unknown_architecture_raises():
    from repro_torch.configs import get_arch

    with pytest.raises(KeyError, match="gemma-2b"):
        get_arch("no-such-arch")


@pytest.mark.parametrize("path", ["src/repro_torch/models/attention.py", "src/repro_torch/models/transformer.py",
                                  "src/repro_torch/models/model.py", "src/repro_torch/convert.py",
                                  "src/repro_torch/launch/serve.py", "src/repro_torch/configs/base.py"])
def test_front_end_modules_import_neither_jax_nor_the_jax_package(path):
    mods = [mod for _, mod in _imported_modules(REPO / path)]
    assert mods and not [mod for mod in mods if _forbidden(mod)], mods


def _frontend_arch(name):
    import importlib.util

    from repro_torch.configs.base import ArchConfig

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return ArchConfig(**smoke.FRONTEND_ARCHS[name])


@pytest.mark.parametrize("name", ["whisper", "gemma2", "internvl2"])
def test_front_end_serving_and_training_default_to_cuda_and_raise_without_a_card(name, monkeypatch):
    """``launch.serve`` (its ``generate`` draws the prefix or frames on the
    card) and the train state of an audio, a post-norm and a VLM
    architecture land on the card unless the caller asks for the CPU."""
    _no_card()
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    full = _frontend_arch(name)
    monkeypatch.setattr(serve, "get_arch", lambda arch: full)
    for argv in (["--tokens", "1"], ["--tokens", "1", "--full", "--layers", "2"]):
        with pytest.raises(RuntimeError, match=r"'cuda' requested.*pass device='cpu'"):
            serve.main(["--arch", full.name, *argv])
    with pytest.raises(RuntimeError, match=r"'cuda' requested.*pass device='cpu'"):
        M.init_train_state(full.reduced(), torch.Generator().manual_seed(0))
    st = M.init_train_state(full.reduced(), torch.Generator().manual_seed(0), device="cpu")
    assert all(p.device.type == "cpu" for p in st.params.parameters())
