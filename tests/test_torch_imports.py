"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

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
    return top in ("jax", "jaxlib", "repro")


def test_port_imports_neither_jax_nor_the_jax_package():
    assert len(PORT_FILES) > 10
    bad = [
        f"{p.relative_to(REPO)}:{line}: import {mod}"
        for p in PORT_FILES
        for line, mod in _imported_modules(p)
        if _forbidden(mod)
    ]
    assert not bad, "\n".join(bad)


def test_forbidden_import_detector():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("repro.core.plan")
    assert not _forbidden("repro_torch.core.plan") and not _forbidden("torch")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")


def test_fl_run_defaults_to_cuda_and_raises_without_a_card():
    _no_card()
    from repro_torch.launch import fl_run

    with pytest.raises(RuntimeError, match="cuda"):
        fl_run.main(["--dataset", "vehicle", "--rounds", "1"])


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
