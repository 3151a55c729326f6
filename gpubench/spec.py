"""Find a cell's parts by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a data file of its own (``configs/<name>.json``,
``traffic/<name>.json``).  A configuration names its plain reference
(``refs/<name>.py``: the architecture's weights, inputs and forward pass),
a mix its generator (``generators/<name>.py``), and each metric is a
reader of its own (``metrics/<name>.py``).  A cell's correctness limits
are in ``limits/<cell>.json``.  Nothing here knows a name in advance, so a
later change adds a configuration, a mix, a metric or a cell as files
alone.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict[str, Any]  # the configuration file, as run
    traffic: Dict[str, Any]  # the traffic file
    limits: Dict[str, Any]  # the correctness limits
    end_to_end: List[Dict[str, Any]]  # the metrics of BENCHMARK.json this cell reports
    per_layer: List[Dict[str, Any]]


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: Dict[str, Any], cell: str, e2e_names: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` key
    lists; without the key, every cell (an end-to-end metric) or every cell
    that reports the end-to-end metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def _load_file(path: Path, tag: str) -> ModuleType:
    mod_name = "gpubench_" + tag + "_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``: its ``read(run)`` gives the metric's value, or
    None where the run holds nothing to read."""
    return _load_file(HERE / "metrics" / f"{name}.py", "metric")


def reference(name: str) -> ModuleType:
    """``refs/<name>.py``: a configuration's plain reference."""
    return _load_file(HERE / "refs" / f"{name}.py", "ref")


def generator(name: str) -> ModuleType:
    """``generators/<name>.py``: a traffic mix's generator (its ``Traffic``
    and ``window``)."""
    return _load_file(HERE / "generators" / f"{name}.py", "generator")


def sub_seed(seed: int, *tags: Any) -> int:
    """A 63-bit seed derived from ``seed`` and ``tags``: the same on every
    machine and in every process."""
    text = "/".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") & ((1 << 63) - 1)


def port_fields(config: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration's keys that ``repro_torch.configs.base.ArchConfig``
    takes (every other key documents the source, the cut and the check)."""
    import dataclasses

    from repro_torch.configs.base import ArchConfig

    names = {f.name for f in dataclasses.fields(ArchConfig)}
    return {k: v for k, v in config.items() if k in names}
