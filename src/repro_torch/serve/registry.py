"""Multi-tenant model registry — one serving frontend, many federations
(answers to ``repro/serve/registry.py``).

Each TENANT is a named subscription to a ``publish_artifact`` checkpoint
stream (a publish directory with a ``LATEST`` pointer), backed by its own
``ServeEngine`` on the registry's device.

  * **Hot swap.**  ``refresh()`` polls each tenant's ``LATEST`` pointer
    (``latest_artifact`` retries a torn read once and raises on a
    corrupt one) and, when a new ``publish_version`` appears, swaps the
    grown ensemble into the live engine through ``update_ensemble``: the
    engine's single ``_live`` publication, so a concurrent batch sees the
    old ensemble or the new one.  A checkpoint whose STRUCTURE changed (a
    new learner, capacity or committee shape: an elastic run's late-merge
    budget grows the capacity) fails that check, and the registry
    rebuilds the tenant's engine instead, counted apart.
  * **Quantized artifacts.**  A ``quantize="int8"`` stream changes
    nothing here: dequantized leaves keep their float32 shapes, so the
    structural signature, and with it the hot swap, is unchanged.

  * **Shared programs.**  Tenants of one structure share their predict
    programs through the process-wide ``serve/compile_cache`` (a CUDA
    graph per batch size on the card): ``stats()`` reports each tenant's
    ``compiles`` and ``cache_hits`` and the cache's own counters.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics, trace
from repro_torch.serve import compile_cache
from repro_torch.serve.artifact import latest_artifact, load_artifact
from repro_torch.serve.engine import EngineConfig, ServeEngine

# Process-wide registry metric families; ``stats()`` keeps its per-tenant
# dict shape as a view over the same events.
_M_SWAPS = obs_metrics.counter(
    "mafl_registry_swaps_total", "Compile-free hot swaps across all tenants."
)
_M_REBUILDS = obs_metrics.counter(
    "mafl_registry_rebuilds_total",
    "Engine rebuilds forced by structural checkpoint changes.",
)
_M_TENANTS = obs_metrics.gauge(
    "mafl_registry_tenants", "Tenants currently registered."
)


@dataclasses.dataclass
class Tenant:
    name: str
    publish_dir: Path
    engine: ServeEngine
    version: Optional[int]  # manifest publish_version (None: unversioned)
    path: Path  # artifact file currently served
    config: Optional[EngineConfig] = None  # tenant override (None: registry default)
    swaps: int = 0  # update_ensemble refreshes
    rebuilds: int = 0  # structural changes that needed a new engine


def _artifact_version(manifest: dict) -> Optional[int]:
    v = manifest.get("publish_version")
    return int(v) if v is not None else None


class ModelRegistry:
    def __init__(self, *, config: Optional[EngineConfig] = None,
                 device: str | torch.device = "cuda"):
        """``config`` is the default engine policy for tenants that do not
        bring their own (batch size, deadline); its ``committee`` field is
        per artifact and always overridden.  Every tenant's artifacts load
        to ``device`` (the card by default; raises without one unless
        ``"cpu"`` is asked for)."""
        self._default = config or EngineConfig()
        self.device = resolve_device(device)
        self._tenants: Dict[str, Tenant] = {}

    # -- tenant lifecycle ---------------------------------------------------
    def add_tenant(self, name: str, publish_dir: str | Path, *,
                   config: Optional[EngineConfig] = None) -> ServeEngine:
        """Subscribe ``name`` to a checkpoint stream and bring up its engine
        from the stream's current ``LATEST``.  Returns the live engine
        (borrow only: the registry owns the swap lifecycle)."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        publish_dir = Path(publish_dir)
        path = latest_artifact(publish_dir)
        if path is None:
            raise ValueError(f"tenant {name!r}: nothing published in {publish_dir}")
        art = load_artifact(path, self.device)
        engine = ServeEngine.from_artifact(art, config=self._tenant_config(config, art))
        self._tenants[name] = Tenant(name=name, publish_dir=publish_dir, engine=engine,
                                     version=_artifact_version(art.manifest), path=path,
                                     config=config)
        _M_TENANTS.set(len(self._tenants))
        return engine

    def remove_tenant(self, name: str) -> None:
        del self._tenants[self._require(name).name]
        _M_TENANTS.set(len(self._tenants))

    def _require(self, name: str) -> Tenant:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(f"unknown tenant {name!r}; registered: {sorted(self._tenants)}") from None

    def _tenant_config(self, config: Optional[EngineConfig], art) -> EngineConfig:
        return dataclasses.replace(config or self._default, committee=art.committee)

    def tenants(self) -> List[str]:
        return sorted(self._tenants)

    def engine(self, name: str) -> ServeEngine:
        return self._require(name).engine

    # -- the fleet data plane ----------------------------------------------
    def predict(self, name: str, X) -> np.ndarray:
        return self._require(name).engine.predict(X)

    # -- checkpoint hot-swap ------------------------------------------------
    def refresh(self, name: Optional[str] = None) -> Dict[str, Optional[int]]:
        """Poll ``LATEST`` for one tenant (or all) and swap in any new
        checkpoint.  Returns ``{tenant: publish_version}`` for the tenants
        that changed.  Same-structure checkpoints hot-swap; structural
        changes rebuild the engine."""
        names = [self._require(name).name] if name is not None else self.tenants()
        changed: Dict[str, Optional[int]] = {}
        for n in names:
            t = self._tenants[n]
            with trace.span("registry.refresh", tenant=n) as sp:
                path = latest_artifact(t.publish_dir)
                if path is None or path == t.path:
                    continue
                art = load_artifact(path, self.device)
                version = _artifact_version(art.manifest)
                if version is not None and version == t.version:
                    continue
                try:
                    with trace.span("registry.swap", tenant=n, version=version):
                        t.engine.update_ensemble(art.ensemble)
                    t.swaps += 1
                    _M_SWAPS.inc()
                    sp.set(outcome="swap")
                except ValueError:
                    # the structure changed under this tenant: the live engine
                    # cannot take it, so build a new one
                    with trace.span("registry.rebuild", tenant=n, version=version):
                        t.engine = ServeEngine.from_artifact(
                            art, config=self._tenant_config(t.config, art))
                    t.rebuilds += 1
                    _M_REBUILDS.inc()
                    sp.set(outcome="rebuild")
                t.version, t.path = version, path
                changed[n] = version
        return changed

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        """Per-tenant serving counters plus the process compile cache:
        the version and artifact served, swaps, rebuilds, requests,
        batches, programs built and borrowed warm (the live engine's)."""
        tenants = {
            n: {
                "version": t.version,
                "artifact": str(t.path),
                "swaps": t.swaps,
                "rebuilds": t.rebuilds,
                "requests": t.engine.stats.requests,
                "batches": t.engine.stats.batches,
                "compiles": t.engine.stats.compiles,
                "cache_hits": t.engine.stats.cache_hits,
            }
            for n, t in self._tenants.items()
        }
        return {"tenants": tenants, "compile_cache": compile_cache.cache_stats()}
