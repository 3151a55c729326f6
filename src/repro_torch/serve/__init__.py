"""Ensemble serving on the card (answers to ``repro/serve/``: homogeneous
and heterogeneous ensembles, DistBoost.F committees included): a
federation's trained strong hypothesis taken to batched inference.

  * ``artifact``  — save/load a deployable single-file artifact (the
    JAX package's format, byte for byte; optionally quantized with the
    bf16/int8 per-leaf codecs and calibrated vote-exactness), plus the
    rolling checkpoint stream (``publish_artifact`` / ``latest_artifact``)
    a still-training federation hands to serving;
  * ``engine``    — fixed-shape micro-batching with one ``vote_argmax``
    kernel launch per batch;
  * ``scheduler`` — the async deadline dispatch loop: a partial batch
    runs on its own after ``t_max_s``, no ``flush()`` needed;
  * ``cache``     — shard-resident incremental vote cache.

Driver: ``launch/serve_fl.py``.  Not ported yet: the compile cache, the
multi-tenant registry, the mesh engine (ROADMAP Queue 1).
"""
from repro_torch.serve.artifact import (
    LoadedArtifact,
    ensemble_signature,
    latest_artifact,
    load_artifact,
    publish_artifact,
    save_artifact,
)
from repro_torch.serve.cache import ShardVoteCache
from repro_torch.serve.engine import EngineStats, ServeEngine
from repro_torch.serve.scheduler import DeadlineScheduler

__all__ = [
    "DeadlineScheduler",
    "EngineStats",
    "LoadedArtifact",
    "ServeEngine",
    "ShardVoteCache",
    "ensemble_signature",
    "latest_artifact",
    "load_artifact",
    "publish_artifact",
    "save_artifact",
]
