"""Ensemble serving on the card (answers to ``repro/serve/``: homogeneous
and heterogeneous ensembles, DistBoost.F committees included): a
federation's trained strong hypothesis taken to batched inference.

  * ``artifact``  — save/load a deployable single-file artifact (the
    JAX package's format, byte for byte; optionally quantized with the
    bf16/int8 per-leaf codecs and calibrated vote-exactness), plus the
    rolling checkpoint stream (``publish_artifact`` / ``latest_artifact``)
    a still-training federation hands to serving;
  * ``engine``    — fixed-shape micro-batching with one ``vote_argmax``
    kernel launch per batch, replayed from a CUDA graph on the card;
    ``EngineConfig(mesh=...)`` swaps in the
    batch-sharded predict of ``fl/sharded.make_batch_predict``, so one
    engine spans a mesh of ranks (one ``vote_argmax`` launch per rank a
    batch, over its slice);
  * ``scheduler`` — the async deadline dispatch loop: a partial batch
    runs on its own by its requests' deadlines, no ``flush()`` needed;
  * ``compile_cache`` — the process-wide predict programs, one per
    (structure, batch size), shared by engines of one structure;
  * ``cache``     — shard-resident incremental vote cache;
  * ``registry``  — the multi-tenant registry: one engine per subscribed
    checkpoint stream, hot-swapped or rebuilt on ``refresh()``.

Driver: ``launch/serve_fl.py``.
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
from repro_torch.serve.engine import EngineConfig, EngineStats, ServeEngine
from repro_torch.serve.registry import ModelRegistry
from repro_torch.serve.scheduler import DeadlineScheduler

__all__ = [
    "DeadlineScheduler",
    "EngineConfig",
    "EngineStats",
    "LoadedArtifact",
    "ModelRegistry",
    "ServeEngine",
    "ShardVoteCache",
    "ensemble_signature",
    "latest_artifact",
    "load_artifact",
    "publish_artifact",
    "save_artifact",
]
