"""Fixed-shape micro-batching inference engine (answers to
``repro/serve/engine.py``, local engine).

Serving traffic arrives as ragged row groups.  The engine packs incoming
rows into static ``[B, d]`` batches (padding the ragged tail) and runs
one ensemble predict per batch on the ensemble's device:

  * one ``member_prediction`` over the stacked ``[T, ...]`` slot params
    gives every member's vote, ``[T, B]`` (a DistBoost.F committee slot
    ``[T, C, ...]`` folds its C votes into the member's first).  A
    heterogeneous ensemble stacks its groups' ``[T, B]`` blocks into one
    ``[Σ_g T, B]`` (a group with no used member is skipped: its weights
    are all 0); a heterogeneous committee folds each member's seats
    across the groups first (``core/hetero.py``);
  * ``used = (arange(T) < count) * alpha`` weighs them (computed once per
    published ensemble, not per batch);
  * one ``ops.vote_argmax`` reduces them: the hand-written kernel on the
    card, its plain version on the CPU.

The copy of the answers to the host is the batch's one sync: the
response is then ready.

Three entry points:

  * ``predict(X)``        — synchronous: chunk, pad, run, unpad;
  * ``submit(X)/flush()`` — the inline micro-batching scheduler: rows
    queue until a full batch packs (or ``flush`` pads the remainder),
    results land in ``results`` keyed by the returned request ids;
  * ``scheduler(...)``    — the async deadline dispatch loop
    (``serve/scheduler.py``).

``update_ensemble`` swaps in a grown ensemble.  The swap is validated
against the live ensemble's full structural signature (nesting + every
leaf's shape/dtype): an ensemble of another learner or spec that merely
matches ``alpha``'s capacity must not be served.

``EngineConfig`` groups the serving knobs (batch size, committee, the
deadline scheduler's default ``t_max_s``, the mesh) so a caller such as
``serve/registry.py`` passes one object.  Given a mesh
(``launch/mesh.py``), every static batch goes through
``fl/sharded.make_batch_predict``: each rank of the mesh runs the engine
on the same traffic, scores its slice of the batch over the federation
axes and gathers the others' (admission requires the batch size to
divide over the shards, and a homogeneous ensemble).  There is no kernel
switch: ``ops`` dispatches on the tensors' device.

A batch runs a *program* from the process-wide ``serve/compile_cache``:
on the card a CUDA graph of the predict at that batch size, shared by
every engine of the same structure (``EngineStats.compiles`` counts the
programs this engine built, ``cache_hits`` those it found built); on the
CPU, and for a mesh engine, the eager predict.  ``EngineConfig(
cuda_graphs=False)`` serves each batch eagerly on the card instead (the
comparison that the graphs' votes and speed are held to).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import hetero, scoring
from repro_torch.core.boosting import used_weights
from repro_torch.core.hetero import HeterogeneousSpec
from repro_torch.kernels import ops
from repro_torch.learners.base import LearnerSpec, WeakLearner
from repro_torch.obs import metrics as obs_metrics, trace
from repro_torch.serve import compile_cache
from repro_torch.serve.artifact import ensemble_device, ensemble_signature

# Process-wide engine metric families: every engine reports into these in
# addition to its per-instance ``EngineStats``.
_M_REQUESTS = obs_metrics.counter(
    "mafl_engine_requests_total", "Rows admitted across all engines."
)
_M_BATCHES = obs_metrics.counter(
    "mafl_engine_batches_total", "Static batches dispatched across all engines."
)
_M_PADDED = obs_metrics.counter(
    "mafl_engine_padded_rows_total", "Padding rows dispatched across all engines."
)
_M_COMPILES = obs_metrics.counter(
    "mafl_engine_compiles_total", "Predict programs built (process-wide cache misses)."
)
_M_CACHE_HITS = obs_metrics.counter(
    "mafl_engine_cache_hits_total",
    "Predict programs borrowed warm from the process-wide compile cache.",
)
_M_BATCH_SECONDS = obs_metrics.histogram(
    "mafl_engine_batch_seconds", "Per-batch dispatch wall seconds (all engines)."
)
_M_REQ_LATENCY = obs_metrics.histogram(
    "mafl_engine_request_latency_seconds",
    "Per-request submit-to-result seconds (all engines).",
)


# -- predict programs (module-level: the process-wide cache shares them
# across engines, so nothing here may close over one) --------------------


def _predict(learner, spec, committee: bool, active, ensemble, used: torch.Tensor,
             Xb: torch.Tensor) -> torch.Tensor:
    """[B, d] rows -> [B] int32 classes: every member's vote (a mix's
    active groups stacked), one ``vote_argmax``."""
    if isinstance(spec, HeterogeneousSpec):
        preds = hetero.hetero_member_predictions(spec, ensemble, Xb, committee=committee,
                                                 active=active)
    else:
        preds = scoring.member_prediction(learner, spec, ensemble.params, Xb,
                                          committee=committee)  # [T, B]
    return ops.vote_argmax(preds, used, n_classes=spec.n_classes)


def _build_program(learner, spec, committee: bool, active, ensemble, used: torch.Tensor,
                   batch_size: int) -> Callable:
    """The program of one (structure, batch size): a CUDA graph on the
    card, the eager predict elsewhere."""
    predict = functools.partial(_predict, learner, spec, committee, active)
    if used.device.type != "cuda":
        return predict
    return compile_cache.GraphProgram(predict, ensemble, used, batch_size, spec.n_features)


def _build_mesh_program(mesh_predict: Callable) -> Callable:
    # the batch-sharded predict's gloo collectives run on host tensors,
    # which no graph holds: the program is the eager call
    return lambda ensemble, used, Xb: mesh_predict(ensemble.params, ensemble.alpha, ensemble.count, Xb)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving policy knobs, grouped so drivers can pass one object.

    ``t_max_s`` is the deadline scheduler's default: the longest a queued
    partial batch may wait before it is dispatched padded
    (``serve/scheduler.DeadlineScheduler``).  ``mesh`` selects the predict
    backend: None runs the local predict; a ``launch/mesh.Mesh`` shards
    every static batch over the mesh's federation axes
    (``fl/sharded.make_batch_predict``), every rank of the mesh serving
    the same traffic.  There is no kernel flag: the card always runs the
    kernel.  ``cuda_graphs`` (the default) serves the card's batches by
    replaying cached CUDA graphs; False runs them eagerly."""

    batch_size: int = 256
    committee: bool = False
    t_max_s: float = 0.005
    mesh: Any = None  # launch/mesh.Mesh | None
    cuda_graphs: bool = True


@dataclasses.dataclass
class EngineStats:
    requests: int = 0
    batches: int = 0
    padded_rows: int = 0
    # zero batches run by ``warmup``
    warmup_batches: int = 0
    # programs this engine built, and programs it found already built by
    # another engine (the per-tenant view of the process-wide cache)
    compiles: int = 0
    cache_hits: int = 0
    # batches (warm-ups included) served by replaying a CUDA graph; a
    # graph's first batch, which captures it, runs eagerly and is not one
    graph_replays: int = 0
    # fixed-memory log-spaced histograms: ``.count`` is the sample count,
    # ``.percentile(p)`` estimates quantiles within ~5% (obs/metrics.py)
    batch_seconds: obs_metrics.Histogram = dataclasses.field(
        default_factory=obs_metrics.Histogram
    )
    # per-request seconds from submit() to result availability
    request_latencies: obs_metrics.Histogram = dataclasses.field(
        default_factory=obs_metrics.Histogram
    )


class ServeEngine:
    def __init__(
        self,
        learner: WeakLearner | None,
        spec: LearnerSpec | HeterogeneousSpec,
        ensemble,
        *,
        batch_size: Optional[int] = None,
        committee: Optional[bool] = None,
        config: Optional[EngineConfig] = None,
    ):
        """Serve ``ensemble`` on the device its tensors lie on; ``committee``
        for a DistBoost.F ensemble.  Homogeneous: ``(learner, LearnerSpec,
        Ensemble)``; heterogeneous: ``(None, HeterogeneousSpec, the group
        tuple)``.  The knobs come either as keywords or inside ``config``,
        never both."""
        if config is None:
            config = EngineConfig(
                batch_size=256 if batch_size is None else int(batch_size),
                committee=bool(committee),
            )
        elif batch_size is not None or committee is not None:
            # silently preferring one source over the other would serve
            # under knobs the caller never asked for
            raise ValueError("pass batch_size/committee inside the EngineConfig, not alongside it")
        batch_size, committee = config.batch_size, config.committee
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.config = config
        self.hetero = isinstance(spec, HeterogeneousSpec)
        if self.hetero:
            if learner is not None:
                raise ValueError("heterogeneous engines resolve per-group learners from the "
                                 "HeterogeneousSpec; pass learner=None")
            if config.mesh is not None:
                raise ValueError("mesh-backed serving is homogeneous-only: the batch-sharded "
                                 "predict runs one program per shard (fl/sharded.py)")
            hetero.resolve(spec)  # fail fast on unknown registry keys
        self._mesh_predict = None
        if config.mesh is not None:
            from repro_torch.fl.sharded import fl_shards, make_batch_predict
            from repro_torch.launch.mesh import Mesh

            if not isinstance(config.mesh, Mesh):
                raise TypeError(f"EngineConfig(mesh=...) takes a launch/mesh.Mesh, got "
                                f"{type(config.mesh).__name__}")
            # multi-shard admission: every dispatched batch is the full
            # static [B, d] (pack pads), and B must split evenly over the
            # mesh's federation axes
            shards = fl_shards(config.mesh)
            if batch_size % shards:
                raise ValueError(f"batch_size {batch_size} does not divide over the "
                                 f"{shards} federation shards of the mesh")
            self._mesh_predict = make_batch_predict(learner, spec, config.mesh,
                                                    committee=committee)
        self.learner = learner
        self.spec = spec
        self.committee = committee
        self.batch_size = int(batch_size)
        self.device = ensemble_device(ensemble)
        # engine-local view of the process-wide cache, keyed by (B, active
        # mask) for lock-free steady-state lookups
        self._programs: Dict[tuple, Callable] = {}
        # ONE publication point for everything a hot swap changes: readers
        # snapshot (ensemble, used weights, active groups) with a single
        # attribute load, so a concurrent update_ensemble is never seen
        # half-applied
        self._live = self._publication(ensemble)
        self.stats = EngineStats()
        # (id, row, t_submit); deque so batch draining is O(B), not a slice-copy
        self._queue: Deque[tuple[int, np.ndarray, float]] = collections.deque()
        self._next_id = 0
        # id -> predicted class; consume with ``take``
        self.results: Dict[int, int] = {}

    @classmethod
    def from_artifact(
        cls,
        art,  # artifact.LoadedArtifact
        *,
        batch_size: Optional[int] = None,
        config: Optional[EngineConfig] = None,
    ) -> "ServeEngine":
        """An engine for a loaded artifact, on the device it was loaded to
        (the artifact says whether it is a committee)."""
        if config is not None:
            if batch_size is not None:
                raise ValueError("pass batch_size inside the EngineConfig, not alongside it")
            if config.committee != art.committee:
                raise ValueError(
                    f"config.committee={config.committee} contradicts the "
                    f"artifact (committee={art.committee})"
                )
            return cls(art.learner, art.spec, art.ensemble, config=config)
        return cls(art.learner, art.spec, art.ensemble, batch_size=batch_size,
                   committee=art.committee)

    @property
    def ensemble(self):
        return self._live[0]

    def _publication(self, ensemble) -> tuple:
        """(ensemble, the members' weights, the active-group mask): what a
        batch reads, computed once per published ensemble."""
        if not self.hetero:
            return ensemble, used_weights(ensemble), None
        active = hetero.active_groups(ensemble, committee=self.committee)
        used = hetero.hetero_used_weights(ensemble, committee=self.committee, active=active)
        return ensemble, used, active

    def _active_key(self, ensemble, active) -> Optional[tuple]:
        """The active-group mask as the cache keys it: a plain mix's mask,
        all groups when none holds a member (the predict then stacks every
        group); None for committees and homogeneous ensembles."""
        if not self.hetero or self.committee:
            return None
        return active if active is not None else (True,) * len(ensemble)

    def _program(self, B: int, live: tuple) -> Callable:
        """The ``(ensemble, used, Xb) -> [B] int32`` program for one batch
        size and active mask, from the process-wide ``compile_cache``: a
        structurally identical engine elsewhere in the process makes this a
        hit."""
        ensemble, used, active = live
        akey = self._active_key(ensemble, active)
        local_key = (B, akey)
        fn = self._programs.get(local_key)
        if fn is not None:
            return fn
        if not self.config.cuda_graphs and self.device.type == "cuda" and self._mesh_predict is None:
            fn = functools.partial(_predict, self.learner, self.spec, self.committee, active)
            self._programs[local_key] = fn
            return fn
        key = compile_cache.program_key(
            self.spec, ensemble_signature(ensemble), batch_size=B, committee=self.committee,
            device=self.device, mesh=self.config.mesh, active_mask=akey)
        if self._mesh_predict is not None:
            build = functools.partial(_build_mesh_program, self._mesh_predict)
        else:
            build = functools.partial(_build_program, self.learner, self.spec, self.committee,
                                      active, ensemble, used, B)
        with trace.span("serve.compile", batch_size=B) as sp:
            fn, hit = compile_cache.get_or_build(key, build)
            sp.set(cache_hit=hit)
        if hit:
            self.stats.cache_hits += 1
            _M_CACHE_HITS.inc()
        else:
            self.stats.compiles += 1
            _M_COMPILES.inc()
        self._programs[local_key] = fn
        return fn

    def _predict(self, ensemble, used: torch.Tensor, active, Xb: torch.Tensor) -> torch.Tensor:
        """[B, d] rows -> [B] int32 classes, on the device."""
        program = self._program(Xb.shape[0], (ensemble, used, active))
        if isinstance(program, compile_cache.GraphProgram):
            out, replayed = program.run(ensemble, used, Xb)
            self.stats.graph_replays += replayed
            return out
        return program(ensemble, used, Xb)

    def warmup(self) -> None:
        """Run one batch of zeros at the steady-state shape, so the
        program's build (a graph capture, the kernel library's load at
        first use) and the device's first launches are paid before traffic
        arrives."""
        X = torch.zeros(self.batch_size, self.spec.n_features, device=self.device)
        self._predict(*self._live, X).cpu()
        self.stats.warmup_batches += 1

    def _run_batch(self, Xb: torch.Tensor, n_valid: int) -> np.ndarray:
        """One static [B, d] batch; returns the n_valid un-padded answers."""
        B = Xb.shape[0]
        t0 = time.perf_counter()
        # one snapshot: the weights and their used mask always come from
        # the same hot-swap publication
        live = self._live
        with trace.span("serve.batch", batch_size=B, n_valid=n_valid):
            out = self._predict(*live, Xb).cpu().numpy()  # device sync = response ready
        dt = time.perf_counter() - t0
        self.stats.batch_seconds.observe(dt)
        _M_BATCH_SECONDS.observe(dt)
        self.stats.batches += 1
        _M_BATCHES.inc()
        self.stats.padded_rows += B - n_valid
        _M_PADDED.inc(B - n_valid)
        return out[:n_valid]

    def _pack(self, rows: np.ndarray) -> torch.Tensor:
        n = rows.shape[0]
        if n < self.batch_size:  # pad the ragged tail to the static shape
            pad = np.zeros((self.batch_size - n, rows.shape[1]), rows.dtype)
            rows = np.concatenate([rows, pad], axis=0)
        return torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(self.device)

    # -- synchronous path ---------------------------------------------------
    def predict(self, X) -> np.ndarray:
        """Serve a whole [m, d] matrix through static batches."""
        X = np.asarray(X, np.float32)
        self.stats.requests += X.shape[0]
        _M_REQUESTS.inc(X.shape[0])
        out = [
            self._run_batch(
                self._pack(X[i : i + self.batch_size]),
                min(self.batch_size, X.shape[0] - i),
            )
            for i in range(0, X.shape[0], self.batch_size)
        ]
        return np.concatenate(out) if out else np.zeros((0,), np.int32)

    # -- micro-batching scheduler ------------------------------------------
    def submit(self, X) -> List[int]:
        """Queue rows; full batches run immediately.  Returns request ids
        (answers appear in ``self.results``; ``flush`` forces the tail)."""
        X = np.atleast_2d(np.asarray(X, np.float32))
        now = time.perf_counter()
        ids = []
        for row in X:
            self._queue.append((self._next_id, row, now))
            ids.append(self._next_id)
            self._next_id += 1
        self.stats.requests += len(ids)
        _M_REQUESTS.inc(len(ids))
        while len(self._queue) >= self.batch_size:
            self._dispatch([self._queue.popleft() for _ in range(self.batch_size)])
        return ids

    def flush(self) -> None:
        """Run the pending partial batch, padded to the static shape."""
        if self._queue:
            self._dispatch(list(self._queue))
            self._queue.clear()

    def take(self, rid: int) -> int:
        """Pop one answered request — the memory-bounded way to read results."""
        return self.results.pop(rid)

    def _dispatch(self, entries) -> None:
        rows = np.stack([r for _, r, _ in entries])
        preds = self._run_batch(self._pack(rows), len(entries))
        done = time.perf_counter()
        answers = preds.tolist()  # one bulk int conversion, outside the loop
        for (rid, _, t_submit), p in zip(entries, answers):
            self.results[rid] = p
            self.stats.request_latencies.observe(done - t_submit)
            _M_REQ_LATENCY.observe(done - t_submit)

    # -- async deadline dispatch --------------------------------------------
    def scheduler(self, *, t_max_s: Optional[float] = None):
        """Start a ``serve/scheduler.DeadlineScheduler`` over this engine:
        full batches dispatch immediately, a partial batch dispatches on
        its own once the earliest queued deadline (default
        ``config.t_max_s``) arrives — no ``flush`` call needed."""
        from repro_torch.serve.scheduler import DeadlineScheduler

        return DeadlineScheduler(self, t_max_s=t_max_s)

    # -- live ensemble swap -------------------------------------------------
    def update_ensemble(self, ensemble) -> None:
        """Swap in a grown ensemble of the same structure, on the engine's
        device.  Capacity alone is NOT identity: the full structural
        signature (the same check ``save_artifact`` applies against its
        manifest template) must match the live ensemble."""
        with trace.span("serve.hot_swap"):
            got, want = ensemble_signature(ensemble), ensemble_signature(self.ensemble)
            if got != want:
                raise ValueError(
                    "ensemble does not match the serving ensemble's structure "
                    f"(nesting + leaf shapes/dtypes): {got} != {want}; "
                    "build a new engine for a different learner/spec/capacity"
                )
            if ensemble_device(ensemble) != self.device:
                raise ValueError(
                    f"ensemble is on {ensemble_device(ensemble)}, the engine serves on {self.device}"
                )
            # single attribute store = atomic publication under the GIL
            self._live = self._publication(ensemble)
