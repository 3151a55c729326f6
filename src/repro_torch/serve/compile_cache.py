"""Process-wide predict-program cache: one program per serving structure
and batch size, shared by every engine in the process.  The port's
counterpart of ``repro/serve/compile_cache.py``.

A program is what a served batch runs: the member predictions and the
``vote_argmax`` launch of ``serve/engine.py``'s predict.  On the card it
is a CUDA graph of that predict at one batch size, captured once
(:class:`GraphProgram`); on the CPU it is the eager predict itself; a mesh
engine's predict runs gloo collectives on host tensors, which no graph
can hold, so its program is its eager predict too, keyed with the mesh.
The key is everything a program is built from:

  * the spec's structural identity (learner registry key, problem
    geometry, canonical hparams JSON; per group for a mix, plus the
    collaborator assignment),
  * the ensemble's full structural signature (nesting + every leaf's
    shape/dtype: ``artifact.ensemble_signature``, made hashable),
  * committee, batch size, the device (where the JAX key has
    ``use_pallas``: the device decides the kernel here),
  * the mesh's identity, and the heterogeneous active-group mask.

Nothing outside the key may change a program: the ensemble's values (its
parameters, alphas and count) are runtime arguments, copied into the
graph's static buffers at every call, so a hot swap or a second tenant of
the same structure needs no new graph.

``get_or_build`` returns the shared program and counts a hit; a miss
builds outside the lock: two racing builders of one key both build, the
last write wins, and the programs are interchangeable.  A graph program's
build only allocates its static buffers; its first call captures the
graph, as a jitted function compiles at its first call.
``cache_stats()`` reports the process's programs, hits and misses.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.hetero import HeterogeneousSpec
from repro_torch.kernels import ops
from repro_torch.learners.base import LearnerSpec
from repro_torch.obs import metrics as obs_metrics, trace

_LOCK = threading.Lock()
_CACHE: Dict[tuple, Callable] = {}

# the cache's counters ARE registry metrics; cache_stats() is a view
_M_HITS = obs_metrics.counter(
    "mafl_compile_cache_hits_total",
    "Program lookups served warm from the process-wide compile cache.",
)
_M_MISSES = obs_metrics.counter(
    "mafl_compile_cache_misses_total",
    "Program lookups that had to build a program.",
)
_M_PROGRAMS = obs_metrics.gauge(
    "mafl_compile_cache_programs", "Built programs resident in the cache."
)


def spec_identity(spec: LearnerSpec | HeterogeneousSpec) -> tuple:
    """Hashable structural identity of a serving spec.  Two specs with
    equal identities build identical member-predict programs."""
    if isinstance(spec, HeterogeneousSpec):
        return (
            "hetero",
            tuple(spec_identity(s) for s in spec.specs),
            tuple(spec.assignment),
        )
    return (
        spec.name,
        int(spec.n_features),
        int(spec.n_classes),
        json.dumps(dict(spec.hparams), sort_keys=True),
    )


def _hashable_signature(signature: tuple) -> tuple:
    structure, leaves = signature
    return (structure, tuple((tuple(s), str(d)) for s, d in leaves))


def program_key(
    spec: LearnerSpec | HeterogeneousSpec,
    signature: tuple,  # artifact.ensemble_signature(ensemble)
    *,
    batch_size: int,
    committee: bool,
    device: torch.device | str,
    mesh: Any = None,
    active_mask: Tuple[bool, ...] | None = None,
) -> tuple:
    """The full cache key for one serving program."""
    try:
        mesh_id = ("mesh", hash(mesh)) if mesh is not None else None
    except TypeError:  # an unhashable mesh still gets a stable identity
        mesh_id = ("mesh-id", id(mesh))
    return (
        spec_identity(spec),
        _hashable_signature(signature),
        int(batch_size),
        bool(committee),
        str(torch.device(device)),
        mesh_id,
        active_mask,
    )


def get_or_build(key: tuple, build: Callable[[], Callable]) -> Tuple[Callable, bool]:
    """Return ``(program, was_hit)``, building (and caching) on a miss.

    The build runs outside the lock; two racing builders of the same key
    both build but converge on one cached program (last write wins)."""
    with _LOCK:
        fn = _CACHE.get(key)
        if fn is not None:
            _M_HITS.inc()
            return fn, True
        _M_MISSES.inc()
    with trace.span("compile_cache.build"):
        fn = build()
    with _LOCK:
        _CACHE[key] = fn
        _M_PROGRAMS.set(len(_CACHE))
    return fn, False


def cache_stats() -> dict:
    """Process-wide counters: programs resident, hits, misses, hit rate —
    a dict view over the ``mafl_compile_cache_*`` registry metrics."""
    with _LOCK:
        hits, misses = int(_M_HITS.value), int(_M_MISSES.value)
        total = hits + misses
        return {
            "programs": len(_CACHE),
            "hits": hits,
            "misses": misses,
            "hit_rate": (hits / total) if total else 0.0,
        }


def clear_cache() -> None:
    """Drop every cached program and zero the counters (tests/benches)."""
    with _LOCK:
        _CACHE.clear()
        _M_HITS._reset()
        _M_MISSES._reset()
        _M_PROGRAMS.set(0)


def _tensor_leaves(tree: Any):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


class GraphProgram:
    """A CUDA graph of ``predict(ensemble, used, Xb)`` at one batch size.

    It owns static copies of a template ensemble, its ``used`` weights and
    a ``[B, d]`` batch.  Building it runs nothing.  Every call copies the
    caller's ensemble (every tensor leaf, in the template's leaf order: the
    key's signature makes them the same shapes), weights and batch into the
    static buffers under the program's lock, so that engines sharing it do
    not interleave.  The first call then runs the predict eagerly on a side
    stream and answers from it: the kernels' first calls opt in to their
    shared memory and load their libraries, which a capture cannot do.  It
    then captures the graph; a failed capture raises.  Every later call
    replays the graph and returns a copy of its output.

    A capture runs in CUDA's thread-local capture mode: other threads (the
    schedulers of engines already serving) go on using the card while one
    thread captures, and only the capturing thread's own calls are held to
    a capture's rules.  Captures themselves take one process-wide lock.

    Launch counts: the first call's kernels count in their wrappers as
    launches, the capture's calls as captures (``captured`` holds them by
    kernel), and each replay adds ``captured`` to the kernels' launch
    counts (``ops.count_replay``), since a replay launches them.  So every
    call, replayed or not, counts one launch of each kernel it runs.
    """

    _capture_lock = threading.Lock()

    def __init__(self, predict: Callable, ensemble: Any, used: torch.Tensor, batch_size: int,
                 n_features: int):
        self._predict = predict
        self._lock = threading.Lock()
        self.ensemble = pytree.tree_map_only(torch.Tensor, torch.clone, ensemble)
        self._leaves = _tensor_leaves(self.ensemble)
        self.used = used.clone()
        self.X = torch.zeros((batch_size, n_features), dtype=torch.float32, device=used.device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: torch.Tensor | None = None
        self.captured: Dict[str, int] = {}
        self.replays = 0

    def run(self, ensemble: Any, used: torch.Tensor, Xb: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        """``(votes, replayed)``: the predict of ``Xb`` under ``ensemble``
        and ``used``, and whether a replay of the graph answered it (False
        for the call that captured it)."""
        with self._lock:
            for dst, src in zip(self._leaves, _tensor_leaves(ensemble)):
                dst.copy_(src)
            self.used.copy_(used)
            self.X.copy_(Xb)
            if self.graph is None:
                return self._warm_up_and_capture(), False
            self.graph.replay()
            ops.count_replay(self.captured)
            self.replays += 1
            return self.out.clone(), True

    def __call__(self, ensemble: Any, used: torch.Tensor, Xb: torch.Tensor) -> torch.Tensor:
        return self.run(ensemble, used, Xb)[0]

    def _warm_up_and_capture(self) -> torch.Tensor:
        device = self.used.device
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device=device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            eager = self._predict(self.ensemble, self.used, self.X)
        main.wait_stream(side)
        eager.record_stream(main)  # read on the caller's stream after this returns
        graph = torch.cuda.CUDAGraph()
        with GraphProgram._capture_lock:
            before = ops.capture_counts()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self._predict(self.ensemble, self.used, self.X)
            after = ops.capture_counts()
        self.captured = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.graph, self.out = graph, out
        return eager
