"""Shard-resident incremental vote cache (answers to
``repro/serve/cache.py``: homogeneous and heterogeneous ensembles,
DistBoost.F committees included).

``ShardVoteCache`` extends ``core/scoring.VoteTally`` into serving: a
registered shard keeps its ``[n, K]`` alpha-weighted vote tally resident
on the ensemble's device, so

  * a repeat request is a pure ``argmax`` over the tally — ZERO member
    predicts (a cache hit);
  * after the ensemble grows, the next request folds in only the newly
    appended members — O(new members), not O(T) (a partial hit).

The tally adds members in ascending order, one fp32 add per member, as
the ``vote_argmax`` kernel sums them, so on the card the cache answers
exactly what the engine answers.  A heterogeneous shard keeps one tally
per learner group (a committee ensemble one, folded across the groups);
each grows append-only, and the answer is the argmax of their sum, so
it can differ from the engine's only on a row whose top two vote sums
tie to within rounding.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Hashable

import numpy as np
import torch

from repro_torch.core import hetero, scoring
from repro_torch.core.boosting import Ensemble
from repro_torch.core.hetero import HeterogeneousSpec
from repro_torch.learners.base import LearnerSpec, WeakLearner
from repro_torch.obs import metrics as obs_metrics, trace
from repro_torch.serve.artifact import ensemble_device

# Process-wide vote-cache metric families; per-instance ``stats()``
# keeps its dict shape over the instance counters.
_M_HITS = obs_metrics.counter(
    "mafl_vote_cache_hits_total", "Requests answered from a resident tally alone."
)
_M_PARTIAL = obs_metrics.counter(
    "mafl_vote_cache_partial_hits_total",
    "Requests that folded only newly appended members.",
)
_M_MISSES = obs_metrics.counter(
    "mafl_vote_cache_misses_total", "First-contact requests (full tally build)."
)
_M_FOLDED = obs_metrics.counter(
    "mafl_vote_cache_members_folded_total",
    "Member-predict passes actually run by vote caches.",
)


@dataclasses.dataclass
class _Resident:
    X: torch.Tensor  # [n, d] — the shard's rows, pinned for member predicts
    # [n, K] running votes over members [0, counted): one VoteTally for a
    # homogeneous ensemble, a per-group tuple for a heterogeneous one
    tally: Any
    fingerprint: tuple  # (shape, crc32 of rows) — guards against key reuse
    counted: int = 0  # used members folded so far


def _fingerprint(X) -> tuple:
    # Normalise to the float32 the cache actually serves BEFORE hashing:
    # the same rows held in float64 must fingerprint identically.
    arr = np.ascontiguousarray(np.asarray(X, np.float32))
    return (arr.shape, zlib.crc32(arr.tobytes()))


def _alpha_prefix_crc(ensemble, counts: tuple) -> int:
    """CRC of the used alpha prefix (of every group, concatenated, for a
    heterogeneous ensemble): an already-tallied member must never change
    under the cache."""
    groups = (ensemble,) if isinstance(ensemble, Ensemble) else ensemble
    return zlib.crc32(b"".join(
        np.ascontiguousarray(e.alpha[:c].cpu().numpy()).tobytes() for e, c in zip(groups, counts)))


class ShardVoteCache:
    def __init__(self, learner: WeakLearner | None, spec: LearnerSpec | HeterogeneousSpec,
                 ensemble, *, committee: bool = False):
        """Homogeneous: ``(learner, LearnerSpec, Ensemble)``.  Heterogeneous:
        ``(None, HeterogeneousSpec, the group tuple)``."""
        self.hetero = isinstance(spec, HeterogeneousSpec)
        if self.hetero and learner is not None:
            raise ValueError("heterogeneous caches resolve per-group learners from the "
                             "HeterogeneousSpec; pass learner=None")
        self.learner = learner
        self.spec = spec
        self.committee = committee
        self.ensemble = ensemble
        self.device = ensemble_device(ensemble)
        self._counts = self._group_counts(ensemble)
        self._alpha_crc = _alpha_prefix_crc(ensemble, self._counts)
        self._shards: Dict[Hashable, _Resident] = {}
        self.hits = 0  # requests answered from the tally alone
        self.partial_hits = 0  # requests that folded only new members
        self.misses = 0  # first-contact requests (full tally build)
        self.members_folded = 0  # total member-predict passes actually run
        self.reregistrations = 0  # key reuse with different rows (tally rebuilt)

    @classmethod
    def from_artifact(cls, art) -> "ShardVoteCache":
        """The cache counterpart of ``ServeEngine.from_artifact``."""
        return cls(art.learner, art.spec, art.ensemble, committee=art.committee)

    def _group_counts(self, ensemble) -> tuple:
        return tuple(e.count for e in ensemble) if self.hetero else (ensemble.count,)

    def _used_count(self) -> int:
        if self.hetero:
            return hetero.hetero_count(self.ensemble, committee=self.committee)
        return self.ensemble.count

    def register(self, key: Hashable, X) -> None:
        """Pin a shard resident with an empty tally (no predicts yet)."""
        rows = np.asarray(X, np.float32)
        with trace.span("vote_cache.register", rows=rows.shape[0]):
            n = rows.shape[0]
            tally = (hetero.init_hetero_tally(self.spec, n, self.device, committee=self.committee)
                     if self.hetero else scoring.init_tally(n, self.spec.n_classes, self.device))
            self._shards[key] = _Resident(
                X=torch.from_numpy(np.ascontiguousarray(rows)).to(self.device),
                tally=tally,
                fingerprint=_fingerprint(rows),
            )

    def __contains__(self, key: Hashable) -> bool:
        return key in self._shards

    def predict(self, key: Hashable, X=None) -> np.ndarray:
        """Serve one resident shard; builds residency on first contact."""
        if key not in self._shards:
            if X is None:
                raise KeyError(f"shard {key!r} not resident and no rows given")
            self.register(key, X)
        elif X is not None and _fingerprint(X) != self._shards[key].fingerprint:
            # key reuse with different rows: the old tally answers the OLD
            # rows — re-register so the caller never gets stale predictions
            self.reregistrations += 1
            self.register(key, X)
        shard = self._shards[key]
        count = self._used_count()
        new = count - shard.counted
        if new == 0:
            self.hits += 1
            _M_HITS.inc()
        else:
            if shard.counted == 0:
                self.misses += 1  # full tally build (first contact)
                _M_MISSES.inc()
            else:
                self.partial_hits += 1  # folds only the appended members
                _M_PARTIAL.inc()
            with trace.span("vote_cache.refresh", new_members=new):
                if self.hetero:
                    shard.tally = hetero.hetero_tally_new_votes(
                        self.spec, self.ensemble, shard.tally, shard.X, committee=self.committee)
                else:
                    shard.tally = scoring.tally_new_votes(
                        self.learner, self.spec, self.ensemble, shard.tally, shard.X,
                        committee=self.committee,
                    )
            shard.counted = count
            self.members_folded += new
            _M_FOLDED.inc(new)
        pred = (hetero.hetero_tally_predict(shard.tally) if self.hetero
                else scoring.tally_predict(shard.tally))
        return pred.cpu().numpy()

    def update_ensemble(self, ensemble) -> None:
        """Swap in a grown ensemble; resident tallies refresh lazily on the
        next request, each folding only the appended members."""
        counts = self._group_counts(ensemble)
        if any(c < c0 for c, c0 in zip(counts, self._counts)):
            raise ValueError("ensemble shrank; serving caches only grow")
        # resident tallies hold votes of members [0, counted): replacing an
        # already-tallied member would silently serve the old model forever,
        # so reject anything that is not a pure append
        if _alpha_prefix_crc(ensemble, self._counts) != self._alpha_crc:
            raise ValueError(
                "already-tallied ensemble members changed; serving caches are "
                "append-only — build a new ShardVoteCache for a retrained model"
            )
        if ensemble_device(ensemble) != self.device:
            raise ValueError(
                f"ensemble is on {ensemble_device(ensemble)}, the cache serves on {self.device}"
            )
        self.ensemble = ensemble
        self._counts = counts
        self._alpha_crc = _alpha_prefix_crc(ensemble, counts)

    def stats(self) -> Dict[str, Any]:
        return {
            "shards": len(self._shards),
            "hits": self.hits,
            "partial_hits": self.partial_hits,
            "misses": self.misses,
            "members_folded": self.members_folded,
            "reregistrations": self.reregistrations,
        }
