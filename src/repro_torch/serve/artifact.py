"""Deployable ensemble artifact — the federation's inference deliverable
(answers to ``repro/serve/artifact.py``, homogeneous flavour).

A trained strong hypothesis becomes one file:

    MAFLSRV1 | u32 manifest_len | manifest JSON | packed payload

The payload is ``core/serialization.serialize(ensemble, packed=True)``:
every leaf in one contiguous buffer, in the leaf order the JAX package
writes, with ``count`` as a 0-dim int32 — so the port and the JAX package
write the same bytes for the same ensemble and read each other's files.
The manifest names the learner (registry key), the learning problem
(n_features/n_classes/hparams) and the ensemble geometry (capacity T,
used count, committee size), which is exactly enough to rebuild the
structure via ``init_ensemble`` and pour the payload back into it.  A
DistBoost.F ensemble stores a committee of C hypotheses per slot
(``committee_size`` C, slots ``[T, C, ...]``); it votes within each slot
first (``core/scoring.member_prediction(committee=True)``).

Heterogeneous ensembles (format v2, ``"learner": "heterogeneous"``) are a
tuple of per-group ensembles; their payload is the groups' leaves in
group order, and the manifest adds the per-group learner specs
(``groups``), the collaborator→group ``assignment`` and the learner key
of every used member (``member_learners``, in the group-blocked member
order).  A heterogeneous committee's ``committee_size`` is the
federation's C: each slot holds one seat block per group.

Quantized artifacts (format v3, either flavour) encode each leaf with its
own codec (``core/serialization.py``) and record the per-leaf plans in the
manifest.

A still-training federation publishes a ROLLING artifact stream with
``publish_artifact``: each checkpoint is a fresh versioned file plus an
atomically replaced ``LATEST`` pointer.
"""
from __future__ import annotations

import json
import struct
import time
import zlib
from pathlib import Path
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import boosting, hetero
from repro_torch.core.boosting import Ensemble
from repro_torch.core.hetero import HeterogeneousSpec
from repro_torch.core.serialization import (
    CODEC_BF16,
    CODEC_INT8,
    CODEC_RAW,
    CODEC_U8,
    decode_leaf,
    deserialize,
    encode_leaf,
    encoded_nbytes,
    flatten,
    leaf_specs,
    outlier_rows,
    serialize,
    unflatten,
    wire_format,
)
from repro_torch.device import resolve_device
from repro_torch.learners import LearnerSpec, WeakLearner, available_learners, get_learner

MAGIC = b"MAFLSRV1"
# Reader capability.  Homogeneous artifacts write format_version 1,
# heterogeneous ones 2, quantized ones (either flavour) 3 with a per-leaf
# "leaf_codecs" list in the manifest.
MANIFEST_VERSION = 3
HOMOGENEOUS_VERSION = 1
HETERO_VERSION = 2
QUANTIZED_VERSION = 3
HETERO_LEARNER = "heterogeneous"  # the manifest "learner" key of a mix

QUANTIZE_MODES = ("bf16", "int8")
# float leaves below this share of the float payload stay raw: thresholds
# and priors are noise-sized but decision-critical
SMALL_LEAF_SHARE = 0.05


class LoadedArtifact(NamedTuple):
    learner: WeakLearner | None  # None for a heterogeneous artifact
    spec: LearnerSpec | HeterogeneousSpec
    ensemble: Any  # Ensemble | HeteroEnsemble, on the device load_artifact was given
    committee_size: int | None  # DistBoost.F stores a committee per slot
    manifest: dict

    @property
    def committee(self) -> bool:
        return self.committee_size is not None

    @property
    def hetero(self) -> bool:
        return isinstance(self.spec, HeterogeneousSpec)


def ensemble_signature(ensemble: Ensemble) -> tuple:
    """Full structural identity of an ensemble: its nesting plus every
    leaf's (shape, dtype), ``count`` as a 0-dim int32.  Two ensembles with
    equal signatures are interchangeable under a serving engine — the
    check both ``save_artifact`` (against the manifest-derived template)
    and ``ServeEngine.update_ensemble`` (against the live ensemble) apply."""
    return leaf_specs(ensemble)


def _require_learner(name: str, context: str) -> WeakLearner:
    """Registry lookup that raises the documented ``ValueError``: an
    artifact naming a learner this process cannot build is rejected."""
    try:
        return get_learner(name)
    except KeyError:
        raise ValueError(
            f"{context}: unknown learner key {name!r}; "
            f"registered: {available_learners()}"
        ) from None


def _ensemble_template(spec: LearnerSpec, T: int, committee_size: int | None = None, *,
                       context: str = "artifact") -> Ensemble:
    """The structure an artifact's payload pours back into.
    ``init_ensemble`` is shape-deterministic, so saver and loader derive
    the same leaf shapes from the manifest alone."""
    learner = _require_learner(spec.name, context)
    return boosting.init_ensemble(learner, spec, T, "cpu", committee_size=committee_size)


def _hetero_template(hspec: HeterogeneousSpec, T: int, committee: bool, *,
                     context: str = "artifact") -> hetero.HeteroEnsemble:
    for name in hspec.names:
        _require_learner(name, context)
    return hetero.init_hetero_ensemble(hspec, T, "cpu", committee=committee)


def _ensemble_to(ensemble: Any, device) -> Any:
    if isinstance(ensemble, Ensemble):
        return boosting.ensemble_to(ensemble, device)
    return hetero.hetero_ensemble_to(ensemble, device)


def ensemble_device(ensemble: Any) -> torch.device:
    """The device a homogeneous or heterogeneous ensemble lies on."""
    return (ensemble if isinstance(ensemble, Ensemble) else ensemble[0]).alpha.device


# ---------------------------------------------------------------------------
# Quantization planning — which codec each leaf gets, and the
# vote-preserving calibration that promotes un-quantizable member slots
# ---------------------------------------------------------------------------


def _group_leaf_plans(params_leaves, mode: str) -> list:
    """Default per-leaf codec plan for ONE ensemble's params leaves."""
    float_total = sum(
        l.nbytes for l in params_leaves if np.issubdtype(l.dtype, np.floating)
    )
    plans = []
    for l in params_leaves:
        if np.issubdtype(l.dtype, np.integer):
            # host numpy leaves: int() here is a cast, not a device sync
            in_range = l.size == 0 or (int(l.min()) >= 0 and int(l.max()) <= 255)  # mafl: allow[host-sync]
            plans.append({"codec": CODEC_U8 if in_range else CODEC_RAW})
        elif not np.issubdtype(l.dtype, np.floating) or l.ndim < 2 \
                or l.nbytes < SMALL_LEAF_SHARE * float_total:
            plans.append({"codec": CODEC_RAW})
        elif mode == "bf16":
            plans.append({"codec": CODEC_BF16})
        else:
            plans.append({"codec": CODEC_INT8, "outlier_rows": outlier_rows(l),
                          "promoted_slots": []})
    return plans


def _plan_ensembles(ensembles: list, mode: str) -> list:
    """Per-leaf plans in the artifact's leaf order (the groups in turn):
    params leaves get the requested codec, alpha and count stay raw (they
    weight the vote tally directly; quantizing them would change served
    votes)."""
    if mode not in QUANTIZE_MODES:
        raise ValueError(f"quantize must be one of {QUANTIZE_MODES}, got {mode!r}")
    plans = []
    for ens in ensembles:
        plans += _group_leaf_plans(flatten(ens.params)[0], mode) + [{"codec": CODEC_RAW}] * 2
    return plans


def _quantize_roundtrip(ensemble: Any, plans: list) -> Any:
    """What a consumer will serve: encode + decode every leaf."""
    leaves, structure = flatten(ensemble)
    out = [decode_leaf(encode_leaf(l, p), p, l.shape, l.dtype) for l, p in zip(leaves, plans)]
    return _ensemble_to(unflatten(structure, out), ensemble_device(ensemble))


def _calibrate_plans(spec, ensemble: Any, plans: list, calibrate, committee: bool) -> list:
    """Greedy vote-preserving promotion: serve the quantized ensemble on
    the calibration rows and, while any vote differs from the f32
    ensemble's, promote the member slot (of any group) whose raw
    restoration fixes the most rows (a bf16 leaf's only escape is raw
    wholesale).  Terminates at all-slots-raw, which is exact by
    construction."""
    X = torch.as_tensor(np.asarray(calibrate, np.float32), device=ensemble_device(ensemble))
    is_hetero = isinstance(spec, HeterogeneousSpec)

    def votes(ens):
        if is_hetero:
            return hetero.hetero_strong_predict(spec, ens, X, committee=committee)
        return boosting.strong_predict(get_learner(spec.name), spec, ens, X, committee=committee)

    ensembles = list(ensemble) if is_hetero else [ensemble]
    group_slices, off = [], 0  # plan-index range per group
    for ens in ensembles:
        n = len(flatten(ens)[0])
        group_slices.append((off, off + n))
        off += n

    def flips(ps) -> int:
        groups = [_quantize_roundtrip(ens, ps[a:b]) for ens, (a, b) in zip(ensembles, group_slices)]
        # calibration is offline; each trial's flip count gates the next
        # greedy step, so the sync is inherent
        return int((votes(tuple(groups) if is_hetero else groups[0]) != want).sum())  # mafl: allow[host-sync]

    want = votes(ensemble)
    n_flips = flips(plans)
    if n_flips == 0:
        return plans

    # an int8 leaf can restore ONE member slot raw; a bf16 leaf's only
    # escape is raw wholesale
    actions: list = []
    for g, ens in enumerate(ensembles):
        a, b = group_slices[g]
        if any(p["codec"] == CODEC_INT8 for p in plans[a:b]):
            actions += [("slot", g, t) for t in range(ens.count)]
    actions += [("leaf", i, None) for i, p in enumerate(plans) if p["codec"] == CODEC_BF16]

    def apply(ps, action):
        kind, x, t = action
        if kind == "slot":
            a, b = group_slices[x]
            return [
                dict(p, promoted_slots=sorted(set(p["promoted_slots"]) | {t}))
                if a <= i < b and p["codec"] == CODEC_INT8 else p
                for i, p in enumerate(ps)
            ]
        return [dict(p, codec=CODEC_RAW) if i == x else p for i, p in enumerate(ps)]

    # Greedy: each round, apply the single action that fixes the most
    # calibration rows (ties -> first).  Applying EVERY action makes the
    # round trip the identity on all voting members, so the loop always
    # reaches zero flips.
    applied: set = set()
    while n_flips > 0 and len(applied) < len(actions):
        best = None
        for act in actions:
            if act in applied:
                continue
            trial = apply(plans, act)
            ft = flips(trial)
            if best is None or ft < best[1]:
                best = (act, ft, trial)
        applied.add(best[0])
        n_flips, plans = best[1], best[2]
    return plans


def _demote_uneconomic(ensemble: Any, plans: list) -> list:
    """A quantized leaf whose encoded form ends up no smaller than raw
    ships raw instead: exactness is free and the artifact never grows
    past its f32 twin."""
    out = []
    for (shape, dtype), p in zip(leaf_specs(ensemble)[1], plans):
        raw = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        uneconomic = p["codec"] != CODEC_RAW and encoded_nbytes(p, shape, dtype) >= raw
        out.append({"codec": CODEC_RAW} if uneconomic else p)
    return out


def _maybe_quantize(spec, ensemble: Any, quantize: Optional[str], calibrate, committee: bool):
    """Returns (payload, leaf_codecs) — leaf_codecs is None unquantized."""
    if quantize is None:
        return serialize(ensemble, packed=True)[0], None
    ensembles = list(ensemble) if isinstance(spec, HeterogeneousSpec) else [ensemble]
    plans = _plan_ensembles(ensembles, quantize)
    if calibrate is not None:
        plans = _calibrate_plans(spec, ensemble, plans, calibrate, committee)
    plans = _demote_uneconomic(ensemble, plans)
    leaves = flatten(ensemble)[0]
    return b"".join(encode_leaf(l, p) for l, p in zip(leaves, plans)), plans


def save_artifact(
    path: str | Path,
    spec: LearnerSpec | HeterogeneousSpec,
    ensemble: Any,
    *,
    committee_size: int | None = None,
    extra: dict | None = None,
    quantize: str | None = None,
    calibrate: Any = None,
) -> Path:
    """Write a single-file serving artifact; returns the path.  A
    ``LearnerSpec`` writes the v1 manifest, a ``HeterogeneousSpec`` (with
    the per-group ensemble tuple) the v2 one.  A DistBoost.F ensemble
    passes its ``committee_size`` (slots ``[T, C, ...]``; for a
    heterogeneous committee, the federation's C).

    ``quantize`` ("bf16" or "int8") writes a v3 artifact whose payload
    leaves are individually encoded.  With ``calibrate`` (an [n, d] row
    matrix), the saver checks the dequantized ensemble's votes against
    the f32 ensemble's on those rows and stores raw any member slot whose
    votes quantization would flip."""
    path = Path(path)
    if isinstance(spec, HeterogeneousSpec):
        return _save_hetero(path, spec, ensemble, committee_size=committee_size, extra=extra,
                            quantize=quantize, calibrate=calibrate)
    template = _ensemble_template(spec, ensemble.alpha.shape[0], committee_size)
    got, want = ensemble_signature(ensemble), ensemble_signature(template)
    if got != want:
        raise ValueError(
            f"ensemble does not match the {spec.name!r} template: {got} != {want}"
        )
    payload, plans = _maybe_quantize(spec, ensemble, quantize, calibrate,
                                     committee_size is not None)
    manifest = {
        "format_version": HOMOGENEOUS_VERSION if plans is None else QUANTIZED_VERSION,
        "learner": spec.name,
        "n_features": spec.n_features,
        "n_classes": spec.n_classes,
        "hparams": dict(spec.hparams),
        "ensemble_capacity": int(ensemble.alpha.shape[0]),
        "ensemble_count": int(ensemble.count),
        "committee_size": committee_size,
        "payload_bytes": len(payload),
        "payload_crc32": zlib.crc32(payload),
    }
    if plans is not None:
        manifest["quantize"] = quantize
        manifest["leaf_codecs"] = plans
    return _write(path, manifest, payload, extra)


def _write(path: Path, manifest: dict, payload: bytes, extra: dict | None) -> Path:
    overlap = set(extra or {}) & set(manifest)
    if overlap:
        raise ValueError(f"extra manifest keys shadow required fields: {sorted(overlap)}")
    manifest.update(extra or {})
    blob = json.dumps(manifest, sort_keys=True).encode()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(blob)))
        f.write(blob)
        f.write(payload)
    return path


def _save_hetero(path: Path, hspec: HeterogeneousSpec, ensemble: hetero.HeteroEnsemble, *,
                 committee_size: int | None, extra: dict | None, quantize: str | None = None,
                 calibrate: Any = None) -> Path:
    if committee_size is not None and committee_size != hspec.n_collaborators:
        raise ValueError(
            f"heterogeneous committees span the whole federation: committee_size "
            f"must be {hspec.n_collaborators} (or None), got {committee_size}"
        )
    committee = committee_size is not None
    T = int(ensemble[0].alpha.shape[0])
    template = _hetero_template(hspec, T, committee)
    got, want = ensemble_signature(ensemble), ensemble_signature(template)
    if got != want:
        raise ValueError(
            f"ensemble does not match the heterogeneous template for groups "
            f"{hspec.names}: {got} != {want}"
        )
    counts = [e.count for e in ensemble]
    if committee:
        if len(set(counts)) != 1:
            raise ValueError(f"committee group counts must move in lockstep: {counts}")
        # every used member is one mixed committee: one seat per collaborator
        seat_names = [hspec.specs[g].name for g in hspec.assignment]
        member_learners: list = [seat_names] * counts[0]
    else:
        member_learners = [hspec.specs[g].name for g in range(hspec.n_groups)
                           for _ in range(counts[g])]
    payload, plans = _maybe_quantize(hspec, ensemble, quantize, calibrate, committee)
    manifest = {
        "format_version": HETERO_VERSION if plans is None else QUANTIZED_VERSION,
        "learner": HETERO_LEARNER,
        "n_features": hspec.n_features,
        "n_classes": hspec.n_classes,
        "hparams": {},  # per-group hparams live in "groups"
        "groups": [
            {"learner": s.name, "hparams": dict(s.hparams), "members": list(hspec.members(g)),
             "count": counts[g]}
            for g, s in enumerate(hspec.specs)
        ],
        "assignment": list(hspec.assignment),
        "member_learners": member_learners,
        "ensemble_capacity": T,
        "ensemble_count": hetero.hetero_count(ensemble, committee=committee),
        "committee_size": committee_size,
        "payload_bytes": len(payload),
        "payload_crc32": zlib.crc32(payload),
    }
    if plans is not None:
        manifest["quantize"] = quantize
        manifest["leaf_codecs"] = plans
    return _write(path, manifest, payload, extra)


_MANIFEST_KEYS = (
    "format_version", "learner", "n_features", "n_classes", "hparams",
    "ensemble_capacity", "ensemble_count", "committee_size",
    "payload_bytes", "payload_crc32",
)


def _decode_payload(payload: bytes, template: Any, manifest: dict, path) -> Any:
    """Pour a payload back into the template — per-leaf codec decode for
    quantized (v3) artifacts, packed deserialize otherwise.  CPU tensors."""
    plans = manifest.get("leaf_codecs")
    if plans is None:
        return deserialize([payload], wire_format(template), packed=True)
    structure, specs = leaf_specs(template)
    if len(plans) != len(specs):
        raise ValueError(
            f"{path}: manifest lists {len(plans)} leaf codecs "
            f"for {len(specs)} payload leaves"
        )
    out, off = [], 0
    for (shape, dtype), plan in zip(specs, plans):
        try:
            n = encoded_nbytes(plan, shape, dtype)
            out.append(decode_leaf(payload[off : off + n], plan, shape, np.dtype(dtype)))
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from e
        off += n
    if off != len(payload):
        raise ValueError(
            f"{path}: quantized payload length mismatch ({len(payload)} != {off})"
        )
    return unflatten(structure, out)


def load_artifact(path: str | Path, device: str | torch.device = "cuda") -> LoadedArtifact:
    """Read and check an artifact; its ensemble lands on ``device`` (the
    card by default: raises without one unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    data = Path(path).read_bytes()
    header = len(MAGIC) + 4  # magic + u32 manifest length
    # validate lengths BEFORE unpacking: a file truncated inside the
    # header must raise the documented ValueError, not a raw struct.error
    if len(data) < header:
        raise ValueError(
            f"{path}: truncated header ({len(data)} < {header} bytes)"
        )
    if data[: len(MAGIC)] != MAGIC:
        raise ValueError(f"{path}: not a MAFL serving artifact (bad magic)")
    (mlen,) = struct.unpack("<I", data[len(MAGIC) : header])
    if len(data) < header + mlen:
        raise ValueError(
            f"{path}: truncated manifest ({len(data) - header} < {mlen} bytes)"
        )
    try:
        manifest = json.loads(data[header : header + mlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: corrupt manifest: {e}") from e
    if not isinstance(manifest, dict):
        raise ValueError(f"{path}: manifest is not a JSON object")
    missing = [k for k in _MANIFEST_KEYS if k not in manifest]
    if missing:
        raise ValueError(f"{path}: manifest missing required keys {missing}")
    payload = data[header + mlen :]
    if manifest["format_version"] > MANIFEST_VERSION:
        raise ValueError(
            f"{path}: artifact format v{manifest['format_version']} is newer "
            f"than this reader (v{MANIFEST_VERSION})"
        )
    if len(payload) != manifest["payload_bytes"]:
        raise ValueError(
            f"{path}: truncated payload ({len(payload)} != {manifest['payload_bytes']} bytes)"
        )
    if zlib.crc32(payload) != manifest["payload_crc32"]:
        raise ValueError(f"{path}: payload checksum mismatch")
    if manifest["learner"] == HETERO_LEARNER:
        return _load_hetero(path, manifest, payload, dev)
    spec = LearnerSpec(
        manifest["learner"],
        manifest["n_features"],
        manifest["n_classes"],
        dict(manifest["hparams"]),
    )
    template = _ensemble_template(spec, manifest["ensemble_capacity"],
                                  manifest["committee_size"], context=str(path))
    ensemble = _decode_payload(payload, template, manifest, path)
    return LoadedArtifact(
        learner=get_learner(spec.name),
        spec=spec,
        ensemble=boosting.ensemble_to(ensemble, dev),
        committee_size=manifest["committee_size"],
        manifest=manifest,
    )


def _load_hetero(path, manifest: dict, payload: bytes, dev: torch.device) -> LoadedArtifact:
    for k in ("groups", "assignment"):
        if k not in manifest:
            raise ValueError(f"{path}: heterogeneous manifest missing {k!r}")
    specs = tuple(
        LearnerSpec(g["learner"], manifest["n_features"], manifest["n_classes"],
                    dict(g["hparams"]))
        for g in manifest["groups"]
    )
    try:
        hspec = HeterogeneousSpec(specs=specs, assignment=tuple(manifest["assignment"]))
    except ValueError as e:
        raise ValueError(f"{path}: invalid heterogeneous manifest: {e}") from e
    template = _hetero_template(hspec, manifest["ensemble_capacity"],
                                manifest["committee_size"] is not None, context=str(path))
    ensemble = _decode_payload(payload, template, manifest, path)
    return LoadedArtifact(
        learner=None,
        spec=hspec,
        ensemble=hetero.hetero_ensemble_to(ensemble, dev),
        committee_size=manifest["committee_size"],
        manifest=manifest,
    )


# ---------------------------------------------------------------------------
# Rolling checkpoint stream — the federation→serving handoff
# ---------------------------------------------------------------------------

LATEST = "LATEST"


def publish_artifact(
    publish_dir: str | Path,
    spec: LearnerSpec | HeterogeneousSpec,
    ensemble: Any,
    *,
    version: int,
    committee_size: int | None = None,
    extra: dict | None = None,
) -> Path:
    """One checkpoint of a still-training federation: write a fresh
    versioned artifact, then atomically repoint ``LATEST`` at it.

    The version lands in the manifest (``publish_version``) and the file
    name.  The pointer swap is an ``os.replace``: a concurrent reader
    sees the old complete artifact or the new one, never a partial write."""
    publish_dir = Path(publish_dir)
    path = publish_dir / f"ensemble_v{version:06d}.mafl"
    save_artifact(
        path, spec, ensemble, committee_size=committee_size,
        extra={"publish_version": int(version), **(extra or {})},
    )
    tmp = publish_dir / (LATEST + ".tmp")
    tmp.write_text(path.name)
    tmp.replace(publish_dir / LATEST)
    return path


def _resolve_latest(pointer: Path) -> Path | None:
    if not pointer.exists():
        return None
    name = pointer.read_text().strip()
    return (pointer.parent / name) if name else None


def latest_artifact(publish_dir: str | Path) -> Path | None:
    """Resolve the ``LATEST`` pointer; None when nothing is published.
    A pointer naming a not-yet-visible file is re-resolved once; one that
    STILL names a missing file is corruption and raises ``ValueError``."""
    pointer = Path(publish_dir) / LATEST
    path = _resolve_latest(pointer)
    if path is not None and not path.exists():  # torn read: retry once
        time.sleep(0.05)
        path = _resolve_latest(pointer)
        if path is not None and not path.exists():
            raise ValueError(
                f"{pointer}: names artifact {pointer.read_text().strip()!r} "
                f"which does not exist (torn or corrupt publish)"
            )
    return path
