"""Production-mesh dry-run: one pass of every (architecture x input shape)
over the production meshes, recording bytes, FLOPs and the collective
schedule for the roofline (``roofline.py``).  The port's counterpart of
``repro/launch/dryrun.py``, with its flags and its JSON fields.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fl-round          # the MAFL round
Results: experiments/dryrun/<arch>__<shape>__<mesh>.json (incremental).

Where the JAX package compiles a step for 256 or 512 devices, this runs
the port's own step once, in this process, as rank 0 of a ``"fake"``
process group of that many ranks (``launch/mesh.py:make_production_mesh``):
the parameters, the optimizer state, the inputs and the decode state are
DTensors placed by ``models/shardings.py`` whose blocks are fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage), so the pass computes
nothing and allocates nothing, and every sharding decision and collective
is DTensor's.  It touches no device and takes no ``device`` argument: a
fake tensor lives nowhere, and the kernels, which cannot launch on one,
are not on this path (the plain attention runs, as the JAX dry-run runs
without Pallas).  What it records:

* ``memory.argument_size_in_bytes`` / ``output_size_in_bytes``: one
  device's blocks of the step's inputs and outputs, exact from the
  placements.  ``temp_size_in_bytes`` and ``generated_code_size_in_bytes``
  are null: no compiler plans the temporaries here.
* ``cost``: ``roofline.DeviceCostMode``'s FLOPs and bytes a device; the
  bytes are the unfused sum of every op's input and output bytes
  (``bytes_note``), larger than XLA's fused figure.
* ``collectives``: ``roofline.CollectiveRecorder``'s record.

A pass at full depth would walk every layer; as the JAX dry-run solves
for the per-unit cost from two partial unrolls, the pass runs at 2 and at
1 repeating unit(s) of ``cfg.pattern()`` and extrapolates each count
linearly to the full depth (``cost_extrapolated``): every count is
(outside the stack) + (units) x (one unit), so this is exact.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import roofline
from repro_torch.configs import INPUT_SHAPES, all_archs, get_arch
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.models import attention, moe, shardings
from repro_torch.models import model as M
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import AdamWState

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun"

# long_500k applicability: constant-state or native-local architectures
# only; pure full-attention archs are skipped and recorded.
LONG_OK = {"xlstm-1.3b", "llama4-scout-17b-a16e"}

BYTES_NOTE = ("unfused: the sum of every aten op's input and output bytes on one device "
              "(XLA's bytes accessed are after fusion)")


def combos(mesh_kind: str):
    for arch in sorted(all_archs()):
        for shape in INPUT_SHAPES.values():
            yield arch, shape.name, mesh_kind


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and arch not in LONG_OK:
        return (
            "long_500k requires sub-quadratic context handling; "
            f"{arch} is pure full-attention (no native local/SSM variant) — skip per brief"
        )
    return None


def pad_heads(cfg: ArchConfig, model_n: int = 16) -> ArchConfig:
    """Pad attention heads up to a multiple of the model axis so attention
    shards instead of replicating (llama4: 40->48 heads).  Only shapes
    matter to the dry-run."""
    H, Kv = cfg.n_heads, cfg.n_kv_heads
    if H % model_n:
        H = -(-H // model_n) * model_n
    if H % Kv or (Kv % model_n and Kv > model_n):
        Kv = model_n if Kv != cfg.n_heads else H
    if Kv == cfg.n_heads and cfg.n_kv_heads == cfg.n_heads:
        Kv = H  # MHA stays MHA
    return dataclasses.replace(cfg, n_heads=H, n_kv_heads=Kv)


def _distribute_model(model, specs: Dict[str, shardings.Spec], dm) -> None:
    """Each parameter replaced by a DTensor of its spec (fake blocks)."""
    owners = dict(model.named_modules())
    for name, spec in specs.items():
        mod, _, leaf = name.rpartition(".")
        p = getattr(owners[mod], leaf)
        setattr(owners[mod], leaf, torch.nn.Parameter(shardings.distribute(p, spec, dm), requires_grad=False))


def _opt_state(params: Dict[str, torch.Tensor], specs, dm) -> AdamWState:
    def f32(p, spec):
        return shardings.distribute(torch.empty(p.shape, dtype=torch.float32), spec, dm)

    return AdamWState(torch.zeros((), dtype=torch.int32),
                      {k: f32(p, specs[k]) for k, p in params.items()},
                      {k: f32(p, specs[k]) for k, p in params.items()})


def _state_bytes(cfg: ArchConfig, mesh, policy: str, zero1: bool, train: bool) -> Tuple[int, int, Any]:
    """One device's bytes of the full-depth model's parameters and of its
    optimizer state (0 outside training), from the specs alone, and the
    abstract model itself."""
    model = M.abstract_model(cfg)
    params, axes = M.param_tree(model), M.param_axes(model)
    pspecs = shardings.param_specs(cfg, params, axes, mesh, policy=policy)
    pb = sum(math.prod(shardings.local_shape(tuple(p.shape), pspecs[k], mesh)) * p.element_size()
             for k, p in params.items())
    ob = 0
    if train:
        ospecs = shardings.param_specs(cfg, params, axes, mesh, policy=policy, zero1=zero1)
        ob = 4 + 2 * sum(4 * math.prod(shardings.local_shape(tuple(p.shape), ospecs[k], mesh))
                         for k, p in params.items())
    return pb, ob, model


def _place_inputs(cfg: ArchConfig, shape: InputShape, mesh, fm) -> Dict[str, Any]:
    """``input_specs`` as DTensors placed by ``input_spec_tree`` (fake
    blocks; the decode state's host position as it is)."""
    inputs = M.input_specs(cfg, shape, fm)
    ispecs = shardings.input_spec_tree(cfg, shape, inputs, mesh)
    dm = mesh.device_mesh
    with fm:
        return {k: (M.ServeState(shardings.place_state(v.caches, shape.global_batch, dm), v.pos)
                    if k == "state" else shardings.distribute(v, ispecs[k], dm))
                for k, v in inputs.items()}


def _pass(cfg: ArchConfig, shape: InputShape, mesh, policy: str, zero1: bool, accum: int) -> Dict[str, Any]:
    """One step of ``cfg`` over ``mesh`` under the counters."""
    from torch.distributed.tensor.experimental import implicit_replication

    dm = mesh.device_mesh
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    model = M.abstract_model(cfg, fm)
    params, axes = M.param_tree(model), M.param_axes(model)
    cost, rec = roofline.DeviceCostMode(), roofline.CollectiveRecorder()
    t0 = time.time()
    optimizers.clear_tables()  # each pass builds (and counts) the step's tables once
    with fm, contextlib.ExitStack() as done:
        done.callback(optimizers.clear_tables)
        _distribute_model(model, shardings.param_specs(cfg, params, axes, mesh, policy=policy), dm)
        batch = _place_inputs(cfg, shape, mesh, fm)
        if shape.kind == "train":
            params = M.param_tree(model)
            opt = _opt_state(params, shardings.param_specs(cfg, params, axes, mesh, policy=policy, zero1=zero1), dm)
        with implicit_replication(), rec, cost:
            if shape.kind == "train":
                state, metrics = M.train_step(cfg, M.TrainState(model, opt), batch, accum=accum)
                out = (M.param_tree(model), state.opt, metrics)
            elif shape.kind == "prefill":
                out = M.prefill(model, batch)
            else:
                out = M.serve_step(model, batch["state"], batch["token"])
    return {"flops": cost.flops, "bytes": float(cost.bytes_accessed), "calls": rec.calls,
            "out_bytes": roofline.local_bytes(out), "seconds": time.time() - t0}


def lower_one(arch: str, shape_name: str, mesh_kind: str, unrolled: bool = True,
              policy: str = "baseline", zero1: bool = False, accum: int = 1,
              padded_heads: bool = False, chunked_local: bool = True,
              grouped_dispatch: bool = False, *, cfg: Optional[ArchConfig] = None,
              input_shape: Optional[InputShape] = None,
              mesh_dims: Optional[Tuple[Sequence[int], Sequence[str]]] = None) -> Dict[str, Any]:
    """The dry-run of one combo: passes at 2 and 1 repeating units,
    extrapolated to the full depth (``unrolled``; else a full-depth
    pass).  ``cfg``, ``input_shape`` and ``mesh_dims`` (shape, axis names)
    replace the registered config, ``INPUT_SHAPES[shape_name]`` and the
    production mesh (the tests' small runs)."""
    cfg = cfg or get_arch(arch)
    shape = input_shape or INPUT_SHAPES[shape_name]
    ctx = fake_mesh(*mesh_dims) if mesh_dims else make_production_mesh(multi_pod=(mesh_kind == "multi"))
    with ctx as mesh, _variant(policy, chunked_local, grouped_dispatch, mesh):
        n_devices = mesh.size
        if padded_heads:
            cfg = pad_heads(cfg, mesh.shape["model"])
        spec_policy = "baseline" if policy == "fsdp-gather" else policy
        unit, R = cfg.pattern()
        period = len(unit)
        U = min(R, 2) if unrolled else R
        t0 = time.time()
        big = _pass(cfg.with_layers(U * period), shape, mesh, spec_policy, zero1, accum)
        extrapolated = False
        small_s = 0.0
        if U < R:
            small = _pass(cfg.with_layers(period), shape, mesh, spec_policy, zero1, accum)
            small_s = small["seconds"]

            def extra(mU, m1):
                return mU + (R - U) * (mU - m1) / (U - 1)

            coll_big, coll_small = roofline.collective_stats(big["calls"]), roofline.collective_stats(small["calls"])
            flops, bytes_accessed = extra(big["flops"], small["flops"]), extra(big["bytes"], small["bytes"])
            out_bytes = int(round(extra(big["out_bytes"], small["out_bytes"])))
            kinds = set(coll_big.ops) | set(coll_small.ops)
            coll = roofline.CollectiveStats(
                {k: int(round(extra(coll_big.ops.get(k, 0), coll_small.ops.get(k, 0)))) for k in kinds},
                {k: int(round(extra(coll_big.raw_bytes.get(k, 0), coll_small.raw_bytes.get(k, 0)))) for k in kinds},
                max(extra(coll_big.wire_bytes, coll_small.wire_bytes), 0.0))
            extrapolated = True
        else:
            flops, bytes_accessed, out_bytes = big["flops"], big["bytes"], big["out_bytes"]
            coll = roofline.collective_stats(big["calls"])
        pb, ob, full = _state_bytes(cfg, mesh, spec_policy, zero1, shape.kind == "train")
        in_bytes = roofline.local_bytes(_place_inputs(cfg, shape, mesh, FakeTensorMode()))
        params, axes = M.param_tree(full), M.param_axes(full)
        terms = roofline.roofline_terms(flops, bytes_accessed, coll.wire_bytes)
        mf = roofline.model_flops(cfg, params, axes, shape)
        total_p, active_p = roofline.param_counts(cfg, params, axes)
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_kind,
        "n_devices": n_devices,
        "compile_seconds": {"scanned": round(small_s, 1), "unrolled": round(big["seconds"], 1)},
        "cost_from_unrolled": unrolled,
        "cost_extrapolated": extrapolated,
        "unit_repeats": R,
        "unroll_used": U,
        "variant": {"policy": policy, "zero1": zero1, "accum": accum,
                    "padded_heads": padded_heads, "chunked_local": chunked_local,
                    "grouped_dispatch": grouped_dispatch},
        "memory": {
            "argument_size_in_bytes": pb + ob + in_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": None,
            "generated_code_size_in_bytes": None,
        },
        "cost": {"flops_per_device": flops, "bytes_per_device": bytes_accessed, "bytes_note": BYTES_NOTE},
        "collectives": coll.to_dict(),
        "roofline": terms,
        "model_flops_total": mf,
        "model_flops_per_device": mf / n_devices,
        "useful_flops_ratio": (mf / n_devices) / flops if flops else None,
        "params_total": total_p,
        "params_active": active_p,
        "seconds": round(time.time() - t0, 1),
    }


@contextlib.contextmanager
def _variant(policy: str, chunked_local: bool, grouped_dispatch: bool, mesh):
    """The module switches a variant sets, restored on exit."""
    prev = (attention.CHUNKED_LOCAL, shardings.FSDP_WEIGHT_GATHER, moe.DISPATCH_GROUPS)
    attention.set_chunked_local(chunked_local)
    # "fsdp-gather" = baseline param layout + explicit weight-gather
    # redistributions at every use (shardings.maybe_gather_weight)
    shardings.set_fsdp_weight_gather(policy == "fsdp-gather")
    moe.set_dispatch_groups(shardings.dp_size(mesh) if grouped_dispatch else 1)
    try:
        yield
    finally:
        attention.set_chunked_local(prev[0])
        shardings.set_fsdp_weight_gather(prev[1])
        moe.set_dispatch_groups(prev[2])


def run_combo(arch, shape_name, mesh_kind, out_dir: Path, force=False,
              policy="baseline", zero1=False, accum=1,
              padded_heads=False, chunked_local=False, grouped_dispatch=False):
    out_dir.mkdir(parents=True, exist_ok=True)
    parts = []
    if policy != "baseline":
        parts.append(policy.replace("-", ""))
    if zero1:
        parts.append("zero1")
    if accum != 1:
        parts.append(f"accum{accum}")
    if padded_heads:
        parts.append("padheads")
    if chunked_local:
        parts.append("chunkedlocal")
    if grouped_dispatch:
        parts.append("groupdisp")
    suffix = ("__" + "_".join(parts)) if parts else ""
    path = out_dir / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
    if path.exists() and not force:
        print(f"[skip-cached] {path.name}")
        return json.loads(path.read_text())
    reason = skip_reason(arch, shape_name)
    if reason:
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "skipped": reason}
        path.write_text(json.dumps(result, indent=2))
        print(f"[skipped] {arch} x {shape_name}: noted")
        return result
    print(f"[lower] {arch} x {shape_name} x {mesh_kind} ...", flush=True)
    try:
        result = lower_one(arch, shape_name, mesh_kind, unrolled=(mesh_kind == "single"),
                           policy=policy, zero1=zero1, accum=accum,
                           padded_heads=padded_heads, chunked_local=chunked_local,
                           grouped_dispatch=grouped_dispatch)
        print(
            f"[ok] {arch} x {shape_name} x {mesh_kind}: "
            f"passes {result['compile_seconds']}s, "
            f"bottleneck {result['roofline']['bottleneck']}",
            flush=True,
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        result = {
            "arch": arch,
            "shape": shape_name,
            "mesh": mesh_kind,
            "error": f"{type(e).__name__}: {e}"[:2000],
            "traceback": traceback.format_exc()[-4000:],
        }
        print(f"[FAIL] {arch} x {shape_name} x {mesh_kind}: {type(e).__name__}: {str(e)[:300]}", flush=True)
    path.write_text(json.dumps(result, indent=2))
    return result


def run_fl_round(mesh_kind: str, out_dir: Path, force=False, packed=False,
                 sizes: Tuple[int, int, int, int] = (65536, 54, 8, 100)):
    """Dry-run the paper's own workload: rank 0's SPMD AdaBoost.F round
    (``fl/sharded.py``) over the production mesh, its data fake tensors
    (``sizes``: local samples, features, classes, rounds — forestcover-
    scale shards by default)."""
    from repro_torch.core import boosting
    from repro_torch.fl.sharded import fl_shards, sharded_adaboost_round
    from repro_torch.learners import LearnerSpec, get_learner

    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "__packed" if packed else ""
    path = out_dir / f"mafl-adaboost-f__fl_round__{mesh_kind}{suffix}.json"
    if path.exists() and not force:
        print(f"[skip-cached] {path.name}")
        return json.loads(path.read_text())

    n, d, K, T = sizes
    lspec = LearnerSpec("decision_tree", d, K, {"depth": 4, "n_bins": 16})
    learner = get_learner("decision_tree")
    with make_production_mesh(multi_pod=(mesh_kind == "multi")) as mesh:
        C = fl_shards(mesh)
        cost, rec = roofline.DeviceCostMode(), roofline.CollectiveRecorder()
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            X = torch.empty((1, n, d), dtype=torch.float32)
            y = torch.zeros((1, n), dtype=torch.int32)
            m = torch.ones((1, n), dtype=torch.float32)
            state = boosting.init_boost_state(learner, lspec, T, m, X=X)
            with rec, cost:
                sharded_adaboost_round(learner, lspec, mesh, state, X, y, m, packed_broadcast=packed)
        t_pass = time.time() - t0
        coll = rec.stats()
        result = {
            "arch": "mafl-adaboost-f",
            "shape": "fl_round",
            "mesh": mesh_kind,
            "packed_broadcast": packed,
            "n_devices": mesh.size,
            "collaborators": C,
            "local_samples": n,
            "compile_seconds": round(t_pass, 1),
            "cost": {"flops_per_device": cost.flops, "bytes_per_device": float(cost.bytes_accessed),
                     "bytes_note": BYTES_NOTE},
            "collectives": coll.to_dict(),
            "roofline": roofline.roofline_terms(cost.flops, cost.bytes_accessed, coll.wire_bytes),
        }
    path.write_text(json.dumps(result, indent=2))
    print(f"[ok] MAFL fl_round x {mesh_kind}: {result['roofline']['bottleneck']}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fl-round", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--policy", default="baseline", choices=["baseline", "gather2d", "fsdp-gather"])
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--pad-heads", action="store_true")
    ap.add_argument("--chunked-local", action="store_true")
    ap.add_argument("--grouped-dispatch", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.fl_round:
        for mk in meshes:
            run_fl_round(mk, out_dir, force=args.force, packed=args.packed)
        return
    if args.all:
        for mk in meshes:
            for arch, shape_name, mesh_kind in combos(mk):
                run_combo(arch, shape_name, mesh_kind, out_dir, force=args.force)
            run_fl_round(mk, out_dir, force=args.force)
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all, or --fl-round)")
    for mk in meshes:
        run_combo(args.arch, args.shape, mk, out_dir, force=args.force,
                  policy=args.policy, zero1=args.zero1, accum=args.accum,
                  padded_heads=args.pad_heads, chunked_local=args.chunked_local,
                  grouped_dispatch=args.grouped_dispatch)


if __name__ == "__main__":
    main()
