#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py            # on a machine with one NVIDIA H100

Phases, each of which raises (non-zero exit) on failure:

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
3. hold every kernel to its plain PyTorch version on the card, at the main
   path's shapes (adult, letter, forestcover; C = 8, depth 4, 16 bins) and
   at ragged cases; time the kernel, its plain version and (where one
   exists) the one PyTorch call that computes the same function, each on
   the device alone (replayed from a CUDA graph), and the kernel wrapper's
   eager time per call;
4. run the port's federation through ``repro_torch.launch.fl_run`` on the
   card — adult 10 rounds with the default flags (the main path, with every
   kernel's launch count set to 0 just before), letter and forestcover 5
   rounds each — and check the launch counts and that no plain version ran
   on a CUDA tensor;
5. run the adult configuration on the CPU and compare it with the card's;
6. print ms/round on the card for each dataset, the adult round's ms per
   stage, and where the adult run's device time goes (``torch.profiler``).

The second-to-last line is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.  Without a card, or beside no copy of
the repo, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"  # run histories (--history-out)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
MAIN = {"dataset": "adult", "rounds": 10, "collaborators": 8, "depth": 4, "eval_every": 5}
SHAPES = {  # dataset: (n per collaborator, d, K) with C = 8
    "adult": (4070, 14, 2),
    "letter": (2000, 16, 26),
    "forestcover": (6250, 54, 2),
}
C, DEPTH, N_BINS = 8, 4, 16
DEV = "cuda"
TOL = {  # kernel: tolerance against its plain version on the card
    "tree_hist": {"atol": 1e-4, "rtol": 0.0},  # atomics reorder the sum
    "weighted_errors": {"atol": 0.0, "rtol": 1e-4},
    "weight_update": {"atol": 0.0, "rtol": 1e-5},
}
SOURCES = {
    "tree_hist": ("src/repro_torch/csrc/tree_hist.cu", "src/repro/kernels/tree_hist.py:88"),
    "weighted_errors": ("src/repro_torch/csrc/boost_update.cu", "src/repro/kernels/boost_update.py:51"),
    "weight_update": ("src/repro_torch/csrc/boost_update.cu", "src/repro/kernels/boost_update.py:86"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing and bounds ----------------------------------------------------------


def _events(torch):
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def eager_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time per call of ``fn`` called eagerly ``iters`` times, from
    CUDA events around the loop.  A call that launches less work than the
    host spends issuing it measures the host: this is the time a caller's
    loop sees."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = _events(torch)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(torch, fn, iters: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn`` in ms: ``iters`` calls captured
    in a CUDA graph, replayed ``reps`` times between CUDA events, so the
    host's launch overhead is out of the number.  Inputs stay in the 50 MB
    L2 between calls, as they do on the main path, where the producer of
    each input ran just before."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = _events(torch)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def timings(torch, kernel, plain, library=None) -> dict:
    """Device ms of the kernel, its plain version and the library call,
    and the kernel wrapper's eager ms per call."""
    return {
        "ms": cuda_ms(torch, kernel),
        "plain_ms": cuda_ms(torch, plain),
        "library_ms": cuda_ms(torch, library) if library is not None else None,
        "eager_ms": eager_ms(torch, kernel),
    }


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def assert_close(torch, name: str, got, want, what: str) -> float:
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name} {what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name} {what}: non-finite output")
    tol = TOL[name]
    ok = bool(torch.isclose(got, want, rtol=tol["rtol"], atol=tol["atol"]).all())
    err = max_err(got, want)
    check(ok, f"{name} {what}: max |kernel - plain| = {err:.3g} exceeds {tol}")
    return err


# -- phase 3: kernels against their plain versions --------------------------------


def hist_inputs(torch, g, H, n, d, L, K, dense=False, zero_tail=0):
    """Random bins, leaves and weighted labels.  Weights are scaled by
    L·(B+1)/n so that a histogram cell holds a mass of order 1, as the
    main path's globally normalised weights never exceed: the float32
    rounding of a cell then stays far below atol 1e-4, while one sample
    still moves its cell by far more than that."""
    bins = torch.randint(0, N_BINS + 1, (H, n, d), generator=g, dtype=torch.int32).to(DEV)
    leaf = torch.randint(0, L, (H, n), generator=g, dtype=torch.int32).to(DEV)
    w = torch.rand(H, n, K if dense else 1, generator=g) * (L * (N_BINS + 1) / n)
    if not dense:  # the main path's wy: a weighted one-hot of the labels
        y = torch.randint(0, K, (H, n), generator=g)
        w = torch.nn.functional.one_hot(y, K).float() * w
    if zero_tail:
        w[:, n - zero_tail:] = 0.0
    return bins, leaf, w.contiguous().to(DEV)


def check_tree_hist(torch, ops, ref, g):
    """Every level of the main path's fits at each dataset's shape, and
    ragged cases.  Returns ({dataset: record}, worst error); a dataset's
    times and bound are means per launch over one round's levels
    (L = 1, 2, 4, 8), each level also kept on its own."""
    results = {ds: {"levels": {}} for ds in SHAPES}
    cases = [(ds, C, n, d, K, L, False, 0) for ds, (n, d, K) in SHAPES.items() for L in (1, 2, 4, 8)]
    cases += [
        ("ragged", 33, 1001, 5, 3, 8, True, 0),  # n off any block, H = 33, d < dblk
        ("ragged", 3, 257, 19, 26, 8, True, 0),  # K = 26, d ragged against dblk
        ("ragged", 8, 777, 14, 2, 4, True, 100),  # zero-weight rows
        ("ragged", 1, 5, 3, 2, 1, True, 0),  # fewer samples than threads
    ]
    worst = 0.0
    for ds, H, n, d, K, L, dense, tail in cases:
        bins, leaf, wy = hist_inputs(torch, g, H, n, d, L, K, dense, tail)
        got = ops.tree_hist(bins, leaf, wy, n_leaves=L, n_bins_p1=N_BINS + 1)
        want = ref.tree_hist_batched_ref(bins, leaf, wy, L, N_BINS + 1)
        err = assert_close(torch, "tree_hist", got, want, f"{ds} H={H} n={n} d={d} K={K} L={L}")
        worst = max(worst, err)
        if tail:
            trimmed = ref.tree_hist_batched_ref(
                bins[:, : n - tail].contiguous(), leaf[:, : n - tail].contiguous(),
                wy[:, : n - tail].contiguous(), L, N_BINS + 1,
            )
            assert_close(torch, "tree_hist", got, trimmed, "zero-weight rows dropped")
        if ds in SHAPES:
            B1 = N_BINS + 1
            seg = ((torch.arange(H, device=DEV).view(H, 1, 1) * L + leaf.long().unsqueeze(-1)) * d
                   + torch.arange(d, device=DEV).view(1, 1, d)) * B1 + bins.long()
            seg = seg.reshape(-1)
            vals = wy.unsqueeze(2).expand(H, n, d, K).reshape(-1, K).contiguous()
            buf = torch.zeros(H * L * d * B1, K, device=DEV)
            nbytes = 4 * (H * n * d + H * n + H * n * K + H * L * d * B1 * K)
            ops_ = d * int((wy != 0).sum())  # one add per nonzero (sample, class) per feature
            bms, by = bound_ms(nbytes, ops_)
            results[ds]["levels"][L] = {
                "max_abs_err": err, "bound_ms": bms, "bound_by": by,
                **timings(torch,
                          lambda: ops.tree_hist(bins, leaf, wy, n_leaves=L, n_bins_p1=B1),
                          lambda: ref.tree_hist_batched_ref(bins, leaf, wy, L, B1),
                          lambda: buf.index_add_(0, seg, vals)),
            }
    for ds, (n, d, K) in SHAPES.items():
        levels = results[ds]["levels"]
        mean = {k: sum(v[k] for v in levels.values()) / len(levels)
                for k in ("ms", "plain_ms", "library_ms", "eager_ms", "bound_ms")}
        results[ds].update(mean, shape=f"bin_idx [{C}, {n}, {d}], L=1,2,4,8, K={K}",
                           max_abs_err=max(v["max_abs_err"] for v in levels.values()),
                           bound_by=levels[2**(DEPTH - 1)]["bound_by"])
    log(f"tree_hist: {len(cases)} cases agree, worst max_abs_err {worst:.3g}")
    return results, worst


def check_weighted_errors(torch, ops, ref, g):
    results, worst = {}, 0.0
    cases = [(ds, C, C, n, K) for ds, (n, _, K) in SHAPES.items()]
    cases += [("ragged", 4, 33, 4097, 5), ("ragged", 8, 8, 1, 2), ("ragged", 2, 3, 100, 26)]
    for ds, Cc, H, n, K in cases:
        preds = torch.randint(0, K, (Cc, H, n), generator=g, dtype=torch.int32).to(DEV)
        y = torch.randint(0, K, (Cc, n), generator=g, dtype=torch.int32).to(DEV)
        w = torch.rand(Cc, n, generator=g)
        w[0] = 0.0  # a zero-weight shard
        w = (w / w.sum()).to(DEV)
        got = ops.weighted_errors(preds, y, w)
        want = ref.weighted_errors_ref(preds, y, w)
        err = assert_close(torch, "weighted_errors", got, want, f"{ds} [{Cc}, {H}, {n}]")
        check(float(got[0].abs().max()) == 0.0, "weighted_errors: zero-weight shard is not 0")
        worst = max(worst, err)
        if ds in SHAPES:
            nbytes = 4 * (Cc * H * n + 2 * Cc * n + Cc * H)
            bms, by = bound_ms(nbytes, 2 * Cc * H * n)
            # no single PyTorch call computes a masked weighted row sum: no library time
            results[ds] = {
                "shape": f"preds [{Cc}, {H}, {n}]", "max_abs_err": err,
                "bound_ms": bms, "bound_by": by,
                **timings(torch, lambda: ops.weighted_errors(preds, y, w),
                          lambda: ref.weighted_errors_ref(preds, y, w)),
            }
    log(f"weighted_errors: {len(cases)} cases agree, worst max_abs_err {worst:.3g}")
    return results, worst


def check_weight_update(torch, ops, ref, g):
    results, worst = {}, 0.0
    cases = [(ds, C * n) for ds, (n, _, _) in SHAPES.items()] + [("ragged", 4097), ("ragged", 1)]
    for ds, N in cases:
        w = (torch.rand(N, generator=g) / N).to(DEV)
        mis = (torch.rand(N, generator=g) < 0.3).float().to(DEV)
        mask = torch.ones(N)
        mask[-3:] = 0.0
        mask = mask.to(DEV)
        for a in (0.37, -2.0, 10.0):
            alpha = torch.tensor(a, device=DEV)
            got = ops.weight_update(w, mis, mask, alpha)
            want = ref.boost_weight_update_ref(w, mis, mask, alpha)
            err = assert_close(torch, "weight_update", got, want, f"{ds} N={N} alpha={a}")
            worst = max(worst, err)
        if ds in SHAPES:
            alpha = torch.tensor(0.37, device=DEV)
            bms, by = bound_ms(4 * (4 * N + 1), 4 * N)
            # no single PyTorch call computes w * exp(a * mis) * mask: no library time
            results[ds] = {
                "shape": f"w [{N}]", "max_abs_err": err, "bound_ms": bms, "bound_by": by,
                **timings(torch, lambda: ops.weight_update(w, mis, mask, alpha),
                          lambda: ref.boost_weight_update_ref(w, mis, mask, alpha)),
            }
    log(f"weight_update: {len(cases) * 3} cases agree, worst max_abs_err {worst:.3g}")
    return results, worst


# -- phases 4-6: the federation ---------------------------------------------------


def run_fl(fl_run, dataset: str, rounds: int, device: str, tag: str) -> dict:
    """One ``fl_run`` invocation as a user would make it; returns its
    history file (history rows + every round's metrics)."""
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"chip_smoke_{tag}.json"
    argv = ["--dataset", dataset, "--rounds", str(rounds), "--collaborators", str(C),
            "--depth", str(DEPTH), "--eval-every", str(MAIN["eval_every"]), "--seed", "0",
            "--device", device, "--history-out", str(path)]
    log(f"$ python -m repro_torch.launch.fl_run {' '.join(argv)}")
    fl_run.main(argv)
    return json.loads(path.read_text())


def check_run(run: dict, rounds: int, what: str) -> None:
    check(len(run["rounds"]) == rounds, f"{what}: {len(run['rounds'])} rounds recorded, not {rounds}")
    f1 = run["history"][-1]["f1"]
    check(0.0 < f1 <= 1.0, f"{what}: final F1 {f1} outside (0, 1]")
    for r in run["rounds"]:
        check(0 <= r["chosen"] < C, f"{what}: chosen {r['chosen']} out of range")
        check(0.0 <= r["epsilon"] <= 1.0, f"{what}: epsilon {r['epsilon']} outside [0, 1]")
        check(abs(r["alpha"]) <= 10.0, f"{what}: alpha {r['alpha']} outside [-10, 10]")


def stage_breakdown(torch, fl_run, card: str) -> None:
    """Host ms of each stage of the adult round (fit, score, aggregate),
    each ended by a device sync, averaged over rounds 5-9."""
    from repro_torch.core import boosting

    fed = fl_run.build_federation("adult", C, MAIN["rounds"], DEPTH, 0, DEV)
    state = boosting.init_boost_state(fed.learner, fed.spec, MAIN["rounds"], fed.masks, X=fed.Xs)
    stages = boosting.adaboost_f_stages(fed.learner, fed.spec)
    ms = {name: 0.0 for name, _ in stages}
    steady = range(MAIN["rounds"] // 2, MAIN["rounds"])
    for r in range(MAIN["rounds"]):
        carry = {}
        for name, fn in stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, carry = fn(state, carry, fed.Xs, fed.ys, fed.masks)
            torch.cuda.synchronize()
            if r in steady:
                ms[name] += 1e3 * (time.perf_counter() - t0) / len(steady)
    log(f"stage ms/round (adult, rounds 5-9, synced per stage, {card}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))


def profile_round(torch, fl_run, card: str) -> None:
    """Device time by kernel and the device's busy share over the adult
    main path's rounds (set-up excluded), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fed = fl_run.build_federation("adult", C, MAIN["rounds"], DEPTH, 0, DEV)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fed.run(eval_every=MAIN["eval_every"])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = [(e.key, e.count, getattr(e, "device_time_total", None) or e.cuda_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    if not busy_us:
        log(f"profile: torch.profiler recorded no device time on {card}; busy share not measured")
        return
    log(f"profile (adult, {MAIN['rounds']} rounds incl. binning and 2 evals, profiler on, {card}): "
        f"wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {sum(r[1] for r in rows)} device activities")
    for key, count, us in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:110]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from a "
              "checkout of the repo", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch import fl_run

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  device {kind}  "
        f"count {torch.cuda.device_count()}  python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    log(f"kernels: {_build.library_path().relative_to(ROOT)} "
        f"({'built in %.1fs' % built if built is not None else 'reused'}, "
        f"load {time.perf_counter() - t0:.1f}s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas " + line.split("ptxas info    :")[-1].strip())

    # 3. kernels against their plain versions
    g = torch.Generator().manual_seed(0)
    per_kernel = {
        "tree_hist": check_tree_hist(torch, ops, ref, g),
        "weighted_errors": check_weighted_errors(torch, ops, ref, g),
        "weight_update": check_weight_update(torch, ops, ref, g),
    }
    detail = {k: v[0] for k, v in per_kernel.items()}
    log("kernel_detail " + json.dumps({"card": card, "kernels": detail}))

    # 4. the federation on the card; the adult run is the main path
    ops.reset_launches()
    device_calls = dict(ref.device_calls)
    t0 = time.perf_counter()
    main_run = run_fl(fl_run, "adult", MAIN["rounds"], "cuda", "adult_cuda")
    main_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    want = {"tree_hist": MAIN["rounds"] * DEPTH, "weighted_errors": MAIN["rounds"],
            "weight_update": MAIN["rounds"]}
    check(launches == want, f"main path launches {launches} != {want}")
    check(ref.device_calls == device_calls,
          f"a plain version ran on CUDA tensors in the main path: {ref.device_calls}")
    check_run(main_run, MAIN["rounds"], "adult on the card")
    log(f"main path launches {launches}")

    for ds in ("letter", "forestcover"):
        ops.reset_launches()
        run = run_fl(fl_run, ds, 5, "cuda", f"{ds}_cuda")
        got = ops.launch_counts()
        check(got == {"tree_hist": 5 * DEPTH, "weighted_errors": 5, "weight_update": 5},
              f"{ds} launches {got}")
        check(ref.device_calls == device_calls, f"{ds}: a plain version ran on CUDA tensors")
        check_run(run, 5, f"{ds} on the card")
        log(f"{ds}: final F1 {run['history'][-1]['f1']:.4f}, launches {got}")

    # 5. the same adult configuration on the CPU (the plain versions)
    cpu_run = run_fl(fl_run, "adult", MAIN["rounds"], "cpu", "adult_cpu")
    check_run(cpu_run, MAIN["rounds"], "adult on the CPU")
    g0, c0 = main_run["rounds"][0], cpu_run["rounds"][0]
    check(g0["chosen"] == c0["chosen"], f"round 0 chosen: card {g0['chosen']} vs CPU {c0['chosen']}")
    check(abs(g0["epsilon"] - c0["epsilon"]) <= 1e-4 * abs(c0["epsilon"]),
          f"round 0 epsilon: card {g0['epsilon']} vs CPU {c0['epsilon']}")
    f1_gpu, f1_cpu = main_run["history"][-1]["f1"], cpu_run["history"][-1]["f1"]
    check(abs(f1_gpu - f1_cpu) <= 0.02, f"final F1: card {f1_gpu} vs CPU {f1_cpu}")
    agree = sum(a["chosen"] == b["chosen"] for a, b in zip(main_run["rounds"], cpu_run["rounds"]))
    log(f"card vs CPU: chosen agrees in {agree}/{MAIN['rounds']} rounds; "
        f"final F1 {f1_gpu:.4f} vs {f1_cpu:.4f}")

    # 6. ms/round on the card: rounds 5-9 of a 10-round run per dataset
    # (library loaded, allocator warm), host clock up to the eval's sync at
    # round 9, so one eval is included; then where a round's device time
    # goes, from torch.profiler over another adult run
    ms_round = {}
    for ds in SHAPES:
        timed = run_fl(fl_run, ds, MAIN["rounds"], "cuda", f"{ds}_cuda_timed")
        ms_round[ds] = 1e3 * timed["history"][-1]["round_seconds"]
    log(f"ms/round (rounds 5-9, one eval) on {card}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms_round.items())
        + f"; first adult run, set-up and warm-up included: {1e3 * main_s / MAIN['rounds']:.3f}")
    stage_breakdown(torch, fl_run, card)
    profile_round(torch, fl_run, card)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f}s")

    kernels = []
    for name, (res, worst) in per_kernel.items():
        src, replaces = SOURCES[name]
        main_shape = res["adult"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "launches_per_round": launches[name] / MAIN["rounds"],
            "max_abs_err": worst, "max_err": worst,
            "ms": main_shape["ms"], "kernel_ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": main_shape["library_ms"],
            "eager_ms": main_shape["eager_ms"], "shape": main_shape["shape"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
