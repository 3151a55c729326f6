"""Rehearse a cell's output check on a dozen seeds or more, and its
control on some of them, in one process (the model is built once; each
seed draws its weights into the same tensors).

  python3 -m gpubench.rehearse --workload <cell> --seeds 1-12 --control 1-3 [--seconds S]

For each seed: the cell's traffic for ``--seconds`` (default the mix's
``check.rehearse_seconds``: long enough to send its longest request),
then the check's readings of what the program served, its verdict under
the cell's limits and, for a ``--control`` seed, the readings of the
control (the reference in float8 e4m3 in the program's place) on the
same rows and the control's verdict under the same limits (it has to
come out not correct).  One JSON line a seed on standard output.  Limits
come from these readings (``limits/<cell>.json``); the benchmark's own
runs never run the control.  It runs on the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 5,9,1000000007")
    ap.add_argument("--control", default="", help="seeds that also run the control")
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    from gpubench import run as entry

    entry._environment()
    import torch

    from gpubench import bench, check, spec
    from gpubench.weights import Weights
    from repro_torch.models import model as M

    cell = spec.cell(args.workload, entry.ROOT)
    if not torch.cuda.is_available():
        print("gpubench.rehearse: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    seconds = args.seconds if args.seconds is not None else float(cell.traffic["check"]["rehearse_seconds"])
    control = set(_seeds(args.control))
    weights = Weights(cell.config, dev)
    model = None
    clock = bench._Clock(dev)
    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        weights.draw(seed)
        if model is None:
            model = bench.build(cell.config, weights)
        gen, traffic = bench.traffic_of(cell, seed, dev)
        torch.cuda.reset_peak_memory_stats()
        batches, window_s = gen.window(traffic, bench.sender(M, model, traffic, clock), clock.sync, seconds)
        peak = torch.cuda.max_memory_allocated()
        t1 = time.perf_counter()
        readings, ctrl, failed = bench.outputs_check(cell, weights, traffic, batches, seed, seed in control)
        ok, _ = check.verdict(readings, cell.limits["limits"], failed)
        ctrl_ok = check.verdict(ctrl, cell.limits["limits"], 0)[0] if ctrl is not None else None
        print(json.dumps({"seed": seed, "correct": ok, "control_correct": ctrl_ok, "program": readings,
                          "control": ctrl, "failed": failed,
                          "batches": len(batches), "rows": sum(b.rows for b in batches), "window_s": window_s,
                          "peak_bytes": peak, "check_s": time.perf_counter() - t1,
                          "seed_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
