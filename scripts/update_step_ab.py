#!/usr/bin/env python3
"""Time the AdaBoost.F weight update of a ``repro_torch`` tree on the card,
and count the host operations of an adult round, so that two trees can be
compared in one call:

  python3 scripts/update_step_ab.py --src src            # this checkout
  python3 scripts/update_step_ab.py --src /path/to/other/src

``--src`` is the directory that holds the ``repro_torch`` package to
measure; the timing and counting helpers come from this checkout's
``chip_smoke.py``.  For each N (adult, letter and forestcover at 8
collaborators, adult at 64) it times ``core.scoring.update_weights`` on
``[C, n]`` weights, as a round calls it: device ms per call (a CUDA graph
of 20 calls replayed between CUDA events) and eager ms per call, and
counts the host operations of one call.  It then counts the host
operations of one steady adult round.  It prints the card's name and power
limit and one JSON line, and exits non-zero without a card.  Run the two
trees in turns (A, B, B, A) in one call: times from two calls may come
from two cards.

``--clusters 4,8,16`` also times this checkout's fused ``weight_update``
kernel at each N with each cluster size (its C entry called directly,
threads as ``update_plan`` sizes them), the evidence for the plan's
cluster of 16.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
UPDATE = {"adult": (8, 4070), "letter": (8, 2000), "forestcover": (8, 6250), "adult_64": (64, 4070)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    ap.add_argument("--clusters", default="", help="comma-separated cluster sizes to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("update_step_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import scoring
    from repro_torch.kernels import ops
    from repro_torch.launch import fl_run

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    g = torch.Generator().manual_seed(0)
    rows = {}
    for name, (C, n) in UPDATE.items():
        w = torch.rand(C, n, generator=g)
        w = (w / w.sum()).to(cs.DEV)
        mis = (torch.rand(C, n, generator=g) < 0.3).float().to(cs.DEV)
        mask = torch.ones(C, n, device=cs.DEV)
        alpha = torch.tensor(0.37, device=cs.DEV)
        step = lambda: scoring.update_weights(w, mis, mask, alpha)  # noqa: E731
        rows[name] = {"N": C * n, "device_ms": cs.cuda_ms(torch, step), "eager_ms": cs.eager_ms(torch, step),
                      "host_ops": cs.host_ops(torch, ops, step)["host_ops"]}
    for c in (int(x) for x in args.clusters.split(",") if x):
        for name, row in rows.items():
            row[f"kernel_ms_cluster_{c}"] = cluster_ms(torch, cs, row["N"], c)
    counted = cs.round_host_ops(torch, ops, fl_run)
    print(json.dumps({"src": str(Path(args.src).resolve()), "card": card, "update_weights": rows,
                      "round_host_ops": counted["round"]["host_ops"],
                      "round_torch_ops": counted["round"]["torch_ops"],
                      "round_kernel_launches": counted["round"]["kernel_launches"]}), flush=True)
    return 0


def cluster_ms(torch, cs, N: int, clusters: int) -> float:
    """Device ms of one fused ``weight_update`` launch over N elements as
    one cluster of ``clusters`` CTAs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.boost_update import _cta_threads

    g = torch.Generator().manual_seed(N)
    w, mis = torch.rand(N, generator=g).to(cs.DEV), (torch.rand(N, generator=g) < 0.3).float().to(cs.DEV)
    mask, out = torch.ones(N, device=cs.DEV), torch.empty(N, device=cs.DEV)
    alpha = torch.tensor([0.37], device=cs.DEV)
    lib, threads = _build.library(), _cta_threads(N, clusters)

    def launch():
        _build.check(lib.repro_weight_update(
            w.data_ptr(), mis.data_ptr(), mask.data_ptr(), alpha.data_ptr(), out.data_ptr(), N,
            clusters, threads, torch.cuda.current_stream().cuda_stream), "weight_update")

    return cs.cuda_ms(torch, launch)


if __name__ == "__main__":
    sys.exit(main())
