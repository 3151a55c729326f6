#!/usr/bin/env python3
"""Time the ``weighted_errors`` kernel of a ``repro_torch`` tree on the card
at AdaBoost.F's and PreWeak.F's shapes, so that two trees can be compared
in one call:

  python3 scripts/errors_ab.py --src src            # this checkout
  python3 scripts/errors_ab.py --src /path/to/other/src

``--src`` is the directory that holds the ``repro_torch`` package to
measure; the timing helpers come from this checkout's ``chip_smoke.py``.
At each shape (AdaBoost.F's H = C rows at adult, letter and forestcover
with C = 8 and at adult with 64 collaborators; PreWeak.F's at adult, C = 8,
T = 10 and 100; and ``[4, 12800, 2000]``, past the 11 776 rows a kernel
with a per-row total in shared memory could hold) it checks the kernel
against its plain version (rtol 1e-4) and the same bits from two calls,
then times it: device
ms per call (a CUDA graph of 20 calls replayed between CUDA events) beside
the bound (bytes over 3.35 TB/s).  A launch the tree refuses is recorded as
such.  It prints the card's name and power limit and one JSON line, and
exits non-zero without a card.  Run the two trees in turns (A, B, B, A) in
one call: times from two calls may come from two cards.

``--plans cs:rows,...`` also times this checkout's kernel at each shape
with each launch plan (its C entry called directly: clusters of ``cs``
CTAs, ``rows`` rows a CTA), the evidence for the plan ``errors_plan``
picks.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {"adaboost_adult": (8, 8, 4070), "adaboost_letter": (8, 8, 2000),
          "adaboost_forestcover": (8, 8, 6250), "adaboost_adult_64": (64, 64, 509),
          "preweak_t10": (8, 80, 4070), "preweak_t100": (8, 800, 4070),
          "past_cap": (4, 12800, 2000)}


def inputs(torch, dev, C: int, H: int, n: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    preds = torch.randint(0, 2, (C, H, n), generator=g, dtype=torch.int32).to(dev)
    y = torch.randint(0, 2, (C, n), generator=g, dtype=torch.int32).to(dev)
    w = torch.rand(C, n, generator=g)
    return preds, y, (w / w.sum()).to(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    ap.add_argument("--plans", default="", help="comma-separated cs:rows launch plans to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("errors_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = {}
    for name, (C, H, n) in SHAPES.items():
        preds, y, w = inputs(torch, cs.DEV, C, H, n)
        bound, _ = cs.bound_ms(4 * (C * H * n + 2 * C * n + C * H), 2 * C * H * n)
        row = {"shape": [C, H, n], "bound_ms": bound}
        try:
            got = ops.weighted_errors(preds, y, w)
            torch.cuda.synchronize()
        except RuntimeError as e:  # this tree's kernel does not take the shape
            row["refused"] = str(e)[:200]
            rows[name] = row
            del preds
            continue
        want = ref.weighted_errors_ref(preds, y, w)
        row["max_rel_err"] = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        row["ok"] = bool(torch.isclose(got, want, rtol=1e-4, atol=0.0).all())
        row["same_bits"] = bool(torch.equal(got, ops.weighted_errors(preds, y, w)))
        row["ms"] = cs.cuda_ms(torch, lambda: ops.weighted_errors(preds, y, w))
        for plan in (p for p in args.plans.split(",") if p):
            row[f"ms_plan_{plan}"] = plan_ms(torch, cs, preds, y, w, *map(int, plan.split(":")))
        rows[name] = row
        del preds, want
    print(json.dumps({"src": str(Path(args.src).resolve()), "card": card, "weighted_errors": rows}),
          flush=True)
    return 0


def plan_ms(torch, cs, preds, y, w, clusters: int, rows: int) -> float:
    """Device ms of one ``weighted_errors`` launch with the given plan."""
    from repro_torch.kernels import _build

    C, H, n = preds.shape
    out = torch.empty(C, H, device=cs.DEV)
    lib = _build.library()

    def launch():
        _build.check(lib.repro_weighted_errors(
            preds.data_ptr(), y.data_ptr(), w.data_ptr(), out.data_ptr(), C, H, n, clusters, rows,
            torch.cuda.current_stream().cuda_stream), "weighted_errors")

    return cs.cuda_ms(torch, launch)


if __name__ == "__main__":
    sys.exit(main())
