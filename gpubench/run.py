"""Run one cell of ``BENCHMARK.json`` once and print its result line.

  python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, the device's busy and window seconds and a breakdown,
from a profile of the window.  The last lines on standard error and the
result's last key, ``checks``, give each number the output check compared
beside its limit.  Exits 2 without a result when the cell's cards are not
there, 3 when JAX, flax or the JAX package ``repro`` was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def _environment() -> None:
    """The program's package on the path, and every compiler cache at a
    fixed directory inside the checkout (the port's own kernels build into
    ``build/repro_torch/``, ``repro_torch/kernels/_build.py``)."""
    caches = ROOT / "build" / "gpubench"
    os.environ["TRITON_CACHE_DIR"] = str(caches / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(caches / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(caches / "cuda")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT / "src"))


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded modules)."""
    return sorted({name.split(".")[0] for name in (sys.modules if names is None else names)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from gpubench import spec

    cell = spec.cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from gpubench import bench

    line, _, readings = bench.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {found}", file=sys.stderr)
        return 3
    print("readings " + json.dumps(readings), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
