#!/usr/bin/env python3
"""Time the float32 ``flash_attention`` kernel of a ``repro_torch`` tree on
the card at the shapes the float32 route serves, so that two trees can be
compared in one call:

  python3 scripts/flash_f32_ab.py --src src            # this checkout
  python3 scripts/flash_f32_ab.py --src /path/to/other/src

``--src`` is the directory that holds the ``repro_torch`` package to
measure; the timing helpers come from this checkout's ``chip_smoke.py``.
The shapes: whisper-large-v3's encoder (``q``/``k``/``v [4, 20, 1500, 64]``,
non-causal) and cross-attention (``q [4, 20, 64, 64]`` against 1500 keys),
``chip_smoke.py``'s ``ragged`` case (``[1, 2, 100, 64]``, causal) and a
D = 256 causal prefill (gemma-2b's heads, ``q [1, 8, 2048, 256]`` over one
KV head).  At each shape it checks the kernel against its plain version
(``ref.attention_ref``, atol 2e-5), the same bits from a second call and
from a CUDA-graph replay, then times it: device ms per call (a CUDA graph
of 20 calls replayed between CUDA events) beside the plain version's and
float32 SDPA's, and both bounds (q, k, v and o moved once over 3.35 TB/s
against 3 x 4·D operations per visible pair over 495 TFLOP/s of TF32, or
4·D over 67 TFLOP/s of float32 on the CUDA cores).  Where the tree has
one, it prints the launch plan the kernel takes.  It prints the card's
name and power limit and one JSON line, and exits non-zero without a card
or when a tree disagrees with the plain version.  Run the two trees in
turns (A, B, B, A) in one call: times from two calls may come from two
cards.

``--whisper N`` also serves whisper-large-v3 whole (``chip_smoke.py``'s
``FRONTEND_ARCHS``, random weights from seed 0, bf16 with float32 frames
as ``launch.serve`` draws them): one prefill to warm up, then N prefills
of a 4 x 64 prompt after 1500 frames, each timed on the host clock (ended
by a synchronize), then one more under ``torch.profiler``: the device
time of each kernel family (the float32 and bf16 ``flash_attention``
routes, GEMMs, the rest) and the device's busy share of the wall.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {  # B, H, Hkv, S, T, D, causal
    "whisper_encoder_1500": (4, 20, 20, 1500, 1500, 64, False),
    "whisper_cross_64x1500": (4, 20, 20, 64, 1500, 64, False),
    "ragged": (1, 2, 2, 100, 100, 64, True),
    "d256_2048": (1, 8, 1, 2048, 2048, 256, True),
}
ATOL = 2e-5  # chip_smoke.py's TOL["flash_attention"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    ap.add_argument("--whisper", type=int, default=0, help="timed whisper-large-v3 prefills (0: none)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_f32_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.library()
    ptxas = {e: i for e, i in cs.ptxas_report(_build.build_log).items()
             if "flash_attention" in e and "sm90" not in e}
    rows, ok = {}, True
    for name, (B, H, Hkv, S, T, D, causal) in SHAPES.items():
        g = torch.Generator().manual_seed(S + T + D)
        q, k, v = (torch.randn(shape, generator=g).to(cs.DEV)
                   for shape in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))
        kernel = lambda: ops.flash_attention(q, k, v, causal=causal)
        plain = lambda: ref.attention_ref(q, k, v, causal=causal)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = cs.max_err(got, want)
        pairs = cs.visible_pairs(S, T, causal, None)
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        row = {
            "shape": [B, H, Hkv, S, T, D, causal], "max_abs_err": err,
            "ok": bool(torch.isfinite(got).all()) and err <= ATOL,
            "same_bits": bool(torch.equal(got, kernel())),
            "graph_replay_same_bits": cs.graph_bits(torch, kernel),
            "ms": cs.cuda_ms(torch, kernel), "plain_ms": cs.cuda_ms(torch, plain),
            "sdpa_ms": cs.cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)),
            "bound_3xtf32_ms": cs.bound_ms(nbytes, 3 * 4 * D * B * H * pairs, cs.TF32_OPS_PER_S),
            "bound_cuda_cores_ms": cs.bound_ms(nbytes, 4 * D * B * H * pairs, cs.F32_OPS_PER_S),
        }
        if hasattr(fa, "kernel_f32_plan"):
            row["plan"] = list(fa.kernel_f32_plan(B, H, Hkv, S, T, D, causal, None))
        ok &= row["ok"] and row["same_bits"] and row["graph_replay_same_bits"]
        rows[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    record = {"src": str(Path(args.src).resolve()), "card": card, "ptxas": ptxas, "flash_f32": rows}
    if args.whisper:
        record["whisper_prefill"] = whisper_prefill(torch, cs, args.whisper)
        print(f"whisper_prefill: {json.dumps(record['whisper_prefill'])}", flush=True)
    print(json.dumps(record), flush=True)
    return 0 if ok else 2


def family(kernel: str) -> str:
    """The kernel family a device activity's name belongs to."""
    if "flash_attention" in kernel:
        return "flash_attention_bf16" if "sm90" in kernel else "flash_attention_f32"
    return "gemm" if any(k in kernel.lower() for k in ("gemm", "xmma", "cutlass")) else "other"


def whisper_prefill(torch, cs, n: int, B: int = 4, S: int = 64) -> dict:
    """Host ms of ``n`` warm prefills of whisper-large-v3 whole, and one
    profiled prefill's device ms by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = ArchConfig(**cs.FRONTEND_ARCHS["whisper"])
    model = serve.build(cfg, 0, torch.device(cs.DEV))
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1)).to(cs.DEV)
    batch = {"tokens": tok, **serve.front_end_inputs(cfg, B, torch.Generator(device=cs.DEV).manual_seed(2))}
    M.prefill(model, batch, cache_len=S)
    host_ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.prefill(model, batch, cache_len=S)
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        M.prefill(model, batch, cache_len=S)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_family = {}
    for e in prof.key_averages():
        if cs.is_kernel(e, DeviceType):
            ms = (getattr(e, "device_time_total", None) or e.cuda_time_total) / 1e3
            fam = by_family.setdefault(family(e.key), {"ms": 0.0, "launches": 0})
            fam["ms"] += ms
            fam["launches"] += e.count
    busy = sum(f["ms"] for f in by_family.values())
    return {"shape": f"{B} x {S} after {cfg.encoder_seq} frames", "host_ms": host_ms,
            "median_host_ms": statistics.median(host_ms), "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy, "busy_share": busy / wall_ms if wall_ms else None,
            "device_ms_by_family": by_family}


if __name__ == "__main__":
    sys.exit(main())
