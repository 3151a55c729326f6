#!/usr/bin/env python3
"""Time the bfloat16 ``flash_attention`` route of a ``repro_torch`` tree on
the card at the D = 128 prefill shapes it serves, so that two trees can be
compared in one call:

  python3 scripts/flash_bf16_ab.py --src src            # this checkout
  python3 scripts/flash_bf16_ab.py --src /path/to/other/src
  python3 scripts/flash_bf16_ab.py --src src --prefill gemma2-27b --n 5

``--src`` is the directory that holds the ``repro_torch`` package to
measure; the timing helpers come from this checkout's ``chip_smoke.py``.
The rows: grok-1's layers (``q [1, 48, 8192, 128]`` over 8 KV heads, causal,
softcap 30), llama4-scout's chunked-local (window 8192) and global layers
(``[1, 40, 16384, 128]`` over 8), gemma2-27b's local (window 4096) and
global layers (``[1, 32, 8192, 128]`` over 16, softcap 50) and internvl2-26b's
(``[4, 48, 1088, 128]`` over 8, causal); then, as guards, the bf16 D = 64
rows (whisper-large-v3's encoder, cross- and self-attention) and the
D = 256 rows (gemma-2b at 64, 2048 and 8192 tokens).  At each row it checks
the kernel against its plain version (a KV head's group at a time, within
``chip_smoke.TOL["flash_attention_bf16"]``, the worst share of the limit
logged), the same bits from a second call and from a CUDA-graph replay,
then times it: device ms per call (a CUDA graph of calls replayed between
CUDA events) beside the bound (4·D flops per visible pair over 989 TFLOP/s,
against q, k, v and o moved once over 3.35 TB/s) and SDPA's ms (causal or
non-causal with ``enable_gqa``; at a window, K/V expanded to the query
heads and the window as a boolean mask on the memory-efficient backend; at
a softcap without it, since SDPA has no score modifier).  At the softcap
rows it also times ``torch.nn.attention.flex_attention`` compiled, with the
softcap as a ``score_mod`` and the causal or window mask as a block mask:
the same function, as a library computes it (the port never calls it); a
compile error is recorded instead of a time.  It prints the card's name and
power limit, the plan each row takes where the tree has one, and one JSON
line; it exits non-zero without a card or when a row disagrees.

``--prefill ARCH`` instead serves a whole prefill: llama4-scout-17b-a16e at
``chip_smoke.py`` phase 16's cut (4 of 48 layers, 1 x 16 384) or
gemma2-27b at phase 18's (all 46 layers, 1 x 8192), random bf16 weights from
seed 0: one prefill to warm up, ``--n`` prefills each timed on the host
clock and ended by a synchronize, then one under ``torch.profiler``: the
device time of ``flash_attention``, of the GEMMs and of the rest, the busy
share of the wall, and the kernel's launches a prefill.  Run each model in
its own process (gemma2-27b peaks at 57.74 GiB), and the two trees in turns
(A, B, B, A) in one call: times from two calls may come from two cards.
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
ROWS = {  # B, H, Hkv, S, T, D, causal, window, softcap
    "grok_8192_softcap": (1, 48, 8, 8192, 8192, 128, True, None, 30.0),
    "llama4_window_16384": (1, 40, 8, 16384, 16384, 128, True, 8192, None),
    "llama4_16384": (1, 40, 8, 16384, 16384, 128, True, None, None),
    "gemma2_window_8192_softcap": (1, 32, 16, 8192, 8192, 128, True, 4096, 50.0),
    "gemma2_8192_softcap": (1, 32, 16, 8192, 8192, 128, True, None, 50.0),
    "internvl2_1088": (4, 48, 8, 1088, 1088, 128, True, None, None),
    # guards: the other head dims of the bf16 route
    "whisper_encoder_1500": (4, 20, 20, 1500, 1500, 64, False, None, None),
    "whisper_cross_64x1500": (4, 20, 20, 64, 1500, 64, False, None, None),
    "whisper_self_64": (4, 20, 20, 64, 64, 64, True, None, None),
    "gemma_serve": (4, 8, 1, 64, 64, 256, True, None, None),
    "gemma_2048": (1, 8, 1, 2048, 2048, 256, True, None, None),
    "gemma_window_8192": (1, 8, 1, 8192, 8192, 256, True, 4096, None),
    "gemma_8192": (1, 8, 1, 8192, 8192, 256, True, None, None),
}
PREFILLS = {  # arch: (layers, batch, prompt); None: all of its layers
    "llama4-scout-17b-a16e": (4, 1, 16384),
    "gemma2-27b": (None, 1, 8192),
}


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    ap.add_argument("--prefill", choices=sorted(PREFILLS), help="time this model's prefill instead")
    ap.add_argument("--n", type=int, default=5, help="timed prefills")
    ap.add_argument("--no-flex", action="store_true", help="skip flex_attention at the softcap rows")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("flash_bf16_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    card = card_name()
    print(card, flush=True)
    _build.library()
    record = {"src": str(Path(args.src).resolve()), "card": card}
    if args.prefill:
        record["prefill"] = prefill(torch, cs, args.prefill, args.n)
        print(json.dumps(record), flush=True)
        return 0
    record["ptxas"] = {e: i for e, i in cs.ptxas_report(_build.build_log).items() if "sm90" in e}
    rows, ok = {}, True
    for name, shape in ROWS.items():
        row = kernel_row(torch, cs, name, *shape, flex=not args.no_flex)
        ok &= row["ok"] and row["same_bits"] and row["graph_replay_same_bits"]
        rows[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
        torch.cuda.empty_cache()
    record["flash_bf16"] = rows
    print(json.dumps(record), flush=True)
    return 0 if ok else 2


def kernel_row(torch, cs, name, B, H, Hkv, S, T, D, causal, window, softcap, flex=True) -> dict:
    """One row: the kernel against the plain version, its bits twice and
    from a graph replay, its device ms, the bound, SDPA's and flex_attention's ms."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(S + T + D)
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16).to(cs.DEV)
               for shape in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    kw = {"causal": causal, "window": window, "softcap": softcap}
    kernel = lambda: ops.flash_attention(q, k, v, **kw)
    got = kernel()
    want = cs.grouped_attention_ref(torch, ref, q, k, v, **kw).float()
    torch.cuda.synchronize()
    tol = cs.TOL["flash_attention_bf16"]
    use = float(((got.float() - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())
    err = cs.max_err(got.float(), want)
    del want
    pairs = cs.visible_pairs(S, T, causal, window)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound, by = cs.bound_ms(nbytes, 4 * D * B * H * pairs, cs.BF16_OPS_PER_S)
    big = S * T * H > 1 << 30
    iters, reps = (5, 3) if big else (20, 10)
    ms = cs.cuda_ms(torch, kernel, iters=iters, reps=reps)
    row = {
        "shape": [B, H, Hkv, S, T, D, causal, window, softcap], "max_abs_err": err, "use_of_limit": use,
        "ok": bool(torch.isfinite(got).all()) and use <= 1.0,
        "same_bits": bool(torch.equal(got, kernel())),
        "graph_replay_same_bits": cs.graph_bits(torch, kernel),
        "ms": ms, "tflops": 4 * D * B * H * pairs / ms / 1e9, "bound_ms": bound, "bound_by": by,
    }
    del got
    if window:
        i = torch.arange(S, device=cs.DEV)[:, None] + (T - S)
        j = torch.arange(T, device=cs.DEV)[None, :]
        mask = (j <= i) & (i - j < window)
        ke, ve = (x.repeat_interleave(H // Hkv, dim=1) for x in (k, v))

        def sdpa():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)
    else:
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    row["sdpa_ms"] = cs.cuda_ms(torch, sdpa, iters=iters, reps=reps)
    row["sdpa_call"] = (("SDPA memory-efficient, K/V expanded, the window as a boolean mask" if window else
                         f"SDPA {'causal' if causal else 'non-causal'}, enable_gqa")
                        + (" (without the softcap)" if softcap else ""))
    if window:
        del ke, ve, mask
    if hasattr(fa, "kernel_bf16_plan"):
        plan = fa.kernel_bf16_plan(B, H, Hkv, S, T, D, causal, window)
        row["plan"] = {"kernel": plan.kernel, "bm": plan.bm, "bn": plan.bn, "query_blocks": len(plan.tiles)}
    if softcap and flex:
        row.update(flex_row(torch, cs, q, k, v, S, T, causal, window, softcap, iters, reps))
    return row


def flex_row(torch, cs, q, k, v, S, T, causal, window, softcap, iters, reps) -> dict:
    """``flex_attention`` compiled, the softcap as a score_mod and the mask
    as a block mask: its device ms and its agreement with the kernel."""
    from repro_torch.kernels import ops

    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        off = T - S

        def visible(b, h, qi, kj):
            pos = qi + off
            keep = kj <= pos if causal else kj >= 0
            return keep & (pos - kj < window) if window else keep

        def cap(score, b, h, qi, kj):
            return softcap * torch.tanh(score / softcap)

        block = create_block_mask(visible, None, None, S, T, device=cs.DEV)
        compiled = torch.compile(flex_attention)
        fn = lambda: compiled(q, k, v, score_mod=cap, block_mask=block, enable_gqa=True)
        got = fn()
        torch.cuda.synchronize()
        gap = cs.max_err(got.float(), ops.flash_attention(q, k, v, causal=causal, window=window,
                                                          softcap=softcap).float())
        return {"flex_ms": cs.cuda_ms(torch, fn, iters=iters, reps=reps), "flex_vs_kernel_max_abs": gap}
    except Exception as e:  # a library yardstick: its failure is recorded, not fatal
        return {"flex_ms": None, "flex_error": f"{type(e).__name__}: {str(e)[:400]}"}


def family(kernel: str) -> str:
    """The kernel family a device activity's name belongs to."""
    if "flash_attention" in kernel:
        return "flash_attention"
    return "gemm" if any(k in kernel.lower() for k in ("gemm", "xmma", "cutlass", "nvjet")) else "other"


def prefill(torch, cs, arch: str, n: int) -> dict:
    """Host ms of ``n`` warm prefills of ``arch`` at its cut, and one
    profiled prefill's device ms by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ArchConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    layers, B, S = PREFILLS[arch]
    if arch == "gemma2-27b":  # not registered: chip_smoke.py's literal
        cfg = ArchConfig(**cs.FRONTEND_ARCHS["gemma2"])
    else:
        cfg = get_arch(arch).with_layers(layers)
    model = serve.build(cfg, 0, torch.device(cs.DEV))
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1)).to(cs.DEV)
    batch = {"tokens": tok}
    with torch.no_grad():
        M.prefill(model, batch, cache_len=S)
        torch.cuda.synchronize()
        host_ms = []
        ops.reset_launches()
        for _ in range(n):
            t0 = time.perf_counter()
            M.prefill(model, batch, cache_len=S)
            torch.cuda.synchronize()
            host_ms.append(1e3 * (time.perf_counter() - t0))
        launches = ops.launch_counts()["flash_attention"] / n
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
    return {"arch": arch, "layers": cfg.n_layers, "shape": f"{B} x {S}", "host_ms": host_ms,
            "median_host_ms": statistics.median(host_ms), "flash_launches_per_prefill": launches,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy, "busy_share": busy / wall_ms if wall_ms else None,
            "device_ms_by_family": by_family}


if __name__ == "__main__":
    sys.exit(main())
