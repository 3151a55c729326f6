#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py            # on a machine with one NVIDIA H100

Phases, each of which raises (non-zero exit) on failure:

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, and
   check ptxas's report (no spill in the bf16 ``flash_attention``
   instances, ``tree_hist``, ``weighted_errors``, ``weight_update`` or
   ``vote_argmax``) and ``tree_hist``'s SASS (its shared-memory atomics
   are integer adds, no CAS loop);
3. hold every kernel to its plain PyTorch version on the card, at the main
   paths' shapes (training: adult, letter, forestcover; C = 8, depth 4, 16
   bins; ``weight_update`` also at adult's 64 collaborators; serving:
   ``vote_argmax`` at pendigits' and letter's batches) and at ragged cases;
   the training and voting kernels each with its output landing on a
   NaN-filled block (every element must be written), the cluster kernels
   (``tree_hist``, ``weighted_errors``, ``weight_update``) with the same
   bits from two calls and ``tree_hist``'s main-path plans against the
   clusters the card holds at once, ``tree_hist`` under AdaBoost's skewed
   weights (the same split as the plain version), ``vote_argmax`` past one
   member tile, at 1 808 classes, with NaN alphas and equal to a
   member-by-member ``VoteTally``; time the kernel, its plain version
   and (where one exists) the one PyTorch call that computes the same
   function, each on the device alone (replayed from a CUDA graph), beside
   the launch floor (a 1-element ``fill_`` replayed the same way), and the
   kernel wrapper's eager time per call; ``weighted_errors`` also at
   PreWeak.F's C*T rows (adult, T = 10 and 100) and past the 11 776 rows
   a per-row shared-memory total could hold; and phase 10's new shapes:
   ``weight_update`` under adult's Dirichlet mask (``[8, n_max]``, most of
   each row's tail 0: the same bits twice, the padding exactly 0 after
   the renormalisation), ``weighted_errors`` at ``[8, 8, n_max]`` with
   zero-weight tails, ``vote_argmax`` at the heterogeneous engine's
   ``[30, 256]`` (pendigits, 3 groups of T = 10, K = 10) equal to a
   member-by-member ``VoteTally``;
4. run the port's federation through ``repro_torch.launch.fl_run`` on the
   card — adult 10 rounds with the default flags (the main path, with every
   kernel's launch count set to 0 just before), letter and forestcover 5
   rounds each — and check the launch counts and that no plain version ran
   on a CUDA tensor;
5. run the adult configuration on the CPU and compare it with the card's;
6. print ms/round on the card for each dataset, the host operations of an
   adult round (PyTorch operators and kernel launches, counted), the adult
   round's ms per stage, and where the adult run's device time goes
   (``torch.profiler``);
7. serve through ``repro_torch.launch.serve_fl`` on the card — pendigits
   with the defaults, saving an artifact, under ``--policy sync`` (the
   serving main path, with every launch count set to 0 just before), that
   artifact again with ``--load`` under ``--policy deadline`` (both serving
   the test split repeatedly for ``WINDOW_S`` seconds), a
   ``--publish-every 2`` run and letter at 100 rounds — checking that
   ``vote_argmax`` launched once per batch (and once per warm-up), that no
   plain version ran on the card and that the vote cache answered what
   the engine answered; then serve the card's artifacts on the CPU and
   compare;
8. serve gemma-2b at full width (18 layers, bf16, random weights from a
   seed) through ``repro_torch.launch.serve --full`` on the card — batch 4,
   prompt 64, 32 decode tokens (the LLM serving path, with every launch
   count set to 0 just before) — checking one ``flash_attention`` launch
   per layer of the prefill, no plain version on the card, tokens inside
   the vocabulary and finite logits; then that prefill(S) and one decode
   step give prefill(S + 1)'s logits, that the same weights cut to 2 layers
   in float32 give the CPU's prefill logits, and where a prefill's and a
   decode step's device time goes (``torch.profiler``);
9. run the other algorithms and learner through ``repro_torch.launch.fl_run``
   on the card (adult, C = 8, depth 4, 16 bins, seed 0; every launch count
   set to 0 just before each run): DistBoost.F, PreWeak.F, bagging and
   ``--learner extra_tree`` for 10 rounds and PreWeak.F for 100 (its
   ``weighted_errors`` at ``[8, 800, 4070]``), checking each run's launch
   counts and that no plain version ran on the card; each 10-round run
   again on the CPU (the same draws), compared with the card's; ms/round of
   each and PreWeak.F's set-up ms; then publish a DistBoost.F committee
   artifact from a pendigits run and serve it through ``serve_fl
   --artifact ... --load`` (one ``vote_argmax`` launch a batch and a
   warm-up, the vote cache answering what the engine answers, the card's
   votes the CPU's outside the near-tie gap);
10. run the other learners, the Dirichlet split and heterogeneous
   federations through ``repro_torch.launch.fl_run`` on the card (adult,
   C = 8, depth 4, 16 bins, 10 rounds, seed 0; every launch count set to
   0 just before each run): ``--learner ridge``, ``gaussian_nb``,
   ``nearest_centroid`` and ``mlp``; ``--split dirichlet``; ``--learners``
   over all six families with ``--split dirichlet``; ``--learners
   decision_tree,ridge,gaussian_nb`` under DistBoost.F, PreWeak.F and
   bagging — checking each run's launch counts, that no plain version ran
   on the card, and, against the same run on the CPU, round 0's member,
   the agreeing rounds and F1 within 0.02; ms/round of each and the host
   operations of a mixed adult round (its one winner read included); then
   serve: ``serve_fl --learners decision_tree,ridge,gaussian_nb`` on
   pendigits (C = 6, publish every 2), its last v2 artifact with
   ``--load``, a heterogeneous DistBoost.F committee artifact and
   ``serve_fl --learner ridge`` — one ``vote_argmax`` a batch and a
   warm-up, the cache answering what the engine answers, the card's votes
   the CPU's outside the near-tie gap;
11. run the interpreted OpenFL-style round, FedAvg and the §5.1 flags
   through ``repro_torch.launch.fl_run`` on the card (adult, C = 8, depth
   4, 16 bins, 10 rounds, seed 0; every launch count set to 0 just before
   each run): ``--faithful`` (the interpreted path's main run: 32
   ``tree_hist``, 8 ``weighted_errors``, 8 ``weight_update_product`` and no
   renormalising ``weight_update`` a round, no plain version on the card),
   again on the CPU (the chosen member compared round by round, F1 within
   0.02) and against the card's fused run; the §5.1 ladder (``--faithful``,
   then ``+packed_serialization``, ``+bounded_tensordb``,
   ``+fast_barrier``, ``+fused_round``, ``+cache_predictions``, and
   ``batched_fit`` off) with ms/round, the TensorDB's peak entries, comm MB
   and the barrier's sleep of each; PreWeak.F (T = 10) without its
   prediction cache against the cached run; ``--algorithm fedavg --learner
   mlp`` on the card and the CPU (F1 above the constant predictor's, the
   same comm bytes).  Phase 3 holds the new shapes too:
   ``weight_update_product`` at ``[4 070]`` and ``[32 560]``, ``tree_hist``
   at H = 1 (``[1, 4 070, 14]``, L = 1, 2, 4, 8) under skewed weights and
   ``weighted_errors`` at ``[1, 8, 4 070]``;
12. run the elastic runtime and the multi-tenant registry on the card
   (adult, C = 8, depth 4, 16 bins, IID, seed 0, 10 rounds; every launch
   count set to 0 just before each run): (a) ``Federation.run(policy=
   ParticipationPolicy())`` with no faults for all four algorithms, equal
   to the fused run bit for bit (history, every round's metrics, weights,
   ensemble) with the fused run's launches (AdaBoost.F 4 / 1 / 1 / 0 a
   round); through ``fl_run --elastic``, each also on the CPU: (b) virtual
   chaos (``--deadline-ms 1000 --fault-seed 7 --fault-drop-p 0.2
   --fault-kill 2:3``), (c) late merges (``--deadline-ms 500 --fault-seed 3
   --fault-delay-p 0.4 --fault-delay-ms 600:1400``), (d) DistBoost.F under
   (b)'s faults — responders, dropouts and late merges equal to the CPU's,
   one ``weight_update_product`` a partial round and one ``weight_update``
   a full one, each late alpha its base times its discount, the ensemble
   count rounds - skipped + late merges, round 0's member the CPU's, F1
   within 0.02; (e) ``--elastic-realtime --deadline-ms 20`` (every round at
   least one responder, ms/round); (f) a ``ModelRegistry`` of three
   tenants refreshed at every checkpoint (adult: (b)'s run publishing
   every 2, then a late-merge run whose larger capacity rebuilds;
   pendigits: serve_fl's defaults, then a DistBoost.F committee stream that
   rebuilds; letter, T = 100): the expected swaps and rebuilds, one
   ``vote_argmax`` a served batch, each tenant's votes those of a
   standalone engine and the CPU's outside the near-tie gap, rows/s and
   p50/p99 of 37-row ``predict`` calls and ``submit(deadline_s=)`` with
   ``drain()`` under the deadline scheduler;
13. run the multi-process federation through ``repro_torch.launch.fl_spawn``,
   every process on the one card (adult, fl_run's defaults, seed 0): (a)
   the lockstep runtime over gloo at P = 1, 2, 4 and 8 processes with the
   packed broadcast and at P = 8 per leaf, 6 rounds a history row each:
   every process exits 0, comm bytes, hypothesis bytes and collectives a
   round equal ``BENCH_distributed.json``'s, round 0's chosen member the
   fused card run's at C = P (the agreeing rounds printed), F1 within 0.02
   of it, ms/round a P; (b) a 2-process run whose processes print their
   launch counts (4 ``tree_hist``, 1 ``weighted_errors``, 1
   ``weight_update`` a round each, set to 0 just before), and a fault-free
   4-process run of the elastic socket star the same way (4 ``tree_hist``
   a round and 4 in its warm-up, 1 ``weight_update_product`` a round each,
   every round over all 4); (c) the elastic
   socket star with collaborator 2 killed at round 3 (``--deadline-ms
   3000``, 10 rounds, on the card and the CPU): evicted, every round
   recorded, rounds from 3 on over at most 3 processes, F1 within 0.02 of
   the CPU's and above 0.5; (d) delay-only stragglers past an 800 ms
   deadline (5 rounds): deadline dropouts, late merges with lateness >= 1
   and ``|alpha| <= |base|``, each round's ms.  Phase 3 holds each
   process's shapes too, at P = 1, 2, 4 and 8: ``tree_hist`` at H = 1
   (``[1, 32 561 // P, 14]``, L = 1, 2, 4, 8) under skewed weights,
   ``weighted_errors`` at ``[1, P, 32 561 // P]``, the renormalised
   ``weight_update`` over ``[P · (32 561 // P)]`` and
   ``weight_update_product`` over ``[32 561 // P]``.

Each phase's seconds are printed at the end.  The second-to-last line is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.  Without a card, or beside no copy of
the repo, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"  # run histories (--history-out)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 on the tensor cores, dense
MAIN = {"dataset": "adult", "rounds": 10, "collaborators": 8, "depth": 4, "eval_every": 5}
SHAPES = {  # dataset: (n per collaborator, d, K) with C = 8
    "adult": (4070, 14, 2),
    "letter": (2000, 16, 26),
    "forestcover": (6250, 54, 2),
}
C, DEPTH, N_BINS = 8, 4, 16
DEV = "cuda"
TOL = {  # kernel: tolerance against its plain version on the card
    # the kernel sums in fixed point per CTA (an error of at most 2^-31 of a
    # CTA's mass a value), the plain version in float32 in another order
    "tree_hist": {"atol": 1e-4, "rtol": 0.0},
    "weighted_errors": {"atol": 0.0, "rtol": 1e-4},
    "weight_update": {"atol": 0.0, "rtol": 1e-5},
    "weight_update_product": {"atol": 0.0, "rtol": 1e-6},  # elementwise: expf against exp
    # float32 sums in another order (tests/test_kernels.py's atol); in bf16
    # both sides round the same float32 value, so they may land one ulp
    # apart: at most 2^-7 of the value, within rtol 1e-2, plus atol 4e-3
    # near 0.  Rows that see n keys give |o| ~ sqrt(e / n), about 0.04 at
    # 2048 keys, so a fixed atol of 2e-2 would be half an output there.
    "flash_attention": {"atol": 2e-5, "rtol": 0.0},
    "flash_attention_bf16": {"atol": 4e-3, "rtol": 1e-2},
}
SOURCES = {
    "tree_hist": ("src/repro_torch/csrc/tree_hist.cu", "src/repro/kernels/tree_hist.py:88"),
    "weighted_errors": ("src/repro_torch/csrc/boost_update.cu", "src/repro/kernels/boost_update.py:51"),
    "weight_update": ("src/repro_torch/csrc/boost_update.cu", "src/repro/kernels/boost_update.py:86"),
    "weight_update_product": ("src/repro_torch/csrc/boost_update.cu",
                              "src/repro/kernels/boost_update.py:86"),
    "vote_argmax": ("src/repro_torch/csrc/vote_argmax.cu", "src/repro/kernels/vote_argmax.py:63"),
    # the record reports the bf16 route (gemma-2b's); float32 calls take
    # csrc/flash_attention.cu, timed at "ragged"
    "flash_attention": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                        "src/repro/kernels/flash_attention.py:121"),
}
MAIN_SHAPE = {"tree_hist": "adult", "weighted_errors": "adult", "weight_update": "adult",
              "weight_update_product": "adult_shard", "vote_argmax": "pendigits",
              "flash_attention": "gemma_serve"}
# vote_argmax [T, n, K]: serve_fl's defaults on pendigits (10 rounds, batch
# 256) and letter at 100 rounds, at the batch and at a whole 4096-row shard,
# and letter's batch at 1000 rounds
VOTE_SHAPES = {
    "pendigits": (10, 256, 10),
    "letter": (100, 256, 26),
    "letter_4096": (100, 4096, 26),
    "letter_1000": (1000, 256, 26),  # eight member tiles, double-buffered
}
# the heterogeneous engine's vote on pendigits: 3 groups of T = 10, batch 256
HETERO_VOTE = (30, 256, 10)
SERVE = OUT / "serve"  # serving artifacts and the rolling checkpoint stream
WINDOW_S = 1.0  # seconds each policy serves pendigits' test split for
# flash_attention [B, H, Hkv, S, T, D, causal, window, softcap, bf16]:
# tests/test_kernels.py's sweep and fully-masked-tiles case in float32 (the
# CUDA-core route) and each again in bf16 (the TMA/wgmma route: D = 32, 64,
# 128, 256), a 130-row case (its last block's second warpgroup holds no row
# inside S) and a 40-query chunk against 200 keys (one warpgroup, several
# tiles), then gemma-2b's heads at the serving defaults' prefill (batch 4,
# prompt 64) and at a 2048-token prompt
_FLASH_F32 = {
    "gqa": (2, 4, 2, 128, 128, 64, True, None, None),
    "mqa_window": (1, 4, 1, 128, 128, 64, True, 64, None),
    "s_lt_t_softcap": (1, 2, 2, 96, 160, 32, True, None, 30.0),
    "noncausal": (1, 2, 2, 128, 128, 64, False, None, None),
    "ragged": (1, 2, 2, 100, 100, 64, True, None, None),
    "masked_tiles": (1, 2, 2, 256, 256, 32, True, 16, None),
}
FLASH_CASES = {
    **{name: (*case, False) for name, case in _FLASH_F32.items()},
    **{f"{name}_bf16": (*case, True) for name, case in _FLASH_F32.items()},
    "bf16": (1, 8, 2, 128, 128, 128, True, None, None, True),
    "ragged_130_bf16": (2, 2, 1, 130, 130, 128, True, None, None, True),
    "chunk_40x200_bf16": (1, 4, 1, 40, 200, 128, True, None, None, True),
    "gemma_serve": (4, 8, 1, 64, 64, 256, True, None, None, True),
    "gemma_2048": (1, 8, 1, 2048, 2048, 256, True, None, None, True),
}
# timed: both routes, bf16 at gemma-2b's shapes and float32 at "ragged"
FLASH_TIMED = ("gemma_serve", "gemma_2048", "ragged")
LLM = {"arch": "gemma-2b", "batch": 4, "prompt_len": 64, "tokens": 32, "layers": 18}
# bf16 keeps 8 bits, and prefill(S + 1) and prefill(S) + one decode step
# round at different places through 18 layers.  Measured at full width: at
# most 0.047 apart on the CPU with 8 layers, 0.094 on an H100 with 18 (the
# same in every run: the weights come from a seed); the limit is about 2x
# that at every logit magnitude.
DECODE_TOL = {"atol": 0.2, "rtol": 0.0}
# float32 on the card and on the CPU: the same sums in other orders, about
# 1e-5 on logits of up to about 35 (float32 against float64 on the CPU)
CPU_TOL = {"atol": 1e-3, "rtol": 0.0}


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


def launch_floor_ms(torch) -> float:
    """Device time of the least a launch can cost: a 1-element ``fill_``,
    replayed as every kernel is (``cuda_ms``).  A kernel's time reads
    against its bound and this floor together."""
    one = torch.empty(1, device=DEV)
    return cuda_ms(torch, lambda: one.fill_(1.0))


def poisoned(torch, shape, call):
    """``call()`` right after a NaN-filled float32 block of ``shape`` was
    freed, so that the caching allocator hands that block to the call's
    output: a cell the kernel never writes stays NaN."""
    junk = torch.full(shape, float("nan"), device=DEV)
    ptr = junk.data_ptr()
    del junk
    out = call()
    check(out.data_ptr() == ptr, f"the allocator did not hand back the NaN-filled {tuple(shape)} block")
    return out


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
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


# -- phase 2: the build's register report ------------------------------------------


def ptxas_report(build_log: str) -> dict:
    """{kernel entry: {"registers", "spill_bytes", "stack_bytes"}} from
    nvcc's ``-Xptxas -v`` output; names are mangled (a flash instance reads
    ``..._kernelILi256E...`` for D = 256)."""
    report, entry = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            report[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[entry]["stack_bytes"] = int(m.group(1))
            report[entry]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[entry]["registers"] = int(m.group(1))
    return report


# the CUDA-core kernels of the training and serving paths, by mangled name:
# tree_hist, weighted_errors, weight_update, and vote_argmax for 1, 2, 4, 8
# and 16 classes a thread
CORE_KERNELS = ("tree_hist_kernel", "weighted_errors_kernel", "weight_update_kernel",
                "weight_product_kernel", "vote_argmax_kernel")


def kernel_row(entry: str, info: dict) -> str:
    """The "name: registers, spill bytes" of one instance of ``CORE_KERNELS``."""
    name = next(k for k in CORE_KERNELS if k in entry)[: -len("_kernel")]
    m = re.search(r"_kernelILi(\d+)E", entry)
    return f"{name}{f'<{m.group(1)}>' if m else ''}: {info.get('registers')}, {info.get('spill_bytes')}"


def shared_atomics(build, entry: str) -> set:
    """The shared-memory atomic opcodes (``ATOMS...``) in the SASS of the
    kernel whose name contains ``entry``, from cuobjdump.  A float
    ``atomicAdd`` on shared memory compiles to a compare-and-swap loop
    (``ATOMS.CAST.SPIN``) on this card, a 32-bit integer one to ``ATOMS.ADD``."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path())],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()[:500]}")
    ops = set()
    for function in sass.stdout.split("Function : ")[1:]:
        if entry in function.splitlines()[0]:
            ops |= set(re.findall(r"\b(ATOMS\.[\w.]+)", function))
    return ops


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
    from repro_torch.kernels import tree_hist as tree_hist_mod

    """Every level of the main path's fits at each dataset's shape, and
    ragged cases.  Returns ({dataset: record}, worst error); a dataset's
    times and bound are means per launch over one round's levels
    (L = 1, 2, 4, 8), each level also kept on its own."""
    results = {ds: {"levels": {}} for ds in SHAPES}
    cases = [(ds, C, n, d, K, L, False, 0) for ds, (n, d, K) in SHAPES.items() for L in (1, 2, 4, 8)]
    cases += [
        ("ragged", 33, 1001, 5, 3, 8, True, 0),  # odd n, H = 33
        ("ragged", 3, 257, 19, 26, 8, True, 0),  # K = 26, d ragged against dblk
        ("ragged", 8, 777, 14, 2, 4, True, 100),  # zero-weight rows
        ("ragged", 1, 3, 3, 2, 1, True, 0),  # n < cs: CTAs of a cluster with no sample
        ("ragged", 2, 1, 4, 2, 2, True, 0),  # n = 1
    ]
    worst, empty = 0.0, []
    for ds, H, n, d, K, L, dense, tail in cases:
        bins, leaf, wy = hist_inputs(torch, g, H, n, d, L, K, dense, tail)
        # every output cell must be written: the output lands on a NaN-filled block
        got = poisoned(torch, (H, L, d, N_BINS + 1, K),
                       lambda: ops.tree_hist(bins, leaf, wy, n_leaves=L, n_bins_p1=N_BINS + 1))
        want = ref.tree_hist_batched_ref(bins, leaf, wy, L, N_BINS + 1)
        err = assert_close(torch, "tree_hist", got, want, f"{ds} H={H} n={n} d={d} K={K} L={L}")
        again = ops.tree_hist(bins, leaf, wy, n_leaves=L, n_bins_p1=N_BINS + 1)
        check(torch.equal(got, again), f"tree_hist {ds} H={H} n={n} L={L}: two calls differ by up to "
              f"{max_err(got, again):.3g}")
        plan = tree_hist_mod.launch_plan(H, n, d, L, N_BINS + 1, K)
        if n < plan.cs:
            empty.append(f"n={n} cs={plan.cs}")
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
    check(len(empty) == 2, f"tree_hist: the n < cs cases do not leave CTAs empty: {empty}")
    log(f"tree_hist: {len(cases)} cases agree, each written over a NaN-filled block and the same "
        f"bits in two calls, worst "
        f"max_abs_err {worst:.3g}; clusters with empty CTAs at {', '.join(empty)}")
    worst = max(worst, check_tree_hist_skewed(torch, ops, ref, g, tree_hist_mod))
    one_wave(torch, tree_hist_mod)
    return results, worst


def check_tree_hist_skewed(torch, ops, ref, g, tree_hist_mod, fits: int = 8) -> float:
    """AdaBoost's skewed weights at adult's deepest level (C = 8, L = 8):
    log-normal weights with sigma = 4 normalised to sum 1, so a CTA's
    fixed-point step, set by its heaviest sample, is coarse for the light
    ones.  Each fit is held at atol 1e-4 and must pick the plain version's
    split for every collaborator; the worst error and the cells whose
    plain mass is nonzero but whose kernel sum rounds to 0 are logged."""
    from repro_torch.learners.tree import _split_scores

    n, d, K = SHAPES["adult"]
    L, B1 = 2**(DEPTH - 1), N_BINS + 1
    worst, zeroed, nonzero, same = 0.0, 0, 0, 0
    for _ in range(fits):
        bins = torch.randint(0, B1, (C, n, d), generator=g, dtype=torch.int32).to(DEV)
        leaf = torch.randint(0, L, (C, n), generator=g, dtype=torch.int32).to(DEV)
        w = torch.exp(4.0 * torch.randn(C, n, generator=g, dtype=torch.float64))
        w = (w / w.sum()).float()
        y = torch.randint(0, K, (C, n), generator=g)
        wy = (torch.nn.functional.one_hot(y, K).float() * w.unsqueeze(-1)).contiguous().to(DEV)
        got = ops.tree_hist(bins, leaf, wy, n_leaves=L, n_bins_p1=B1)
        want = ref.tree_hist_batched_ref(bins, leaf, wy, L, B1)
        worst = max(worst, assert_close(torch, "tree_hist", got, want, "skewed weights, adult L=8"))
        zeroed += int(((want != 0) & (got == 0)).sum())
        nonzero += int((want != 0).sum())
        split_got = torch.argmax(_split_scores(got).flatten(1), dim=1)
        split_want = torch.argmax(_split_scores(want).flatten(1), dim=1)
        check(torch.equal(split_got, split_want), f"tree_hist skewed weights: splits "
              f"{split_got.tolist()} differ from the plain version's {split_want.tolist()}")
        same += C
    plan = tree_hist_mod.launch_plan(C, n, d, L, B1, K)
    log(f"tree_hist, skewed weights (log-normal sigma 4, sum 1; adult [{C}, {n}, {d}], L={L}, "
        f"cluster {plan.cs}): {fits} draws, worst max_abs_err {worst:.3g} (atol 1e-4); "
        f"{zeroed} of {nonzero} nonzero cells round to 0; the same split in {same}/{same} fits")
    return worst


def one_wave(torch, tree_hist_mod) -> None:
    """Each main-path launch plan against the card's own count of
    clusters it holds at once (``cudaOccupancyMaxActiveClusters``): the
    plan's grid must fit in one wave."""
    import ctypes

    from repro_torch.kernels import _build

    lib, rows = _build.library(), []
    for ds, (n, d, K) in SHAPES.items():
        for L in (1, 2, 4, 8):
            p = tree_hist_mod.launch_plan(C, n, d, L, N_BINS + 1, K)
            held = ctypes.c_int(0)
            _build.check(lib.repro_tree_hist_max_clusters(L, N_BINS + 1, K, p.dblk, p.cs, p.threads,
                                                          ctypes.byref(held)), "max active clusters")
            clusters = C * -(-d // p.dblk)
            check(clusters <= held.value, f"tree_hist {ds} L={L}: plan {tuple(p)} has {clusters} "
                  f"clusters, the card holds {held.value} at once")
            rows.append(f"{ds} L={L} {clusters}/{held.value} (dblk {p.dblk}, cs {p.cs}, "
                        f"{p.threads} threads, {p.shared_bytes} B)")
    log("tree_hist plans, clusters / clusters the card holds at once: " + "; ".join(rows))


# weighted_errors at PreWeak.F's C*T rows (adult, C = 8, T = 10 and 100) and
# past the 11 776 rows a per-row shared-memory total could hold
PREWEAK_SHAPES = {"preweak_t10": (C, 10 * C, 4070), "preweak_t100": (C, 100 * C, 4070),
                  "past_cap": (4, 12800, 2000)}


def check_weighted_errors(torch, ops, ref, g):
    results, worst = {}, 0.0
    cases = [(ds, C, C, n, K) for ds, (n, _, K) in SHAPES.items()]
    cases += [(ds, Cc, H, n, 2) for ds, (Cc, H, n) in PREWEAK_SHAPES.items()]
    cases += [("ragged", 4, 33, 4097, 5), ("ragged", 8, 8, 1, 2), ("ragged", 2, 3, 100, 26),
              ("ragged", 8, 8, 5, 2), ("ragged", 3, 8, 1001, 3),  # n < cs twice; odd n
              ("ragged", 2, 17, 1, 2), ("ragged", 5, 41, 1001, 3)]  # empty slices; a ragged chunk
    for ds, Cc, H, n, K in cases:
        preds = torch.randint(0, K, (Cc, H, n), generator=g, dtype=torch.int32).to(DEV)
        y = torch.randint(0, K, (Cc, n), generator=g, dtype=torch.int32).to(DEV)
        w = torch.rand(Cc, n, generator=g)
        w[0] = 0.0  # a zero-weight shard
        w = (w / w.sum()).to(DEV)
        # every output element must be written: the output lands on a NaN-filled block
        got = poisoned(torch, (Cc, H), lambda: ops.weighted_errors(preds, y, w))
        want = ref.weighted_errors_ref(preds, y, w)
        err = assert_close(torch, "weighted_errors", got, want, f"{ds} [{Cc}, {H}, {n}]")
        check(float(got[0].abs().max()) == 0.0, "weighted_errors: zero-weight shard is not 0")
        again = ops.weighted_errors(preds, y, w)
        check(torch.equal(got, again), f"weighted_errors {ds} [{Cc}, {H}, {n}]: two calls differ "
              f"by up to {max_err(got, again):.3g}")
        worst = max(worst, err)
        if ds in SHAPES or ds in PREWEAK_SHAPES:
            nbytes = 4 * (Cc * H * n + 2 * Cc * n + Cc * H)
            bms, by = bound_ms(nbytes, 2 * Cc * H * n)
            # no single PyTorch call computes a masked weighted row sum: no library time
            results[ds] = {
                "shape": f"preds [{Cc}, {H}, {n}]", "max_abs_err": err,
                "bound_ms": bms, "bound_by": by,
                **timings(torch, lambda: ops.weighted_errors(preds, y, w),
                          lambda: ref.weighted_errors_ref(preds, y, w)),
            }
    log(f"weighted_errors: {len(cases)} cases agree, each written over a NaN-filled block and "
        f"the same bits in two calls; worst max_abs_err {worst:.3g}")
    return results, worst


UPDATE_SHAPES = {  # weight_update N = C * n: the main path's datasets at C = 8, and adult at
    # the paper's 64 collaborators (its largest scale)
    **{ds: C * n for ds, (n, _, _) in SHAPES.items()},
    "adult_64": 64 * SHAPES["adult"][0],
}


def check_weight_update(torch, ops, ref, g):
    """The fused update (the Pallas body, then division by the clamped
    total) against its plain version at rtol 1e-5: the four N of
    ``UPDATE_SHAPES`` and N = 1 and 4 097, three alphas, a mask with
    zeros; each output written over a NaN-filled block and the same bits
    from a second call; an all-zero mask gives zeros through the 1e-30
    clamp."""
    results, worst = {}, 0.0
    cases = list(UPDATE_SHAPES.items()) + [("ragged", 4097), ("ragged", 1)]
    for ds, N in cases:
        w = (torch.rand(N, generator=g) / N).to(DEV)
        mis = (torch.rand(N, generator=g) < 0.3).float().to(DEV)
        mask = torch.ones(N)
        mask[3::7] = 0.0  # padding rows
        mask = mask.to(DEV)
        for a in (0.37, -2.0, 10.0):
            alpha = torch.tensor(a, device=DEV)
            got = poisoned(torch, (N,), lambda: ops.weight_update(w, mis, mask, alpha))
            want = ref.renormalised_weight_update_ref(w, mis, mask, alpha)
            err = assert_close(torch, "weight_update", got, want, f"{ds} N={N} alpha={a}")
            again = ops.weight_update(w, mis, mask, alpha)
            check(torch.equal(got, again), f"weight_update {ds} N={N} alpha={a}: two calls differ "
                  f"by up to {max_err(got, again):.3g}")
            worst = max(worst, err)
        zeros = ops.weight_update(w, mis, torch.zeros_like(mask), alpha)
        torch.cuda.synchronize()
        check(bool((zeros == 0).all()), f"weight_update N={N}: an all-zero mask gives "
              f"{zeros[zeros != 0][:4].tolist()}, not zeros")
        if ds in UPDATE_SHAPES:
            alpha = torch.tensor(0.37, device=DEV)
            # bytes: w, mis, mask and alpha read once, out written once; operations:
            # a product (exp and three multiplies), an add and a division an element
            bms, by = bound_ms(4 * (4 * N + 1), 6 * N)
            # no single PyTorch call computes the renormalised update: no library time
            results[ds] = {
                "shape": f"w [{N}]", "max_abs_err": err, "bound_ms": bms, "bound_by": by,
                **timings(torch, lambda: ops.weight_update(w, mis, mask, alpha),
                          lambda: ref.renormalised_weight_update_ref(w, mis, mask, alpha)),
            }
    log(f"weight_update: {len(cases) * 3} cases agree, each written over a NaN-filled block and "
        f"the same bits in two calls, all-zero masks give zeros; worst max_abs_err {worst:.3g}; "
        + "; ".join(f"{k} N={UPDATE_SHAPES[k]} {v['ms']:.5f} ms (bound {v['bound_ms']:.6f}, plain "
                    f"{v['plain_ms']:.5f}, eager {v['eager_ms']:.5f})" for k, v in results.items()))
    return results, worst


def check_weight_update_product(torch, ops, ref, g):
    """The interpreted round's un-renormalised update (the Pallas body
    alone) against its plain version at rtol 1e-6: adult's shard
    ``[4 070]`` (a collaborator's update) and the whole ``[32 560]``, an odd
    N, three alphas and a mask with zeros; each output written over a
    NaN-filled block."""
    results, worst = {}, 0.0
    cases = [("adult_shard", SHAPES["adult"][0]), ("adult", C * SHAPES["adult"][0]),
             ("ragged", 4097), ("ragged", 1)]
    for ds, N in cases:
        w = (torch.rand(N, generator=g) / N).to(DEV)
        mis = (torch.rand(N, generator=g) < 0.3).float().to(DEV)
        mask = torch.ones(N)
        mask[3::7] = 0.0
        mask = mask.to(DEV)
        err = 0.0
        for a in (0.37, -2.0, 10.0):
            alpha = torch.tensor(a, device=DEV)
            got = poisoned(torch, (N,), lambda: ops.weight_update_product(w, mis, mask, alpha))
            want = ref.boost_weight_update_ref(w, mis, mask, alpha)
            err = max(err, assert_close(torch, "weight_update_product", got, want,
                                        f"{ds} N={N} alpha={a}"))
        worst = max(worst, err)
        if ds != "ragged":
            alpha = torch.tensor(0.37, device=DEV)
            # bytes: w, mis, mask and alpha read once, out written once (16N + 4);
            # operations: an exp and three multiplies an element
            bms, by = bound_ms(4 * (4 * N + 1), 4 * N)
            # no single PyTorch call computes w * exp(alpha * mis) * mask: no library time
            results[ds] = {
                "shape": f"w [{N}]", "max_abs_err": err, "bound_ms": bms, "bound_by": by,
                **timings(torch, lambda: ops.weight_update_product(w, mis, mask, alpha),
                          lambda: ref.boost_weight_update_ref(w, mis, mask, alpha)),
            }
    log(f"weight_update_product: {len(cases) * 3} cases agree, each written over a NaN-filled "
        f"block; worst max_abs_err {worst:.3g}; "
        + "; ".join(f"{k} {v['shape']} {v['ms']:.5f} ms (bound {v['bound_ms']:.6f}, plain "
                    f"{v['plain_ms']:.5f}, eager {v['eager_ms']:.5f})" for k, v in results.items()))
    return results, worst


def vote_gap_agree(votes, a, b, alpha) -> tuple:
    """(rows where ``a`` and ``b`` differ outside the near-tie gap, rows
    inside it, rows inside it where they differ): a row whose top two vote
    sums lie within 1e-5·Σ|α| may go either way when the members are
    summed in another order."""
    top2 = votes.topk(2, dim=-1).values
    near = top2[:, 0] - top2[:, 1] <= 1e-5 * float(alpha.abs().sum())
    differ = a != b
    return int((differ & ~near).sum()), int(near.sum()), int((differ & near).sum())


def tally_classes(torch, preds, alpha, K):
    """The classes of a ``VoteTally`` built member by member
    (``scoring.tally_new_votes``: one ``alpha[t] * one_hot`` add a member,
    in ascending order), from a stub learner that predicts ``preds``."""
    import dataclasses
    from typing import NamedTuple

    from repro_torch.core import boosting, scoring
    from repro_torch.learners.base import LearnerSpec, WeakLearner

    class Votes(NamedTuple):
        preds: object

    @dataclasses.dataclass(frozen=True)
    class Stub(WeakLearner):
        def predict(self, spec, params, X):
            return params.preds

    T, n = preds.shape
    learner = Stub("stub", None, None, None)
    ens = boosting.Ensemble(Votes(preds), alpha, T)
    tally = scoring.tally_new_votes(learner, LearnerSpec("stub", 1, K), ens,
                                    scoring.init_tally(n, K, DEV), torch.zeros(n, 1, device=DEV))
    return scoring.tally_predict(tally)


def check_vote_argmax(torch, ops, ref, g):
    """Exact agreement with the plain version, each output written over a
    NaN-filled block: the serving shapes, ragged n, T = 0 and 1, T past
    one member tile, K = 400 and K = 1 808 (several classes a thread), and
    NaN and infinite alphas (NaN votes, ranked as torch.argmax ranks them);
    predictions in [-1, K] and constructed ties (half-integer alphas from
    a few values: every vote sum is exact in f32, so the summation order
    cannot matter).  At letter's batch, equality with a member-by-member
    ``VoteTally`` under arbitrary alphas, which holds only if the kernel
    sums the members in ascending order.  The error returned is the
    largest |kernel - plain| class index over the exact cases."""
    results, worst = {}, 0
    cases = [(name, T, n, K) for name, (T, n, K) in VOTE_SHAPES.items()]
    cases += [("ragged", 13, 1001, 5), ("ragged", 1, 1, 2), ("ragged", 0, 7, 3),
              ("ragged", 300, 333, 7), ("ragged", 4, 300, 400),  # 4 classes a thread
              ("ragged", 6, 77, 1808),  # 16 classes a thread, 928 threads
              ("nan_alpha", 20, 203, 6)]  # NaN and inf alphas
    for name, T, n, K in cases:
        preds = torch.randint(-1, K + 1, (T, n), generator=g, dtype=torch.int32).to(DEV)
        alpha = torch.randint(0, 4, (T,), generator=g).float() * 0.5
        if name == "nan_alpha":
            alpha[3], alpha[11] = float("nan"), float("inf")
        alpha = alpha.to(DEV)
        got = poisoned(torch, (n,), lambda: ops.vote_argmax(preds, alpha, n_classes=K))
        want = ref.vote_argmax_ref(preds, alpha, K)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and got.shape == (n,), f"vote_argmax {name}: {got.dtype} {tuple(got.shape)}")
        err = int((got.long() - want.long()).abs().max()) if n else 0
        worst = max(worst, err)
        check(err == 0, f"vote_argmax {name} [{T}, {n}, {K}]: "
              f"{int((got != want).sum())} rows differ from the plain version")
        if name in VOTE_SHAPES:
            alpha_r = torch.rand(T, generator=g).to(DEV) * 3.0  # arbitrary weights
            votes = torch.einsum("t,tnk->nk", alpha_r,
                                 (preds.unsqueeze(-1) == torch.arange(K, device=DEV)).float())
            differ, near, near_differ = vote_gap_agree(
                votes, ops.vote_argmax(preds, alpha_r, n_classes=K),
                ref.vote_argmax_ref(preds, alpha_r, K), alpha_r)
            check(differ == 0, f"vote_argmax {name}: {differ} rows differ outside the near-tie gap")
            clean = torch.randint(0, K, (T, n), generator=g, dtype=torch.int32).to(DEV)
            bms, by = bound_ms(4 * (T * n + T + n), 2 * T * n)  # a compare and an add per vote
            # no single PyTorch call computes a weighted vote and its argmax: no library time
            results[name] = {
                "shape": f"preds [{T}, {n}], K={K}", "max_abs_err": err, "bound_ms": bms,
                "bound_by": by, "near_tie_rows": near, "near_tie_rows_differ": near_differ,
                **timings(torch, lambda: ops.vote_argmax(clean, alpha_r, n_classes=K),
                          lambda: ref.vote_argmax_ref(clean, alpha_r, K)),
            }
    # ascending member order, bit for bit: against a member-by-member tally at
    # letter's batch, with arbitrary alphas and with alphas a few ulps apart
    # (sums of equal counts that only the order of rounding tells apart)
    T, n, K = VOTE_SHAPES["letter"]
    preds = torch.randint(0, K, (T, n), generator=g, dtype=torch.int32).to(DEV)
    tally_rows = []
    for what, alpha in (("arbitrary", torch.rand(T, generator=g) * 3.0),
                        ("ulps apart", 1.0 + torch.randint(0, 4, (T,), generator=g) * 2.0**-23)):
        alpha = alpha.to(DEV)
        want = tally_classes(torch, preds, alpha, K)
        got = ops.vote_argmax(preds, alpha, n_classes=K)
        plain = ref.vote_argmax_ref(preds, alpha, K)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"vote_argmax letter, {what} alphas: {int((got != want).sum())} "
              "rows differ from a member-by-member VoteTally")
        tally_rows.append(f"{what}: equal in {n}/{n} rows (the plain einsum differs in "
                          f"{int((plain != want).sum())})")
    log(f"vote_argmax: {len(cases)} cases equal to the plain version, each written over a NaN-filled "
        f"block; arbitrary alphas agree outside the near-tie gap (rows inside, of them differing: "
        + ", ".join(f"{k} {v['near_tie_rows']}, {v['near_tie_rows_differ']}"
                    for k, v in results.items()) + "); against a member-by-member VoteTally at "
        f"letter [{T}, {n}, {K}]: " + "; ".join(tally_rows) + "; "
        + "; ".join(f"{k} {v['ms']:.5f} ms (bound {v['bound_ms']:.7f}, plain {v['plain_ms']:.5f}, "
                    f"eager {v['eager_ms']:.5f})" for k, v in results.items()))
    return results, float(worst)


def dirichlet_mask(fl_run):
    """The ``[8, n_max]`` padding mask of phase 10's adult Dirichlet split
    (alpha 0.5, seed 0), drawn on the CPU as ``fl_run`` draws it."""
    return fl_run.build_federation("adult", C, 1, DEPTH, 0, "cpu", split="dirichlet").masks


def check_dirichlet_shapes(torch, ops, ref, g, mask) -> dict:
    """Phase 10's new kernel shapes against the plain versions:
    ``weight_update`` over the flattened Dirichlet mask (three alphas, rtol
    1e-5, each output written over a NaN-filled block, the same bits from a
    second call, every padding slot exactly 0 and the total 1 after the
    renormalisation); ``weighted_errors`` at ``[8, 8, n_max]`` with
    zero-weight tails (rtol 1e-4, the same bits twice); ``vote_argmax`` at
    ``[30, 256]``, K = 10, equal to the plain version outside the near-tie
    gap and to a member-by-member ``VoteTally`` bit for bit.  Returns
    {kernel: {shape name: record}}."""
    Cm, n = mask.shape
    pad_share = 1.0 - float(mask.mean())
    m = mask.reshape(-1).to(DEV)
    N = m.numel()
    pad = m == 0
    w = torch.rand(N, generator=g) * mask.reshape(-1)
    w = (w / w.sum()).to(DEV)
    mis = (torch.rand(N, generator=g) < 0.3).float().to(DEV)
    worst = 0.0
    for a in (0.37, -2.0, 10.0):
        alpha = torch.tensor(a, device=DEV)
        got = poisoned(torch, (N,), lambda: ops.weight_update(w, mis, m, alpha))
        want = ref.renormalised_weight_update_ref(w, mis, m, alpha)
        worst = max(worst, assert_close(torch, "weight_update", got, want,
                                        f"Dirichlet [{Cm}, {n}] alpha={a}"))
        check(torch.equal(got, ops.weight_update(w, mis, m, alpha)),
              f"weight_update Dirichlet alpha={a}: two calls differ")
        check(bool((got[pad] == 0).all()), f"weight_update Dirichlet alpha={a}: "
              f"{int((got[pad] != 0).sum())} padding slots are not 0")
        check(abs(float(got.double().sum()) - 1.0) < 1e-5,
              f"weight_update Dirichlet alpha={a}: the total is {float(got.double().sum())}")
    alpha = torch.tensor(0.37, device=DEV)
    bms, by = bound_ms(4 * (4 * N + 1), 6 * N)
    update = {"shape": f"w [{N}] = [{Cm}, {n}], {100 * pad_share:.1f}% padding",
              "max_abs_err": worst, "bound_ms": bms, "bound_by": by,
              **timings(torch, lambda: ops.weight_update(w, mis, m, alpha),
                        lambda: ref.renormalised_weight_update_ref(w, mis, m, alpha))}

    wc = w.view(Cm, n)
    preds = torch.randint(0, 2, (Cm, Cm, n), generator=g, dtype=torch.int32).to(DEV)
    y = torch.randint(0, 2, (Cm, n), generator=g, dtype=torch.int32).to(DEV)
    got = poisoned(torch, (Cm, Cm), lambda: ops.weighted_errors(preds, y, wc))
    err = assert_close(torch, "weighted_errors", got, ref.weighted_errors_ref(preds, y, wc),
                       f"Dirichlet [{Cm}, {Cm}, {n}]")
    check(torch.equal(got, ops.weighted_errors(preds, y, wc)), "weighted_errors Dirichlet: two calls differ")
    bms, by = bound_ms(4 * (Cm * Cm * n + 2 * Cm * n + Cm * Cm), 2 * Cm * Cm * n)
    errors = {"shape": f"preds [{Cm}, {Cm}, {n}], {100 * pad_share:.1f}% zero-weight",
              "max_abs_err": err, "bound_ms": bms, "bound_by": by,
              **timings(torch, lambda: ops.weighted_errors(preds, y, wc),
                        lambda: ref.weighted_errors_ref(preds, y, wc))}

    T, nb, K = HETERO_VOTE
    vp = torch.randint(0, K, (T, nb), generator=g, dtype=torch.int32).to(DEV)
    va = (torch.rand(T, generator=g) * 3.0).to(DEV)
    got = poisoned(torch, (nb,), lambda: ops.vote_argmax(vp, va, n_classes=K))
    plain = ref.vote_argmax_ref(vp, va, K)
    tally = tally_classes(torch, vp, va, K)
    votes = torch.einsum("t,tnk->nk", va, (vp.unsqueeze(-1) == torch.arange(K, device=DEV)).float())
    differ, near, _ = vote_gap_agree(votes, got, plain, va)
    check(differ == 0, f"vote_argmax hetero [{T}, {nb}]: {differ} rows differ outside the near-tie gap")
    check(torch.equal(got, tally), f"vote_argmax hetero [{T}, {nb}]: {int((got != tally).sum())} rows "
          "differ from a member-by-member VoteTally")
    bms, by = bound_ms(4 * (T * nb + T + nb), 2 * T * nb)
    vote = {"shape": f"preds [{T}, {nb}], K={K} (3 groups x T = 10)", "max_abs_err": 0,
            "bound_ms": bms, "bound_by": by, "near_tie_rows": near,
            **timings(torch, lambda: ops.vote_argmax(vp, va, n_classes=K),
                      lambda: ref.vote_argmax_ref(vp, va, K))}
    log(f"phase 10 shapes: weight_update Dirichlet [{Cm}, {n}] ({100 * pad_share:.1f}% padding) agrees "
        f"(worst {worst:.3g}), padding exactly 0, {update['ms']:.5f} ms (bound {update['bound_ms']:.6f}, "
        f"plain {update['plain_ms']:.5f}); weighted_errors [{Cm}, {Cm}, {n}] {errors['ms']:.5f} ms "
        f"(bound {errors['bound_ms']:.6f}, plain {errors['plain_ms']:.5f}); vote_argmax [{T}, {nb}] "
        f"= a member-by-member VoteTally, {vote['ms']:.5f} ms (plain {vote['plain_ms']:.5f})")
    return {"weight_update": {"adult_dirichlet": update},
            "weighted_errors": {"adult_dirichlet": errors},
            "vote_argmax": {"hetero_pendigits": vote}}


# phase 13's process counts; at P processes each holds an adult shard of
# 32 561 // P rows (P = 8's is phase 11's collaborator shard)
DIST_PROCESSES = (1, 2, 4, 8)


def dist_shards(fl_run) -> dict:
    """{P: rows of a process's adult shard} at phase 13's process counts,
    split on the CPU as ``fl_run`` splits them (IID, seed 0)."""
    shards = {P: int(fl_run.build_inputs("adult", P, 1, DEPTH, 0)[1].shape[1])
              for P in DIST_PROCESSES}
    check(shards[C] == SHAPES["adult"][0], f"adult's shard at P = {C}: {shards[C]} rows")
    return shards


def h1_hist(torch, ops, ref, g, n: int) -> tuple:
    """``tree_hist`` at H = 1 over an adult shard of ``n`` rows, L = 1, 2,
    4, 8, K = 2, under AdaBoost's skewed weights: atol 1e-4, the plain
    version's split, each output on a NaN-filled block, the same bits
    twice.  Returns (record, worst error, the plans)."""
    from repro_torch.kernels import tree_hist as tree_hist_mod
    from repro_torch.learners.tree import _split_scores

    _, d, K = SHAPES["adult"]
    B1 = N_BINS + 1
    levels, worst, plans = {}, 0.0, []
    for L in (1, 2, 4, 8):
        bins = torch.randint(0, B1, (1, n, d), generator=g, dtype=torch.int32).to(DEV)
        leaf = torch.randint(0, L, (1, n), generator=g, dtype=torch.int32).to(DEV)
        w = torch.exp(4.0 * torch.randn(1, n, generator=g, dtype=torch.float64))
        w = (w / w.sum()).float()
        y = torch.randint(0, K, (1, n), generator=g)
        wy = (torch.nn.functional.one_hot(y, K).float() * w.unsqueeze(-1)).contiguous().to(DEV)
        got = poisoned(torch, (1, L, d, B1, K),
                       lambda: ops.tree_hist(bins, leaf, wy, n_leaves=L, n_bins_p1=B1))
        want = ref.tree_hist_batched_ref(bins, leaf, wy, L, B1)
        err = assert_close(torch, "tree_hist", got, want, f"H=1 [1, {n}, {d}] L={L}, skewed weights")
        check(torch.equal(got, ops.tree_hist(bins, leaf, wy, n_leaves=L, n_bins_p1=B1)),
              f"tree_hist H=1 [1, {n}, {d}] L={L}: two calls differ")
        check(torch.equal(torch.argmax(_split_scores(got).flatten(1), dim=1),
                          torch.argmax(_split_scores(want).flatten(1), dim=1)),
              f"tree_hist H=1 [1, {n}, {d}] L={L}: the split differs from the plain version's")
        worst = max(worst, err)
        p = tree_hist_mod.launch_plan(1, n, d, L, B1, K)
        plans.append(f"L={L} dblk {p.dblk} cs {p.cs} {p.threads} threads")
        seg = ((leaf.long().unsqueeze(-1) * d + torch.arange(d, device=DEV).view(1, 1, d)) * B1
               + bins.long()).reshape(-1)
        vals = wy.unsqueeze(2).expand(1, n, d, K).reshape(-1, K).contiguous()
        buf = torch.zeros(L * d * B1, K, device=DEV)
        bms, by = bound_ms(4 * (n * d + n + n * K + L * d * B1 * K), d * int((wy != 0).sum()))
        levels[L] = {"max_abs_err": err, "bound_ms": bms, "bound_by": by,
                     **timings(torch, lambda: ops.tree_hist(bins, leaf, wy, n_leaves=L, n_bins_p1=B1),
                               lambda: ref.tree_hist_batched_ref(bins, leaf, wy, L, B1),
                               lambda: buf.index_add_(0, seg, vals))}
    hist = {k: sum(v[k] for v in levels.values()) / len(levels)
            for k in ("ms", "plain_ms", "library_ms", "eager_ms", "bound_ms")}
    hist.update(shape=f"bin_idx [1, {n}, {d}], L=1,2,4,8, K={K}, skewed weights", levels=levels,
                max_abs_err=worst, bound_by=levels[8]["bound_by"])
    return hist, worst, plans


def shard_errors(torch, ops, ref, g, H: int, n: int) -> dict:
    """``weighted_errors`` over one shard's ``[1, H, n]`` predictions:
    rtol 1e-4, the output on a NaN-filled block, the same bits twice."""
    K = SHAPES["adult"][2]
    preds = torch.randint(0, K, (1, H, n), generator=g, dtype=torch.int32).to(DEV)
    yy = torch.randint(0, K, (1, n), generator=g, dtype=torch.int32).to(DEV)
    ww = (torch.rand(1, n, generator=g) / n).to(DEV)
    got = poisoned(torch, (1, H), lambda: ops.weighted_errors(preds, yy, ww))
    err = assert_close(torch, "weighted_errors", got, ref.weighted_errors_ref(preds, yy, ww),
                       f"one shard [1, {H}, {n}]")
    check(torch.equal(got, ops.weighted_errors(preds, yy, ww)),
          f"weighted_errors [1, {H}, {n}]: two calls differ")
    bms, by = bound_ms(4 * (H * n + 2 * n + H), 2 * H * n)
    return {"shape": f"preds [1, {H}, {n}]", "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            **timings(torch, lambda: ops.weighted_errors(preds, yy, ww),
                      lambda: ref.weighted_errors_ref(preds, yy, ww))}


def update_record(torch, ops, ref, g, name: str, N: int) -> dict:
    """``weight_update`` (renormalised, rtol 1e-5) or
    ``weight_update_product`` (rtol 1e-6) over ``[N]`` against its plain
    version: three alphas, a mask with zeros, each output on a NaN-filled
    block, the same bits twice."""
    fn, plain, ops_each = {
        # operations an element: the product (an exp and three multiplies),
        # and for the renormalised entry an add and a division
        "weight_update": (ops.weight_update, ref.renormalised_weight_update_ref, 6),
        "weight_update_product": (ops.weight_update_product, ref.boost_weight_update_ref, 4),
    }[name]
    w = (torch.rand(N, generator=g) / N).to(DEV)
    mis = (torch.rand(N, generator=g) < 0.3).float().to(DEV)
    mask = torch.ones(N)
    mask[3::7] = 0.0
    mask = mask.to(DEV)
    err = 0.0
    for a in (0.37, -2.0, 10.0):
        alpha = torch.tensor(a, device=DEV)
        got = poisoned(torch, (N,), lambda: fn(w, mis, mask, alpha))
        err = max(err, assert_close(torch, name, got, plain(w, mis, mask, alpha), f"[{N}] alpha={a}"))
        check(torch.equal(got, fn(w, mis, mask, alpha)), f"{name} [{N}] alpha={a}: two calls differ")
    alpha = torch.tensor(0.37, device=DEV)
    # bytes: w, mis, mask and alpha read once, out written once; no single
    # PyTorch call computes either entry: no library time
    bms, by = bound_ms(4 * (4 * N + 1), ops_each * N)
    return {"shape": f"w [{N}]", "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            **timings(torch, lambda: fn(w, mis, mask, alpha), lambda: plain(w, mis, mask, alpha))}


def check_shard_shapes(torch, ops, ref, g, shards: dict) -> dict:
    """The kernels at one collaborator's shard, as phase 11's interpreted
    round (C = 8) and each process of phase 13's runs at P processes give
    them (``shards``: {P: n}; P = 8's n is phase 11's): ``tree_hist`` at
    H = 1 (``[1, n, 14]``, :func:`h1_hist`), ``weighted_errors`` at
    ``[1, P, n]`` (:func:`shard_errors`; its cluster plan depends on the
    row count), and each process's updates (:func:`update_record`): the
    renormalised ``weight_update`` over the replicated ``[P·n]`` (the
    lockstep runtime) and ``weight_update_product`` over its own ``[n]``
    (the elastic star).  Returns {kernel: {shape name: record}}."""
    out = {"tree_hist": {}, "weighted_errors": {}, "weight_update": {}, "weight_update_product": {}}
    rows = []
    for P, n in shards.items():
        hist, worst, plans = h1_hist(torch, ops, ref, g, n)
        errors = shard_errors(torch, ops, ref, g, P, n)
        update = update_record(torch, ops, ref, g, "weight_update", P * n)
        product = update_record(torch, ops, ref, g, "weight_update_product", n)
        # phase 11's names for its shard
        hist_key, errors_key = ("adult_h1", "adult_c1") if P == C else (f"dist_p{P}", f"dist_p{P}")
        out["tree_hist"][hist_key] = hist
        out["weighted_errors"][errors_key] = errors
        out["weight_update"][f"dist_p{P}"] = update
        out["weight_update_product"][f"dist_p{P}"] = product
        rows.append(f"P={P}: tree_hist [1, {n}, 14] worst {worst:.3g} ({'; '.join(plans)}), mean "
                    f"{hist['ms']:.5f} ms (bound {hist['bound_ms']:.6f}, plain {hist['plain_ms']:.5f}, "
                    f"index_add_ {hist['library_ms']:.5f}); weighted_errors [1, {P}, {n}] "
                    f"{errors['ms']:.5f} ms (bound {errors['bound_ms']:.6f}, plain "
                    f"{errors['plain_ms']:.5f}); weight_update [{P * n}] {update['ms']:.5f} ms (bound "
                    f"{update['bound_ms']:.6f}, plain {update['plain_ms']:.5f}); weight_update_product "
                    f"[{n}] {product['ms']:.5f} ms (bound {product['bound_ms']:.6f}, plain "
                    f"{product['plain_ms']:.5f})")
    log("phase 11 and 13 shard shapes against the plain versions, skewed weights for tree_hist, "
        "the plain version's split at every level:\n  " + "\n  ".join(rows))
    return out


def visible_pairs(S: int, T: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through for one (b, h): the work
    a flash kernel must do on these shapes."""
    total = 0
    for i in range(S):
        pos = i + T - S
        hi = min(T - 1, pos) if causal else T - 1
        lo = max(0, pos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def check_flash_attention(torch, ops, ref, g):
    """Each case against the plain version on the card, at ``TOL`` (every
    case logged, then any that disagree named); at gemma-2b's shapes the kernel's, the plain
    version's and SDPA's device times (SDPA's causal mask aligns top-left,
    so it computes the same function only at S == T, as here) and the
    bound: 4·D flops per visible pair over the bf16 peak, against q, k, v
    and o moved once."""
    import torch.nn.functional as F

    results, worst, failed = {}, 0.0, []
    for name, (B, H, Hkv, S, T, D, causal, window, softcap, bf16) in FLASH_CASES.items():
        dt = torch.bfloat16 if bf16 else torch.float32
        q, k, v = (torch.randn(shape, generator=g).to(dt).to(DEV)
                   for shape in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))
        kw = {"causal": causal, "window": window, "softcap": softcap}
        got = ops.flash_attention(q, k, v, **kw).float()
        want = ref.attention_ref(q, k, v, **kw).float()
        torch.cuda.synchronize()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"flash_attention {name}: shape {tuple(got.shape)} or non-finite output")
        # every case is compared and logged before any failure is raised, so
        # that a wrong kernel shows how far off it is at each shape
        tol = TOL["flash_attention_bf16" if bf16 else "flash_attention"]
        err = max_err(got, want)
        use = float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())
        log(f"flash_attention {name}: max |kernel - plain| {err:.4g}, {use:.3f} of the limit {tol}, "
            f"mean |plain| {float(want.abs().mean()):.4g}")
        if use > 1.0:
            failed.append(f"{name} ({err:.4g})")
        worst = max(worst, err)
        if name in FLASH_TIMED:
            elt = q.element_size()
            nbytes = elt * (2 * q.numel() + k.numel() + v.numel())
            flops = 4 * D * B * H * visible_pairs(S, T, causal, window)
            bms, by = bound_ms(nbytes, flops, BF16_OPS_PER_S if bf16 else F32_OPS_PER_S)
            results[name] = {
                "shape": f"q [{B}, {H}, {S}, {D}], k/v [{B}, {Hkv}, {T}, {D}], "
                         f"{'bf16' if bf16 else 'f32'}, causal", "max_abs_err": err,
                "bound_ms": bms, "bound_by": by,
                **timings(torch, lambda: ops.flash_attention(q, k, v, **kw),
                          lambda: ref.attention_ref(q, k, v, **kw),
                          lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                 enable_gqa=True)),
            }
    check(not failed, f"flash_attention disagrees with its plain version in: {', '.join(failed)}")
    log(f"flash_attention: {len(FLASH_CASES)} cases agree, worst max_abs_err {worst:.3g}; "
        + "; ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.5f}, plain {v['plain_ms']:.4f}, "
                    f"SDPA {v['library_ms']:.4f}, eager {v['eager_ms']:.4f})"
                    for k, v in results.items()))
    return results, worst


# -- phases 4-6: the federation ---------------------------------------------------


def run_fl(fl_run, dataset: str, rounds: int, device: str, tag: str, extra=()) -> dict:
    """One ``fl_run`` invocation as a user would make it; returns its
    history file (history rows + every round's metrics)."""
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"chip_smoke_{tag}.json"
    argv = ["--dataset", dataset, "--rounds", str(rounds), "--collaborators", str(C),
            "--depth", str(DEPTH), "--eval-every", str(MAIN["eval_every"]), "--seed", "0",
            "--device", device, "--history-out", str(path), *extra]
    log(f"$ python -m repro_torch.launch.fl_run {' '.join(argv)}")
    fl_run.main(argv)
    return json.loads(path.read_text())


def no_launches(ops) -> dict:
    return {name: 0 for name in ops.launch_counts()}


def check_run(run: dict, rounds: int, what: str, space: int = C) -> None:
    """``space``: the hypotheses a round chooses from (C; PreWeak.F's C*T)."""
    check(len(run["rounds"]) == rounds, f"{what}: {len(run['rounds'])} rounds recorded, not {rounds}")
    f1 = run["history"][-1]["f1"]
    check(0.0 < f1 <= 1.0, f"{what}: final F1 {f1} outside (0, 1]")
    for r in run["rounds"]:
        check(0 <= r["chosen"] < space, f"{what}: chosen {r['chosen']} out of range")
        check(0.0 <= r["epsilon"] <= 1.0, f"{what}: epsilon {r['epsilon']} outside [0, 1]")
        check(abs(r["alpha"]) <= 10.0, f"{what}: alpha {r['alpha']} outside [-10, 10]")


def host_ops(torch, ops, fn) -> dict:
    """The host operations ``fn()`` issues: PyTorch operators through the
    dispatcher (counted by a ``TorchDispatchMode``; most launch a kernel,
    each costs the host its dispatch) and the port's own kernel launches,
    which bypass the dispatcher."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    before = ops.launch_counts()
    with Count() as count:
        fn()
    kernels = sum(ops.launch_counts().values()) - sum(before.values())
    torch_ops = sum(count.ops.values())
    return {"host_ops": torch_ops + kernels, "torch_ops": torch_ops, "kernel_launches": kernels,
            "scalar_reads": count.ops.get("_local_scalar_dense", 0),
            "top": dict(count.ops.most_common(8))}


def round_host_ops(torch, ops, fl_run) -> dict:
    """Host operations of one steady adult round (the sixth of ten) and of
    its weight update alone (``scoring.update_weights``)."""
    from repro_torch.core import boosting, scoring

    fed = fl_run.build_federation("adult", C, MAIN["rounds"], DEPTH, 0, DEV)
    state = boosting.init_boost_state(fed.learner, fed.spec, MAIN["rounds"], fed.masks, X=fed.Xs)
    for _ in range(MAIN["rounds"] // 2):
        state, _ = boosting.adaboost_f_round(fed.learner, fed.spec, state, fed.Xs, fed.ys, fed.masks)
    box = {}

    def one_round():
        box["state"], _ = boosting.adaboost_f_round(fed.learner, fed.spec, state, fed.Xs, fed.ys,
                                                    fed.masks)

    per_round = host_ops(torch, ops, one_round)
    mis = (torch.rand(state.weights.shape, device=DEV) < 0.3).float()
    alpha = torch.tensor(0.37, device=DEV)
    update = host_ops(torch, ops, lambda: scoring.update_weights(state.weights, mis, fed.masks, alpha))
    torch.cuda.synchronize()
    return {"round": per_round, "update_weights": update}


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


def profile_round(torch, fl_run, card: str, rounds: int = MAIN["rounds"], label: str = "adult",
                  run_kw: dict | None = None, **build) -> None:
    """Device time by kernel and the device's busy share over an adult
    run's rounds (set-up excluded; the main path's by default, ``build``
    gives ``build_federation`` other flags, ``run_kw`` ``Federation.run``
    an elastic policy and faults), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fed = fl_run.build_federation("adult", C, rounds, DEPTH, 0, DEV, **build)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fed.run(eval_every=MAIN["eval_every"], **(run_kw or {}))
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = [(e.key, e.count, getattr(e, "device_time_total", None) or e.cuda_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    if not busy_us:
        log(f"profile: torch.profiler recorded no device time on {card}; busy share not measured")
        return
    evals = len(range(MAIN["eval_every"] - 1, rounds, MAIN["eval_every"])) + (rounds % MAIN["eval_every"] != 0)
    log(f"profile ({label}, {rounds} rounds incl. set-up and {evals} eval(s), profiler on, {card}): "
        f"wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {sum(r[1] for r in rows)} device activities")
    for key, count, us in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:110]}")


# -- phase 7: serving ---------------------------------------------------------------


def run_serve(torch, ops, ref, serve_fl, argv: list, what: str) -> tuple:
    """One ``serve_fl`` invocation as a user would make it, with every
    launch count set to 0 just before; checks one ``vote_argmax`` launch
    per batch and per warm-up, and no plain version on the card (the
    cache-equals-engine check is serve_fl's own: it raises)."""
    log(f"$ python -m repro_torch.launch.serve_fl {' '.join(argv)}")
    calls = dict(ref.device_calls)
    ops.reset_launches()
    out = serve_fl.main(argv)
    launches = ops.launch_counts()
    st = out["stats"]
    check(launches["vote_argmax"] == st.batches + st.warmup_batches,
          f"{what}: {launches['vote_argmax']} vote_argmax launches for {st.batches} batches "
          f"and {st.warmup_batches} warm-ups")
    check(ref.device_calls == calls, f"{what}: a plain version ran on CUDA tensors: {ref.device_calls}")
    check(0.0 < out["f1"] <= 1.0, f"{what}: F1 {out['f1']} outside (0, 1]")
    return out, launches


def card_vs_cpu(torch, path: Path, dataset: str, card_pred, what: str) -> str:
    """Serve the card's artifact on the CPU (plain versions) over the same
    rows; the two must agree on every row outside the near-tie gap."""
    from repro_torch.core import boosting, hetero
    from repro_torch.data import get_dataset
    from repro_torch.serve import ServeEngine, load_artifact

    art = load_artifact(path, "cpu")
    _, (_, _, Xte, _) = get_dataset(dataset, torch.Generator().manual_seed(0))
    cpu_pred = ServeEngine.from_artifact(art).predict(Xte.numpy())
    if art.hetero:
        votes = hetero.hetero_ensemble_votes(art.spec, art.ensemble, Xte, committee=art.committee)
        used = hetero.hetero_used_weights(art.ensemble, committee=art.committee)
    else:
        votes = boosting.ensemble_votes(art.learner, art.spec, art.ensemble, Xte,
                                        committee=art.committee)
        used = art.ensemble.alpha[: art.ensemble.count]
    differ, near, _ = vote_gap_agree(votes, torch.from_numpy(cpu_pred), torch.from_numpy(card_pred),
                                     used)
    check(differ == 0, f"{what}: card and CPU differ on {differ} rows outside the near-tie gap")
    agree = int((torch.from_numpy(cpu_pred) == torch.from_numpy(card_pred)).sum())
    return (f"{what}: card and CPU agree on {agree}/{len(cpu_pred)} rows; "
            f"{near} rows inside the near-tie gap")


def serve_phase(torch, ops, ref, card: str) -> dict:
    from repro_torch.launch import serve_fl

    SERVE.mkdir(parents=True, exist_ok=True)
    art = SERVE / "pendigits.mafl"
    # both policies serve the split again and again for WINDOW_S, so their
    # p99 rests on some 10^5 requests rather than one pass's 3498
    window = ["--serve-seconds", str(WINDOW_S)]
    sync, launches = run_serve(torch, ops, ref, serve_fl,
                               ["--dataset", "pendigits", "--artifact", str(art), "--policy", "sync",
                                *window], "pendigits sync")
    deadline, _ = run_serve(torch, ops, ref, serve_fl,
                            ["--dataset", "pendigits", "--artifact", str(art), "--load",
                             "--policy", "deadline", *window], "pendigits deadline (--load)")
    check(bool((sync["pred"] == deadline["pred"]).all()), "the loaded artifact served other votes")
    pub_dir = SERVE / "pendigits_pub"
    shutil.rmtree(pub_dir, ignore_errors=True)
    pub, _ = run_serve(torch, ops, ref, serve_fl,
                       ["--dataset", "pendigits", "--publish-every", "2", "--publish-dir", str(pub_dir)],
                       "pendigits --publish-every 2")
    check(len(pub["published"]) == 5, f"{len(pub['published'])} checkpoints published, not 5")
    letter_art = SERVE / "letter.mafl"
    letter, _ = run_serve(torch, ops, ref, serve_fl,
                          ["--dataset", "letter", "--rounds", "100", "--artifact", str(letter_art)],
                          "letter 100 rounds")
    log(card_vs_cpu(torch, art, "pendigits", sync["pred"], "pendigits"))
    log(card_vs_cpu(torch, letter_art, "letter", letter["pred"], "letter"))
    rows = {"sync": sync, "deadline": deadline, "letter sync": letter}
    log(f"serving on {card}: " + "; ".join(
        f"{k} {v['requests']} requests in {v['seconds']:.3f} s = {v['requests'] / v['seconds']:.0f} "
        f"req/s p50 {v['p50_ms']:.3f} ms p99 {v['p99_ms']:.3f} ms "
        f"({v['stats'].batches} batches, batch p50 {1e3 * v['stats'].batch_seconds.percentile(50):.3f} "
        f"ms p99 {1e3 * v['stats'].batch_seconds.percentile(99):.3f} ms"
        + (f", queue wait p50 {v['wait_p50_ms']:.3f} ms p99 {v['wait_p99_ms']:.3f} ms"
           if "wait_p50_ms" in v else "") + ")"
        for k, v in rows.items()))
    profile_serving(torch, art, card)
    st = sync["stats"]
    return launches, st.batches + st.warmup_batches


def profile_serving(torch, path: Path, card: str) -> None:
    """Where a served batch's time goes: the device's busy share and its
    kernels over ``engine.predict`` of pendigits' test split (14 batches,
    warm engine), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import get_dataset
    from repro_torch.serve import ServeEngine, load_artifact

    engine = ServeEngine.from_artifact(load_artifact(path))
    engine.warmup()
    _, (_, _, Xte, _) = get_dataset("pendigits", torch.Generator().manual_seed(0))
    X = Xte.numpy()
    engine.predict(X)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(X)
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = [(e.key, e.count, getattr(e, "device_time_total", None) or e.cuda_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(r[2] for r in rows)
    if not busy_us:
        log(f"serving profile: torch.profiler recorded no device time on {card}; busy share not measured")
        return
    rows.sort(key=lambda r: -r[2])
    log(f"serving profile (pendigits engine.predict, 3498 rows, 14 batches, profiler on, {card}): "
        f"wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {sum(r[1] for r in rows)} device activities")
    for key, count, us in rows[:8]:
        log(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:110]}")


# -- phase 9: the other algorithms and learner, and committee serving ---------------

# (tag, fl_run flags, rounds, launches, hypotheses a round chooses from); adult, C = 8
ALGORITHM_RUNS = [
    ("distboost_f", ["--algorithm", "distboost_f"], 10,
     {"tree_hist": 40, "weighted_errors": 0, "weight_update": 10}, C),
    ("preweak_f", ["--algorithm", "preweak_f"], 10,
     {"tree_hist": 40, "weighted_errors": 10, "weight_update": 10}, 10 * C),
    # the re-planned weighted_errors at full width: [8, 800, 4070] a round
    ("preweak_f_t100", ["--algorithm", "preweak_f"], 100,
     {"tree_hist": 400, "weighted_errors": 100, "weight_update": 100}, 100 * C),
    ("bagging", ["--algorithm", "bagging"], 10,
     {"tree_hist": 40, "weighted_errors": 0, "weight_update": 0}, C),
    ("extra_tree", ["--learner", "extra_tree"], 10,
     {"tree_hist": 40, "weighted_errors": 10, "weight_update": 10}, C),
]


def preweak_setup_ms(torch, fl_run, rounds: int) -> float:
    """Host ms of PreWeak.F's set-up on the card (T local rounds for every
    collaborator, then the [C, C*T, n] prediction cache), ended by a sync."""
    from repro_torch.core import boosting

    fed = fl_run.build_federation("adult", C, rounds, DEPTH, 0, DEV, algorithm="preweak_f")
    state = boosting.init_boost_state(fed.learner, fed.spec, rounds, fed.masks, X=fed.Xs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    space, _ = boosting.preweak_f_setup(fed.learner, fed.spec, state, fed.Xs, fed.ys, fed.masks, rounds,
                                        fed.generator)
    boosting.preweak_f_predictions(fed.learner, fed.spec, space, fed.Xs)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def algorithms_phase(torch, ops, ref, fl_run, card: str) -> None:
    ms_round = {}
    for tag, extra, rounds, want, space in ALGORITHM_RUNS:
        ops.reset_launches()
        calls = dict(ref.device_calls)
        run = run_fl(fl_run, "adult", rounds, "cuda", f"{tag}_cuda", extra)
        got = ops.launch_counts()
        check(got == {**no_launches(ops), **want}, f"{tag}: launches {got} != {want}")
        check(ref.device_calls == calls, f"{tag}: a plain version ran on CUDA tensors: {ref.device_calls}")
        check_run(run, rounds, f"{tag} on the card", space)
        ms_round[tag] = 1e3 * run["history"][-1]["round_seconds"]
        if rounds != MAIN["rounds"]:
            log(f"{tag}: {rounds} rounds, final F1 {run['history'][-1]['f1']:.4f}, launches {got}")
            continue
        cpu = run_fl(fl_run, "adult", rounds, "cpu", f"{tag}_cpu", extra)
        check_run(cpu, rounds, f"{tag} on the CPU", space)
        g0, c0 = run["rounds"][0], cpu["rounds"][0]
        check(g0["chosen"] == c0["chosen"], f"{tag} round 0 chosen: card {g0['chosen']} vs CPU {c0['chosen']}")
        check(abs(g0["epsilon"] - c0["epsilon"]) <= 1e-4 * abs(c0["epsilon"]),
              f"{tag} round 0 epsilon: card {g0['epsilon']} vs CPU {c0['epsilon']}")
        f1_gpu, f1_cpu = run["history"][-1]["f1"], cpu["history"][-1]["f1"]
        check(abs(f1_gpu - f1_cpu) <= 0.02, f"{tag} final F1: card {f1_gpu} vs CPU {f1_cpu}")
        agree = sum(a["chosen"] == b["chosen"] for a, b in zip(run["rounds"], cpu["rounds"]))
        log(f"{tag}: launches {got}; card vs CPU: chosen agrees in {agree}/{rounds} rounds, "
            f"final F1 {f1_gpu:.4f} vs {f1_cpu:.4f}")
    log(f"ms/round (the last history row: rounds 5-9 of 10, 95-99 of 100; one eval) on {card}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms_round.items()))
    log(f"PreWeak.F set-up ms (adult, C = 8; T local rounds, then the prediction cache) on {card}: "
        + ", ".join(f"T = {t} {preweak_setup_ms(torch, fl_run, t):.3f}" for t in (10, 100)))


def committee_serving(torch, ops, ref, fl_run, card: str) -> None:
    """A DistBoost.F committee artifact published by a pendigits run (C = 4,
    10 rounds), served through ``serve_fl --artifact ... --load``."""
    from repro_torch.launch import serve_fl
    from repro_torch.serve import latest_artifact

    pub = SERVE / "pendigits_distboost"
    shutil.rmtree(pub, ignore_errors=True)
    log("$ python -m repro_torch.launch.fl_run --dataset pendigits --collaborators 4 --rounds 10 "
        f"--algorithm distboost_f --publish-every 10 --publish-dir {pub}")
    fl_run.main(["--dataset", "pendigits", "--collaborators", "4", "--rounds", "10", "--depth", str(DEPTH),
                 "--eval-every", "10", "--algorithm", "distboost_f", "--publish-every", "10",
                 "--publish-dir", str(pub)])
    path = latest_artifact(pub)
    out, launches = run_serve(torch, ops, ref, serve_fl,
                              ["--dataset", "pendigits", "--artifact", str(path), "--load"],
                              "pendigits DistBoost.F committee (--load)")
    st = out["stats"]
    log(f"committee serving on {card}: {launches['vote_argmax']} vote_argmax launches for "
        f"{st.batches} batches and {st.warmup_batches} warm-up, F1 {out['f1']:.4f}, batch p50 "
        f"{1e3 * st.batch_seconds.percentile(50):.3f} ms; vote cache {out['cache']}")
    log(card_vs_cpu(torch, path, "pendigits", out["pred"], "pendigits committee"))


# -- phase 10: the other learners, the Dirichlet split, heterogeneous federations ---

MIX6 = "decision_tree,extra_tree,ridge,gaussian_nb,nearest_centroid,mlp"
MIX3 = "decision_tree,ridge,gaussian_nb"
# (tag, fl_run flags, launches over 10 rounds, hypotheses a round chooses
# from); adult, C = 8.  Six names over 8 collaborators put two in each tree
# group: a level is one tree_hist a group, so 8 a round
HETERO_RUNS = [
    *[(name, ["--learner", name], {"tree_hist": 0, "weighted_errors": 10, "weight_update": 10}, C)
      for name in ("ridge", "gaussian_nb", "nearest_centroid", "mlp")],
    ("dirichlet", ["--split", "dirichlet"],
     {"tree_hist": 40, "weighted_errors": 10, "weight_update": 10}, C),
    ("mixed6_dirichlet", ["--learners", MIX6, "--split", "dirichlet"],
     {"tree_hist": 80, "weighted_errors": 10, "weight_update": 10}, C),
    ("mixed3_distboost_f", ["--learners", MIX3, "--algorithm", "distboost_f"],
     {"tree_hist": 40, "weighted_errors": 0, "weight_update": 10}, C),
    ("mixed3_preweak_f", ["--learners", MIX3, "--algorithm", "preweak_f"],
     {"tree_hist": 40, "weighted_errors": 10, "weight_update": 10}, 10 * C),
    ("mixed3_bagging", ["--learners", MIX3, "--algorithm", "bagging"],
     {"tree_hist": 40, "weighted_errors": 0, "weight_update": 0}, C),
]


def mixed_round_host_ops(torch, ops, fl_run) -> dict:
    """Host operations of one steady mixed adult round (the sixth of ten):
    the six families over 8 collaborators on the Dirichlet split, the
    winner's one read on the host among them."""
    from repro_torch.core import boosting, hetero

    fed = fl_run.build_federation("adult", C, MAIN["rounds"], DEPTH, 0, DEV,
                                  learners=tuple(MIX6.split(",")), split="dirichlet")
    state = hetero.init_hetero_boost_state(fed.spec, MAIN["rounds"], fed.masks, X=fed.Xs)
    stages = hetero.hetero_adaboost_f_stages(fed.spec, generator=fed.generator)
    for _ in range(MAIN["rounds"] // 2):
        state, _ = boosting.run_stages(stages, state, fed.Xs, fed.ys, fed.masks)
    out = host_ops(torch, ops, lambda: boosting.run_stages(stages, state, fed.Xs, fed.ys, fed.masks))
    torch.cuda.synchronize()
    return out


def hetero_phase(torch, ops, ref, fl_run, card: str) -> None:
    ms_round = {}
    for tag, extra, want, space in HETERO_RUNS:
        ops.reset_launches()
        calls = dict(ref.device_calls)
        run = run_fl(fl_run, "adult", MAIN["rounds"], "cuda", f"{tag}_cuda", extra)
        got = ops.launch_counts()
        check(got == {**no_launches(ops), **want}, f"{tag}: launches {got} != {want}")
        check(ref.device_calls == calls, f"{tag}: a plain version ran on CUDA tensors: {ref.device_calls}")
        check_run(run, MAIN["rounds"], f"{tag} on the card", space)
        ms_round[tag] = 1e3 * run["history"][-1]["round_seconds"]
        cpu = run_fl(fl_run, "adult", MAIN["rounds"], "cpu", f"{tag}_cpu", extra)
        check_run(cpu, MAIN["rounds"], f"{tag} on the CPU", space)
        g0, c0 = run["rounds"][0], cpu["rounds"][0]
        check(g0["chosen"] == c0["chosen"], f"{tag} round 0 chosen: card {g0['chosen']} vs CPU {c0['chosen']}")
        f1_gpu, f1_cpu = run["history"][-1]["f1"], cpu["history"][-1]["f1"]
        check(abs(f1_gpu - f1_cpu) <= 0.02, f"{tag} final F1: card {f1_gpu} vs CPU {f1_cpu}")
        agree = sum(a["chosen"] == b["chosen"] for a, b in zip(run["rounds"], cpu["rounds"]))
        log(f"{tag}: launches {got}; card vs CPU: chosen agrees in {agree}/{MAIN['rounds']} rounds, "
            f"round 0 epsilon {g0['epsilon']:.7g} vs {c0['epsilon']:.7g}, final F1 {f1_gpu:.4f} vs "
            f"{f1_cpu:.4f}")
    log(f"ms/round (the last history row: rounds 5-9 of 10, one eval) on {card}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms_round.items()))
    profile_round(torch, fl_run, card, rounds=3, label="adult, six families, Dirichlet",
                  learners=tuple(MIX6.split(",")), split="dirichlet")
    counted = mixed_round_host_ops(torch, ops, fl_run)
    log(f"host operations (adult, six families over 8 collaborators, Dirichlet, round 6 of 10; "
        f"PyTorch operators + kernel launches): {counted['host_ops']} ({counted['torch_ops']} + "
        f"{counted['kernel_launches']}), {counted['scalar_reads']} read(s) of a device scalar on the "
        f"host; most frequent {counted['top']}")


def hetero_serving(torch, ops, ref, fl_run, card: str) -> None:
    """``serve_fl --learners`` on pendigits (C = 6): the publish loop, its
    last v2 artifact served with ``--load``, a heterogeneous DistBoost.F
    committee artifact, and ``--learner ridge``; each against the CPU."""
    from repro_torch.launch import serve_fl
    from repro_torch.serve import latest_artifact

    pub = SERVE / "pendigits_hetero"
    shutil.rmtree(pub, ignore_errors=True)
    loop, _ = run_serve(torch, ops, ref, serve_fl,
                        ["--dataset", "pendigits", "--learners", MIX3, "--collaborators", "6",
                         "--rounds", "10", "--publish-every", "2", "--publish-dir", str(pub)],
                        "pendigits --learners, publish every 2")
    check(len(loop["published"]) == 5, f"{len(loop['published'])} checkpoints published, not 5")
    final = loop["published"][-1]
    loaded, launches = run_serve(torch, ops, ref, serve_fl,
                                 ["--dataset", "pendigits", "--artifact", str(final), "--load",
                                  "--policy", "sync"], "pendigits heterogeneous v2 (--load)")
    check(bool((loaded["pred"] == loop["pred"]).all()), "the loaded v2 artifact served other votes")
    st = loaded["stats"]
    log(f"heterogeneous serving on {card}: {launches['vote_argmax']} vote_argmax launches for "
        f"{st.batches} batches and {st.warmup_batches} warm-up, F1 {loaded['f1']:.4f}, batch p50 "
        f"{1e3 * st.batch_seconds.percentile(50):.3f} ms; vote cache {loaded['cache']}")
    log(card_vs_cpu(torch, final, "pendigits", loaded["pred"], "pendigits heterogeneous"))

    pubc = SERVE / "pendigits_hetero_distboost"
    shutil.rmtree(pubc, ignore_errors=True)
    argv = ["--dataset", "pendigits", "--collaborators", "6", "--rounds", "10", "--depth", str(DEPTH),
            "--eval-every", "10", "--algorithm", "distboost_f", "--learners", MIX3,
            "--publish-every", "10", "--publish-dir", str(pubc)]
    log(f"$ python -m repro_torch.launch.fl_run {' '.join(argv)}")
    fl_run.main(argv)
    path = latest_artifact(pubc)
    committee, launches = run_serve(torch, ops, ref, serve_fl,
                                    ["--dataset", "pendigits", "--artifact", str(path), "--load"],
                                    "pendigits heterogeneous DistBoost.F committee (--load)")
    st = committee["stats"]
    log(f"heterogeneous committee serving on {card}: {launches['vote_argmax']} vote_argmax launches "
        f"for {st.batches} batches and {st.warmup_batches} warm-up, F1 {committee['f1']:.4f}")
    log(card_vs_cpu(torch, path, "pendigits", committee["pred"], "pendigits heterogeneous committee"))

    ridge_art = SERVE / "pendigits_ridge.mafl"
    ridge, launches = run_serve(torch, ops, ref, serve_fl,
                                ["--dataset", "pendigits", "--learner", "ridge", "--artifact",
                                 str(ridge_art)], "pendigits --learner ridge")
    log(f"ridge serving on {card}: {launches['vote_argmax']} vote_argmax launches for "
        f"{ridge['stats'].batches} batches and {ridge['stats'].warmup_batches} warm-up, "
        f"F1 {ridge['f1']:.4f}")
    log(card_vs_cpu(torch, ridge_art, "pendigits", ridge["pred"], "pendigits ridge"))


# -- phase 11: the interpreted round, FedAvg and the §5.1 flags -------------------------

# launches of one interpreted adult round (C = 8, depth 4): a fit per
# collaborator, a weighted_errors per shard, a product per collaborator
INTERPRETED_ROUND = {"tree_hist": C * DEPTH, "weighted_errors": C, "weight_update": 0,
                     "weight_update_product": C}
# the §5.1 ladder (the paper's Fig. 3): each step turns one more flag on
LADDER = [
    ("faithful", {}),
    ("+packed_serialization", {"packed_serialization": True}),
    ("+bounded_tensordb", {"bounded_tensordb": True}),
    ("+fast_barrier", {"fast_barrier": True}),
    ("+fused_round", {"fused_round": True}),
    ("+cache_predictions", {"cache_predictions": True}),
    ("batched_fit off", {"batched_fit": False}),
]


def ladder_step(torch, fl_run, flags, algorithm: str = "adaboost_f") -> dict:
    """One adult run (10 rounds, eval every 5) built with ``flags`` through
    ``fl_run.build_federation``; ms/round is the last history row's
    (rounds 5-9, one eval), host clock."""
    fed = fl_run.build_federation("adult", C, MAIN["rounds"], DEPTH, 0, DEV, algorithm=algorithm,
                                  optimizations=flags)
    hist = fed.run(eval_every=MAIN["eval_every"])
    torch.cuda.synchronize()
    return {"ms_round": 1e3 * hist[-1]["round_seconds"], "f1": hist[-1]["f1"],
            "peak_entries": fed.aggregator.db.peak_entries, "comm_mb": fed.comm_bytes / 1e6,
            "barrier_s": fed.barrier.waited_seconds, "rounds": fed.per_round()}


def interpreted_phase(torch, ops, ref, fl_run, card: str, fused_run: dict) -> int:
    """``--faithful`` at full width on the card and the CPU, the §5.1
    ladder, PreWeak.F without its cache and FedAvg.  Returns the product
    kernel's launches in the ``--faithful`` run."""
    import dataclasses

    rounds = MAIN["rounds"]
    ops.reset_launches()
    calls = dict(ref.device_calls)
    run = run_fl(fl_run, "adult", rounds, "cuda", "faithful_cuda", ["--faithful"])
    got = ops.launch_counts()
    product_launches = got["weight_update_product"]
    want = {**no_launches(ops), **{k: v * rounds for k, v in INTERPRETED_ROUND.items()}}
    check(got == want, f"--faithful: launches {got} != {want}")
    check(ref.device_calls == calls, f"--faithful: a plain version ran on CUDA tensors: {ref.device_calls}")
    check_run(run, rounds, "--faithful on the card")
    cpu = run_fl(fl_run, "adult", rounds, "cpu", "faithful_cpu", ["--faithful"])
    check_run(cpu, rounds, "--faithful on the CPU")
    g0, c0 = run["rounds"][0], cpu["rounds"][0]
    check(g0["chosen"] == c0["chosen"], f"--faithful round 0 chosen: card {g0['chosen']} vs CPU {c0['chosen']}")
    f1_gpu, f1_cpu = run["history"][-1]["f1"], cpu["history"][-1]["f1"]
    check(abs(f1_gpu - f1_cpu) <= 0.02, f"--faithful final F1: card {f1_gpu} vs CPU {f1_cpu}")
    check(run["comm_bytes"] == cpu["comm_bytes"], f"--faithful comm bytes: card {run['comm_bytes']} "
          f"vs CPU {cpu['comm_bytes']}")
    agree = sum(a["chosen"] == b["chosen"] for a, b in zip(run["rounds"], cpu["rounds"]))
    f0 = fused_run["rounds"][0]
    check(g0["chosen"] == f0["chosen"], f"--faithful round 0 chosen {g0['chosen']} vs the fused "
          f"run's {f0['chosen']}")
    f1_fused = fused_run["history"][-1]["f1"]
    check(abs(f1_gpu - f1_fused) <= 0.02, f"--faithful final F1 {f1_gpu} vs the fused run's {f1_fused}")
    agree_fused = sum(a["chosen"] == b["chosen"] for a, b in zip(run["rounds"], fused_run["rounds"]))
    log(f"--faithful (adult, C = {C}, {rounds} rounds) on {card}: launches {got} "
        f"({INTERPRETED_ROUND} a round); card vs CPU: chosen agrees in "
        f"{agree}/{rounds} rounds, final F1 {f1_gpu:.4f} vs {f1_cpu:.4f}; card interpreted vs card "
        f"fused: chosen agrees in {agree_fused}/{rounds}, F1 {f1_gpu:.4f} vs {f1_fused:.4f}; "
        f"{1e3 * run['history'][-1]['round_seconds']:.3f} ms/round (rounds 5-9, one eval), comm "
        f"{run['comm_bytes']} bytes, TensorDB peak {run['tensordb_peak_entries']} entries, barrier "
        f"slept {run['barrier_waited_seconds']:.4f} s")

    from repro_torch.core.plan import OptimizationFlags

    flags, rows = fl_run.FAITHFUL, []
    for step, change in LADDER:
        flags = (dataclasses.replace(flags, **change) if step != "batched_fit off"
                 else OptimizationFlags(batched_fit=False))
        ops.reset_launches()
        rec = ladder_step(torch, fl_run, flags)
        check(ref.device_calls == calls, f"ladder {step}: a plain version ran on CUDA tensors")
        rec["launches"] = ops.launch_counts()
        rows.append((step, rec))
    base = rows[0][1]["rounds"]
    for step, rec in rows:
        agree = sum(a["chosen"] == b["chosen"] for a, b in zip(rec["rounds"], base))
        check(rec["rounds"][0]["chosen"] == base[0]["chosen"], f"ladder {step}: round 0 chose "
              f"{rec['rounds'][0]['chosen']}, --faithful {base[0]['chosen']}")
        rec["agree"] = agree
    check(rows[-1][1]["launches"]["tree_hist"] == C * DEPTH * rounds,
          f"batched_fit off: {rows[-1][1]['launches']['tree_hist']} tree_hist launches, not "
          f"{C * DEPTH * rounds} (one a collaborator a level)")
    log(f"§5.1 ladder (adult, C = {C}, {rounds} rounds; ms/round rounds 5-9 with one eval; {card}): "
        + "; ".join(f"{step} {rec['ms_round']:.3f} ms/round, TensorDB peak {rec['peak_entries']}, "
                    f"comm {rec['comm_mb']:.4f} MB, barrier {rec['barrier_s']:.4f} s, F1 "
                    f"{rec['f1']:.4f}, chosen = --faithful's in {rec['agree']}/{rounds}"
                    for step, rec in rows))
    log("ladder launches: " + "; ".join(f"{step} {rec['launches']}" for step, rec in rows))

    cached = ladder_step(torch, fl_run, OptimizationFlags(), "preweak_f")
    ops.reset_launches()
    uncached = ladder_step(torch, fl_run, OptimizationFlags(cache_predictions=False), "preweak_f")
    got = ops.launch_counts()
    want = {**no_launches(ops), "tree_hist": rounds * DEPTH, "weighted_errors": rounds,
            "weight_update": rounds}
    check(got == want, f"PreWeak.F without its cache: launches {got} != {want}")
    same = [a["chosen"] for a in uncached["rounds"]] == [a["chosen"] for a in cached["rounds"]]
    check(same, "PreWeak.F without its cache chose other members than the cached run")
    log(f"PreWeak.F T = {rounds} (adult) on {card}: cached {cached['ms_round']:.3f} ms/round, "
        f"without the cache {uncached['ms_round']:.3f} (the [{C}, {C * rounds}, "
        f"{SHAPES['adult'][0]}] space predicted every round); the same member in every round, F1 {uncached['f1']:.4f} vs {cached['f1']:.4f}")

    ops.reset_launches()
    fed_argv = ["--algorithm", "fedavg", "--learner", "mlp"]
    fa = run_fl(fl_run, "adult", rounds, "cuda", "fedavg_cuda", fed_argv)
    check(ops.launch_counts() == no_launches(ops), f"FedAvg launched kernels: {ops.launch_counts()}")
    check(ref.device_calls == calls, f"FedAvg: a plain version ran on CUDA tensors: {ref.device_calls}")
    fa_cpu = run_fl(fl_run, "adult", rounds, "cpu", "fedavg_cpu", fed_argv)
    fed = fl_run.build_federation("adult", C, 1, DEPTH, 0, "cpu")
    counts = torch.bincount(fed.ys[fed.masks > 0].long(), minlength=2)
    from repro_torch.core.metrics import f1_macro

    majority = torch.full_like(fed.y_test, int(torch.argmax(counts)))
    chance = float(f1_macro(fed.y_test, majority, 2))
    f1_gpu, f1_cpu = fa["history"][-1]["f1"], fa_cpu["history"][-1]["f1"]
    check(len(fa["history"]) == rounds - 1, f"FedAvg: {len(fa['history'])} history rows")
    check(f1_gpu > chance and f1_cpu > chance, f"FedAvg F1 card {f1_gpu} / CPU {f1_cpu} not above "
          f"the constant predictor's {chance}")
    check(fa["comm_bytes"] == fa_cpu["comm_bytes"], f"FedAvg comm bytes: card {fa['comm_bytes']} "
          f"vs CPU {fa_cpu['comm_bytes']}")
    log(f"FedAvg (adult, C = {C}, mlp hidden 64, 20 local steps, {rounds} rounds) on {card}: final "
        f"F1 {f1_gpu:.4f} (CPU {f1_cpu:.4f}, the constant predictor {chance:.4f}); "
        f"{1e3 * fa['history'][-1]['round_seconds']:.3f} ms/round (the last row); comm "
        f"{fa['comm_bytes']} bytes on both")
    return product_launches


# -- phase 12: the elastic runtime and the multi-tenant registry -----------------------

# (b) virtual chaos, (c) late merges, (e) realtime: fl_run flags (adult, C = 8, 10 rounds)
CHAOS = ["--elastic", "--deadline-ms", "1000", "--fault-seed", "7", "--fault-drop-p", "0.2",
         "--fault-kill", "2:3"]
LATE = ["--elastic", "--deadline-ms", "500", "--fault-seed", "3", "--fault-delay-p", "0.4",
        "--fault-delay-ms", "600:1400"]
REALTIME = ["--elastic", "--elastic-realtime", "--deadline-ms", "20", "--fault-delay-p", "0.3",
            "--fault-delay-ms", "5:60"]
LATE_KEY = ("src_round", "merged_round", "collaborator", "lateness", "discount")
REQUEST_ROWS = 37  # serve_fl's default request
REGISTRY_WINDOW_S = 0.3  # seconds of 37-row registry predicts per tenant


def elastic_noop(torch, ops, ref, fl_run, card: str) -> None:
    """(a) ``ParticipationPolicy()`` with no faults against the fused run,
    for each algorithm: the same history, per-round metrics, weights and
    ensemble to the bit, and the same launches (AdaBoost.F 4 / 1 / 1 / 0 a
    round, phase 6's)."""
    from repro_torch.fl.elastic import ParticipationPolicy

    rounds, rows = MAIN["rounds"], []
    for alg in ("adaboost_f", "distboost_f", "preweak_f", "bagging"):
        runs = {}
        for mode in ("fused", "elastic"):
            fed = fl_run.build_federation("adult", C, rounds, DEPTH, 0, DEV, algorithm=alg)
            calls = dict(ref.device_calls)
            ops.reset_launches()
            hist = fed.run(eval_every=MAIN["eval_every"],
                           policy=ParticipationPolicy() if mode == "elastic" else None)
            torch.cuda.synchronize()
            check(ref.device_calls == calls, f"elastic no-op {alg} {mode}: a plain version ran on CUDA")
            runs[mode] = (fed, hist, ops.launch_counts())
        (f, h1, l1), (e, h2, l2) = runs["fused"], runs["elastic"]
        key = ("round", "f1", "epsilon", "alpha", "chosen")
        check([{k: r[k] for k in key} for r in h1] == [{k: r[k] for k in key} for r in h2],
              f"elastic no-op {alg}: history differs from the fused run's")
        check(e.per_round() == f.per_round(), f"elastic no-op {alg}: round metrics differ")
        check(torch.equal(e.state.weights, f.state.weights), f"elastic no-op {alg}: weights differ")
        check(e.state.ensemble.count == f.state.ensemble.count
              and torch.equal(e.state.ensemble.alpha, f.state.ensemble.alpha)
              and all(torch.equal(a, b) for a, b in zip(e.state.ensemble.params, f.state.ensemble.params)),
              f"elastic no-op {alg}: ensemble differs from the fused run's")
        check(l2 == l1 and l2["weight_update_product"] == 0,
              f"elastic no-op {alg}: launches {l2} != the fused run's {l1}")
        if alg == "adaboost_f":
            want = {**no_launches(ops), "tree_hist": rounds * DEPTH, "weighted_errors": rounds,
                    "weight_update": rounds}
            check(l2 == want, f"elastic no-op adaboost_f: launches {l2} != {want}")
        rows.append(f"{alg} {1e3 * h2[-1]['round_seconds']:.3f} (fused {1e3 * h1[-1]['round_seconds']:.3f})")
    log(f"phase 12 (a) no-op policy = fused run bit for bit (history, metrics, weights, ensemble, "
        f"launches) for all four algorithms; ms/round on {card}: " + ", ".join(rows))


def elastic_pair(torch, ops, ref, fl_run, flags: list, tag: str, extra=()) -> tuple:
    """One ``fl_run --elastic`` run on the card (launch counts set to 0 just
    before) and the same on the CPU; the host-side outcome (responders,
    dropouts, late merges) must be equal and the round counts consistent."""
    calls = dict(ref.device_calls)
    ops.reset_launches()
    gpu = run_fl(fl_run, "adult", MAIN["rounds"], "cuda", f"{tag}_cuda", [*flags, *extra])
    launches = ops.launch_counts()
    check(ref.device_calls == calls, f"{tag}: a plain version ran on CUDA tensors")
    cpu = run_fl(fl_run, "adult", MAIN["rounds"], "cpu", f"{tag}_cpu", [*flags, *extra])
    for k in ("responders", "dropouts"):
        check(gpu[k] == cpu[k], f"{tag}: {k} card {gpu[k]} vs CPU {cpu[k]}")
    late = [{k: r[k] for k in LATE_KEY} for r in gpu["late"]]
    check(late == [{k: r[k] for k in LATE_KEY} for r in cpu["late"]], f"{tag}: late merges differ")
    for run, where in ((gpu, "card"), (cpu, "CPU")):
        for r in run["late"]:
            # alpha = discount * base in float32 (the discount is a power of
            # 1/2, so exact): alpha <= base where the late hypothesis still
            # beats chance under the current weights, |alpha| <= |base| always
            check(r["alpha"] == r["base_alpha"] * r["discount"] and abs(r["alpha"]) <= abs(r["base_alpha"])
                  and (r["alpha"] <= r["base_alpha"] or r["base_alpha"] < 0),
                  f"{tag} {where}: late alpha {r['alpha']} against base {r['base_alpha']}")
        skipped = sum(1 for n in run["responders"] if n == 0)
        check(run["ensemble_count"] == MAIN["rounds"] - skipped + len(run["late"]),
              f"{tag} {where}: {run['ensemble_count']} members, not rounds - skipped + late merges")
        f1 = run["history"][-1]["f1"]
        check(0.0 < f1 <= 1.0, f"{tag} {where}: final F1 {f1}")
    full = sum(1 for n in gpu["responders"] if n == C)
    partial = sum(1 for n in gpu["responders"] if 0 < n < C)
    check(launches["weight_update_product"] == partial and launches["weight_update"] == full,
          f"{tag}: {launches} for {full} full and {partial} partial rounds")
    g0, c0 = gpu["rounds"][0], cpu["rounds"][0]
    check(g0["chosen"] == c0["chosen"], f"{tag} round 0 chosen: card {g0['chosen']} vs CPU {c0['chosen']}")
    f1_gpu, f1_cpu = gpu["history"][-1]["f1"], cpu["history"][-1]["f1"]
    check(abs(f1_gpu - f1_cpu) <= 0.02, f"{tag} final F1: card {f1_gpu} vs CPU {f1_cpu}")
    agree = sum(a["chosen"] == b["chosen"] for a, b in zip(gpu["rounds"], cpu["rounds"]))
    negative = sum(1 for r in gpu["late"] if r["base_alpha"] < 0)
    log(f"phase 12 {tag}: responders {gpu['responders']} (= CPU), dropouts {gpu['dropouts']}, "
        f"{len(gpu['late'])} late merges ({negative} with a base alpha below 0: worse than chance "
        f"under the current weights), {partial} partial + {full} full rounds, launches "
        f"{launches}; card vs CPU: chosen agrees in {agree}/{len(gpu['rounds'])} rounds, final F1 "
        f"{f1_gpu:.4f} vs {f1_cpu:.4f}; {1e3 * gpu['history'][-1]['round_seconds']:.3f} ms/round "
        f"(the last history row)")
    return gpu, launches


def elastic_realtime(torch, fl_run, card: str) -> None:
    """(e) wall-clock arrivals: every round closes over at least
    ``min_responders`` (1)."""
    run = run_fl(fl_run, "adult", MAIN["rounds"], "cuda", "realtime_cuda", REALTIME)
    check(all(n >= 1 for n in run["responders"]), f"realtime: a round under the floor {run['responders']}")
    waits = [h["wait_s"] for h in run["history"]]
    log(f"phase 12 (e) realtime (deadline 20 ms, 30% delayed 5-60 ms) on {card}: responders "
        f"{run['responders']}, dropouts {run['dropouts']}, {len(run['late'])} late merges, "
        f"{1e3 * run['history'][-1]['round_seconds']:.3f} ms/round (the last history row), "
        f"eval-row waits {[round(1e3 * w, 1) for w in waits]} ms")


def registry_phase(torch, ops, ref, fl_run, card: str) -> dict:
    """(f) three tenants on one ``ModelRegistry``: adult (the chaos run
    publishing every 2, then a late-merge run whose larger capacity
    rebuilds), pendigits (serve_fl's defaults, then a DistBoost.F committee
    stream that rebuilds) and letter (T = 100), refreshed at every
    checkpoint.  Returns the registry's ``vote_argmax`` launches."""
    from repro_torch.fl.elastic import FaultPlan, ParticipationPolicy
    from repro_torch.data import get_dataset
    from repro_torch.obs.metrics import Histogram
    from repro_torch.serve import ModelRegistry, ServeEngine, latest_artifact, load_artifact

    root = SERVE / "registry"
    shutil.rmtree(root, ignore_errors=True)
    reg = ModelRegistry()
    outcomes = {}

    def follow(name):
        def on_checkpoint(path, version):
            if name not in reg.tenants():
                reg.add_tenant(name, path.parent)
            else:
                outcomes.setdefault(name, []).append(reg.refresh(name).get(name))
        return on_checkpoint

    chaos = dict(policy=ParticipationPolicy(deadline_s=1.0),
                 faults=FaultPlan(seed=7, drop_p=0.2, kills=((2, 3),)))
    late = dict(policy=ParticipationPolicy(deadline_s=0.5),
                faults=FaultPlan(seed=3, delay_p=0.4, delay_range_s=(0.6, 1.4)))
    streams = [  # tenant, dataset, C, rounds, publish every, build keywords, run keywords
        ("adult", "adult", C, 10, 2, {}, chaos),
        ("adult", "adult", C, 12, 6, {}, late),
        ("pendigits", "pendigits", 4, 10, 2, {}, {}),
        ("pendigits", "pendigits", 4, 12, 12, {"algorithm": "distboost_f"}, {}),
        ("letter", "letter", 4, 100, 50, {}, {}),
    ]
    for name, ds, c, rounds, every, build, run_kw in streams:
        fed = fl_run.build_federation(ds, c, rounds, DEPTH, 0, DEV, **build)
        fed.run(eval_every=rounds, publish_every=every, publish_dir=str(root / name),
                on_checkpoint=follow(name), **run_kw)
    want = {"adult": (5, 1), "pendigits": (4, 1), "letter": (1, 0)}
    stats = reg.stats()["tenants"]
    got = {n: (t["swaps"], t["rebuilds"]) for n, t in stats.items()}
    check(got == want, f"registry (swaps, rebuilds) {got} != {want}")
    check(all(v is not None for vs in outcomes.values() for v in vs), f"a refresh found nothing new: {outcomes}")

    tests = {ds: get_dataset(ds, torch.Generator().manual_seed(0))[1][2].numpy()
             for ds in ("adult", "pendigits", "letter")}
    before = {n: reg.engine(n).stats.batches + reg.engine(n).stats.warmup_batches for n in stats}
    calls = dict(ref.device_calls)
    ops.reset_launches()
    preds = {n: reg.predict(n, tests[n]) for n in reg.tenants()}
    launches = ops.launch_counts()["vote_argmax"]
    served = sum(reg.engine(n).stats.batches + reg.engine(n).stats.warmup_batches - before[n]
                 for n in stats)
    check(launches == served, f"registry: {launches} vote_argmax launches for {served} batches")
    check(ref.device_calls == calls, "registry: a plain version ran on CUDA tensors")
    rows = []
    for n in reg.tenants():
        path = latest_artifact(root / n)
        alone = ServeEngine.from_artifact(load_artifact(path)).predict(tests[n])
        check(bool((alone == preds[n]).all()), f"registry {n}: other votes than a standalone engine")
        rows.append(card_vs_cpu(torch, path, n, preds[n], f"registry {n}"))
    log("phase 12 (f) registry: " + "; ".join(rows) + f"; swaps/rebuilds {got}, {launches} "
        f"vote_argmax launches for {served} batches")

    perf = []
    for n in reg.tenants():
        X, lat = tests[n], Histogram()
        reg.predict(n, X[:REQUEST_ROWS])
        t0 = done = time.perf_counter()
        i = reqs = 0
        while done - t0 < REGISTRY_WINDOW_S:
            rows_ = X[i:i + REQUEST_ROWS]
            t1 = time.perf_counter()
            reg.predict(n, rows_)
            done = time.perf_counter()
            lat.observe(done - t1)
            reqs += len(rows_)
            i = (i + REQUEST_ROWS) % (len(X) - REQUEST_ROWS)
        perf.append(f"{n} {reqs / (done - t0):.0f} rows/s, {lat.count} requests, p50 "
                    f"{1e3 * lat.percentile(50):.3f} ms p99 {1e3 * lat.percentile(99):.3f} ms")
    eng, X = reg.engine("pendigits"), tests["pendigits"]
    with eng.scheduler() as sched:
        t0 = time.perf_counter()
        ids = []
        for i in range(0, len(X), REQUEST_ROWS):
            ids += sched.submit(X[i:i + REQUEST_ROWS], deadline_s=0.002)
        sched.drain()
        dt = time.perf_counter() - t0
        got_pred = sched.results(ids)
        check(bool((got_pred == preds["pendigits"]).all()), "deadline scheduler: other votes than predict")
        waits = sched.queue_wait
    st = eng.stats.request_latencies
    log(f"phase 12 (f) registry predict on {card} (37-row requests, {REGISTRY_WINDOW_S} s each): "
        + "; ".join(perf) + f"; pendigits submit(deadline_s=0.002) + drain(): {len(X)} rows in "
        f"{1e3 * dt:.3f} ms = {len(X) / dt:.0f} rows/s, latency p50 {1e3 * st.percentile(50):.3f} ms "
        f"p99 {1e3 * st.percentile(99):.3f} ms, queue wait p50 {1e3 * waits.percentile(50):.3f} ms")
    return {"vote_argmax": launches}


def elastic_round_cost(torch, ops, fl_run, card: str) -> None:
    """Host operations of one steady adult AdaBoost.F round through the
    elastic stages, full and with one collaborator absent (the sixth of
    ten), and where (b)'s chaos run's device time goes (torch.profiler)."""
    import numpy as np

    from repro_torch.core import boosting, scoring
    from repro_torch.fl.elastic import (FaultPlan, ParticipationPolicy, elastic_adaboost_f_stages,
                                        run_elastic_stages)

    fed = fl_run.build_federation("adult", C, MAIN["rounds"], DEPTH, 0, DEV)
    state = boosting.init_boost_state(fed.learner, fed.spec, MAIN["rounds"], fed.masks, X=fed.Xs)
    stages = elastic_adaboost_f_stages(fed.learner, fed.spec, generator=fed.generator)
    full = scoring.participation(np.ones(C), DEV)
    for _ in range(MAIN["rounds"] // 2):
        state, _, _ = run_elastic_stages(stages, state, fed.Xs, fed.ys, fed.masks, full)
    counted = {}
    for name, resp in (("full", np.ones(C)), ("partial", np.r_[np.ones(C - 1), 0.0])):
        counted[name] = host_ops(torch, ops, lambda: run_elastic_stages(
            stages, state, fed.Xs, fed.ys, fed.masks, scoring.participation(resp, DEV)))
    torch.cuda.synchronize()
    log("phase 12 host operations of an elastic adult round (round 6 of 10; PyTorch operators + "
        "kernel launches): " + "; ".join(
            f"{k} {v['host_ops']} ({v['torch_ops']} + {v['kernel_launches']})" for k, v in counted.items()))
    profile_round(torch, fl_run, card, label="adult b_chaos", run_kw=dict(
        policy=ParticipationPolicy(deadline_s=1.0), faults=FaultPlan(seed=7, drop_p=0.2, kills=((2, 3),))))


def elastic_phase(torch, ops, ref, fl_run, card: str) -> dict:
    """Phase 12; returns the card's launches in (b)'s chaos run and the
    registry's ``vote_argmax`` launches."""
    elastic_noop(torch, ops, ref, fl_run, card)
    _, chaos_launches = elastic_pair(torch, ops, ref, fl_run, CHAOS, "b_chaos")
    elastic_pair(torch, ops, ref, fl_run, LATE, "c_late_merges")
    elastic_pair(torch, ops, ref, fl_run, CHAOS, "d_distboost_chaos", ["--algorithm", "distboost_f"])
    elastic_realtime(torch, fl_run, card)
    elastic_round_cost(torch, ops, fl_run, card)
    return {**chaos_launches, **registry_phase(torch, ops, ref, fl_run, card)}


# -- phase 13: the multi-process federation ------------------------------------------------

# fl_spawn runs: (processes, packed broadcast); adult, fl_run's defaults (depth 4, 16 bins,
# IID, seed 0), 6 rounds, a history row every round
DIST_RUNS = [(1, True), (2, True), (4, True), (8, True), (8, False)]
DIST_ROUNDS = 6
DIST_TIMEOUT_S = 170.0  # each process group's deadline
# the elastic runs: (c) collaborator 2 killed at round 3, (d) delay-only stragglers
DIST_KILL = ["--elastic", "--dataset", "adult", "--rounds", "10", "--deadline-ms", "3000",
             "--fault-kill", "2:3"]
DIST_LATE = ["--elastic", "--dataset", "adult", "--rounds", "5", "--deadline-ms", "800",
             "--fault-delay-p", "0.4", "--fault-delay-ms", "1500:2000", "--fault-seed", "3"]
# a process of the lockstep runtime under fl_run's own entry point, its launch
# counts printed as one line when it returns (the counters live in the process)
COUNTING_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import ops
from repro_torch.launch import fl_run
ops.reset_launches()
fl_run.main(sys.argv[2:])
print("LAUNCHES " + json.dumps(ops.launch_counts()), flush=True)
"""


def spawn_run(fl_spawn, P: int, argv: list, tag: str, min_f1=None) -> tuple:
    """``fl_spawn -n P -- argv --history-out ...`` as a user runs it; returns
    (process 0's history file, seconds).  Any process failing fails the phase."""
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"dist_{tag}.json"
    path.unlink(missing_ok=True)
    argv = [*argv, "--eval-every", "1", "--history-out", str(path)]
    log(f"$ python -m repro_torch.launch.fl_spawn -n {P} -- {' '.join(argv)}")
    t0 = time.perf_counter()
    rc = fl_spawn.spawn(P, argv, timeout=DIST_TIMEOUT_S, min_f1=min_f1)
    dt = time.perf_counter() - t0
    check(rc == 0, f"fl_spawn -n {P} ({tag}) exited {rc}")
    return json.loads(path.read_text()), dt


DIST_SPANS = ("round.fit", "round.broadcast", "round.score", "round.exchange", "round.aggregate",
              "round.eval")


def span_breakdown(trace_path: Path) -> str:
    """Process 0's ms a round in each span of a traced run, rounds 1 to the
    last (round 0 holds the start-up), and the rest of the round."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    late = [e for e in events if e["args"].get("round", 0) >= 1]
    n = DIST_ROUNDS - 1
    total = sum(e["dur"] for e in late if e["name"] == "round") / 1e3 / n
    parts = {k: sum(e["dur"] for e in late if e["name"] == k) / 1e3 / n for k in DIST_SPANS}
    rest = total - sum(parts.values())
    return (", ".join(f"{k[len('round.'):]} {v:.3f}" for k, v in parts.items())
            + f", rest {rest:.3f} of {total:.3f}")


def lockstep_sweep(torch, fl_run, fl_spawn, card: str) -> None:
    """(a) P = 1, 2, 4, 8 packed and P = 8 per leaf on the card: the wire
    counts of ``BENCH_distributed.json``, and each P against the fused run
    at C = P in this call; each run traced (``--trace``), its spans
    broken down."""
    bench = {(b["processes"], b["packed_broadcast"]): b
             for b in json.loads((ROOT / "BENCH_distributed.json").read_text())}
    fused = {}
    rows, spans = [], []
    for P, packed in DIST_RUNS:
        tag = f"p{P}_{'packed' if packed else 'per_leaf'}"
        trace_path = OUT / f"dist_{tag}_trace.json"
        argv = ["--dataset", "adult", "--rounds", str(DIST_ROUNDS), "--seed", "0", "--device", DEV,
                "--trace", str(trace_path)]
        run, secs = spawn_run(fl_spawn, P, argv + ([] if packed else ["--no-packed-broadcast"]), tag)
        spans.append(f"P={P} {'packed' if packed else 'per-leaf'}: {span_breakdown(trace_path)}")
        want = bench[(P, packed)]
        hist = run["history"]
        check(len(hist) == DIST_ROUNDS and run["processes"] == P, f"P={P}: {len(hist)} history rows")
        per_round = {h["comm_bytes"] for h in hist}
        check(per_round == {want["comm_bytes_per_round"]},
              f"P={P}: comm bytes a round {sorted(per_round)} != {want['comm_bytes_per_round']}")
        hyp = run["comm_breakdown"]["hypotheses"] / DIST_ROUNDS
        check(hyp == want["broadcast_bytes_per_round"],
              f"P={P}: hypothesis bytes a round {hyp} != {want['broadcast_bytes_per_round']}")
        calls = run["collective_calls"] / DIST_ROUNDS
        check(calls == want["collectives_per_round"],
              f"P={P}: {calls} collectives a round != {want['collectives_per_round']}")
        if P not in fused:
            fed = fl_run.build_federation("adult", P, DIST_ROUNDS, DEPTH, 0, DEV)
            fhist = fed.run(eval_every=1)
            torch.cuda.synchronize()
            fused[P] = (fed.per_round(), fhist)
        frounds, fhist = fused[P]
        check(run["rounds"][0]["chosen"] == frounds[0]["chosen"],
              f"P={P}: round 0 chosen {run['rounds'][0]['chosen']} vs fused {frounds[0]['chosen']}")
        agree = sum(a["chosen"] == b["chosen"] for a, b in zip(run["rounds"], frounds))
        f1, f1_fused = hist[-1]["f1"], fhist[-1]["f1"]
        check(abs(f1 - f1_fused) <= 0.02, f"P={P}: final F1 {f1} vs fused {f1_fused}")
        ms = sorted(1e3 * h["round_seconds"] for h in hist[1:])
        rows.append(f"P={P} {'packed' if packed else 'per-leaf'}: {ms[len(ms) // 2]:.3f} ms/round "
                    f"(median of rounds 1-{DIST_ROUNDS - 1}; round 0 {1e3 * hist[0]['round_seconds']:.3f}; "
                    f"fused C={P} {1e3 * fhist[-1]['round_seconds']:.3f}), comm "
                    f"{want['comm_bytes_per_round']} B, hypotheses {hyp:.0f} B, {calls:.0f} "
                    f"collectives a round (= BENCH_distributed.json); chosen = fused in {agree}/"
                    f"{DIST_ROUNDS} rounds, F1 {f1:.4f} vs {f1_fused:.4f}; group {secs:.1f} s")
    log(f"phase 13 (a) lockstep runtime on {card}, every process on the one card:\n  "
        + "\n  ".join(rows))
    log("phase 13 (a) process 0's ms a round by span (rounds 1-5, traced):\n  " + "\n  ".join(spans))


def counted_launches(fl_spawn, P: int, flags: list, want: dict, tag: str) -> tuple:
    """A P-process ``fl_run --distributed`` run of ``flags`` through
    ``fl_run.main`` in children that set their launch counts to 0 just
    before and print them when it returns; each process's counts must
    equal ``want``.  Returns (each process's counts, process 0's history
    file)."""
    OUT.mkdir(parents=True, exist_ok=True)
    coord = f"127.0.0.1:{fl_spawn.free_port()}"
    history = OUT / f"dist_count_{tag}.json"
    history.unlink(missing_ok=True)
    procs, logs = [], []
    for i in range(P):
        log_path = OUT / f"dist_count_{tag}_p{i}.log"
        argv = ["--distributed", "--coordinator", coord, "--num-processes", str(P),
                "--process-id", str(i), "--collaborators", str(P), *flags, "--eval-every", "1",
                "--seed", "0", "--device", DEV, "--history-out", str(history)]
        with open(log_path, "w") as f:
            procs.append(subprocess.Popen([sys.executable, "-c", COUNTING_CHILD, str(ROOT / "src"),
                                           *argv], stdout=f, stderr=subprocess.STDOUT))
        logs.append(str(log_path))
    rcs = fl_spawn._join_all(procs, logs, timeout=DIST_TIMEOUT_S)
    check(rcs == [0] * P, f"counting run {tag} exited {rcs}: {[fl_spawn._tail(p, 600) for p in logs]}")
    per_process = []
    for p in logs:
        line = [ln for ln in Path(p).read_text().splitlines() if ln.startswith("LAUNCHES ")]
        check(len(line) == 1, f"{p}: no launch line")
        per_process.append(json.loads(line[0][len("LAUNCHES "):]))
    for i, got in enumerate(per_process):
        check(got == want, f"{tag}: process {i} of {P}: launches {got} != {want}")
    return per_process, json.loads(history.read_text())


def lockstep_launches(fl_spawn, P: int = 2) -> dict:
    """(b) the lockstep runtime at P processes: each makes 4 ``tree_hist``,
    1 ``weighted_errors`` and 1 ``weight_update`` a round, nothing else."""
    want = {"tree_hist": DEPTH * DIST_ROUNDS, "weighted_errors": DIST_ROUNDS,
            "weight_update": DIST_ROUNDS, "weight_update_product": 0, "vote_argmax": 0,
            "flash_attention": 0}
    per_process, _ = counted_launches(
        fl_spawn, P, ["--dataset", "adult", "--rounds", str(DIST_ROUNDS)], want, "lockstep")
    log(f"phase 13 (b) launches of each of {P} processes over {DIST_ROUNDS} rounds: {per_process} "
        f"(4 tree_hist, 1 weighted_errors, 1 weight_update a round)")
    return {k: sum(c[k] for c in per_process) for k in want}


def elastic_launches(fl_spawn, P: int = 4) -> dict:
    """(b) the elastic socket star at P processes, no faults: each makes
    4 ``tree_hist`` a round and 4 in its warm-up fit, and 1
    ``weight_update_product`` a round (its shard's un-renormalised step),
    nothing else; every round closes over all P."""
    want = {"tree_hist": DEPTH * (DIST_ROUNDS + 1), "weighted_errors": 0, "weight_update": 0,
            "weight_update_product": DIST_ROUNDS, "vote_argmax": 0, "flash_attention": 0}
    per_process, run = counted_launches(
        fl_spawn, P, ["--elastic", "--dataset", "adult", "--rounds", str(DIST_ROUNDS)], want,
        "elastic")
    check(run["responders"] == [P] * DIST_ROUNDS and run["evicted"] == [] and not run["late"],
          f"fault-free elastic run: responders {run['responders']}, evicted {run['evicted']}")
    log(f"phase 13 (b) launches of each of {P} processes of the fault-free elastic star over "
        f"{DIST_ROUNDS} rounds: {per_process} (4 tree_hist a round and 4 in the warm-up, 1 "
        f"weight_update_product a round); responders {run['responders']}")
    return {k: sum(c[k] for c in per_process) for k in want}


def elastic_kill(fl_spawn, card: str) -> None:
    """(c) collaborator 2's process exits at round 3: evicted, every round
    recorded, rounds from 3 on over at most 3 processes; F1 the CPU's."""
    runs = {}
    for dev in (DEV, "cpu"):
        runs[dev], secs = spawn_run(fl_spawn, 4, [*DIST_KILL, "--device", dev], f"kill_{dev}",
                                    min_f1=0.5)
        run = runs[dev]
        check(run["evicted"] == [2] and run["dropouts"].get("dead") == 1,
              f"kill on {dev}: evicted {run['evicted']}, dropouts {run['dropouts']}")
        check(len(run["history"]) == 10, f"kill on {dev}: {len(run['history'])} rounds recorded")
        check(all(n <= 3 for n in run["responders"][3:]) and all(n >= 1 for n in run["responders"]),
              f"kill on {dev}: responders {run['responders']}")
    gpu, cpu = runs[DEV], runs["cpu"]
    check(abs(gpu["final_f1"] - cpu["final_f1"]) <= 0.02,
          f"kill: final F1 card {gpu['final_f1']} vs CPU {cpu['final_f1']}")
    ms = sorted(1e3 * h["round_seconds"] for h in gpu["history"])
    log(f"phase 13 (c) elastic kill 2:3 on {card}: evicted {gpu['evicted']}, dropouts "
        f"{gpu['dropouts']}, responders {gpu['responders']} (CPU {cpu['responders']}), final F1 "
        f"{gpu['final_f1']:.4f} vs CPU {cpu['final_f1']:.4f}, {ms[len(ms) // 2]:.3f} ms/round (median)")


def elastic_late(fl_spawn, card: str) -> None:
    """(d) delayed uploads past an 800 ms deadline merge late, discounted;
    each round's ms, its responders and its wait for uploads printed."""
    run, _ = spawn_run(fl_spawn, 4, [*DIST_LATE, "--device", DEV], "late_cuda")
    check(run["dropouts"].get("deadline", 0) > 0, f"late: no deadline dropouts {run['dropouts']}")
    check(bool(run["late"]), "late: no late merges")
    for r in run["late"]:
        check(r["lateness"] >= 1 and abs(r["alpha"]) <= abs(r["base_alpha"]),
              f"late merge {r}: lateness < 1 or |alpha| > |base|")
    check(len(run["history"]) == 5, f"late: {len(run['history'])} rounds recorded")
    negative = sum(1 for r in run["late"] if r["base_alpha"] < 0)
    rounds = [f"{h['round']}: {1e3 * h['round_seconds']:.1f} ms ({h['responders']} responders, "
              f"uploads waited {1e3 * h['wait_s']:.1f} ms)" for h in run["history"]]
    log(f"phase 13 (d) elastic late merges on {card}: dropouts {run['dropouts']}, responders "
        f"{run['responders']}, {len(run['late'])} late merges (lateness "
        f"{sorted({r['lateness'] for r in run['late']})}, {negative} with a base below 0), "
        f"|alpha| <= |base| on each; final F1 {run['final_f1']:.4f}; rounds: " + "; ".join(rounds))


def distributed_phase(torch, fl_run, card: str) -> dict:
    """Phase 13; returns the summed launches of (b)'s processes, of the
    lockstep run and of the elastic star."""
    from repro_torch.launch import fl_spawn

    lockstep_sweep(torch, fl_run, fl_spawn, card)
    launches = {"lockstep": lockstep_launches(fl_spawn), "elastic": elastic_launches(fl_spawn)}
    elastic_kill(fl_spawn, card)
    elastic_late(fl_spawn, card)
    return launches


# -- phase 8: LLM serving -----------------------------------------------------------


def llm_phase(torch, ops, ref, card: str) -> dict:
    """gemma-2b at full width through ``repro_torch.launch.serve --full``
    (a first call warms cuBLAS and the allocator; the second, with every
    count set to 0 just before, is the one checked and reported), then the
    decode-against-prefill and card-against-CPU checks and a profile."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    B, S, N, layers = LLM["batch"], LLM["prompt_len"], LLM["tokens"], LLM["layers"]
    argv = ["--arch", LLM["arch"], "--full", "--batch", str(B), "--prompt-len", str(S),
            "--tokens", str(N), "--seed", "0"]
    log(f"$ python -m repro_torch.launch.serve {' '.join(argv)}   (twice: cold, then warm)")
    cold = serve.main(argv)
    calls = dict(ref.device_calls)
    ops.reset_launches()
    warm = serve.main(argv)
    launches = ops.launch_counts()
    want = {name: 0 for name in launches}
    want["flash_attention"] = layers
    check(launches == want, f"gemma-2b serve launches {launches} != {want}")
    check(ref.device_calls == calls, f"gemma-2b serve: a plain version ran on CUDA tensors: {ref.device_calls}")
    cfg = get_arch(LLM["arch"])
    for run in (cold, warm):
        toks = run["tokens"]
        check(run["logits_finite"], "gemma-2b serve: non-finite logits")
        check(toks.shape == (B, N + 1), f"gemma-2b serve: tokens {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < cfg.padded_vocab())).all()), "gemma-2b serve: token out of range")
    check(torch.equal(cold["tokens"], warm["tokens"]), "gemma-2b serve: two runs from one seed differ")
    timing = {k: {"prefill_ms": 1e3 * r["prefill_seconds"], "decode_ms_per_step": 1e3 * r["decode_seconds"] / N,
                  "decode_tok_per_s": r["tok_per_s"]} for k, r in (("cold", cold), ("warm", warm))}
    log(f"gemma-2b serve on {card}: prefill {B}x{S} {timing['warm']['prefill_ms']:.3f} ms, decode "
        f"{timing['warm']['decode_ms_per_step']:.3f} ms/step = {timing['warm']['decode_tok_per_s']:.1f} tok/s "
        f"(first call: prefill {timing['cold']['prefill_ms']:.3f} ms, "
        f"{timing['cold']['decode_tok_per_s']:.1f} tok/s); launches {launches}")

    # prefill(S) + one decode step against prefill(S + 1), bf16 at full width
    model = serve.build(cfg, 0, torch.device(DEV))
    tok = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=torch.Generator().manual_seed(1)).to(DEV)
    whole, _ = M.prefill(model, {"tokens": tok})
    _, st = M.prefill(model, {"tokens": tok[:, :S]}, cache_len=S + 1)
    stepped, _ = M.serve_step(model, st, tok[:, S:S + 1])
    d = (stepped - whole).abs()
    check(bool(torch.isclose(stepped, whole, **DECODE_TOL).all()),
          f"gemma-2b: decode step vs prefill(S + 1): max |diff| {float(d.max()):.4g} exceeds {DECODE_TOL}")
    same = int((stepped.argmax(-1) == whole.argmax(-1)).sum())
    log(f"gemma-2b bf16: prefill({S}) + 1 decode step vs prefill({S + 1}): max |diff| {float(d.max()):.4g}, "
        f"mean {float(d.mean()):.4g} (tol {DECODE_TOL}); greedy token agrees in {same}/{B} rows")
    profile_llm(torch, model, tok[:, :S], card)
    del model, whole, st, stepped

    # the same weights at full width cut to 2 layers, float32: card vs CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    model2 = serve.build(cfg2, 0, torch.device(DEV))
    on_card, _ = M.prefill(model2, {"tokens": tok[:, :S]})
    model2.to("cpu")
    on_cpu, _ = M.prefill(model2, {"tokens": tok[:, :S].cpu()})
    on_card = on_card.cpu()
    d = (on_card - on_cpu).abs()
    check(bool(torch.isclose(on_card, on_cpu, **CPU_TOL).all()),
          f"gemma-2b 2-layer f32: card vs CPU max |diff| {float(d.max()):.4g} exceeds {CPU_TOL}")
    top2 = on_cpu.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) <= 2 * CPU_TOL["atol"]
    differ = on_card.argmax(-1) != on_cpu.argmax(-1)
    check(not bool((differ & ~near).any()), "gemma-2b 2-layer f32: first greedy token differs outside a near-tie")
    log(f"gemma-2b 2-layer f32 prefill, card vs CPU: max |diff| {float(d.max()):.4g} (tol {CPU_TOL}); "
        f"first greedy token agrees in {int((~differ).sum())}/{B} rows, {int(near.sum())} near-ties")
    return {"launches": launches, "timing": timing}


def profile_llm(torch, model, tokens, card: str) -> None:
    """Device busy share and the top kernels of one gemma-2b prefill and of
    four decode steps after it, from torch.profiler (model warm)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    B, S = tokens.shape
    M.prefill(model, {"tokens": tokens}, cache_len=S + 4)
    torch.cuda.synchronize()
    for what in ("prefill", "decode"):
        _, st = M.prefill(model, {"tokens": tokens}, cache_len=S + 4)
        token = tokens[:, -1:]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                M.prefill(model, {"tokens": tokens}, cache_len=S + 4)
            else:
                for _ in range(4):
                    _, st = M.serve_step(model, st, token)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        rows = [(e.key, e.count, getattr(e, "device_time_total", None) or e.cuda_time_total)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(r[2] for r in rows)
        if not busy_us:
            log(f"gemma-2b {what} profile: no device time recorded on {card}; busy share not measured")
            continue
        rows.sort(key=lambda r: -r[2])
        log(f"gemma-2b {what} profile ({'one prefill' if what == 'prefill' else '4 decode steps'}, "
            f"{B}x{S}, profiler on, {card}): wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
            f"({100 * busy_us / wall_us:.1f}%), {sum(r[1] for r in rows)} device activities")
        for key, count, us in rows[:8]:
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
    phase_s, t_phase = {}, [t_start]

    def phase_done(k: int) -> None:
        now = time.perf_counter()
        phase_s[k] = now - t_phase[0]
        t_phase[0] = now

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  device {kind}  "
        f"count {torch.cuda.device_count()}  python {sys.version.split()[0]}")
    phase_done(1)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    log(f"kernels: {_build.library_path().relative_to(ROOT)} "
        f"({'built in %.1fs' % built if built is not None else 'reused'}, "
        f"load {time.perf_counter() - t0:.1f}s)")
    report = ptxas_report(_build.build_log)
    for entry, info in report.items():
        log(f"  ptxas {entry}: {info}")
    flash = {e: i for e, i in report.items() if "flash_attention" in e}
    if built is not None:  # a reused library brings no report
        sm90 = [e for e in flash if "sm90" in e]

        def row(e):  # "D: registers, spill bytes" of one instance
            d = re.search(r"ILi(\d+)E", e).group(1)
            return f"{d}: {flash[e].get('registers')}, {flash[e].get('spill_bytes')}"

        log("flash_attention ptxas (D: registers, spill bytes): bf16 " + "; ".join(map(row, sm90))
            + " | float32 " + "; ".join(row(e) for e in flash if e not in sm90)
            + " | shared memory is dynamic (bf16, D = 256: 197 672 bytes a 2-warpgroup block)")
        check(len(sm90) == 4 and len(flash) == 8,
              f"ptxas reported {len(sm90)} bf16 and {len(flash) - len(sm90)} float32 flash "
              "instances, not 4 and 4")
        spilled = [row(e) for e in sm90 if flash[e].get("spill_bytes", 1) != 0]
        check(not spilled, f"bf16 flash_attention instances spill: {spilled}")
        core = {e: i for e, i in report.items() if any(k in e for k in CORE_KERNELS)}
        log("tree_hist / weighted_errors / weight_update / weight_update_product / vote_argmax "
            "ptxas (registers, spill bytes): " + "; ".join(kernel_row(e, i) for e, i in core.items()))
        check(len(core) == 9, f"ptxas reported {len(core)} tree_hist/weighted_errors/weight_update/"
              "weight_product/vote_argmax kernels, not 9")
        spilled = [kernel_row(e, i) for e, i in core.items() if i.get("spill_bytes", 1) != 0]
        check(not spilled, f"kernels spill: {spilled}")
    atoms = shared_atomics(_build, "tree_hist_kernel")
    log(f"tree_hist SASS shared-memory atomics: {sorted(atoms)}")
    check("ATOMS.ADD" in atoms and not any("CAS" in a for a in atoms),
          f"tree_hist's shared atomics are not single integer adds: {sorted(atoms)}")

    phase_done(2)

    # 3. kernels against their plain versions
    g = torch.Generator().manual_seed(0)
    floor = launch_floor_ms(torch)
    per_kernel = {
        "tree_hist": check_tree_hist(torch, ops, ref, g),
        "weighted_errors": check_weighted_errors(torch, ops, ref, g),
        "weight_update": check_weight_update(torch, ops, ref, g),
        "weight_update_product": check_weight_update_product(torch, ops, ref, g),
        "vote_argmax": check_vote_argmax(torch, ops, ref, g),
        "flash_attention": check_flash_attention(torch, ops, ref, g),
    }
    for name, rows in check_dirichlet_shapes(torch, ops, ref, g, dirichlet_mask(fl_run)).items():
        per_kernel[name][0].update(rows)
    for name, rows in check_shard_shapes(torch, ops, ref, g, dist_shards(fl_run)).items():
        per_kernel[name][0].update(rows)
    for name, (res, worst) in per_kernel.items():  # every shape checked counts in the worst error
        per_kernel[name] = (res, max([worst] + [r.get("max_abs_err", 0.0) for r in res.values()]))
    detail = {k: v[0] for k, v in per_kernel.items()}
    log("kernel_detail " + json.dumps({"card": card, "launch_floor_ms": floor, "kernels": detail}))
    log(f"kernel ms / bound ms / launch floor ms at the main paths' shapes ({card}): " + "; ".join(
        f"{name} {res[MAIN_SHAPE[name]]['ms']:.5f} / {res[MAIN_SHAPE[name]]['bound_ms']:.6f} / {floor:.5f}"
        for name, (res, _) in per_kernel.items()))
    errs = per_kernel["weighted_errors"][0]
    log(f"weighted_errors ms / bound ms / launch floor ms / plain ms at PreWeak.F's rows ({card}): "
        + "; ".join(f"{ds} {errs[ds]['shape']} {errs[ds]['ms']:.5f} / {errs[ds]['bound_ms']:.5f} / "
                    f"{floor:.5f} / {errs[ds]['plain_ms']:.5f}" for ds in PREWEAK_SHAPES))

    phase_done(3)

    # 4. the federation on the card; the adult run is the main path
    ops.reset_launches()
    device_calls = dict(ref.device_calls)
    t0 = time.perf_counter()
    main_run = run_fl(fl_run, "adult", MAIN["rounds"], "cuda", "adult_cuda")
    main_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    want = {"tree_hist": MAIN["rounds"] * DEPTH, "weighted_errors": MAIN["rounds"],
            "weight_update": MAIN["rounds"]}
    want["weight_update_product"] = want["vote_argmax"] = want["flash_attention"] = 0
    check(launches == want, f"main path launches {launches} != {want}")
    check(ref.device_calls == device_calls,
          f"a plain version ran on CUDA tensors in the main path: {ref.device_calls}")
    check_run(main_run, MAIN["rounds"], "adult on the card")
    log(f"main path launches {launches}")

    for ds in ("letter", "forestcover"):
        ops.reset_launches()
        run = run_fl(fl_run, ds, 5, "cuda", f"{ds}_cuda")
        got = ops.launch_counts()
        check(got == {"tree_hist": 5 * DEPTH, "weighted_errors": 5, "weight_update": 5,
                      "weight_update_product": 0, "vote_argmax": 0, "flash_attention": 0},
              f"{ds} launches {got}")
        check(ref.device_calls == device_calls, f"{ds}: a plain version ran on CUDA tensors")
        check_run(run, 5, f"{ds} on the card")
        log(f"{ds}: final F1 {run['history'][-1]['f1']:.4f}, launches {got}")

    phase_done(4)

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

    phase_done(5)

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
    counted = round_host_ops(torch, ops, fl_run)
    log(f"host operations (adult, round 6 of 10; PyTorch operators + kernel launches): a round "
        f"{counted['round']['host_ops']} ({counted['round']['torch_ops']} + "
        f"{counted['round']['kernel_launches']}), of them the weight update "
        f"{counted['update_weights']['host_ops']} ({counted['update_weights']['torch_ops']} + "
        f"{counted['update_weights']['kernel_launches']}); most frequent {counted['round']['top']}")
    stage_breakdown(torch, fl_run, card)
    profile_round(torch, fl_run, card)

    phase_done(6)

    # 7. serving; the pendigits sync run is the serving main path
    serve_launches, serve_dispatches = serve_phase(torch, ops, ref, card)
    launches["vote_argmax"] = serve_launches["vote_argmax"]
    phase_done(7)

    # 8. LLM serving: gemma-2b at full width, the flash_attention path
    llm = llm_phase(torch, ops, ref, card)
    launches["flash_attention"] = llm["launches"]["flash_attention"]
    phase_done(8)

    # 9. DistBoost.F, PreWeak.F, bagging, extra_tree; committee serving
    algorithms_phase(torch, ops, ref, fl_run, card)
    committee_serving(torch, ops, ref, fl_run, card)
    phase_done(9)

    # 10. the other learners, the Dirichlet split, heterogeneous federations
    # and their serving
    hetero_phase(torch, ops, ref, fl_run, card)
    hetero_serving(torch, ops, ref, fl_run, card)
    phase_done(10)

    # 11. the interpreted round (--faithful), the §5.1 ladder, PreWeak.F
    # without its cache, FedAvg
    launches["weight_update_product"] = interpreted_phase(torch, ops, ref, fl_run, card, main_run)
    phase_done(11)

    # 12. the elastic runtime (fl_run --elastic, faults, late merges) and the
    # multi-tenant registry
    elastic_launches = elastic_phase(torch, ops, ref, fl_run, card)
    phase_done(12)

    # 13. the multi-process federation (fl_spawn, fl_run --distributed [--elastic])
    dist_launches = distributed_phase(torch, fl_run, card)
    phase_done(13)
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f}s")

    kernels = []
    for name, (res, worst) in per_kernel.items():
        src, replaces = SOURCES[name]
        training = name in ("tree_hist", "weighted_errors", "weight_update", "weight_update_product")
        main_shape = res[MAIN_SHAPE[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "launches_per_round": launches[name] / MAIN["rounds"] if training else None,
            "launches_per_batch": launches[name] / serve_dispatches if name == "vote_argmax" else None,
            "launches_per_prefill": launches[name] if name == "flash_attention" else None,
            # phase 12: the chaos run's training launches, the registry's votes
            "launches_elastic": elastic_launches.get(name, 0),
            # phase 13 (b): both processes of the 2-process lockstep run, 6 rounds,
            # and the 4 processes of the fault-free elastic star, 6 rounds
            "launches_distributed": dist_launches["lockstep"][name],
            "launches_elastic_dist": dist_launches["elastic"][name],
            "max_abs_err": worst, "max_err": worst,
            "ms": main_shape["ms"], "kernel_ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": main_shape["library_ms"],
            "eager_ms": main_shape["eager_ms"], "shape": main_shape["shape"],
            "launch_floor_ms": floor,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
