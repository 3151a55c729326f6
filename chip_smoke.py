#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py   # on a machine with one NVIDIA H100

Phases, each of which raises (non-zero exit) on failure:

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, and
   check ptxas's report (no spill in the bf16 ``flash_attention``
   instances, the float32 one at D = 64, ``tree_hist``,
   ``weighted_errors``, ``weight_update`` or ``vote_argmax``) and ``tree_hist``'s SASS (its shared-memory atomics
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
   ``weight_update_product`` over ``[32 561 // P]``;
14. train and serve the LM side's windowed paths on the card: (a)
   gemma-2b at its published width (18 layers, bf16, random weights from a
   seed, no cut) through ``models.model.train_step`` at batch 2 x 1024
   tokens from ``token_batches``: one step twice from the same seeded state
   (the bits compared), three more steps (ms/step, tokens/s, share of the
   step's bound, peak memory) and one at ``accum = 2``; every loss and
   grad-norm finite, the parameters moved, no ``flash_attention`` launch
   (the training forward runs the plain attention, 36 calls a step: 18
   layers and their recompute); (b) a 2-layer float32 cut at ``reduced()``
   widths in the ``full`` and ``local_global`` patterns, 3 steps on the
   card and on the CPU from the same state (losses, grad-norms and every
   parameter within ``TRAIN_TOL``); (c) ``repro_torch.launch.train
   --preset lm100m --steps 300 --checkpoint`` (its own assertion: the loss
   falls), the checkpoint loaded bit for bit, then ``--resume`` (the step
   counter continues from 300, the loss falls again), and a bf16
   ``TrainState`` of reduced gemma-2b round-tripped bit for bit; (d)
   gemma-2b with gemma2's local/global layers (window 4096) prefilling an
   8192-token prompt (18 ``flash_attention`` launches) and decoding 32
   greedy tokens past every local layer's ring, the last step's logits
   against a cache-free forward over the same 8224 tokens at
   ``DECODE_TOL``, and a 2-layer float32 windowed cut (window 256, prompt
   1024, 32 steps) against the CPU at ``CPU_TOL``.  Phase 3 holds
   ``flash_attention`` at that prefill's two shapes (``q [1, 8, 8192,
   256]``, ``k``/``v [1, 1, 8192, 256]``, causal, with and without the
   4096 window), timed against the plain version and SDPA (the window's
   given as a boolean mask);
15. run the SPMD round and the mesh engine on the card (adult, fl_run's
   defaults, 10 rounds, seed 0): (a) ``fl_run --sharded`` on a (1, 1)
   mesh in this process (every launch count set to 0 just before: 4
   ``tree_hist``, 1 ``weighted_errors`` and 1 ``weight_update_product`` a
   round, 1 ``vote_argmax`` for the sharded predict, no plain version on
   the card); (b) 4 gloo ranks of a (4, 1) mesh, every rank on the one
   card, under ``fl_run`` in children that print their launches (the same
   counts each); each run's chosen sequence equal to the fused card run's
   at the same C, its F1 on the truncated test split within 0.02 of the
   fused run's there, ms/round; (c) ``EngineConfig(mesh=...)`` at (1, 1)
   here and on 4 gloo ranks (children serving a saved artifact of the
   fused C = 4 run) equal to the local engine bit for bit, one
   ``vote_argmax`` a batch a rank.  A schedule over several cards is not
   verified: the machine has one.  Phase 3 holds each rank's shapes
   (vehicle's ``[1, n/4, 18]`` fits, ``[1, 4, n/4]`` errors, ``[n/4]``
   product; ``vote_argmax`` over a rank's slice of a batch and of the
   test split, equal to a member-by-member ``VoteTally``);
16. serve and train the MoE architectures at their published widths,
   cut in depth, bf16, random weights from seed 0: (a) grok-1-314b (4 of
   64 layers) with an 8192-token prompt and llama4-scout-17b-a16e (one
   period, 4 of 48 layers: 3 chunked-local, window 8192, and a NoPE global
   layer) with a 16 384-token prompt, 32 greedy steps each, through
   ``repro_torch.launch.serve --full --layers 4`` (every count set to 0
   just before: one ``flash_attention`` launch a layer, nothing else, no
   plain version on the card, tokens inside the vocabulary), then on a
   model built the same way: two prefills with the same bits, warm
   prefill ms and decode ms/step, peak memory, the (token, choice) pairs
   the 1.25 capacity dropped, a profile split into the MoE stages
   (route, dispatch, experts, combine), the attention and the rest, and
   the last of 32 decode steps against a cache-free forward at a
   drop-free capacity (``DECODE_TOL``); (c) llama4-scout's train step at
   full width, one layer, batch 1 x 1024: step 1 twice from one seeded
   state with the same bits, three more timed, peak memory, no
   ``flash_attention`` launch; (d) ``reduced()`` grok-1 and llama4-scout
   in float32 at capacity factor 1.25, 3 steps on the card and the CPU
   within ``TRAIN_TOL``.  Phase 3 holds ``flash_attention`` at the
   prefills' shapes (grok-1 ``q [1, 48, 8192, 128]``, ``k``/``v [1, 8,
   8192, 128]``, causal, softcap 30; llama4-scout ``[1, 40, 16384, 128]``
   over ``[1, 8, 16384, 128]``, causal, with and without the 8192
   window): the plain version a KV head's group at a time, a CUDA-graph
   replay with the eager bits, timed against the plain version and SDPA
   (without the softcap; the window as a mask, K/V expanded);
17. serve and train the recurrent mixers (``models/ssm.py``) at their
   published widths, bf16, random weights from seed 0: (a) xlstm-1.3b
   whole (48 layers: 42 mLSTM, 6 sLSTM; 3.61 G parameters) through
   ``repro_torch.launch.serve --full`` at batch 4, a 2048-token prompt and
   32 greedy steps (every count set to 0 just before: no kernel launch, no
   plain version on the card, tokens inside the vocabulary), then on a
   model built the same way: two prefills with the same bits, warm prefill
   ms, decode ms/step and tok/s, peak memory, a profile split into the
   mLSTM chunks, the sLSTM steps, the projections and the rest (at a
   256-token prompt), and, on the same weights drawn in float32, 128
   decode steps past a 256-token (two-chunk) prefill against a cache-free
   forward over the 384 tokens; (b) a Mamba hybrid
   at gemma-2b's width with Jamba's layout (one period: 7 Mamba layers
   around 1 attention layer) through ``launch.serve``'s ``build`` and
   ``generate`` with a 1 x 8192 prompt: exactly one ``flash_attention``
   launch a prefill (phase 3's ``q [1, 8, 8192, 256]`` causal), the same
   checks and times, decode past an 8064-token prefill against a forward;
   (c) xlstm-1.3b's train step at full width, one unit of 8 layers, batch 2
   x 1024: step 1 twice from one seeded state with the same bits, three
   more timed, peak memory, no kernel launch; (d) the reduced xlstm and
   hybrid in float32, 3 train steps card vs CPU (the first step's moments
   leaf by leaf within ``MOMENT_SCALED_TOL``; ``TRAIN_TOL``; reduced
   xlstm's later steps at ``XLSTM_TRAIN_TOL``), then a prefill and 8 decode
   steps on the card's trained weights within ``CPU_TOL``;
18. serve the pruned configs' features at their published widths and full
   depth, bf16, random weights from seed 0, each an ``ArchConfig`` literal
   of the seed's config file (``FRONTEND_ARCHS``): whisper-large-v3 (32
   encoder layers over 1500 frames, 32 decoder layers with cross-attention,
   sinusoidal positions), gemma2-27b (post-norms, 23 windowed and 23 full
   layers with softcap 50) and internvl2-26b (a 1024-patch prefix), through
   ``launch.serve``'s ``build`` and ``generate`` (every count set to 0 just
   before: 96, 46 and 48 ``flash_attention`` launches a prefill, none a
   decode step, no plain version on the card), then two prefills with the
   same bits, prefill ms, decode ms/step, tok/s, peak memory, the state's
   position P + S, whisper's cross caches unchanged by decode, and one
   decode step against a cache-free forward over S + 1 (``DECODE_TOL``);
   (d) the three reduced in float32, 3 train steps card vs CPU within
   ``TRAIN_TOL`` (step 1's moments leaf by leaf within 1e-4), then a
   prefill and 8 decode steps within ``CPU_TOL``.  Phase 3 holds
   ``flash_attention`` at the six new shapes (whisper's encoder ``[4, 20,
   1500, 64]`` non-causal, its cross-attention 64 queries against 1500
   keys, its decoder self-attention, gemma2's windowed and full layers with
   the softcap, internvl2's ``[4, 48, 1088, 128]`` over 8 KV heads), each
   also replayed from a CUDA graph with the eager bits, and whisper's
   encoder and cross-attention in float32 (the 3xTF32 route, the cross's
   keys split over clusters of 8) with both of that route's bounds and
   float32 SDPA's time;
19. the production mesh: (a) grok-1-314b's MoE layer at full width, 1
   layer, batch 2 x 4096, through the data-parallel dispatch on 2 gloo
   ranks of a (2, 1) mesh sharing the card, each rank against one
   process's ``_moe_dense(x, G=2)`` and the aux the mean of the local ones;
   (b) ``repro_torch.launch.dryrun`` of gemma-2b and grok-1-314b
   ``train_4k`` and ``--fl-round`` on the (16, 16) mesh on the host; (c) a
   (1, 1)-mesh dry-run of gemma-2b's prefill at phase 8's 4 x 64 whose
   argument bytes and FLOPs equal the card's for the same params and inputs.

Phase 7's engines serve from the process-wide cache of CUDA graphs
(``serve/compile_cache.py``): a program's first batch runs eagerly and
captures a graph holding one ``vote_argmax``, every later batch replays it
(the replay counts its launch), so the count stays one launch a batch.
Phase 7 also drives the same artifact and traffic through an engine that
runs every batch eagerly (votes equal bit for bit, both req/s and p50/p99
logged); phase 10 serves a mix with an emptied group (its program skips
the group); phase 12 (f) serves three tenants of one structure from one
program (2 hits, a swap builds none) and captures a new tenant's graph
while another tenant's scheduler serves from its own thread.

Each phase's seconds are printed at the end.  The second-to-last line is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.  Without a card, or beside no copy of
the repo, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
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
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense (3xTF32 takes three)
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
# 3xTF32 route) and each again in bf16 (the TMA/wgmma route: D = 32, 64,
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
    # the D = 128 kernel's edges (128 query rows a block, 128-key tiles): a
    # tail of one row, a chunk with S < T, window edges inside a tile, the
    # softcap with a window, groups of 5, 6 and 8 heads, non-causal, S = 1
    "ragged_257_bf16": (1, 2, 1, 257, 257, 128, True, None, None, True),
    "chunk_40x300_bf16": (1, 4, 1, 40, 300, 128, True, None, None, True),
    "window_100_bf16": (1, 4, 2, 300, 300, 128, True, 100, None, True),
    "window_200_bf16": (1, 4, 2, 300, 300, 128, True, 200, None, True),
    "softcap_window_g6_bf16": (1, 6, 1, 500, 500, 128, True, 200, 30.0, True),
    "noncausal_g5_bf16": (1, 5, 1, 200, 200, 128, False, None, None, True),
    "s1_g1_bf16": (1, 8, 8, 1, 1, 128, True, None, None, True),
    "s1_over_77_softcap_g8_bf16": (1, 8, 1, 1, 77, 128, True, None, 50.0, True),
    "gemma_serve": (4, 8, 1, 64, 64, 256, True, None, None, True),
    "gemma_2048": (1, 8, 1, 2048, 2048, 256, True, None, None, True),
    # phase 14's windowed gemma-2b prefill: its local layers and its full ones
    "gemma_window_8192": (1, 8, 1, 8192, 8192, 256, True, 4096, None, True),
    "gemma_8192": (1, 8, 1, 8192, 8192, 256, True, None, None, True),
    # phase 16's MoE prefills: grok-1's layers (softcap 30, 48 query heads
    # over 8 KV heads), llama4-scout's chunked-local layers (window 8192, 40
    # over 8) and its NoPE global layer
    "grok_8192_softcap": (1, 48, 8, 8192, 8192, 128, True, None, 30.0, True),
    "llama4_window_16384": (1, 40, 8, 16384, 16384, 128, True, 8192, None, True),
    "llama4_16384": (1, 40, 8, 16384, 16384, 128, True, None, None, True),
    # phase 18's prefills: whisper-large-v3 (batch 4, 1500 frames, a 64-token
    # prompt; 20 heads of 64) through its encoder's non-causal layers, its
    # decoder's causal self-attention and its cross-attention (64 queries
    # against the 1500 encoder rows, non-causal); gemma2-27b's windowed and
    # full layers (32 over 16 heads of 128, softcap 50, window 4096, an
    # 8192-token prompt); internvl2-26b's layers (48 over 8 heads, batch 4, a
    # 1024-patch prefix and a 64-token prompt)
    "whisper_encoder_1500": (4, 20, 20, 1500, 1500, 64, False, None, None, True),
    "whisper_cross_64x1500": (4, 20, 20, 64, 1500, 64, False, None, None, True),
    "whisper_self_64": (4, 20, 20, 64, 64, 64, True, None, None, True),
    "gemma2_window_8192_softcap": (1, 32, 16, 8192, 8192, 128, True, 4096, 50.0, True),
    "gemma2_8192_softcap": (1, 32, 16, 8192, 8192, 128, True, None, 50.0, True),
    "internvl2_1088": (4, 48, 8, 1088, 1088, 128, True, None, None, True),
    # whisper's encoder over float32 frames runs in float32, as the JAX
    # package's does, and so does its cross-attention against the float32
    # encoder output: the float32 (3xTF32) route at these two shapes, the
    # second split along the keys over clusters of 8
    "whisper_encoder_1500_f32": (4, 20, 20, 1500, 1500, 64, False, None, None, False),
    "whisper_cross_64x1500_f32": (4, 20, 20, 64, 1500, 64, False, None, None, False),
    # the float32 route's other plans: a key split over a ragged T, a causal
    # chunk with S < T and a window split 2 ways, D = 128 with the softcap
    # and grouped heads, and D = 256 (32-key tiles, one CTA an SM)
    "split_40x1000_f32": (1, 4, 4, 40, 1000, 64, False, None, None, False),
    "chunk_window_96x1000_f32": (1, 4, 2, 96, 1000, 64, True, 256, None, False),
    "softcap_gqa_d128_f32": (2, 8, 2, 200, 200, 128, True, None, 30.0, False),
    "d256_2048_f32": (1, 8, 1, 2048, 2048, 256, True, None, None, False),
}
FRONTEND_FLASH = ("whisper_encoder_1500", "whisper_cross_64x1500", "whisper_self_64",
                  "gemma2_window_8192_softcap", "gemma2_8192_softcap", "internvl2_1088",
                  "whisper_encoder_1500_f32", "whisper_cross_64x1500_f32")
# timed: both routes, bf16 at gemma-2b's shapes and float32 at "ragged"
# and at D = 256
FLASH_TIMED = ("gemma_serve", "gemma_2048", "ragged", "gemma_window_8192", "gemma_8192",
               "grok_8192_softcap", "llama4_window_16384", "llama4_16384", "d256_2048_f32") + FRONTEND_FLASH
# the MoE prefills' shapes: the plain version runs a KV head's group at a time
# (its float32 scores of one call would hold 13-43 GB), timed eagerly; the
# kernel is also replayed from a CUDA graph and must give the eager bits
FLASH_BIG = ("grok_8192_softcap", "llama4_window_16384", "llama4_16384", "gemma2_window_8192_softcap",
             "gemma2_8192_softcap")
FLASH_D128_EDGES = ("ragged_257_bf16", "chunk_40x300_bf16", "window_100_bf16", "window_200_bf16",
                    "softcap_window_g6_bf16", "noncausal_g5_bf16", "s1_g1_bf16",
                    "s1_over_77_softcap_g8_bf16")
# replayed from a CUDA graph, which must give the eager bits
FLASH_REPLAY = FLASH_BIG + FRONTEND_FLASH + FLASH_D128_EDGES + ("ragged", "split_40x1000_f32",
                                                               "d256_2048_f32")
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
# phase 14 (a): gemma-2b's training step at full width, bf16, batch x tokens
# from token_batches; an optimizer whose first step already moves bf16
# weights (lr 3e-4 after a 1-step warm-up)
TRAIN = {"batch": 2, "seq": 1024, "timed_steps": 3}
TRAIN_OPT = {"lr": 3e-4, "warmup_steps": 1, "total_steps": 100}
# (b) float32 card against CPU after 3 steps: tests/test_torch_train.py's
# tolerances against the JAX package (measured there at most 1.2e-7, 7.2e-7
# and 2.9e-5)
TRAIN_TOL = {"loss_rtol": 1e-5, "gnorm_atol": 1e-4, "param_atol": 1e-4}
# (c) the training driver: 150 steps of lm100m, then 300 more from its checkpoint (a
# schedule of 300 steps entered at step 151); cut from 300 and 600 to keep the
# whole run inside its time limit
CLI_STEPS, RESUME_STEPS = 150, 300
# (d) gemma2's local/global layout on gemma-2b: the window Gemma 2 publishes
# (arXiv:2408.00118), a prompt of two windows, decode steps past the ring
WINDOWED = {"window": 4096, "prompt": 8192, "steps": 32}
# phase 15: the SPMD round (fl_run --sharded) on adult at fl_run's defaults,
# on a (1, 1) mesh in this process and on 4 gloo ranks of a (4, 1) mesh (4
# processes on the one card); the mesh engine at serve_fl's batch
SHARDED = {"rounds": 10, "ranks": 4, "batch": 256}
# phase 16: grok-1 and llama4-scout at their published widths, cut in depth
# to what one card's 80 GB holds (grok-1: 4 of 64 layers, about 21.3 G
# parameters; llama4-scout: one pattern period, 4 of 48 layers, about 10.4 G),
# weights in bf16 from seed 0; prompts long enough that llama4's 8192-token
# window bites; decode past it
MOE_SERVE = {
    "grok": {"arch": "grok-1-314b", "layers": 4, "prompt": 8192, "tokens": 32},
    "llama4": {"arch": "llama4-scout-17b-a16e", "layers": 4, "prompt": 16384, "tokens": 32},
}
# decode against a cache-free forward at a drop-free capacity (the served
# capacity factor 1.25 may drop prompt tokens that one decoded token never
# loses): grok at a 1024-token prompt (its drop-free expert buffers at 8192
# tokens would not fit beside its weights), llama4 at the served prompt, past
# its window ring
MOE_DECODE_CHECK = {"grok": 1024, "llama4": 16384}
# the MoE train step: llama4-scout at full width, one layer (a chunked-local
# MoE layer), batch 1 x 1024 from token_batches
MOE_TRAIN = {"arch": "llama4-scout-17b-a16e", "layers": 1, "batch": 1, "seq": 1024, "timed_steps": 3}
# phase 17: xlstm-1.3b whole (48 layers, 3.61 G parameters, 7.27 GB in bf16) at
# batch 4 and a 2048-token prompt (16 chunks of 128), 32 greedy steps; the
# profile at a 256-token prompt (every part of a prefill is linear in its
# length, and the profiler's own cost grows with the ~150 operations a
# token); decode against a forward in float32 across a chunk boundary: a
# 256-token prefill (two chunks, the mLSTM's C/n carried from the first into
# the second and written into the cache) teacher-forced to 384
XLSTM_SERVE = {"batch": 4, "prompt": 2048, "tokens": 32, "profile_prompt": 256, "f32_check": (256, 384)}
# a Mamba hybrid at gemma-2b's width with Jamba's layout (arXiv:2403.19887:
# one attention layer to seven Mamba layers), one period
HYBRID = {"arch_type": "hybrid", "layer_pattern": "mamba_attn", "pattern_period": 8, "attn_index": 4,
          "n_layers": 8}
HYBRID_SERVE = {"batch": 1, "prompt": 8192, "tokens": 32, "check_prefill": 8064}
# decode against a cache-free forward: twice the value measured on an H100
# (hybrid bf16 0.098; xlstm float32 at full depth, 128 steps past a two-chunk
# prefill, 0.1023).  bf16 rounds the residual stream at every layer and random xlstm
# weights amplify it (on the CPU at full width its bf16 forward is 0.66 from
# the float32 forward of the same weights after 8 layers), so xlstm's decode
# path is held in float32
RECURRENT_DECODE_TOL = {"hybrid": {"atol": 0.2, "rtol": 0.0}, "xlstm_f32": {"atol": 0.205, "rtol": 0.0}}
# xlstm-1.3b's train step: one unit of 8 layers at full width, batch 2 x 1024
XLSTM_TRAIN = {"layers": 8, "batch": 2, "seq": 1024, "timed_steps": 3}
# reduced xlstm in float32, card vs CPU: its first step's grad norm (~62) and
# its later steps at tests/test_torch_ssm.py's measured tolerances
XLSTM_TRAIN_TOL = {"first_gnorm_atol": 2e-3, "loss_rtol": 5e-4, "gnorm_rtol": 0.2, "param_atol": 2e-3}
# (d) the first step's AdamW moments leaf by leaf (each leaf's gradient),
# card vs CPU, within this share of each leaf's largest |value|: tests/
# test_torch_ssm.py's limits against the JAX package (the hybrid at 1e-4;
# reduced xlstm at 1.2e-3, twice the float32 spread measured there)
MOMENT_SCALED_TOL = {"hybrid": 1e-4, "xlstm-1.3b": 1.2e-3, "frontend": 1e-4}
# phase 18: the pruned configs' features at their published widths and full
# depth, from the seed's config files (the JAX registry no longer holds them,
# so neither does the port's): whisper-large-v3 (the audio encoder, a
# cross-attention sublayer in every decoder layer, sinusoidal positions),
# gemma2-27b (post-norms; a window and a softcap together) and internvl2-26b
# (the VLM patch-embedding prefix); weights in bf16 from seed 0
FRONTEND_ARCHS = {
    "whisper": dict(
        name="whisper-large-v3", arch_type="audio", n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab_size=51866, mlp_type="gelu", pos_emb="sinusoidal", layer_pattern="full",
        encoder_layers=32, encoder_seq=1500,
        source="arXiv:2212.04356 (Whisper), large-v3 card; f0c2fc6:src/repro/configs/whisper_large_v3.py"),
    "gemma2": dict(
        name="gemma2-27b", arch_type="dense", n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
        head_dim=128, d_ff=36864, vocab_size=256000, mlp_type="geglu", layer_pattern="local_global",
        window=4096, logit_softcap=50.0, final_softcap=30.0, post_norm=True, tie_embeddings=True,
        embed_scale=True, source="arXiv:2408.00118 (Gemma 2); f0c2fc6:src/repro/configs/gemma2_27b.py"),
    "internvl2": dict(
        name="internvl2-26b", arch_type="vlm", n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=92553, mlp_type="swiglu", layer_pattern="full",
        prefix_tokens=1024,
        source="arXiv:2404.16821 (InternVL 1.5/2; InternLM2-20B backbone); "
               "f0c2fc6:src/repro/configs/internvl2_26b.py"),
}
# each served through launch.serve's build and generate: the JAX launcher's
# defaults for whisper and internvl2 (batch 4, prompt 64, 32 steps), gemma2
# as phase 14 (d) serves windowed gemma-2b (1 x 8192, two windows); the
# flash_attention launches a prefill makes (whisper: 32 encoder, 32 self,
# 32 cross)
FRONTEND_SERVE = {
    "whisper": {"batch": 4, "prompt": 64, "tokens": 32, "flash": 96},
    "gemma2": {"batch": 1, "prompt": 8192, "tokens": 32, "flash": 46},
    "internvl2": {"batch": 4, "prompt": 64, "tokens": 32, "flash": 48},
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def is_kernel(e, DeviceType) -> bool:
    """Whether a profile's ``key_averages`` entry is device work: a program
    span's device-side copy (a user annotation, which spans its kernels and
    the gaps between them) is not."""
    return e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)


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


def register_roles(build, entry: str) -> dict:
    """The register counts the kernel whose name contains ``entry`` sets
    with ``setmaxnreg``, read from its SASS (``USETMAXREG``): ``{"alloc":
    [...], "dealloc": [...]}`` (consumers raise, the producer lowers)."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path())],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()[:500]}")
    roles = {"alloc": [], "dealloc": []}
    for function in sass.stdout.split("Function : ")[1:]:
        if entry in function.splitlines()[0]:
            for kind, n in re.findall(r"USETMAXREG\.(TRY_ALLOC|DEALLOC)\S*\s+(?:U?P\w+,\s*)?(0x[0-9a-f]+|\d+)",
                                      function):
                roles["alloc" if kind == "TRY_ALLOC" else "dealloc"].append(int(n, 0))
    return roles


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


def h1_hist(torch, ops, ref, g, n: int, d: int = SHAPES["adult"][1], K: int = SHAPES["adult"][2]) -> tuple:
    """``tree_hist`` at H = 1 over a shard of ``n`` rows and ``d`` features
    (adult's by default), L = 1, 2, 4, 8, ``K`` classes, under AdaBoost's
    skewed weights: atol 1e-4, the plain version's split, each output on a
    NaN-filled block, the same bits twice.  Returns (record, worst error,
    the plans)."""
    from repro_torch.kernels import tree_hist as tree_hist_mod
    from repro_torch.learners.tree import _split_scores

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


def check_sharded_shapes(torch, ops, ref, g, fl_run) -> dict:
    """The kernels at each rank's shapes in phase 15's SPMD round and mesh
    engine, beyond phase 13's adult shards (a rank of the ``(4, 1)`` mesh
    holds P = 4's, of the ``(1, 1)`` mesh P = 1's): vehicle at 4
    collaborators (``tree_hist`` ``[1, n/4, 18]``, ``weighted_errors``
    ``[1, 4, n/4]``, ``weight_update_product`` ``[n/4]``), and
    ``vote_argmax`` over a rank's slice of a batch: the mesh engine's
    ``[10, 256 / 4]`` and the sharded predict's ``[10, 16 281 // 4]`` (adult,
    10 members, K = 2).  Returns {kernel: {shape name: record}}."""
    _, Xs, _, _, Xte, _, spec = fl_run.build_inputs("vehicle", SHARDED["ranks"], 1, DEPTH, 0)
    n, d, K = int(Xs.shape[1]), spec.n_features, spec.n_classes
    hist, worst, plans = h1_hist(torch, ops, ref, g, n, d, K)
    errors = shard_errors(torch, ops, ref, g, SHARDED["ranks"], n)
    product = update_record(torch, ops, ref, g, "weight_update_product", n)
    test_rows = int(fl_run.build_inputs("adult", 1, 1, DEPTH, 0)[4].shape[0])
    votes = {}
    for tag, rows in (("sharded_engine", SHARDED["batch"] // SHARDED["ranks"]),
                      ("sharded_predict", test_rows // SHARDED["ranks"])):
        T, Kv = SHARDED["rounds"], SHAPES["adult"][2]
        preds = torch.randint(-1, Kv + 1, (T, rows), generator=g, dtype=torch.int32).to(DEV)
        alpha = (torch.rand(T, generator=g) * 3.0).to(DEV)
        got = poisoned(torch, (rows,), lambda: ops.vote_argmax(preds, alpha, n_classes=Kv))
        want = tally_classes(torch, preds, alpha, Kv)
        check(torch.equal(got, want), f"vote_argmax {tag} [{T}, {rows}]: {int((got != want).sum())} "
              "rows differ from a member-by-member VoteTally")
        clean = torch.randint(0, Kv, (T, rows), generator=g, dtype=torch.int32).to(DEV)
        bms, by = bound_ms(4 * (T * rows + T + rows), 2 * T * rows)
        votes[tag] = {"shape": f"preds [{T}, {rows}], K={Kv}", "max_abs_err": 0.0, "bound_ms": bms,
                      "bound_by": by, **timings(torch, lambda: ops.vote_argmax(clean, alpha, n_classes=Kv),
                                                lambda: ref.vote_argmax_ref(clean, alpha, Kv))}
    log(f"phase 15 rank shapes against the plain versions: vehicle at {SHARDED['ranks']} collaborators: "
        f"tree_hist [1, {n}, {d}] K={K} worst {worst:.3g} ({'; '.join(plans)}), mean {hist['ms']:.5f} ms "
        f"(bound {hist['bound_ms']:.6f}, plain {hist['plain_ms']:.5f}); weighted_errors "
        f"[1, {SHARDED['ranks']}, {n}] {errors['ms']:.5f} ms (bound {errors['bound_ms']:.6f}, plain "
        f"{errors['plain_ms']:.5f}); weight_update_product [{n}] {product['ms']:.5f} ms (bound "
        f"{product['bound_ms']:.6f}, plain {product['plain_ms']:.5f}); "
        + "; ".join(f"vote_argmax {k} {v['shape']} = a member-by-member VoteTally, {v['ms']:.5f} ms "
                    f"(bound {v['bound_ms']:.7f}, plain {v['plain_ms']:.5f})" for k, v in votes.items()))
    return {"tree_hist": {"sharded_vehicle": hist}, "weighted_errors": {"sharded_vehicle": errors},
            "weight_update_product": {"sharded_vehicle": product}, "vote_argmax": votes}


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


def grouped_attention_ref(torch, ref, q, k, v, **kw):
    """The plain version over one KV head and its query heads at a time,
    concatenated: the same arithmetic a head at a time, in a twelfth to a
    fortieth of the memory (the MoE prefills' float32 scores would hold
    13-43 GB in one call)."""
    g = q.shape[1] // k.shape[1]
    return torch.cat([ref.attention_ref(q[:, j * g:(j + 1) * g], k[:, j:j + 1], v[:, j:j + 1], **kw)
                      for j in range(k.shape[1])], dim=1)


def graph_bits(torch, fn) -> bool:
    """Whether ``fn()`` replayed from a CUDA graph gives the bits of an
    eager call (warmed up on a side stream first, as ``cuda_ms`` does)."""
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(out, eager)


def big_timings(torch, kernel, plain, library) -> dict:
    """``timings`` for the MoE prefills' shapes: the kernel and the library
    call replayed from a CUDA graph (5 calls, 3 replays), the plain version,
    which runs for tenths of a second a call, between CUDA events over 2
    eager calls."""
    return {
        "ms": cuda_ms(torch, kernel, iters=5, reps=3),
        "plain_ms": eager_ms(torch, plain, iters=2, warmup=1),
        "library_ms": cuda_ms(torch, library, iters=5, reps=3),
        "eager_ms": eager_ms(torch, kernel, iters=5, warmup=1),
    }


def check_flash_attention(torch, ops, ref, g):
    """Each case against the plain version on the card, at ``TOL`` (every
    case logged, then any that disagree named); at gemma-2b's shapes the kernel's, the plain
    version's and SDPA's device times (SDPA's causal mask aligns top-left,
    so it computes the same function only at S == T, as here) and the
    bound: 4·D flops per visible pair over the bf16 peak (float32: three
    TF32 products over the TF32 peak, and beside it 4·D over the float32
    peak of the CUDA cores), against q, k, v and o moved once.  At the MoE
    prefills' and gemma2-27b's shapes
    (``FLASH_BIG``) the plain version runs a KV head's group at a time;
    there and at phase 18's other shapes (``FLASH_REPLAY``) the kernel is
    replayed from a CUDA graph with the eager bits.  SDPA is timed as the
    nearest library call: without the softcap where there is one (SDPA has
    no score modifier, so its time is a floor), and at a big window shape
    with K/V expanded to the query heads beforehand (outside the timing)
    and the window as a boolean mask, on its memory-efficient backend."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    results, worst, failed = {}, 0.0, []
    for name, (B, H, Hkv, S, T, D, causal, window, softcap, bf16) in FLASH_CASES.items():
        dt = torch.bfloat16 if bf16 else torch.float32
        q, k, v = (torch.randn(shape, generator=g).to(dt).to(DEV)
                   for shape in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))
        kw = {"causal": causal, "window": window, "softcap": softcap}
        big = name in FLASH_BIG
        plain = (lambda: grouped_attention_ref(torch, ref, q, k, v, **kw)) if big else \
            (lambda: ref.attention_ref(q, k, v, **kw))
        got = ops.flash_attention(q, k, v, **kw).float()
        want = plain().float()
        torch.cuda.synchronize()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"flash_attention {name}: shape {tuple(got.shape)} or non-finite output")
        # every case is compared and logged before any failure is raised, so
        # that a wrong kernel shows how far off it is at each shape
        tol = TOL["flash_attention_bf16" if bf16 else "flash_attention"]
        err = max_err(got, want)
        use = float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())
        replay = graph_bits(torch, lambda: ops.flash_attention(q, k, v, **kw)) if name in FLASH_REPLAY else None
        log(f"flash_attention {name}: max |kernel - plain| {err:.4g}, {use:.3f} of the limit {tol}, "
            f"mean |plain| {float(want.abs().mean()):.4g}"
            + ("" if replay is None else f"; CUDA graph replay = eager bits: {replay}"))
        if use > 1.0:
            failed.append(f"{name} ({err:.4g})")
        if replay is False:
            failed.append(f"{name} (a CUDA graph replay gave other bits)")
        worst = max(worst, err)
        del got, want
        if name in FLASH_TIMED:
            mask = None
            if window:  # SDPA takes the window as a boolean mask (S == T here)
                i = torch.arange(S, device=DEV)[:, None]
                j = torch.arange(T, device=DEV)[None, :]
                mask = (j <= i) & (i - j < window)
            elt = q.element_size()
            nbytes = elt * (2 * q.numel() + k.numel() + v.numel())
            pairs = visible_pairs(S, T, causal, window)
            # bf16: one product on the tensor cores; float32: three TF32 products
            # (3xTF32), beside the bound of float32 on the CUDA cores
            bms, by = bound_ms(nbytes, 4 * D * B * H * pairs * (1 if bf16 else 3),
                               BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S)
            kernel = lambda: ops.flash_attention(q, k, v, **kw)
            if big and window:
                ke, ve = (x.repeat_interleave(H // Hkv, dim=1) for x in (k, v))

                def library():
                    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                        return F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)
            elif window:
                library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
            else:
                library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
            results[name] = {
                "shape": f"q [{B}, {H}, {S}, {D}], k/v [{B}, {Hkv}, {T}, {D}], "
                         f"{'bf16' if bf16 else 'f32'}, {'causal' if causal else 'non-causal'}"
                         + (f", window {window}" if window else "")
                         + (f", softcap {softcap}" if softcap else ""), "max_abs_err": err,
                "bound_ms": bms, "bound_by": by, "visible_pairs": pairs,
                **({} if bf16 else dict(zip(("cuda_core_bound_ms", "cuda_core_bound_by"),
                                            bound_ms(nbytes, 4 * D * B * H * pairs)))),
                **(big_timings(torch, kernel, plain, library) if big else timings(torch, kernel, plain, library)),
            }
            if name in FLASH_REPLAY:
                results[name]["library_call"] = (
                    ("SDPA, K/V expanded to the query heads, window as a boolean mask, memory-efficient"
                     if big and window else "SDPA, window as a boolean mask, enable_gqa" if window else
                     f"SDPA {'causal' if causal else 'non-causal'}, enable_gqa")
                    + (" (without the softcap: SDPA has no score modifier)" if softcap else ""))
                results[name]["graph_replay_same_bits"] = replay
            if big and window:
                del ke, ve
        del q, k, v
        torch.cuda.empty_cache()
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
            for e in prof.key_averages() if is_kernel(e, DeviceType)]
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
    launch count set to 0 and the process's predict programs dropped just
    before (so the run builds its own); checks the ``vote_argmax``
    launches and no plain version on the card (the cache-equals-engine
    check is serve_fl's own: it raises).  One launch a batch and a warm-up:
    a program's first batch runs eagerly and captures a graph holding one
    ``vote_argmax`` (a capture, no launch), every later batch replays it
    (a launch, which the replay counts)."""
    from repro_torch.serve import compile_cache

    log(f"$ python -m repro_torch.launch.serve_fl {' '.join(argv)}")
    calls = dict(ref.device_calls)
    compile_cache.clear_cache()
    ops.reset_launches()
    out = serve_fl.main(argv)
    launches, captures = ops.launch_counts(), ops.capture_counts()
    st = out["stats"]
    served = st.batches + st.warmup_batches
    check(launches["vote_argmax"] == served,
          f"{what}: {launches['vote_argmax']} vote_argmax launches for {st.batches} batches "
          f"and {st.warmup_batches} warm-ups")
    check(st.graph_replays == served - st.compiles and st.compiles >= 1,
          f"{what}: {st.graph_replays} graph replays for {served} batches, {st.compiles} programs built")
    graphs = [p for p in compile_cache._CACHE.values() if isinstance(p, compile_cache.GraphProgram)]
    check(all(g.captured == {"vote_argmax": 1} for g in graphs),
          f"{what}: a graph's kernels {[g.captured for g in graphs]}, not one vote_argmax")
    check(captures["vote_argmax"] == st.compiles,
          f"{what}: {captures['vote_argmax']} vote_argmax captures for {st.compiles} programs built")
    check(ref.device_calls == calls, f"{what}: a plain version ran on CUDA tensors: {ref.device_calls}")
    check(0.0 < out["f1"] <= 1.0, f"{what}: F1 {out['f1']} outside (0, 1]")
    out["captures"] = captures["vote_argmax"]
    out["replayed_launches"] = sum(g.captured["vote_argmax"] * g.replays for g in graphs)
    return out, launches


def eager_serve(torch, ops, ref, serve_fl, path: Path) -> dict:
    """``serve_fl``'s sync engine loop over pendigits' test split for
    ``WINDOW_S``, from an engine that runs every batch eagerly
    (``EngineConfig(cuda_graphs=False)``): the comparison the cached
    graphs are held to.  One launch a batch, no capture."""
    import types

    from repro_torch.data import get_dataset
    from repro_torch.serve import EngineConfig, ServeEngine, load_artifact

    art = load_artifact(path)
    Xte = get_dataset("pendigits", torch.Generator().manual_seed(0))[1][2].numpy()
    engine = ServeEngine.from_artifact(art, config=EngineConfig(cuda_graphs=False))
    engine.warmup()
    args = types.SimpleNamespace(request_rows=REQUEST_ROWS, policy="sync")
    calls = dict(ref.device_calls)
    ops.reset_launches()
    pred, served, dt, _ = serve_fl._drive_engine(args, engine, Xte, WINDOW_S)
    launches, st = ops.launch_counts()["vote_argmax"], engine.stats
    check(launches == st.batches and st.graph_replays == 0 and ops.capture_counts()["vote_argmax"] == 0,
          f"eager engine: {launches} vote_argmax launches for {st.batches} batches, "
          f"{st.graph_replays} graph replays")
    check(ref.device_calls == calls, f"eager engine: a plain version ran on CUDA tensors: {ref.device_calls}")
    lat = st.request_latencies
    return {"pred": pred, "requests": served, "seconds": dt, "p50_ms": 1e3 * lat.percentile(50),
            "p99_ms": 1e3 * lat.percentile(99), "stats": st}


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
    # the same artifact and traffic served eagerly: the cached graphs' votes
    # bit for bit, and the eager figures beside the graphs' in the same run
    log("the same artifact and traffic through serve_fl's sync loop from an eager engine")
    eager = eager_serve(torch, ops, ref, serve_fl, art)
    check(bool((eager["pred"] == sync["pred"]).all()),
          f"cached CUDA graphs served other votes than the eager engine on "
          f"{int((eager['pred'] != sync['pred']).sum())} rows")
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
    rows = {"sync": sync, "sync, eager engine": eager, "deadline": deadline, "letter sync": letter}
    log(f"serving on {card}: " + "; ".join(
        f"{k} {v['requests']} requests in {v['seconds']:.3f} s = {v['requests'] / v['seconds']:.0f} "
        f"req/s p50 {v['p50_ms']:.3f} ms p99 {v['p99_ms']:.3f} ms "
        f"({v['stats'].batches} batches, batch p50 {1e3 * v['stats'].batch_seconds.percentile(50):.3f} "
        f"ms p99 {1e3 * v['stats'].batch_seconds.percentile(99):.3f} ms"
        + (f", queue wait p50 {v['wait_p50_ms']:.3f} ms p99 {v['wait_p99_ms']:.3f} ms"
           if "wait_p50_ms" in v else "") + ")"
        for k, v in rows.items()))
    log(f"phase 7 cached CUDA graphs against the eager engine on {card} (pendigits, sync, "
        f"{WINDOW_S} s each): graphs {sync['requests'] / sync['seconds']:.0f} req/s p50 {sync['p50_ms']:.3f} "
        f"ms p99 {sync['p99_ms']:.3f} ms; eager {eager['requests'] / eager['seconds']:.0f} req/s p50 "
        f"{eager['p50_ms']:.3f} ms p99 {eager['p99_ms']:.3f} ms; votes equal bit for bit "
        f"({len(sync['pred'])} rows); {sync['stats'].graph_replays} graph replays")
    profile_serving(torch, art, card)
    st = sync["stats"]
    return launches, {"batches": st.batches + st.warmup_batches, "graph_replays": st.graph_replays,
                      "replayed_launches": sync["replayed_launches"], "captures": sync["captures"],
                      "programs_built": st.compiles}


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
            for e in prof.key_averages() if is_kernel(e, DeviceType)]
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
    empty_group_serving(torch, final, card)

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


def empty_group_serving(torch, path: Path, card: str) -> None:
    """The heterogeneous engine with its second group emptied (count 0):
    its program skips the group (the active mask keys it), and the cached
    graph's votes equal the eager engine's bit for bit."""
    from repro_torch.data import get_dataset
    from repro_torch.serve import EngineConfig, ServeEngine, load_artifact

    art = load_artifact(path)
    ens = tuple(e._replace(count=0) if g == 1 else e for g, e in enumerate(art.ensemble))
    X = get_dataset("pendigits", torch.Generator().manual_seed(0))[1][2].numpy()
    graphs = ServeEngine(None, art.spec, ens)
    eager = ServeEngine(None, art.spec, ens, config=EngineConfig(cuda_graphs=False))
    got, want = graphs.predict(X), eager.predict(X)
    mask = graphs._active_key(graphs.ensemble, graphs._live[2])
    check(mask is not None and not mask[1] and all(m for g, m in enumerate(mask) if g != 1),
          f"empty group: active mask {mask}")
    check(bool((got == want).all()), f"empty group: graphs and eager differ on {int((got != want).sum())} rows")
    check(graphs.stats.graph_replays == graphs.stats.batches, f"empty group: {graphs.stats}")
    log(f"phase 10 heterogeneous engine with group 1 emptied on {card}: active mask {mask}, cached graph "
        f"= the eager engine bit for bit on {len(got)} rows ({graphs.stats.graph_replays} replays)")


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
    def counts(n):
        st = reg.engine(n).stats
        return st.batches + st.warmup_batches, st.graph_replays, st.compiles

    before = {n: counts(n) for n in stats}
    calls = dict(ref.device_calls)
    ops.reset_launches()
    preds = {n: reg.predict(n, tests[n]) for n in reg.tenants()}
    launches = ops.launch_counts()["vote_argmax"]
    served, replays, built = (sum(counts(n)[i] - before[n][i] for n in stats) for i in range(3))
    # one launch a batch: a program's first batch runs eagerly and captures
    # its graph, every later batch replays it
    check(launches == served and replays == served - built,
          f"registry: {launches} vote_argmax launches and {replays} graph replays for {served} "
          f"batches, {built} programs built")
    check(ref.device_calls == calls, "registry: a plain version ran on CUDA tensors")
    rows = []
    for n in reg.tenants():
        path = latest_artifact(root / n)
        alone = ServeEngine.from_artifact(load_artifact(path)).predict(tests[n])
        check(bool((alone == preds[n]).all()), f"registry {n}: other votes than a standalone engine")
        rows.append(card_vs_cpu(torch, path, n, preds[n], f"registry {n}"))
    log("phase 12 (f) registry: " + "; ".join(rows) + f"; swaps/rebuilds {got}, {replays} graph "
        f"replays for {served} batches, {launches} vote_argmax launches for {built} programs built")
    shared_programs(torch, card)

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


def shared_programs(torch, card: str) -> None:
    """(f) three tenants of one structure (phase 7's pendigits artifact
    published to three streams) share one program: 1 built, 2 hits, their
    votes an eager engine's bit for bit; a swap to a new checkpoint of the
    same structure builds nothing."""
    from repro_torch.data import get_dataset
    from repro_torch.serve import EngineConfig, ModelRegistry, ServeEngine, compile_cache, load_artifact
    from repro_torch.serve import publish_artifact

    art = load_artifact(SERVE / "pendigits.mafl")
    X = get_dataset("pendigits", torch.Generator().manual_seed(0))[1][2].numpy()
    root = SERVE / "registry_shared"
    shutil.rmtree(root, ignore_errors=True)
    for t in ("a", "b", "c"):
        publish_artifact(root / t, art.spec, art.ensemble, version=1)
    compile_cache.clear_cache()
    reg = ModelRegistry()
    for t in ("a", "b", "c"):
        reg.add_tenant(t, root / t)
    eager = ServeEngine.from_artifact(art, config=EngineConfig(cuda_graphs=False)).predict(X)
    for t in ("a", "b", "c"):
        check(bool((reg.predict(t, X) == eager).all()), f"shared program: tenant {t} served other votes")
    s = reg.stats()
    built = sum(v["compiles"] for v in s["tenants"].values())
    hits = sum(v["cache_hits"] for v in s["tenants"].values())
    check((built, hits, s["compile_cache"]["programs"]) == (1, 2, 1),
          f"three tenants of one structure: {built} programs built, {hits} hits, cache {s['compile_cache']}")
    doubled = art.ensemble._replace(alpha=art.ensemble.alpha * 2.0)
    publish_artifact(root / "a", art.spec, doubled, version=2)
    check(reg.refresh() == {"a": 2}, "shared program: the new checkpoint was not found")
    reg.predict("a", X)
    after = reg.stats()
    new = sum(v["compiles"] for v in after["tenants"].values()) - built
    check(new == 0 and after["tenants"]["a"]["swaps"] == 1 and after["compile_cache"]["programs"] == 1,
          f"a swap built {new} programs: {after}")
    log(f"phase 12 (f) three tenants of one structure on {card}: {built} program built, {hits} hits, votes "
        f"= an eager engine's bit for bit; a swap built {new} programs ({after['compile_cache']})")
    capture_beside_serving(torch, reg, X, card)


def capture_beside_serving(torch, reg, X, card: str) -> None:
    """A tenant of another structure (phase 7's letter artifact) is added
    and captures its graph while tenant ``b``'s deadline scheduler serves
    pendigits from its own thread: the capture is thread-local, so neither
    side raises, and both answer as eager engines do."""
    import threading

    from repro_torch.data import get_dataset
    from repro_torch.serve import EngineConfig, ServeEngine, load_artifact, publish_artifact

    letter = load_artifact(SERVE / "letter.mafl")
    Xl = get_dataset("letter", torch.Generator().manual_seed(0))[1][2].numpy()
    want_b = ServeEngine.from_artifact(load_artifact(SERVE / "pendigits.mafl"),
                                       config=EngineConfig(cuda_graphs=False)).predict(X)
    want_d = ServeEngine.from_artifact(letter, config=EngineConfig(cuda_graphs=False)).predict(Xl)
    root = SERVE / "registry_shared"
    publish_artifact(root / "d", letter.spec, letter.ensemble, version=1)
    answers, errors, stop, started = [], [], threading.Event(), threading.Event()
    eng = reg.engine("b")
    with eng.scheduler(t_max_s=0.0005) as sched:
        def traffic():
            try:
                while not stop.is_set():
                    ids = []
                    for i in range(0, len(X), REQUEST_ROWS):
                        ids += sched.submit(X[i:i + REQUEST_ROWS])
                    answers.append(sched.results(ids, timeout_s=60.0))
                    started.set()
            except Exception as e:  # reported by the check below
                errors.append(e)
                started.set()

        t = threading.Thread(target=traffic)
        t.start()
        check(started.wait(60.0), "capture beside serving: no pass served")
        before = eng.stats.batches
        reg.add_tenant("d", root / "d")
        got_d = reg.predict("d", Xl)
        during = eng.stats.batches - before
        stop.set()
        t.join(120.0)
    check(not errors and not t.is_alive(), f"capture beside serving: the serving thread failed: {errors}")
    built = reg.engine("d").stats.compiles
    check(built == 1 and during > 0, f"capture beside serving: {built} programs built, {during} batches "
          f"served meanwhile")
    check(bool((got_d == want_d).all()), "capture beside serving: the new tenant served other votes")
    check(all(bool((a == want_b).all()) for a in answers),
          "capture beside serving: the serving tenant served other votes")
    log(f"phase 12 (f) a letter tenant added and its graph captured on {card} while tenant b's scheduler "
        f"served {during} pendigits batches from its own thread: both = eager engines bit for bit "
        f"({len(answers)} passes)")


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
                for e in prof.key_averages() if is_kernel(e, DeviceType)]
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


# -- phase 14: the LM training step and windowed serving ------------------------------


def train_full_width(torch, ops, ref, card: str) -> dict:
    """(a) gemma-2b at its published width: one step twice from one seeded
    state (bits compared), ``TRAIN["timed_steps"]`` more timed, one at
    ``accum = 2``."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStreamConfig, token_batches
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import AdamWConfig

    cfg = get_arch("gemma-2b")
    B, S = TRAIN["batch"], TRAIN["seq"]
    opt = AdamWConfig(**TRAIN_OPT)
    stream = token_batches(TokenStreamConfig(cfg.vocab_size, S, B, seed=1), device=DEV)
    batches = [next(stream) for _ in range(TRAIN["timed_steps"] + 2)]

    def fresh():
        return M.init_train_state(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)

    state = fresh()
    n_params = sum(p.numel() for p in state.params.parameters())
    ops.reset_launches()
    plain0 = ref.device_calls["flash_attention"]
    state, m = M.train_step(cfg, state, batches[0], opt)
    torch.cuda.synchronize()
    plain = ref.device_calls["flash_attention"] - plain0
    launched = ops.launch_counts()
    check(not any(launched.values()), f"gemma-2b train step launched kernels: {launched}")
    check(plain == 2 * cfg.n_layers, f"gemma-2b train step: {plain} plain attention calls, not "
          f"{2 * cfg.n_layers} (a forward and its recompute a layer)")
    first = {"loss": m["loss"].clone(), "grad_norm": m["grad_norm"].clone(),
             "params": {k: p.detach().clone() for k, p in M.param_tree(state.params).items()},
             "mu": {k: v.clone() for k, v in state.opt.mu.items()}}
    del state, m
    torch.cuda.empty_cache()
    state = fresh()
    state, m = M.train_step(cfg, state, batches[0], opt)
    torch.cuda.synchronize()
    differ = [k for k, p in M.param_tree(state.params).items() if not torch.equal(p, first["params"][k])]
    differ_mu = [k for k, v in state.opt.mu.items() if not torch.equal(v, first["mu"][k])]
    same = (torch.equal(m["loss"], first["loss"]) and torch.equal(m["grad_norm"], first["grad_norm"])
            and not differ and not differ_mu)
    log(f"phase 14 (a) gemma-2b step 1 twice from one seeded state on {card}: "
        + ("the same bits (loss, grad norm, every parameter and first moment)" if same else
           f"bits differ: loss {float(first['loss'])!r} vs {float(m['loss'])!r}, grad norm "
           f"{float(first['grad_norm'])!r} vs {float(m['grad_norm'])!r}; {len(differ)} parameters "
           f"{differ[:6]}, {len(differ_mu)} moments {differ_mu[:6]}"))
    check(same, "gemma-2b train step: one step from one seeded state gave different bits twice")
    del first
    torch.cuda.empty_cache()

    losses, gnorms = [float(m["loss"])], [float(m["grad_norm"])]
    params = M.param_tree(state.params)
    watched = ("embed.embedding", "layers.0.mixer.wq", f"layers.{cfg.n_layers - 1}.ffn.w_down",
               "final_norm.gamma")
    before = {k: params[k].detach().clone() for k in watched}
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for b in batches[1:-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = M.train_step(cfg, state, b, opt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    state, m = profile_train_step(torch, cfg, state, batches[1], opt, card)
    losses.append(float(m["loss"]))
    gnorms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = M.train_step(cfg, state, batches[-1], opt, accum=2)
    torch.cuda.synchronize()
    accum_s = time.perf_counter() - t0
    losses.append(float(m["loss"]))
    gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses + gnorms)), f"gemma-2b training: non-finite loss or grad norm {losses} {gnorms}")
    moved = {k: float((params[k] != before[k]).float().mean()) for k in watched}
    check(all(v > 0 for v in moved.values()), f"gemma-2b training: parameters did not move {moved}")
    check(int(state.opt.step) == len(batches) + 1, f"gemma-2b training: step {int(state.opt.step)}")
    ms = 1e3 * sum(step_s) / len(step_s)
    tokens = B * S
    bound = 1e3 * 6 * n_params * tokens / BF16_OPS_PER_S
    bound_remat = 1e3 * 8 * n_params * tokens / BF16_OPS_PER_S
    log(f"phase 14 (a) gemma-2b training at full width on {card} ({n_params / 1e9:.3f} G parameters, "
        f"bf16, batch {B} x {S} tokens): losses {', '.join(f'{v:.4f}' for v in losses)}; grad norms "
        f"{', '.join(f'{v:.4f}' for v in gnorms)} (the fifth profiled, the last at accum = 2); steps 2-{len(step_s) + 1} "
        f"{ms:.1f} ms/step ({', '.join(f'{1e3 * t:.1f}' for t in step_s)}), {tokens / ms * 1e3:.0f} "
        f"tokens/s, bound {bound:.1f} ms (6·N·tokens over the bf16 peak; {bound_remat:.1f} with the "
        f"recompute) = {100 * bound / ms:.1f}% of it; accum = 2 step {1e3 * accum_s:.1f} ms; peak "
        f"memory {peak / 2**30:.2f} GiB (steps 2 on); share of weights moved {moved}; "
        f"{plain} plain attention calls a step, 0 kernel launches")
    del state, m, before, params
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3, "bound_ms": bound, "peak_bytes": peak,
            "same_bits": same, "losses": losses, "flash_launches": launched["flash_attention"],
            "plain_attention_calls": plain}


def profile_train_step(torch, cfg, state, batch, opt, card: str):
    """Device busy share and the top kernels of one full-width train step,
    from torch.profiler (model warm); returns the advanced state and the
    step's metrics."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = M.train_step(cfg, state, batch, opt)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = [(e.key, e.count, getattr(e, "device_time_total", None) or e.cuda_time_total)
            for e in prof.key_averages() if is_kernel(e, DeviceType)]
    busy_us = sum(r[2] for r in rows)
    if not busy_us:
        log(f"phase 14 (a) train step profile: no device time recorded on {card}; busy share not measured")
        return state, metrics
    rows.sort(key=lambda r: -r[2])
    gemm_us = sum(r[2] for r in rows if any(t in r[0].lower() for t in ("gemm", "nvjet", "xmma", "cutlass")))
    elementwise_us = sum(r[2] for r in rows if "elementwise" in r[0])
    log(f"phase 14 (a) gemma-2b train step profile (profiler on, {card}): wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), GEMM kernels "
        f"{gemm_us / 1e3:.1f} ms, elementwise kernels {elementwise_us / 1e3:.1f} ms, "
        f"{sum(r[1] for r in rows)} device activities")
    for key, count, us in rows[:10]:
        log(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:110]}")
    return state, metrics


def train_card_vs_cpu(torch, card: str) -> None:
    """(b) a 2-layer float32 cut at ``reduced()`` widths: 3 steps on the card
    and on the CPU from the same state and batches."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStreamConfig, token_batches
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import AdamWConfig

    rows = []
    for pattern, changes in (("full", {}), ("local_global", {"layer_pattern": "local_global", "window": 4096})):
        cfg = dataclasses.replace(dataclasses.replace(get_arch("gemma-2b"), **changes).reduced(), n_layers=2)
        opt = AdamWConfig(warmup_steps=2, total_steps=10)
        runs = {}
        for dev in (DEV, "cpu"):
            state = M.init_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
            stream = token_batches(TokenStreamConfig(cfg.vocab_size, 128, 2, seed=1), device=dev)
            metrics = []
            for _ in range(3):
                state, m = M.train_step(cfg, state, next(stream), opt)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            runs[dev] = (metrics, {k: p.detach().cpu() for k, p in M.param_tree(state.params).items()})
        (mg, pg), (mc, pc) = runs[DEV], runs["cpu"]
        loss_err = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(mg, mc))
        gnorm_err = max(abs(a[1] - b[1]) for a, b in zip(mg, mc))
        param_err = max(max_err(pg[k], pc[k]) for k in pc)
        check(loss_err <= TRAIN_TOL["loss_rtol"] and gnorm_err <= TRAIN_TOL["gnorm_atol"]
              and param_err <= TRAIN_TOL["param_atol"],
              f"phase 14 (b) {pattern}: card vs CPU loss {loss_err:.3g} (relative), grad norm "
              f"{gnorm_err:.3g}, parameters {param_err:.3g} exceed {TRAIN_TOL}")
        rows.append(f"{pattern}: losses {', '.join(f'{a[0]:.6f}' for a in mg)} (relative error at most "
                    f"{loss_err:.3g}), grad norms at most {gnorm_err:.3g} apart, parameters {param_err:.3g}")
    log(f"phase 14 (b) float32 2-layer cut, 3 steps, card ({card}) vs CPU (tol {TRAIN_TOL}): "
        + "; ".join(rows))


def train_cli(torch, card: str) -> dict:
    """(c) ``launch/train.py`` on the card with a checkpoint and a resume,
    and a bf16 ``TrainState`` through ``checkpoint.py``."""
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint import _flatten, load_checkpoint, save_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import model as M

    path = OUT / "train" / "lm100m"
    for suffix in (".npz", ".json"):
        path.with_suffix(suffix).unlink(missing_ok=True)
    argv = ["--preset", "lm100m", "--log-every", "100", "--checkpoint", str(path)]
    log(f"$ python -m repro_torch.launch.train {' '.join(argv)} --steps {CLI_STEPS}")
    t0 = time.perf_counter()
    losses = train.main(argv + ["--steps", str(CLI_STEPS)])
    cli_s = time.perf_counter() - t0
    check(losses[-1] < losses[0], "launch.train: the loss did not fall")

    def bits(t):
        t = t.detach().cpu()
        return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()

    cfg = train.PRESETS["lm100m"]
    back = load_checkpoint(M.init_train_state(cfg, torch.Generator().manual_seed(1), device=DEV), path)
    data = np.load(path.with_suffix(".npz"))
    leaves = _flatten(back)[0]
    check(len(leaves) == len(data.files) and all(
        np.array_equal(bits(t), data[f"leaf_{i}"]) for i, t in enumerate(leaves)),
        "launch.train checkpoint: the loaded state is not the saved bits")
    check(int(back.opt.step) == CLI_STEPS, f"launch.train checkpoint: step {int(back.opt.step)}")
    log(f"$ python -m repro_torch.launch.train {' '.join(argv)} --steps {RESUME_STEPS} --resume")
    resumed = train.main(argv + ["--steps", str(RESUME_STEPS), "--resume"])
    check(resumed[-1] < resumed[0], "launch.train --resume: the loss did not fall")
    check(resumed[0] < losses[0] - 1.0, f"launch.train --resume started at loss {resumed[0]}, not from "
          f"the trained state (the first run started at {losses[0]})")
    after = load_checkpoint(M.init_train_state(cfg, torch.Generator().manual_seed(1), device=DEV), path)
    check(int(after.opt.step) == CLI_STEPS + RESUME_STEPS,
          f"launch.train --resume: step {int(after.opt.step)}, not {CLI_STEPS + RESUME_STEPS}")

    # a bf16 TrainState of reduced gemma-2b, two steps in, bit for bit
    cfg16 = dataclasses.replace(get_arch("gemma-2b").reduced(), dtype="bfloat16")
    state = M.init_train_state(cfg16, torch.Generator().manual_seed(0), device=DEV)
    tok = torch.randint(0, cfg16.vocab_size, (2, 65), generator=torch.Generator().manual_seed(3))
    for _ in range(2):
        state, _ = M.train_step(cfg16, state, {"tokens": tok.to(DEV)})
    save_checkpoint(state, OUT / "train" / "bf16")
    back16 = load_checkpoint(M.init_train_state(cfg16, torch.Generator().manual_seed(1), device=DEV),
                             OUT / "train" / "bf16")
    a, b = _flatten(state)[0], _flatten(back16)[0]
    check(all(x.dtype == y.dtype and np.array_equal(bits(x), bits(y)) for x, y in zip(a, b)),
          "bf16 TrainState: the checkpoint round trip changed bits")
    n16 = sum(t.dtype == torch.bfloat16 for t in a)
    log(f"phase 14 (c) launch.train --preset lm100m on {card}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"in {CLI_STEPS} steps ({1e3 * cli_s / CLI_STEPS:.2f} ms/step with start-up and logging); the "
        f"checkpoint loads bit for bit at step {CLI_STEPS}; --resume: loss {resumed[0]:.4f} -> "
        f"{resumed[-1]:.4f}, step {int(after.opt.step)}; bf16 TrainState ({len(a)} leaves, {n16} bf16) "
        "round-trips bit for bit")
    return {"ms_per_step": 1e3 * cli_s / CLI_STEPS}


def windowed_serving(torch, ops, ref, card: str) -> dict:
    """(d) gemma-2b with local/global layers: an 8192-token prefill, 32
    greedy steps past every local ring, against a cache-free forward; a
    float32 2-layer windowed cut against the CPU."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.layers import unembed

    cfg = dataclasses.replace(get_arch("gemma-2b"), layer_pattern="local_global", window=WINDOWED["window"])
    S, N = WINDOWED["prompt"], WINDOWED["steps"]
    model = serve.build(cfg, 0, torch.device(DEV))
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(2)).to(DEV)
    M.prefill(model, {"tokens": prompt[:, :WINDOWED["window"]]})  # warm the allocator at this size
    ops.reset_launches()
    calls = dict(ref.device_calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, st = M.prefill(model, {"tokens": prompt}, cache_len=S + N)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    launches = ops.launch_counts()
    want = {name: 0 for name in launches}
    want["flash_attention"] = cfg.n_layers
    check(launches == want, f"windowed prefill launches {launches} != {want}")
    check(ref.device_calls == calls, f"windowed prefill: a plain version ran on CUDA tensors: {ref.device_calls}")
    slots = [c.k.shape[1] for c in st.caches]
    check(slots == [WINDOWED["window"], S + N] * (cfg.n_layers // 2), f"windowed caches' slots {slots}")
    fed = [torch.argmax(logits, -1)[:, None]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N):
        logits, st = M.serve_step(model, st, fed[-1])
        fed.append(torch.argmax(logits, -1)[:, None])
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / N
    check(bool(torch.isfinite(logits).all()), "windowed decode: non-finite logits")
    seq = torch.cat([prompt] + fed[:-1], 1)  # the prompt and the 32 tokens fed
    with torch.no_grad():
        want_logits = unembed(cfg, model.embed, model(seq)[:, -1:])[:, 0]
    d = (logits - want_logits).abs()
    check(bool(torch.isclose(logits, want_logits, **DECODE_TOL).all()),
          f"windowed decode vs cache-free forward: max |diff| {float(d.max()):.4g} exceeds {DECODE_TOL}")
    same = bool(torch.equal(logits.argmax(-1), want_logits.argmax(-1)))
    log(f"phase 14 (d) gemma-2b local/global (window {WINDOWED['window']}) on {card}: prefill 1x{S} "
        f"{prefill_ms:.1f} ms ({launches['flash_attention']} flash_attention launches), {N} greedy steps "
        f"{decode_ms:.2f} ms/step (positions {S}-{S + N - 1}: ring slots 0-{N - 1} of every local layer); "
        f"last step vs a cache-free forward over {seq.shape[1]} tokens: max |diff| {float(d.max()):.4g}, "
        f"mean {float(d.mean()):.4g} (tol {DECODE_TOL}), greedy token {'agrees' if same else 'differs'}")
    del model, st, logits, want_logits
    torch.cuda.empty_cache()

    # a float32 2-layer cut with a 256-token window: prefill 1024, 32 fed steps, card vs CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32", window=256)
    model2 = serve.build(cfg2, 0, torch.device(DEV))
    tok = torch.randint(0, cfg2.vocab_size, (1, 1024 + N), generator=torch.Generator().manual_seed(4))

    def run(m, t):
        out, st2 = M.prefill(m, {"tokens": t[:, :1024]}, cache_len=1024 + N)
        outs = [out]
        for i in range(N):
            out, st2 = M.serve_step(m, st2, t[:, 1024 + i:1025 + i])
            outs.append(out)
        return torch.stack(outs).cpu()

    on_card = run(model2, tok.to(DEV))
    model2.to("cpu")
    on_cpu = run(model2, tok)
    d = (on_card - on_cpu).abs()
    check(bool(torch.isclose(on_card, on_cpu, **CPU_TOL).all()),
          f"windowed 2-layer f32: card vs CPU max |diff| {float(d.max()):.4g} exceeds {CPU_TOL}")
    log(f"phase 14 (d) 2-layer float32 cut (window 256, prompt 1024, {N} steps past the ring), card vs "
        f"CPU: max |diff| {float(d.max()):.4g} over the prefill and every step (tol {CPU_TOL})")
    return {"launches": launches["flash_attention"], "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def lm_phase(torch, ops, ref, card: str) -> dict:
    full = train_full_width(torch, ops, ref, card)
    train_card_vs_cpu(torch, card)
    cli = train_cli(torch, card)
    windowed = windowed_serving(torch, ops, ref, card)
    return {"train": full, "cli": cli, "windowed": windowed}


# -- phase 15: the SPMD round and the mesh engine ------------------------------------

# a rank of the mesh engine over 4 gloo ranks: it serves adult's test split
# from a saved artifact through EngineConfig(mesh=...) and through the local
# engine, and prints whether the answers agree and the mesh engine's launches
MESH_ENGINE_CHILD = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from repro_torch.fl import distributed
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import EngineConfig, ServeEngine, load_artifact
coord, ranks, rank, artifact, rows, batch, out = sys.argv[2:9]
ranks, rank, batch = int(ranks), int(rank), int(batch)
distributed.initialize(coord, ranks, rank)
mesh = make_mesh((ranks, 1), ("data", "model"))
art = load_artifact(artifact, "cuda")
X = np.load(rows)
local = ServeEngine.from_artifact(art, batch_size=batch).predict(X)
engine = ServeEngine.from_artifact(art, config=EngineConfig(batch_size=batch, mesh=mesh))
ops.reset_launches()
got = engine.predict(X)
launches = ops.launch_counts()
if rank == 0:
    np.save(out, got)
print("MESH " + json.dumps({"equal": bool(np.array_equal(got, local)), "launches": launches,
                            "batches": engine.stats.batches}), flush=True)
distributed.shutdown()
"""


def sharded_children(fl_spawn, P: int, argv_of, script: str, tag: str, marker: str) -> list:
    """P children of ``script`` (each given ``argv_of(i)``) joined with a
    deadline; every one must exit 0 and print one ``marker`` line, whose
    JSON is returned in rank order."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs, logs = [], []
    for i in range(P):
        log_path = OUT / f"sharded_{tag}_r{i}.log"
        with open(log_path, "w") as f:
            procs.append(subprocess.Popen([sys.executable, "-c", script, str(ROOT / "src"), *argv_of(i)],
                                          stdout=f, stderr=subprocess.STDOUT))
        logs.append(str(log_path))
    rcs = fl_spawn._join_all(procs, logs, timeout=DIST_TIMEOUT_S)
    check(rcs == [0] * P, f"{tag}: ranks exited {rcs}: {[fl_spawn._tail(p, 600) for p in logs]}")
    lines = []
    for p in logs:
        line = [ln for ln in Path(p).read_text().splitlines() if ln.startswith(marker + " ")]
        check(len(line) == 1, f"{p}: no {marker} line")
        lines.append(json.loads(line[0][len(marker) + 1:]))
    return lines


def fused_reference(torch, fl_run, C: int) -> tuple:
    """The fused card run at C collaborators (adult, fl_run's defaults):
    (its per-round metrics, its F1 on the test split truncated to a
    multiple of C, as the sharded run scores it, the federation)."""
    from repro_torch.core import boosting
    from repro_torch.core.metrics import f1_macro

    fed = fl_run.build_federation("adult", C, SHARDED["rounds"], DEPTH, 0, DEV)
    fed.run(eval_every=SHARDED["rounds"])
    *_, Xte, yte, spec = fl_run.build_inputs("adult", C, SHARDED["rounds"], DEPTH, 0)
    n = Xte.shape[0] - Xte.shape[0] % C
    pred = boosting.strong_predict(fed.learner, fed.spec, fed.state.ensemble, Xte[:n].to(DEV))
    return fed.per_round(), float(f1_macro(yte[:n].to(DEV), pred, spec.n_classes)), fed


def compare_to_fused(run: dict, fused_rounds: list, fused_f1: float, what: str) -> str:
    """The sharded run's chosen sequence must be the fused card run's, its
    F1 on the truncated split within 0.02; returns the log's words on alpha."""
    chosen = [r["chosen"] for r in run["rounds"]]
    check(chosen == [r["chosen"] for r in fused_rounds],
          f"{what}: chosen {chosen} != the fused card run's {[r['chosen'] for r in fused_rounds]}")
    check(abs(run["f1"] - fused_f1) <= 0.02, f"{what}: F1 {run['f1']} vs the fused run's {fused_f1}")
    rel = max(abs(a["alpha"] - b["alpha"]) / abs(b["alpha"]) for a, b in zip(run["rounds"], fused_rounds))
    return (f"chosen {chosen} = the fused card run's; alpha within {rel:.3g} (relative); F1 "
            f"{run['f1']:.4f} vs {fused_f1:.4f} on the truncated split")


def round_ms(run: dict) -> str:
    """A sharded run's ms/round: the median of rounds 1 on (round 0 holds
    the start-up), the mean of all and round 0's."""
    each = [1e3 * t for t in run["each_round_seconds"]]
    late = sorted(each[1:])
    return (f"{late[len(late) // 2]:.3f} ms/round (median of rounds 1-{len(each) - 1}; mean of all "
            f"{1e3 * run['round_seconds']:.3f}, round 0 {each[0]:.3f})")


def sharded_phase(torch, ops, ref, fl_run, card: str) -> dict:
    """Phase 15: (a) ``fl_run --sharded`` on a (1, 1) mesh in this process,
    its launches set to 0 just before and read just after; (b) 4 gloo ranks
    of a (4, 1) mesh under ``fl_run`` in children that print their
    launches; each against the fused card run at the same C; (c) the mesh
    engine, at (1, 1) here and on the 4 ranks, against the local engine.
    Returns this phase's launches (the (1, 1) run's, and the 4 ranks'
    summed)."""
    import numpy as np

    from repro_torch.core.boosting import ensemble_to
    from repro_torch.launch import fl_spawn
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import EngineConfig, ServeEngine, save_artifact

    R, P = SHARDED["rounds"], SHARDED["ranks"]
    OUT.mkdir(parents=True, exist_ok=True)
    base = ["--sharded", "--dataset", "adult", "--rounds", str(R), "--seed", "0", "--device", DEV]

    # (a) the (1, 1) mesh
    path = OUT / "sharded_1x1.json"
    argv = [*base, "--collaborators", "1", "--num-processes", "1", "--history-out", str(path)]
    log(f"$ python -m repro_torch.launch.fl_run {' '.join(argv)}")
    calls = dict(ref.device_calls)
    ops.reset_launches()
    fl_run.main(argv)
    launches = ops.launch_counts()
    want = {"tree_hist": DEPTH * R, "weighted_errors": R, "weight_update": 0, "weight_update_product": R,
            "vote_argmax": 1, "flash_attention": 0}
    check(launches == want, f"sharded (1, 1) launches {launches} != {want}")
    check(ref.device_calls == calls, f"sharded (1, 1): a plain version ran on CUDA tensors: {ref.device_calls}")
    one = json.loads(path.read_text())
    f_rounds, f_f1, _ = fused_reference(torch, fl_run, 1)
    words = compare_to_fused(one, f_rounds, f_f1, "sharded (1, 1)")
    log(f"phase 15 (a) fl_run --sharded on a (1, 1) mesh on {card}: {round_ms(one)}, sharded predict "
        f"{1e3 * one['predict_seconds']:.3f} ms; {words}; "
        f"launches {launches} (4 tree_hist, 1 weighted_errors, 1 weight_update_product a round, 1 "
        f"vote_argmax a predict)")

    # (b) 4 gloo ranks of a (4, 1) mesh, every rank on the one card
    path = OUT / "sharded_4x1.json"
    path.unlink(missing_ok=True)
    coord = f"127.0.0.1:{fl_spawn.free_port()}"
    argv = [*base, "--collaborators", str(P), "--num-processes", str(P), "--coordinator", coord,
            "--history-out", str(path)]
    log(f"$ python -m repro_torch.launch.fl_spawn -n {P} -- {' '.join(argv)}   (ranks printing their launches)")
    t0 = time.perf_counter()
    per_rank = sharded_children(fl_spawn, P, lambda i: [*argv, "--process-id", str(i)], COUNTING_CHILD,
                                "round", "LAUNCHES")
    group_s = time.perf_counter() - t0
    for i, got in enumerate(per_rank):
        check(got == want, f"sharded (4, 1): rank {i} launches {got} != {want}")
    four = json.loads(path.read_text())
    check(four["mesh"] == {"data": P, "model": 1} and four["ranks"] == P, f"sharded (4, 1): {four['mesh']}")
    f_rounds, f_f1, fed = fused_reference(torch, fl_run, P)
    words = compare_to_fused(four, f_rounds, f_f1, f"sharded ({P}, 1)")
    log(f"phase 15 (b) fl_run --sharded on {P} gloo ranks of a ({P}, 1) mesh on {card} (one card; a "
        f"schedule over several cards is not verified here): {round_ms(four)}, sharded predict "
        f"{1e3 * four['predict_seconds']:.3f} ms, group {group_s:.1f} s; {words}; "
        f"each rank's launches {per_rank}")

    # (c) the mesh engine against the local engine, on the fused C = 4 run's ensemble
    *_, Xte, _, _ = fl_run.build_inputs("adult", P, R, DEPTH, 0)
    X = Xte.numpy()
    ens = fed.state.ensemble
    local = ServeEngine(fed.learner, fed.spec, ens, batch_size=SHARDED["batch"]).predict(X)
    eng = ServeEngine(fed.learner, fed.spec, ens,
                      config=EngineConfig(batch_size=SHARDED["batch"], mesh=make_host_mesh()))
    ops.reset_launches()
    got = eng.predict(X)
    host_launches = ops.launch_counts()
    check(np.array_equal(got, local), f"mesh engine (1, 1): {int((got != local).sum())} answers differ")
    check(host_launches["vote_argmax"] == eng.stats.batches, f"mesh engine (1, 1): launches {host_launches}")
    artifact = save_artifact(OUT / "sharded_engine.mafl", fed.spec, ensemble_to(ens, "cpu"))
    rows = OUT / "sharded_engine_rows.npy"
    np.save(rows, X)
    answers = OUT / "sharded_engine_answers.npy"
    coord = f"127.0.0.1:{fl_spawn.free_port()}"
    engine_ranks = sharded_children(
        fl_spawn, P, lambda i: [coord, str(P), str(i), str(artifact), str(rows), str(SHARDED["batch"]),
                                str(answers)], MESH_ENGINE_CHILD, "engine", "MESH")
    check(all(r["equal"] for r in engine_ranks), f"mesh engine ({P}, 1): a rank's answers differ: {engine_ranks}")
    check(np.array_equal(np.load(answers), local), f"mesh engine ({P}, 1): answers differ from this process's")
    batches = engine_ranks[0]["batches"]
    check(all(r["launches"]["vote_argmax"] == batches for r in engine_ranks),
          f"mesh engine ({P}, 1): vote_argmax launches {[r['launches'] for r in engine_ranks]}, {batches} batches")
    log(f"phase 15 (c) mesh engine (batch {SHARDED['batch']}, adult's {len(X)} test rows, the fused C = {P} "
        f"card run's {ens.count} members): (1, 1) = the local engine bit for bit, {eng.stats.batches} "
        f"vote_argmax launches; ({P}, 1) over gloo: every rank = the local engine bit for bit, "
        f"{batches} batches, one vote_argmax launch a batch a rank (over its {SHARDED['batch'] // P} rows)")
    total = {k: launches[k] + sum(r[k] for r in per_rank) for k in launches}
    return {"host_mesh": launches, "ranks": total}


# -- phase 16: MoE layers, grok-1 and llama4-scout at full width ------------------------


class MoeDrops:
    """While open, the port's tracer records, so ``models/moe.py`` counts its
    MoE layers' work; on leaving, ``dropped`` is the (token, choice) pairs
    their capacity dropped meanwhile (``mafl_moe_rows_dropped_total``, every
    phase)."""

    @staticmethod
    def total() -> float:
        from repro_torch.obs.metrics import REGISTRY

        return sum(c.value for c in REGISTRY.get("mafl_moe_rows_dropped_total").children())

    def __enter__(self):
        from repro_torch.obs import trace

        self.trace, self.was_on, self.start = trace, trace.TRACER.enabled, self.total()
        trace.enable()
        return self

    def __exit__(self, *exc):
        if not self.was_on:
            self.trace.disable()
        self.dropped = int(self.total() - self.start)


MOE_RANGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
SSM_RANGES = ("ssm.mlstm_chunks", "ssm.slstm_steps", "ssm.mamba_scan", "ssm.projections")


def device_profile(torch, model, tokens, card: str, phase: str, labels: tuple) -> dict:
    """Device time of one prefill of ``tokens`` and of one decode step
    after it, by the profiler ranges ``labels``, the ``flash_attention``
    kernel and the rest; the device busy share of the wall and the device
    activities the profiler saw.  ``phase`` heads the log lines.  Returns
    {what: {part: ms}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    B, S = tokens.shape
    out = {}
    for what in ("prefill", "decode"):
        _, st = M.prefill(model, {"tokens": tokens}, cache_len=S + 2)
        token = tokens[:, -1:]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                M.prefill(model, {"tokens": tokens}, cache_len=S + 2)
            else:
                M.serve_step(model, st, token)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()

        def dev_ms(e):
            return (getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)) / 1e3

        # a range's device time is its kernels' (the host-side range's total)
        kernels = [e for e in events if is_kernel(e, DeviceType)]
        busy = sum(dev_ms(e) for e in kernels)
        activities = sum(e.count for e in kernels)
        parts = {lab: sum(dev_ms(e) for e in events if e.key == lab and e.device_type == DeviceType.CPU)
                 for lab in labels}
        parts["attention (flash_attention)"] = sum(dev_ms(e) for e in kernels if "flash_attention" in e.key)
        parts["rest"] = busy - sum(parts.values())
        out[what] = {"wall_ms": wall_ms, "busy_ms": busy, "device_launches": activities, **parts}
        if not busy:
            log(f"{phase} {what} profile: no device time recorded on {card}; not measured")
            continue
        log(f"{phase} {what} profile ({B}x{S}, profiler on, {card}): wall {wall_ms:.3f} ms, device busy "
            f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%), {activities} device activities: "
            + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)" for k, v in parts.items()))
    return out


def counted_serve(torch, ops, ref, what: str, call, flash: int, shape: tuple, vocab: int) -> tuple:
    """``call()``, a ``launch.serve`` entry point, with every count set to 0
    just before: it must launch ``flash`` ``flash_attention`` kernels and
    nothing else, run no plain version on the card, and give finite logits
    and tokens of ``shape`` inside ``vocab``.  Returns (its output, the
    launches, the peak memory of the call)."""
    calls = dict(ref.device_calls)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = call()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want["flash_attention"] = flash
    check(launches == want, f"{what} launches {launches} != {want}")
    check(ref.device_calls == calls, f"{what}: a plain version ran on CUDA tensors: {ref.device_calls}")
    toks = out["tokens"]
    check(out["logits_finite"] and tuple(toks.shape) == shape, f"{what}: tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < vocab)).all()), f"{what}: a token out of range")
    return out, launches, peak


@contextlib.contextmanager
def flash_routes(ops):
    """Counts the ``flash_attention`` calls made inside by (q's dtype, S,
    T, causal): the route each attention takes (bf16: TMA + wgmma, float32:
    3xTF32 on mma.sync)."""
    seen, inner = collections.Counter(), ops.flash_attention

    def recording(q, k, v, **kw):
        seen[(str(q.dtype).replace("torch.", ""), q.shape[2], k.shape[2], kw.get("causal", True))] += 1
        return inner(q, k, v, **kw)

    ops.flash_attention = recording
    try:
        yield seen
    finally:
        ops.flash_attention = inner


def prefill_twice_and_decode(torch, model, tok, S: int, N: int, what: str, first_ctx=None,
                             extras=None) -> tuple:
    """Two prefills of ``tok[:, :S]`` with the batch's ``extras`` (a
    prefix or frames; the first under ``first_ctx`` where given, the second
    timed warm; the same bits, or fail), then ``N`` greedy decode steps,
    timed; peak memory from the first prefill on.  Returns
    ({"prefill_ms", "decode_ms_per_step", "peak_bytes", "same_bits"}, the
    prefill's logits, the state after decode)."""
    import contextlib

    from repro_torch.models import model as M

    batch = {"tokens": tok[:, :S], **(extras or {})}
    P = batch["prefix"].shape[1] if "prefix" in batch else 0
    torch.cuda.reset_peak_memory_stats()
    with first_ctx or contextlib.nullcontext():
        first, _ = M.prefill(model, batch, cache_len=P + S + N)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, st = M.prefill(model, batch, cache_len=P + S + N)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    same = torch.equal(first, again)
    check(same, f"{what}: two prefills of the same prompt differ (max |diff| {max_err(first, again):.3g})")
    del first
    token = torch.argmax(again, dim=-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N):
        logits, st = M.serve_step(model, st, token)
        token = torch.argmax(logits, dim=-1)[:, None]
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / N
    check(bool(torch.isfinite(logits).all()), f"{what}: non-finite decode logits")
    return ({"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
             "peak_bytes": torch.cuda.max_memory_allocated(), "same_bits": same}, again, st)


def moe_serving(torch, ops, ref, card: str, tag: str) -> dict:
    """One architecture of ``MOE_SERVE`` through ``launch.serve --full
    --layers`` (every count set to 0 just before: one ``flash_attention``
    launch a layer of the prefill, nothing else, no plain version on the
    card), then on a model built the same way: two prefills with the same
    bits, warm prefill and decode times, peak memory, the drops of the
    served capacity, a profile, and decode against a cache-free forward at
    a drop-free capacity."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.layers import unembed

    run = MOE_SERVE[tag]
    L, S, N = run["layers"], run["prompt"], run["tokens"]
    full = get_arch(run["arch"])
    cfg = full.with_layers(L)
    argv = ["--arch", run["arch"], "--full", "--layers", str(L), "--batch", "1", "--prompt-len", str(S),
            "--tokens", str(N), "--seed", "0"]
    log(f"$ python -m repro_torch.launch.serve {' '.join(argv)}")
    out, launches, served_peak = counted_serve(torch, ops, ref, f"{tag} serve", lambda: serve.main(argv), L,
                                               (1, N + 1), cfg.padded_vocab())
    served_prefill_s = out["prefill_seconds"]
    del out
    torch.cuda.empty_cache()

    model = serve.build(cfg, 0, torch.device(DEV))
    n_params = sum(p.numel() for p in model.parameters())
    tok = torch.randint(0, cfg.vocab_size, (1, S + N), generator=torch.Generator().manual_seed(1)).to(DEV)
    drops = MoeDrops()
    timed, again, st = prefill_twice_and_decode(torch, model, tok, S, N, tag, first_ctx=drops)
    prof = device_profile(torch, model, tok[:, :S], card, f"phase 16 {tag}", MOE_RANGES)
    del again, st
    torch.cuda.empty_cache()

    # decode against a cache-free forward, at a drop-free capacity
    Sc = MOE_DECODE_CHECK[tag]
    model.cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    with MoeDrops() as free:
        _, st = M.prefill(model, {"tokens": tok[:, :Sc]}, cache_len=Sc + N)
        for s in range(Sc, Sc + N):
            stepped, st = M.serve_step(model, st, tok[:, s:s + 1])
        with torch.no_grad():
            whole = unembed(model.cfg, model.embed, model(tok[:, :Sc + N])[:, -1:])[:, 0]
    check(free.dropped == 0, f"{tag}: the drop-free check dropped {free.dropped}")
    d = (stepped - whole).abs()
    check(bool(torch.isclose(stepped, whole, **DECODE_TOL).all()),
          f"{tag}: decode past {Sc} vs a cache-free forward: max |diff| {float(d.max()):.4g} > {DECODE_TOL}")
    model.cfg = cfg
    log(f"phase 16 {tag}: {run['arch']} at full width, depth cut to {L} of {full.n_layers} layers "
        f"({n_params / 1e9:.3f} G parameters, bf16), on {card}: prefill 1x{S} {timed['prefill_ms']:.3f} ms "
        f"(warm), decode {timed['decode_ms_per_step']:.3f} ms/step ({N} greedy steps); first call through "
        f"launch.serve: prefill {1e3 * served_prefill_s:.3f} ms; two prefills the same bits: "
        f"{timed['same_bits']}; peak memory {timed['peak_bytes'] / 2**30:.2f} GiB (launch.serve's run "
        f"{served_peak / 2**30:.2f} GiB); capacity {moe.capacity(cfg, S)} slots an expert at {S} tokens, "
        f"dropped (token, choice) pairs over the {L} layers {drops.dropped}; launches {launches}; decode of {N} "
        f"tokens past a {Sc}-token prompt vs a cache-free forward (drop-free capacity): max |diff| "
        f"{float(d.max()):.4g}, mean {float(d.mean()):.4g} (tol {DECODE_TOL})")
    del model, st, stepped, whole
    torch.cuda.empty_cache()
    return {"launches": launches, **timed, "served_peak_bytes": served_peak, "dropped": drops.dropped,
            "decode_vs_forward_max": float(d.max()), "profile": prof, "params": n_params}


def moe_train(torch, ops, ref, card: str) -> dict:
    """(c) llama4-scout's MoE train step at full width, one layer (a
    chunked-local MoE layer), bf16, batch x tokens from token_batches: one
    step twice from one seeded state (the first's state copied to the host,
    every bit compared), ``timed_steps`` more timed; no ``flash_attention``
    launch (the training forward runs the plain attention: a forward and
    its recompute a layer), the loss with its aux term finite, the
    parameters moved, peak memory."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStreamConfig, token_batches
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import AdamWConfig

    full = get_arch(MOE_TRAIN["arch"])
    cfg = full.with_layers(MOE_TRAIN["layers"])
    B, S = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    opt = AdamWConfig(**TRAIN_OPT)
    stream = token_batches(TokenStreamConfig(cfg.vocab_size, S, B, seed=1), device=DEV)
    batches = [next(stream) for _ in range(MOE_TRAIN["timed_steps"] + 1)]

    def fresh():
        return M.init_train_state(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = fresh()
    n_params = sum(p.numel() for p in state.params.parameters())
    ops.reset_launches()
    plain0 = ref.device_calls["flash_attention"]
    state, m = M.train_step(cfg, state, batches[0], opt)
    torch.cuda.synchronize()
    plain = ref.device_calls["flash_attention"] - plain0
    launched = ops.launch_counts()
    check(not any(launched.values()), f"MoE train step launched kernels: {launched}")
    check(plain == 2 * cfg.n_layers, f"MoE train step: {plain} plain attention calls, not {2 * cfg.n_layers}")
    host = {"loss": m["loss"].cpu(), "grad_norm": m["grad_norm"].cpu(),
            "params": {k: p.detach().cpu() for k, p in M.param_tree(state.params).items()},
            "mu": {k: v.cpu() for k, v in state.opt.mu.items()},
            "nu": {k: v.cpu() for k, v in state.opt.nu.items()}}
    del state, m
    torch.cuda.empty_cache()
    state = fresh()
    state, m = M.train_step(cfg, state, batches[0], opt)
    torch.cuda.synchronize()
    differ = [k for k, p in M.param_tree(state.params).items() if not torch.equal(p.cpu(), host["params"][k])]
    differ_m = [k for k, v in state.opt.mu.items() if not torch.equal(v.cpu(), host["mu"][k])]
    differ_m += [k for k, v in state.opt.nu.items() if not torch.equal(v.cpu(), host["nu"][k])]
    same = (torch.equal(m["loss"].cpu(), host["loss"]) and torch.equal(m["grad_norm"].cpu(), host["grad_norm"])
            and not differ and not differ_m)
    check(same, f"MoE train step: one step from one seeded state gave other bits: loss "
          f"{float(host['loss'])!r} vs {float(m['loss'])!r}; parameters {differ[:6]}, moments {differ_m[:6]}")
    watched = ("embed.embedding", "layers.0.ffn.router", "layers.0.ffn.w_gate", "layers.0.mixer.wq")
    params = M.param_tree(state.params)
    losses, gnorms = [float(m["loss"])], [float(m["grad_norm"])]
    step_s = []
    for b in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = M.train_step(cfg, state, b, opt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses + gnorms)), f"MoE training: non-finite loss or grad norm {losses} {gnorms}")
    moved = {k: float((params[k].cpu() != host["params"][k]).float().mean()) for k in watched}
    check(all(v > 0 for v in moved.values()), f"MoE training: parameters did not move {moved}")
    ms = 1e3 * sum(step_s) / len(step_s)
    bound = 1e3 * 6 * n_params * B * S / BF16_OPS_PER_S
    log(f"phase 16 (c) {MOE_TRAIN['arch']} training at full width, depth cut to {cfg.n_layers} of "
        f"{full.n_layers} layers ({n_params / 1e9:.3f} G parameters, bf16, batch {B} x {S} tokens) on "
        f"{card}: step 1 twice from one seeded state the same bits (loss, grad norm, every parameter and "
        f"both moments): {same}; losses {', '.join(f'{v:.4f}' for v in losses)} (the aux term "
        f"included); grad norms {', '.join(f'{v:.4f}' for v in gnorms)}; steps 2-{len(step_s) + 1} "
        f"{ms:.1f} ms/step ({', '.join(f'{1e3 * t:.1f}' for t in step_s)}), {B * S / ms * 1e3:.0f} "
        f"tokens/s; 6·N·tokens over the bf16 peak {bound:.2f} ms (all N counted, though a token runs one "
        f"expert of {cfg.n_experts}); peak memory {peak / 2**30:.2f} GiB; share of weights moved {moved}; "
        f"{plain} plain attention calls a step, 0 kernel launches")
    del state, m, params, host
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "peak_bytes": peak, "same_bits": same, "losses": losses,
            "flash_launches": launched["flash_attention"], "params": n_params}


def moe_train_card_vs_cpu(torch, card: str) -> None:
    """(d) reduced() grok-1 and llama4-scout in float32 at the published
    capacity factor 1.25: 3 steps on the card and on the CPU from the same
    state (losses, grad norms and every parameter within ``TRAIN_TOL``)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import AdamWConfig

    rows = []
    for name in ("grok-1-314b", "llama4-scout-17b-a16e"):
        cfg = dataclasses.replace(get_arch(name).reduced(), capacity_factor=1.25)
        opt = AdamWConfig(warmup_steps=2, total_steps=10)
        tok = torch.randint(0, cfg.vocab_size, (2, 129), generator=torch.Generator().manual_seed(3),
                            dtype=torch.int32)
        runs = {}
        for dev in (DEV, "cpu"):
            st = M.init_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
            ms = []
            for i in range(3):
                st, m = M.train_step(cfg, st, {"tokens": tok.roll(i, 1).to(dev)}, opt)
                ms.append((float(m["loss"]), float(m["grad_norm"])))
            runs[dev] = (ms, {k: p.detach().cpu() for k, p in M.param_tree(st.params).items()})
        (mg, pg), (mc, pc) = runs[DEV], runs["cpu"]
        loss_err = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(mg, mc))
        gn_err = max(abs(a[1] - b[1]) for a, b in zip(mg, mc))
        p_err = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
        check(loss_err <= TRAIN_TOL["loss_rtol"] and gn_err <= TRAIN_TOL["gnorm_atol"]
              and p_err <= TRAIN_TOL["param_atol"],
              f"{name} float32 reduced: card vs CPU loss {loss_err:.3g}, grad norm {gn_err:.3g}, "
              f"parameters {p_err:.3g} exceed {TRAIN_TOL}")
        rows.append(f"{name}: loss {loss_err:.3g} (relative), grad norm {gn_err:.3g}, parameters {p_err:.3g}")
    log(f"phase 16 (d) reduced() MoE models in float32 at capacity factor 1.25, 3 steps, card ({card}) vs "
        f"CPU (tol {TRAIN_TOL}): " + "; ".join(rows))


def moe_phase(torch, ops, ref, card: str) -> dict:
    return {"grok": moe_serving(torch, ops, ref, card, "grok"),
            "llama4": moe_serving(torch, ops, ref, card, "llama4"),
            "train": moe_train(torch, ops, ref, card),
            "cpu": moe_train_card_vs_cpu(torch, card)}


# -- phase 17: the recurrent mixers (xlstm-1.3b whole, a Mamba hybrid) -----------------------


def decode_against_forward(torch, model, tok, prefix: int, what: str, tol: dict, whole=None,
                           extras=None) -> dict:
    """Prefill ``tok[:, :prefix]`` (after the batch's ``extras``, a prefix
    or frames), teacher-force the rest through decode steps, and hold the
    last step's logits against a cache-free forward over all of ``tok``
    with the same extras, or against ``whole``, the last logits of a
    prefill over all of ``tok`` already made (the same forward, its caches
    written besides)."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import unembed

    extras = extras or {}
    end = tok.shape[1] + (extras["prefix"].shape[1] if "prefix" in extras else 0)
    _, st = M.prefill(model, {"tokens": tok[:, :prefix], **extras}, cache_len=end)
    for s in range(prefix, tok.shape[1]):
        stepped, st = M.serve_step(model, st, tok[:, s:s + 1])
    del st
    if whole is None:
        with torch.no_grad():
            whole = unembed(model.cfg, model.embed, model(tok, **extras)[:, -1:])[:, 0]
    d = (stepped - whole).abs()
    agree = int((stepped.argmax(-1) == whole.argmax(-1)).sum())
    check(bool(torch.isclose(stepped, whole, **tol).all()),
          f"{what}: decode of {tok.shape[1] - prefix} tokens past {prefix} vs a cache-free forward: max |diff| "
          f"{float(d.max()):.4g} exceeds {tol}")
    return {"max": float(d.max()), "mean": float(d.mean()), "greedy_agree": agree, "rows": tok.shape[0],
            "logit_max": float(whole.abs().max())}


def xlstm_serving(torch, ops, ref, card: str) -> dict:
    """(a) xlstm-1.3b whole (48 layers) through ``launch.serve --full``
    (every count set to 0 just before: no kernel launch, no plain version
    on the card, tokens inside the vocabulary), then on a model built the
    same way: two prefills with the same bits, warm prefill ms, decode
    ms/step and tok/s, peak memory, a profile; then the same weights drawn
    in float32, all 48 layers: decode across a chunk boundary against a
    cache-free forward."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.layers import unembed

    marks = [("start", time.perf_counter())]
    run = XLSTM_SERVE
    B, S, N = run["batch"], run["prompt"], run["tokens"]
    cfg = get_arch("xlstm-1.3b")
    argv = ["--arch", "xlstm-1.3b", "--full", "--batch", str(B), "--prompt-len", str(S), "--tokens", str(N),
            "--seed", "0"]
    log(f"$ python -m repro_torch.launch.serve {' '.join(argv)}")
    out, launches, served_peak = counted_serve(torch, ops, ref, "xlstm serve", lambda: serve.main(argv), 0,
                                               (B, N + 1), cfg.padded_vocab())
    served = {"prefill_ms": 1e3 * out["prefill_seconds"], "decode_ms_per_step": 1e3 * out["decode_seconds"] / N,
              "tok_per_s": out["tok_per_s"]}
    del out
    torch.cuda.empty_cache()
    marks.append(("launch.serve", time.perf_counter()))

    model = serve.build(cfg, 0, torch.device(DEV))
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    kinds = [layer.kind for layer in model.layers]
    check(kinds.count("mlstm") == 42 and kinds.count("slstm") == 6, f"xlstm layers {kinds}")
    tok = torch.randint(0, cfg.vocab_size, (B, S + N), generator=torch.Generator().manual_seed(1)).to(DEV)
    timed, again, st = prefill_twice_and_decode(torch, model, tok, S, N, "xlstm")
    state_bytes = sum(t.numel() * t.element_size() for c in st.caches for t in c)
    del again, st
    marks.append(("two prefills and decode", time.perf_counter()))
    prof = device_profile(torch, model, tok[:, :run["profile_prompt"]], card, "phase 17 xlstm", SSM_RANGES)
    marks.append(("profile", time.perf_counter()))
    del model
    torch.cuda.empty_cache()
    # the same weights in float32 (the same draws, not cast), all 48 layers:
    # decode continues a two-chunk prefill's state as the forward does
    f32 = serve.build(dataclasses.replace(cfg, dtype="float32"), 0, torch.device(DEV))
    p32, e32 = run["f32_check"]
    dec32 = decode_against_forward(torch, f32, tok[:, :e32], p32, "xlstm float32", RECURRENT_DECODE_TOL["xlstm_f32"])
    # the float32 noise floor of that forward: the same forward with every
    # float32 weight perturbed by 1e-7 relative (logged, not checked)
    with torch.no_grad():
        base = unembed(f32.cfg, f32.embed, f32(tok[:, :e32])[:, -1:])[:, 0]
        g = torch.Generator(device=DEV).manual_seed(2)
        for p in f32.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g, device=DEV, dtype=p.dtype))
        nudged = unembed(f32.cfg, f32.embed, f32(tok[:, :e32])[:, -1:])[:, 0]
    dec32["noise_floor"] = float((nudged - base).abs().max())
    del f32, base, nudged
    torch.cuda.empty_cache()
    marks.append(("float32 decode vs forward", time.perf_counter()))
    spans = ", ".join(f"{name} {b - a:.1f}" for (_, a), (name, b) in zip(marks, marks[1:]))
    decode_ms = timed["decode_ms_per_step"]
    log(f"phase 17 (a): xlstm-1.3b whole, 48 layers (42 mLSTM, 6 sLSTM) at full width ({n_params / 1e9:.3f} G "
        f"parameters, {n_bytes / 1e9:.2f} GB, bf16 with float32 gates and recurrences), on {card}: prefill "
        f"{B}x{S} {timed['prefill_ms']:.3f} ms (warm), decode {decode_ms:.3f} ms/step = {B * 1e3 / decode_ms:.1f} "
        f"tok/s ({N} greedy steps); through launch.serve (first call): prefill {served['prefill_ms']:.3f} ms, "
        f"decode {served['decode_ms_per_step']:.3f} ms/step = {served['tok_per_s']:.1f} tok/s; two prefills the "
        f"same bits: {timed['same_bits']}; recurrent state {state_bytes / 1e9:.3f} GB; peak memory "
        f"{timed['peak_bytes'] / 2**30:.2f} GiB (launch.serve's run {served_peak / 2**30:.2f} GiB); launches "
        f"{launches}; in float32, decode of {e32 - p32} tokens past a {p32}-token prefill vs a cache-free forward "
        f"over {e32}: max |diff| {dec32['max']:.4g}, mean {dec32['mean']:.4g}, largest |logit| "
        f"{dec32['logit_max']:.4g} (tol {RECURRENT_DECODE_TOL['xlstm_f32']}; the forward against itself with "
        f"the weights perturbed by 1e-7 relative: {dec32['noise_floor']:.4g}), greedy token agrees in "
        f"{dec32['greedy_agree']}/{dec32['rows']} rows; seconds: {spans}")
    return {"launches": launches, **timed, "tok_per_s": B * 1e3 / decode_ms, "served": served,
            "served_peak_bytes": served_peak, "decode_vs_forward_f32": dec32, "profile": prof, "params": n_params,
            "state_bytes": state_bytes}


def hybrid_serving(torch, ops, ref, card: str) -> dict:
    """(b) the Mamba hybrid (gemma-2b's widths, jamba's layout, one period:
    7 Mamba layers around 1 attention layer) through ``launch.serve``'s
    ``build`` and ``generate`` (every count set to 0 just before: exactly
    one ``flash_attention`` launch, at ``q [1, 8, 8192, 256]`` causal),
    then two prefills with the same bits, peak memory, a profile, decode
    against a forward."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve

    t_start = time.perf_counter()
    run = HYBRID_SERVE
    B, S, N = run["batch"], run["prompt"], run["tokens"]
    cfg = dataclasses.replace(get_arch("gemma-2b"), **HYBRID)
    model = serve.build(cfg, 0, torch.device(DEV))
    n_params = sum(p.numel() for p in model.parameters())
    check([layer.kind for layer in model.layers] == ["mamba"] * 4 + ["attn_full"] + ["mamba"] * 3,
          f"hybrid layers {[layer.kind for layer in model.layers]}")
    tok = torch.randint(0, cfg.vocab_size, (B, S + N), generator=torch.Generator().manual_seed(1)).to(DEV)
    log(f"phase 17 (b): launch.serve.generate(build(gemma-2b with {HYBRID}, seed 0), a {B}x{S} prompt, {N})")
    out, launches, served_peak = counted_serve(torch, ops, ref, "hybrid generate",
                                               lambda: serve.generate(model, tok[:, :S], N), 1, (B, N + 1),
                                               cfg.padded_vocab())
    served = {"prefill_ms": 1e3 * out["prefill_seconds"], "decode_ms_per_step": 1e3 * out["decode_seconds"] / N}
    del out
    timed, again, st = prefill_twice_and_decode(torch, model, tok, S, N, "hybrid")
    del st
    torch.cuda.empty_cache()
    prof = device_profile(torch, model, tok[:, :S], card, "phase 17 hybrid", SSM_RANGES)
    torch.cuda.empty_cache()
    dec = decode_against_forward(torch, model, tok[:, :S], run["check_prefill"], "hybrid",
                                 RECURRENT_DECODE_TOL["hybrid"], whole=again)
    del again
    decode_ms = timed["decode_ms_per_step"]
    log(f"phase 17 (b): Mamba hybrid at gemma-2b's width (8 layers: 7 Mamba, d_state {cfg.d_state}, d_conv "
        f"{cfg.d_conv}, expand {cfg.ssm_expand}, and 1 attention layer; {n_params / 1e9:.3f} G parameters, bf16) "
        f"on {card}: prefill {B}x{S} {timed['prefill_ms']:.3f} ms (warm; generate's first "
        f"{served['prefill_ms']:.3f}), decode {decode_ms:.3f} ms/step = {B * 1e3 / decode_ms:.1f} tok/s; two "
        f"prefills the same bits: {timed['same_bits']}; peak memory {timed['peak_bytes'] / 2**30:.2f} GiB "
        f"(generate's run {served_peak / 2**30:.2f} GiB); launches {launches}; decode of "
        f"{S - run['check_prefill']} tokens past {run['check_prefill']} vs a cache-free forward over {S}: max "
        f"|diff| {dec['max']:.4g}, mean {dec['mean']:.4g}, largest |logit| {dec['logit_max']:.4g} (tol "
        f"{RECURRENT_DECODE_TOL['hybrid']}), greedy token "
        f"agrees in {dec['greedy_agree']}/{dec['rows']} rows; {time.perf_counter() - t_start:.1f} s")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, **timed, "served": served, "served_peak_bytes": served_peak,
            "decode_vs_forward": dec, "profile": prof, "params": n_params}


def xlstm_train(torch, ops, ref, card: str) -> dict:
    """(c) xlstm-1.3b's train step at full width, one unit (7 mLSTM, 1
    sLSTM), bf16, batch x tokens from token_batches: step 1 twice from one
    seeded state (every bit compared), ``timed_steps`` more timed; no
    kernel launch and no attention at all; peak memory."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStreamConfig, token_batches
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import AdamWConfig

    full = get_arch("xlstm-1.3b")
    cfg = full.with_layers(XLSTM_TRAIN["layers"])
    B, S = XLSTM_TRAIN["batch"], XLSTM_TRAIN["seq"]
    opt = AdamWConfig(**TRAIN_OPT)
    stream = token_batches(TokenStreamConfig(cfg.vocab_size, S, B, seed=1), device=DEV)
    batches = [next(stream) for _ in range(XLSTM_TRAIN["timed_steps"] + 1)]

    def fresh():
        return M.init_train_state(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = fresh()
    n_params = sum(p.numel() for p in state.params.parameters())
    ops.reset_launches()
    plain0 = ref.device_calls["flash_attention"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = M.train_step(cfg, state, batches[0], opt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = ops.launch_counts()
    plain = ref.device_calls["flash_attention"] - plain0
    check(not any(launched.values()) and plain == 0,
          f"xlstm train step launched {launched}, {plain} plain attention calls")
    host = {"loss": m["loss"].cpu(), "grad_norm": m["grad_norm"].cpu(),
            "params": {k: p.detach().cpu() for k, p in M.param_tree(state.params).items()},
            "mu": {k: v.cpu() for k, v in state.opt.mu.items()},
            "nu": {k: v.cpu() for k, v in state.opt.nu.items()}}
    del state, m
    torch.cuda.empty_cache()
    state = fresh()
    state, m = M.train_step(cfg, state, batches[0], opt)
    torch.cuda.synchronize()
    differ = [k for k, p in M.param_tree(state.params).items() if not torch.equal(p.cpu(), host["params"][k])]
    differ_m = [k for k, v in state.opt.mu.items() if not torch.equal(v.cpu(), host["mu"][k])]
    differ_m += [k for k, v in state.opt.nu.items() if not torch.equal(v.cpu(), host["nu"][k])]
    same = (torch.equal(m["loss"].cpu(), host["loss"]) and torch.equal(m["grad_norm"].cpu(), host["grad_norm"])
            and not differ and not differ_m)
    check(same, f"xlstm train step: one step from one seeded state gave other bits: loss "
          f"{float(host['loss'])!r} vs {float(m['loss'])!r}; parameters {differ[:6]}, moments {differ_m[:6]}")
    watched = ("embed.embedding", "layers.0.mixer.wq", "layers.0.mixer.w_if", "layers.7.mixer.r_h")
    params = M.param_tree(state.params)
    losses, gnorms = [float(m["loss"])], [float(m["grad_norm"])]
    step_s = []
    for b in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = M.train_step(cfg, state, b, opt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses + gnorms)), f"xlstm training: non-finite loss or grad norm {losses} {gnorms}")
    moved = {k: float((params[k].cpu() != host["params"][k]).float().mean()) for k in watched}
    check(all(v > 0 for v in moved.values()), f"xlstm training: parameters did not move {moved}")
    ms = 1e3 * sum(step_s) / len(step_s)
    bound = 1e3 * 6 * n_params * B * S / BF16_OPS_PER_S
    log(f"phase 17 (c) xlstm-1.3b training at full width, depth cut to {cfg.n_layers} of {full.n_layers} layers "
        f"(7 mLSTM, 1 sLSTM; {n_params / 1e9:.3f} G parameters, bf16, batch {B} x {S} tokens) on {card}: step 1 "
        f"twice from one seeded state the same bits (loss, grad norm, every parameter and both moments): "
        f"{same}; losses {', '.join(f'{v:.4f}' for v in losses)}; grad norms {', '.join(f'{v:.4f}' for v in gnorms)}; "
        f"steps 2-{len(step_s) + 1} {ms:.1f} ms/step ({', '.join(f'{1e3 * t:.1f}' for t in step_s)}; the first "
        f"{1e3 * first_s:.1f}), {B * S / ms * 1e3:.0f} tokens/s; 6·N·tokens over the bf16 peak {bound:.2f} ms; "
        f"peak memory {peak / 2**30:.2f} GiB; share of weights moved {moved}; 0 kernel launches, 0 attention calls")
    del state, m, params, host
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "peak_bytes": peak, "same_bits": same, "losses": losses,
            "flash_launches": launched["flash_attention"], "params": n_params}


def reduced_card_vs_cpu(torch, name: str, cfg, moment_tol: float, steps_ok) -> str:
    """``cfg`` (a reduced float32 model) on the card and on the CPU from one
    state: 3 train steps (with the batch's prefix or frames, drawn on the
    CPU), the first step's AdamW moments held leaf by leaf within
    ``moment_tol`` of each leaf's largest |value|, the steps' losses, grad
    norms and the parameters after them by ``steps_ok(loss_err, gn_err,
    p_err, card_metrics, cpu_metrics) -> (ok, tol)``; then, on the card's
    trained weights, a 256-token prefill and 8 decode steps on both (logits
    within ``CPU_TOL``).  Returns the log row."""
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import AdamWConfig

    opt = AdamWConfig(warmup_steps=2, total_steps=10)
    tok = torch.randint(0, cfg.vocab_size, (2, 129), generator=torch.Generator().manual_seed(3),
                        dtype=torch.int32)
    extras = serve.front_end_inputs(cfg, 2, torch.Generator().manual_seed(5))
    runs, moments = {}, {}
    for dev in (DEV, "cpu"):
        st = M.init_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
        on = {k: v.to(dev) for k, v in extras.items()}
        ms = []
        for i in range(3):
            st, m = M.train_step(cfg, st, {"tokens": tok.roll(i, 1).to(dev), **on}, opt)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                # a copy: the later steps update the moments in place
                moments[dev] = {f"{mom}:{k}": v.to("cpu", copy=True) for mom in ("mu", "nu")
                                for k, v in getattr(st.opt, mom).items()}
        runs[dev] = (ms, st.params)
    # the first step's moments leaf by leaf: every leaf's gradient
    mom_err = {k: float((moments[DEV][k] - v).abs().max() / v.abs().max()) for k, v in moments["cpu"].items()}
    worst = max(mom_err, key=mom_err.get)
    check(mom_err[worst] <= moment_tol, f"{name} float32 reduced: card vs CPU, step 1's {worst} "
          f"{mom_err[worst]:.3g} of its largest |value| exceeds {moment_tol}")
    (mg, card_model), (mc, cpu_model) = runs[DEV], runs["cpu"]
    pg, pc = M.param_tree(card_model), M.param_tree(cpu_model)
    loss_err = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(mg, mc)]
    gn_err = [abs(a[1] - b[1]) for a, b in zip(mg, mc)]
    p_err = max(float((pg[k].cpu() - pc[k]).abs().max()) for k in pc)
    ok, tol = steps_ok(loss_err, gn_err, p_err, mg, mc)
    check(ok, f"{name} float32 reduced: card vs CPU losses {loss_err}, grad norms {gn_err}, parameters "
          f"{p_err:.3g} exceed {tol}")
    # inference on the card's trained weights, both devices
    cpu_model.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    ptok = torch.randint(0, cfg.vocab_size, (2, 264), generator=torch.Generator().manual_seed(4))
    P = cfg.prefix_tokens if "prefix" in extras else 0
    outs = {}
    for dev, model in ((DEV, card_model), ("cpu", cpu_model)):
        t = ptok.to(dev)
        logits, st = M.prefill(model, {"tokens": t[:, :256], **{k: v.to(dev) for k, v in extras.items()}},
                               cache_len=P + 264)
        got = [logits]
        for s in range(256, 264):
            logits, st = M.serve_step(model, st, t[:, s:s + 1])
            got.append(logits)
        outs[dev] = torch.stack(got).cpu()
    d = float((outs[DEV] - outs["cpu"]).abs().max())
    check(d <= CPU_TOL["atol"], f"{name} float32 reduced: card vs CPU prefill + decode logits max |diff| "
          f"{d:.4g} exceeds {CPU_TOL}")
    return (f"{name}: step 1's moments, worst leaf {worst} {mom_err[worst]:.3g} of its largest |value| "
            f"(tol {moment_tol}); losses {', '.join(f'{v:.3g}' for v in loss_err)} "
            f"(relative), grad norms {', '.join(f'{v:.3g}' for v in gn_err)}, parameters {p_err:.3g} "
            f"(tol {tol}); prefill + 8 decode steps' logits {d:.3g}")


def within_train_tol(loss_err, gn_err, p_err, mg, mc) -> tuple:
    """``TRAIN_TOL`` on every step (``reduced_card_vs_cpu``'s rule)."""
    return (max(loss_err) <= TRAIN_TOL["loss_rtol"] and max(gn_err) <= TRAIN_TOL["gnorm_atol"]
            and p_err <= TRAIN_TOL["param_atol"]), TRAIN_TOL


def recurrent_card_vs_cpu(torch, card: str) -> None:
    """(d) reduced() xlstm and the reduced hybrid in float32 through
    ``reduced_card_vs_cpu``.  The hybrid's steps are held to ``TRAIN_TOL``;
    xlstm's first step too but its grad norm (``XLSTM_TRAIN_TOL``), and its
    later steps to ``XLSTM_TRAIN_TOL``, as ``tests/test_torch_ssm.py`` holds
    the port to the JAX package (reduced xlstm's training is chaotic at
    float32 rounding: the JAX package against itself from weights perturbed
    by 1e-7 moves the third step's grad norm by 4%)."""
    import dataclasses

    from repro_torch.configs import get_arch

    def xlstm_ok(loss_err, gn_err, p_err, mg, mc) -> tuple:
        later = XLSTM_TRAIN_TOL
        ok = (loss_err[0] <= TRAIN_TOL["loss_rtol"] and gn_err[0] <= later["first_gnorm_atol"]
              and max(loss_err[1:]) <= later["loss_rtol"] and p_err <= later["param_atol"]
              and all(abs(a[1] - b[1]) <= later["gnorm_rtol"] * abs(b[1]) for a, b in zip(mg[1:], mc[1:])))
        return ok, {"first_step_loss_rtol": TRAIN_TOL["loss_rtol"], **later}

    rows = [reduced_card_vs_cpu(torch, "xlstm-1.3b", get_arch("xlstm-1.3b").reduced(),
                                MOMENT_SCALED_TOL["xlstm-1.3b"], xlstm_ok),
            reduced_card_vs_cpu(torch, "hybrid", dataclasses.replace(get_arch("gemma-2b"), **HYBRID).reduced(),
                                MOMENT_SCALED_TOL["hybrid"], within_train_tol)]
    log(f"phase 17 (d) reduced() xlstm and hybrid in float32, card ({card}) vs CPU: " + "; ".join(rows))


def recurrent_phase(torch, ops, ref, card: str) -> dict:
    return {"xlstm": xlstm_serving(torch, ops, ref, card),
            "hybrid": hybrid_serving(torch, ops, ref, card),
            "train": xlstm_train(torch, ops, ref, card),
            "cpu": recurrent_card_vs_cpu(torch, card)}


# -- phase 18: the pruned configs' features (whisper, gemma2, internvl2) --------------------


def frontend_serving(torch, ops, ref, card: str, tag: str) -> dict:
    """One architecture of ``FRONTEND_ARCHS`` whole, at full width, through
    ``launch.serve``'s ``build`` and ``generate`` (every count set to 0
    just before: ``FRONTEND_SERVE``'s ``flash_attention`` launches in the
    prefill, none in decode, no plain version on the card, tokens inside the
    vocabulary, finite logits), then on the same model with the same
    front-end inputs: two prefills with the same bits, warm prefill ms,
    decode ms/step and tok/s, peak memory, the state's position (P + S),
    the cross caches unchanged by decode, and one decode step past the
    prompt against a cache-free forward over S + 1 at ``DECODE_TOL``."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    t_start = time.perf_counter()
    run = FRONTEND_SERVE[tag]
    B, S, N = run["batch"], run["prompt"], run["tokens"]
    cfg = ArchConfig(**FRONTEND_ARCHS[tag])
    model = serve.build(cfg, 0, torch.device(DEV))
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    tok = torch.randint(0, cfg.vocab_size, (B, S + N), generator=torch.Generator().manual_seed(1)).to(DEV)
    log(f"phase 18 {tag}: launch.serve.generate(build({cfg.name}, seed 0), a {B}x{S} prompt, {N})")
    out, launches, served_peak = counted_serve(
        torch, ops, ref, f"{tag} generate",
        lambda: serve.generate(model, tok[:, :S], N, generator=torch.Generator(device=DEV).manual_seed(2)),
        run["flash"], (B, N + 1), cfg.padded_vocab())
    served = {"prefill_ms": 1e3 * out["prefill_seconds"], "decode_ms_per_step": 1e3 * out["decode_seconds"] / N}
    del out
    torch.cuda.empty_cache()
    extras = serve.front_end_inputs(cfg, B, torch.Generator(device=DEV).manual_seed(2))
    P = cfg.prefix_tokens if "prefix" in extras else 0
    ops.reset_launches()
    with flash_routes(ops) as routes:
        timed, again, st = prefill_twice_and_decode(torch, model, tok, S, N, tag, extras=extras)
    log(f"phase 18 {tag}: flash_attention routes over two prefills (q dtype, S x T, causal: launches): "
        + "; ".join(f"{d} {s}x{t} {'causal' if c else 'non-causal'}: {n}" for (d, s, t, c), n in routes.items()))
    if cfg.arch_type == "audio":  # float32 frames: the encoder and cross-attention run float32
        f32 = {(s, t, c): n for (d, s, t, c), n in routes.items() if d == "float32"}
        want = {(cfg.encoder_seq, cfg.encoder_seq, False): 2 * cfg.encoder_layers, (S, cfg.encoder_seq, False):
                2 * cfg.n_layers}
        check(f32 == want, f"{tag}: float32 flash routes {f32}, not the encoder's and the cross's {want}")
    per_prefill = ops.launch_counts()["flash_attention"] / 2
    check(per_prefill == run["flash"], f"{tag}: {per_prefill} flash_attention launches a prefill, not {run['flash']}")
    # each route's launches a prefill: (q dtype, S x T, causal) -> launches
    routes = {f"{d} {s}x{t} {'causal' if c else 'non-causal'}": n // 2 for (d, s, t, c), n in routes.items()}
    check(st.pos == P + S + N, f"{tag}: the state's position {st.pos} after {N} steps, not P + S + N = {P + S + N}")
    del again, st
    torch.cuda.empty_cache()
    crosses = None
    if cfg.arch_type == "audio":  # the cross caches stay as prefill wrote them
        _, st = M.prefill(model, {"tokens": tok[:, :S], **extras}, cache_len=S + N)
        before = [(c[1].k.clone(), c[1].v.clone()) for c in st.caches]
        for s in range(S, S + N):
            _, st = M.serve_step(model, st, tok[:, s:s + 1])
        crosses = all(torch.equal(c[1].k, k) and torch.equal(c[1].v, v) for c, (k, v) in zip(st.caches, before))
        check(crosses, f"{tag}: a cross cache changed across {N} decode steps")
        check(all(c[1].k.shape[1] == cfg.encoder_seq for c in st.caches), f"{tag}: cross caches of another length")
        del st, before
        torch.cuda.empty_cache()
    dec = decode_against_forward(torch, model, tok[:, :S + 1], S, tag, DECODE_TOL, extras=extras)
    decode_ms = timed["decode_ms_per_step"]
    log(f"phase 18 {tag}: {cfg.name} whole at full width ({cfg.n_layers} layers"
        + (f" + {cfg.encoder_layers} encoder layers over {cfg.encoder_seq} frames" if cfg.encoder_layers else "")
        + (f", a {cfg.prefix_tokens}-patch prefix" if P else "")
        + f"; {n_params / 1e9:.3f} G parameters, {n_bytes / 1e9:.2f} GB bf16) on {card}: prefill {B}x{S} "
        f"{timed['prefill_ms']:.3f} ms (warm; generate's first {served['prefill_ms']:.3f}; flash_attention "
        f"routes a prefill: {', '.join(f'{k}: {n}' for k, n in routes.items())}), decode "
        f"{decode_ms:.3f} ms/step = {B * 1e3 / decode_ms:.1f} tok/s ({N} greedy steps); two prefills the same "
        f"bits: {timed['same_bits']}; state position P + S = {P + S}; peak memory "
        f"{timed['peak_bytes'] / 2**30:.2f} GiB (generate's run {served_peak / 2**30:.2f} GiB); launches "
        f"{launches}" + ("" if crosses is None else f"; cross caches unchanged by decode: {crosses}")
        + f"; one decode step past {S} vs a cache-free forward over {S + 1}: max |diff| {dec['max']:.4g}, mean "
        f"{dec['mean']:.4g}, largest |logit| {dec['logit_max']:.4g} (tol {DECODE_TOL}), greedy token agrees in "
        f"{dec['greedy_agree']}/{dec['rows']} rows; {time.perf_counter() - t_start:.1f} s")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, **timed, "tok_per_s": B * 1e3 / decode_ms, "served": served,
            "served_peak_bytes": served_peak, "decode_vs_forward": dec, "params": n_params, "pos": P + S,
            "flash_routes_per_prefill": routes}


def frontend_card_vs_cpu(torch, card: str) -> None:
    """(d) the three reduced in float32 through ``reduced_card_vs_cpu``,
    held to ``TRAIN_TOL`` and step 1's moments to 1e-4 of each leaf's
    scale."""
    from repro_torch.configs.base import ArchConfig

    rows = [reduced_card_vs_cpu(torch, tag, ArchConfig(**arch).reduced(), MOMENT_SCALED_TOL["frontend"],
                                within_train_tol) for tag, arch in FRONTEND_ARCHS.items()]
    log(f"phase 18 (d) reduced() whisper, gemma2 and internvl2 in float32, card ({card}) vs CPU: "
        + "; ".join(rows))


def frontend_phase(torch, ops, ref, card: str) -> dict:
    runs = {tag: frontend_serving(torch, ops, ref, card, tag) for tag in FRONTEND_ARCHS}
    frontend_card_vs_cpu(torch, card)
    return runs


# -- phase 19: the data-parallel MoE dispatch and the production-mesh dry-run ------------

# (a) grok-1-314b at full width (hf:xai-org/grok-1: d_model 6144, 8 experts of
# d_ff 32768, top-2), one MoE layer, batch 2 x 4096 in bf16, on 2 gloo ranks
# of a (2, 1) ("data", "model") mesh sharing the card; each rank dispatches
# its own row (set_dispatch_groups(2) under shardings.use_mesh)
MOE_DP = {"arch": "grok-1-314b", "batch": 2, "seq": 4096, "ranks": 2}
# bf16 against one process's _moe_dense(x, G=2): the same products at other
# batch shapes round apart; the limit is 2x the gap measured on NVIDIA H100
# 80GB HBM3 at 700 W (0.001953: one bf16 ulp at the outputs' magnitude)
MOE_DP_TOL = {"atol": 0.004, "rtol": 0.0}
MOE_DP_CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_arch
from repro_torch.fl import distributed
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe, shardings
coord, ranks, rank, inp, out = sys.argv[2:7]
ranks, rank = int(ranks), int(rank)
distributed.initialize(coord, ranks, rank)
mesh = make_mesh((ranks, 1), ("data", "model"))
cfg = get_arch("grok-1-314b").with_layers(1)
m = moe.MoE(cfg, torch.Generator(device="cuda").manual_seed(0))
x = torch.load(inp)
rows = x.shape[0] // ranks
i = mesh.coords["data"]
mine = x[i * rows:(i + 1) * rows].to("cuda")
moe.set_dispatch_groups(ranks)
with shardings.use_mesh(mesh):
    moe.apply_moe(cfg, m, mine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, aux = moe.apply_moe(cfg, m, mine)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
local = float(moe._moe_dense(cfg, m, mine, 1)[1])
torch.save(y.cpu(), out + f".{rank}.pt")
print("MOEDP " + json.dumps({"coord": i, "aux": float(aux), "local_aux": local, "ms": ms}), flush=True)
distributed.shutdown()
"""


def moe_dispatch_phase(torch, card: str) -> dict:
    """(a) each rank's output against this process's ``_moe_dense(x, G=2)``
    on the whole batch at ``MOE_DP_TOL``; each rank's aux loss the mean of
    the two local ones (float32 on the host: the same sum)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import fl_spawn
    from repro_torch.models import moe

    cfg = get_arch(MOE_DP["arch"]).with_layers(1)
    B, S, R = MOE_DP["batch"], MOE_DP["seq"], MOE_DP["ranks"]
    OUT.mkdir(parents=True, exist_ok=True)
    inp, out = OUT / "moe_dp_x.pt", OUT / "moe_dp_y"
    x = (torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.5).to(torch.bfloat16)
    torch.save(x, inp)
    coord = f"127.0.0.1:{fl_spawn.free_port()}"
    log(f"phase 19 (a) {cfg.name} one MoE layer at full width, {B} x {S} bf16, on {R} gloo ranks of a "
        f"({R}, 1) mesh sharing the card")
    ranks = sharded_children(fl_spawn, R, lambda i: [coord, str(R), str(i), str(inp), str(out)],
                             MOE_DP_CHILD, "moe_dp", "MOEDP")
    m = moe.MoE(cfg, torch.Generator(device=DEV).manual_seed(0))
    xd = x.to(DEV)
    moe._moe_dense(cfg, m, xd, R)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, _ = moe._moe_dense(cfg, m, xd, R)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    local = [float(moe._moe_dense(cfg, m, xd[g * (B // R):(g + 1) * (B // R)], 1)[1]) for g in range(R)]
    gaps = []
    for r in ranks:
        g = r["coord"]
        y = torch.load(f"{out}.{ranks.index(r)}.pt").to(DEV).float()
        ref_rows = want[g * (B // R):(g + 1) * (B // R)].float()
        gaps.append(max_err(y, ref_rows))
        check(bool(torch.isclose(y, ref_rows, **MOE_DP_TOL).all()),
              f"data-parallel dispatch rank {g}: max |diff| {gaps[-1]:.4g} from _moe_dense(x, G={R}) "
              f"exceeds {MOE_DP_TOL}")
        check(abs(r["local_aux"] - local[g]) <= 1e-5 * abs(local[g]),
              f"rank {g}: local aux {r['local_aux']} against this process's {local[g]}")
    mean = float(sum(torch.tensor(r["local_aux"], dtype=torch.float32) for r in ranks) / R)
    check(all(abs(r["aux"] - mean) <= 1e-6 * abs(mean) for r in ranks),
          f"the ranks' aux {[r['aux'] for r in ranks]} is not the mean of their local auxes {mean}")
    rank_ms = ", ".join("%.2f" % r["ms"] for r in ranks)
    log(f"phase 19 (a) on {card}: each rank's {B // R} x {S} rows = its rows of _moe_dense(x, G={R}) within "
        f"max |diff| {max(gaps):.4g} (tol {MOE_DP_TOL}); aux on every rank {ranks[0]['aux']:.6f} = the mean "
        f"of the ranks' local auxes {[r['local_aux'] for r in ranks]} (this process's {local}); a rank's "
        f"dispatch {rank_ms} ms (2 ranks sharing the card), one process's G = {R} {ms:.2f} ms")
    del m, xd, want
    torch.cuda.empty_cache()
    return {"max_abs_err": max(gaps), "aux": ranks[0]["aux"]}


# (b) three dry-run combos on the card machine's host, on the (16, 16) mesh;
# (c) a (1, 1) dry-run of gemma-2b's prefill at phase 8's batch 4 x 64, held
# to the same prefill on the card
DRYRUN_COMBOS = (["--arch", "gemma-2b", "--shape", "train_4k"], ["--arch", "grok-1-314b", "--shape", "train_4k"],
                 ["--fl-round"])
DRYRUN_CHILD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch import roofline
from repro_torch.configs import get_arch
from repro_torch.configs.base import InputShape
from repro_torch.kernels import _build
from repro_torch.launch import dryrun, serve
from repro_torch.models import model as M
out, combos = sys.argv[2], json.loads(sys.argv[3])
for argv in combos:
    dryrun.main([*argv, "--out", out, "--force"])
B, S = 4, 64
r = dryrun.lower_one("gemma-2b", "prefill_64", "single", input_shape=InputShape("prefill_64", S, B, "prefill"),
                     mesh_dims=((1, 1), ("data", "model")))
_build.library()
torch.cuda.synchronize()
before = torch.cuda.memory_allocated()
cfg = get_arch("gemma-2b")
model = serve.build(cfg, 0, torch.device("cuda"))
tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1),
                       dtype=torch.int32).to("cuda")
torch.cuda.synchronize()
held = torch.cuda.memory_allocated() - before
M.prefill(model, {"tokens": tokens})
cost = roofline.DeviceCostMode()
with cost:
    M.prefill(model, {"tokens": tokens})
torch.cuda.synchronize()
print("DRYRUN " + json.dumps({"argument_bytes": r["memory"]["argument_size_in_bytes"], "held": held,
                              "dry_flops": r["cost"]["flops_per_device"], "card_flops": cost.flops,
                              "layers": cfg.n_layers, "heads": cfg.n_heads, "hd": cfg.hd}), flush=True)
"""


def dryrun_phase(torch, card: str) -> dict:
    """(b) ``launch/dryrun.py`` on ``DRYRUN_COMBOS`` over the production
    mesh (the card machine's host; no card): each combo's bottleneck and
    three roofline terms.  (c) the (1, 1) dry-run of gemma-2b's prefill:
    its argument bytes = the bytes the card holds for the same parameters
    and tokens (``memory_allocated`` before and after); its FLOPs = the
    card's prefill under the same ``DeviceCostMode`` plus the plain
    attention's 4·B·H·S·S·D a layer, which the dry-run counts (its fake
    tensors take the plain route) and the card's ``flash_attention``
    launches hide from the mode."""
    out = OUT / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    OUT.mkdir(parents=True, exist_ok=True)
    log_path = OUT / "dryrun_child.log"
    argv = [sys.executable, "-c", DRYRUN_CHILD, str(ROOT / "src"), str(out), json.dumps(DRYRUN_COMBOS)]
    log(f"phase 19 (b)-(c): python -m repro_torch.launch.dryrun "
        + " ; ".join(" ".join(a) for a in DRYRUN_COMBOS) + " ; a (1, 1) gemma-2b prefill 4 x 64")
    with open(log_path, "w") as f:
        rc = subprocess.run(argv, stdout=f, stderr=subprocess.STDOUT, timeout=600).returncode
    text = log_path.read_text()
    check(rc == 0, f"dry-run child exited {rc}: {text[-3000:]}")
    rows = []
    for name in ("gemma-2b__train_4k__single", "grok-1-314b__train_4k__single",
                 "mafl-adaboost-f__fl_round__single"):
        r = json.loads((out / f"{name}.json").read_text())
        check("error" not in r and "roofline" in r, f"dry-run {name}: {r.get('error')}\n{r.get('traceback')}")
        t = r["roofline"]
        rows.append(f"{name}: bottleneck {t['bottleneck']}, compute {t['compute_s']:.4g} s, memory "
                    f"{t['memory_s']:.4g} s, collective {t['collective_s']:.4g} s ({r['n_devices']} devices, "
                    f"{r['cost']['flops_per_device']:.4g} FLOPs a device, collectives {r['collectives']['ops']})")
    log(f"phase 19 (b) dry-run on the card machine's host (bounds from shapes and H100 datasheet peaks): "
        + "; ".join(rows))
    line = [ln for ln in text.splitlines() if ln.startswith("DRYRUN ")]
    check(len(line) == 1, "dry-run child printed no DRYRUN line")
    c = json.loads(line[0][len("DRYRUN "):])
    attention = c["layers"] * 4 * 4 * c["heads"] * 64 * 64 * c["hd"]
    check(c["argument_bytes"] == c["held"],
          f"(1, 1) dry-run argument bytes {c['argument_bytes']} != the card's {c['held']}")
    check(c["dry_flops"] == c["card_flops"] + attention,
          f"(1, 1) dry-run FLOPs {c['dry_flops']} != the card's {c['card_flops']} + attention {attention}")
    log(f"phase 19 (c) (1, 1) dry-run of gemma-2b prefill 4 x 64 against the card ({card}): argument bytes "
        f"{c['argument_bytes']} = memory_allocated's {c['held']}; FLOPs {c['dry_flops']:.6g} = the card's "
        f"{c['card_flops']:.6g} + the plain attention's {attention:.6g} ({c['layers']} layers)")
    return c


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
            + " | shared memory is dynamic (bf16, D = 256: 197 672 bytes a 2-warpgroup block; D = 128: "
            "164 952 bytes a 3-warpgroup block; float32, "
            "D = 64: 52 224 bytes of q and the K/V ring a block of 4 warps, 4 blocks an SM at 128 registers)")
        ws = sorted(e for e in sm90 if "ws_kernel" in e)
        check(len(sm90) == 4 and len(flash) == 8 and len(ws) == 2
              and any("ILi64E" in e for e in ws) and any("ILi128E" in e for e in ws),
              f"ptxas reported {len(sm90)} bf16 ({len(ws)} warp-specialised) and "
              f"{len(flash) - len(sm90)} float32 flash instances, not 4 (2: D = 64, 128) and 4")
        spilled = [row(e) for e in sm90 if flash[e].get("spill_bytes", 1) != 0]
        check(not spilled, f"bf16 flash_attention instances spill: {spilled}")
        # the warp-specialised kernel (D = 64, 128): registers by role
        # (setmaxnreg in its SASS), and no wgmma that ptxas serialised (its
        # "Potential Performance Loss" remarks)
        roles = register_roles(_build, "flash_attention_sm90_ws_kernel")
        log("flash_attention bf16 warp-specialised (D: ptxas registers a thread at launch, spill bytes): "
            + "; ".join(map(row, ws)) + f"; consumers raised to {roles['alloc']}, the producer lowered to "
            f"{roles['dealloc']} registers (setmaxnreg, both instances)")
        check(len(roles["alloc"]) == 2 and len(set(roles["alloc"])) == 1
              and len(roles["dealloc"]) == 2 and len(set(roles["dealloc"])) == 1,
              f"the warp-specialised kernel's SASS sets no single register count per role: {roles}")
        serialised = [ln.strip() for ln in _build.build_log.splitlines()
                      if "wgmma.mma_async instructions are serialized" in ln and "ws_kernel" in ln]
        check(not serialised, f"ptxas serialised the warp-specialised kernel's wgmma: {serialised}")
        f32_64 = [row(e) for e in flash if e not in sm90 and "ILi64E" in e]
        check(len(f32_64) == 1 and f32_64[0].endswith(", 0"),
              f"the float32 flash_attention instance at D = 64 (whisper's) spills: {f32_64}")
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
    for name, rows in check_sharded_shapes(torch, ops, ref, g, fl_run).items():
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
    serve_launches, serve_counts = serve_phase(torch, ops, ref, card)
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

    # 14. the LM training step at full width, the training driver and its
    # checkpoints, and windowed serving (an 8192-token prefill, ring decode)
    lm = lm_phase(torch, ops, ref, card)
    phase_done(14)

    # 15. the SPMD round (fl_run --sharded) on a (1, 1) mesh and on 4 gloo
    # ranks, and the mesh engine
    sharded_launches = sharded_phase(torch, ops, ref, fl_run, card)
    phase_done(15)

    # 16. MoE: grok-1 and llama4-scout at full width (depth cut), their
    # prefills through flash_attention's softcap and window routes; the MoE
    # train step
    moe_runs = moe_phase(torch, ops, ref, card)
    phase_done(16)

    # 17. the recurrent mixers: xlstm-1.3b whole at full width, a Mamba hybrid
    # through flash_attention, xlstm's train step, card vs CPU
    recurrent = recurrent_phase(torch, ops, ref, card)
    phase_done(17)

    # 18. the pruned configs' features: whisper-large-v3, gemma2-27b and
    # internvl2-26b whole at full width, through flash_attention's non-causal,
    # cross and window + softcap routes; the reduced three card vs CPU
    frontends = frontend_phase(torch, ops, ref, card)
    phase_done(18)

    # 19. the data-parallel MoE dispatch on 2 gloo ranks at grok-1's full
    # width; the production-mesh dry-run, and a (1, 1) one held to the card
    moe_dispatch_phase(torch, card)
    dryrun_phase(torch, card)
    phase_done(19)
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
            # phase 7 serves from cached CUDA graphs: a program's first batch
            # launches eagerly and captures the graph (wrapper_captures, no
            # launch), every later batch replays it (replayed_launches: the
            # graph's captured vote_argmax times its replays); launches is both
            "launches_per_batch": (launches[name] / serve_counts["batches"]
                                   if name == "vote_argmax" else None),
            "replayed_launches": serve_counts["replayed_launches"] if name == "vote_argmax" else None,
            "wrapper_captures": serve_counts["captures"] if name == "vote_argmax" else None,
            "graph_replays": serve_counts["graph_replays"] if name == "vote_argmax" else None,
            "batches": serve_counts["batches"] if name == "vote_argmax" else None,
            "launches_per_prefill": launches[name] if name == "flash_attention" else None,
            # phase 12: the chaos run's training launches, the registry's votes
            "launches_elastic": elastic_launches.get(name, 0),
            # phase 13 (b): both processes of the 2-process lockstep run, 6 rounds,
            # and the 4 processes of the fault-free elastic star, 6 rounds
            "launches_distributed": dist_launches["lockstep"][name],
            "launches_elastic_dist": dist_launches["elastic"][name],
            # phase 15 (a) the (1, 1) mesh's run; (b) its run plus the 4 ranks' (4, 1) run, summed
            "launches_sharded_host_mesh": sharded_launches["host_mesh"][name],
            "launches_sharded": sharded_launches["ranks"][name],
            "max_abs_err": worst, "max_err": worst,
            "ms": main_shape["ms"], "kernel_ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": main_shape["library_ms"],
            "eager_ms": main_shape["eager_ms"], "shape": main_shape["shape"],
            "launch_floor_ms": floor,
        })
        if name == "flash_attention":  # phase 14: the windowed prefill's shapes and launches
            kernels[-1]["launches_windowed_prefill"] = lm["windowed"]["launches"]
            # the training forward runs the plain attention, as the JAX package's does
            kernels[-1]["launches_training"] = lm["train"]["flash_launches"]
            kernels[-1]["windowed_prefill"] = {
                case: {k: res[case][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "eager_ms")}
                for case in ("gemma_window_8192", "gemma_8192")}
            # phase 16: the MoE prefills' launches and shapes
            kernels[-1]["launches_moe_prefill"] = {k: moe_runs[k]["launches"][name] for k in MOE_SERVE}
            kernels[-1]["moe_prefill"] = {
                case: {k: res[case][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "library_call", "eager_ms",
                                                 "graph_replay_same_bits")}
                for case in FLASH_BIG}
            # phase 17: the hybrid's prefill (its one attention layer, at "gemma_8192"'s
            # shape) and xlstm's serving and train step, which launch none
            kernels[-1]["launches_hybrid_prefill"] = recurrent["hybrid"]["launches"][name]
            kernels[-1]["launches_xlstm_serve"] = recurrent["xlstm"]["launches"][name]
            kernels[-1]["launches_xlstm_train"] = recurrent["train"]["flash_launches"]
            # phase 18: the front-end models' prefills and their shapes
            kernels[-1]["launches_frontend_prefill"] = {k: frontends[k]["launches"][name] for k in FRONTEND_ARCHS}
            kernels[-1]["frontend_prefill"] = {
                case: {k: res[case][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "library_call", "eager_ms",
                                                 "graph_replay_same_bits")}
                for case in FRONTEND_FLASH}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
