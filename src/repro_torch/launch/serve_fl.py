"""Ensemble serving driver on PyTorch — train-then-serve, load-then-serve,
or the continuous train→publish→serve loop (answers to
``repro/launch/serve_fl.py``).

  # train a federation, save the artifact, then serve the test split:
  PYTHONPATH=src python -m repro_torch.launch.serve_fl --dataset pendigits \\
      --rounds 10 --artifact /tmp/pendigits.mafl

  # serve an existing artifact (one the JAX package wrote serves too, and
  # a DistBoost.F committee artifact that fl_run --algorithm distboost_f
  # --publish-every published):
  PYTHONPATH=src python -m repro_torch.launch.serve_fl --dataset pendigits \\
      --artifact /tmp/pendigits.mafl --load

  # continuous loop: the federation publishes a rolling artifact every
  # k rounds and the serving side folds each checkpoint in:
  PYTHONPATH=src python -m repro_torch.launch.serve_fl --dataset pendigits \\
      --rounds 10 --publish-every 2 --publish-dir /tmp/pendigits_pub

  # heterogeneous: learner families cycled over the collaborators; the
  # mixed ensemble publishes v2 artifacts and serves behind the same API
  # (one vote_argmax a batch over every group's members):
  PYTHONPATH=src python -m repro_torch.launch.serve_fl --dataset pendigits \\
      --learners decision_tree,ridge,gaussian_nb --collaborators 6 \\
      --rounds 10 --publish-every 2 --publish-dir /tmp/pendigits_hetero

Runs on the card by default (``--device cpu`` runs the kernels' plain
versions on the CPU).  Serving drives the micro-batching engine over the
test split (ragged tail included) under ``--policy sync`` (submit/flush)
or ``--policy deadline`` (a partial batch runs by itself after
``--t-max-ms``), reports req/s and p50/p99 latency, then replays the same
traffic against the shard-resident vote cache.  On the card each batch
replays the engine's cached CUDA graph (``serve/compile_cache.py``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.metrics import f1_macro
from repro_torch.data import PAPER_DATASETS, get_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.fl_run import LEARNERS, build_federation, finish_obs, parse_learners
from repro_torch.obs import trace
from repro_torch.serve import ServeEngine, ShardVoteCache, load_artifact, save_artifact


def _f1(y: np.ndarray, pred: np.ndarray, n_classes: int) -> float:
    return float(f1_macro(torch.from_numpy(y), torch.from_numpy(pred), n_classes))


def _federation(args, device):
    """AdaBoost.F over an IID split of ``--dataset`` with ``--learner`` or
    the ``--learners`` mix."""
    return build_federation(args.dataset, args.collaborators, args.rounds, args.depth,
                            args.seed, device, learner=args.learner, learners=args.learners)


def train_ensemble(args, device):
    """Train the federation; its ``state.ensemble`` is the trained strong
    hypothesis (a group tuple for ``--learners``)."""
    fed = _federation(args, device)
    t0 = time.perf_counter()
    fed.run(eval_every=args.rounds)  # one eval at the end: the run's one host sync
    print(f"trained {args.rounds} rounds x {args.collaborators} collaborators "
          f"in {time.perf_counter() - t0:.1f}s")
    return fed


def _drive_engine(args, engine: ServeEngine, Xte: np.ndarray, min_seconds: float = 0.0):
    """Push the ragged request stream through the configured policy: the
    whole split once, then again until ``min_seconds`` have passed.
    Returns (one pass's predictions in submit order, rows served, wall
    seconds, the deadline scheduler's queue-wait histogram or None)."""
    step = args.request_rows

    def passes(submit, answers):
        def one_pass():
            ids = []
            for i in range(0, Xte.shape[0], step):
                ids.extend(submit(Xte[i : i + step]))
            return answers(ids)

        t0 = time.perf_counter()
        pred, n = one_pass(), 1
        while time.perf_counter() - t0 < min_seconds:
            if not np.array_equal(one_pass(), pred):
                raise RuntimeError("a repeated pass served other votes")
            n += 1
        return pred, n * Xte.shape[0], time.perf_counter() - t0

    if args.policy == "deadline":
        with engine.scheduler(t_max_s=args.t_max_ms / 1e3) as sched:
            # NO flush: the tail dispatches on its own at the deadline
            out = passes(sched.submit, lambda ids: sched.results(ids, timeout_s=60.0))
        return (*out, sched.queue_wait)

    def answers(ids):
        engine.flush()
        return np.array([engine.take(i) for i in ids], np.int32)

    return (*passes(engine.submit, answers), None)


def serve(args, learner, lspec, ensemble, Xte: np.ndarray, yte: np.ndarray, *,
          committee: bool = False) -> dict:
    engine = ServeEngine(learner, lspec, ensemble, batch_size=args.batch, committee=committee)
    engine.warmup()  # the program built (a graph captured) before traffic arrives

    pred, served, dt, queue_wait = _drive_engine(args, engine, Xte, args.serve_seconds)
    n = Xte.shape[0]
    f1 = _f1(yte, pred, lspec.n_classes)
    # request_latencies is a bounded log-spaced histogram: percentiles
    # carry a ~5% relative error (see obs/metrics.py), constant memory
    lat = engine.stats.request_latencies
    p50, p99 = 1e3 * lat.percentile(50), 1e3 * lat.percentile(99)
    wait = {}
    if queue_wait is not None:
        wait = {"wait_p50_ms": 1e3 * queue_wait.percentile(50),
                "wait_p99_ms": 1e3 * queue_wait.percentile(99)}
    print(
        f"engine[{args.policy}]: {served} requests in {dt:.3f}s = {served/dt:.0f} req/s  "
        f"p50 {p50:.2f}ms p99 {p99:.2f}ms  "
        f"({engine.stats.batches} batches, {engine.stats.padded_rows} padded rows)  "
        f"F1 {f1:.4f}"
        + (f"  queue wait p50 {wait['wait_p50_ms']:.2f}ms p99 {wait['wait_p99_ms']:.2f}ms"
           if wait else "")
    )

    # repeat traffic: the shard-resident vote cache answers from the tally
    cache = ShardVoteCache(learner, lspec, ensemble, committee=committee)
    cache.predict("test_split", Xte)  # first contact builds the tally
    repeats = max(args.cache_repeats, 1)
    t0 = time.perf_counter()
    for _ in range(repeats):
        cache_pred = cache.predict("test_split")
    dt_hit = (time.perf_counter() - t0) / repeats
    if not np.array_equal(cache_pred, pred):
        raise RuntimeError("cache path diverged from engine")
    print(
        f"vote cache: repeat shard of {n} rows in {dt_hit*1e3:.2f}ms "
        f"= {n/dt_hit:.0f} req/s ({cache.stats()})"
    )
    return {"f1": f1, "pred": pred, "requests": served, "seconds": dt, "p50_ms": p50,
            "p99_ms": p99, **wait, "stats": engine.stats, "cache": cache.stats()}


def publish_and_consume(args, device) -> dict:
    """The continuous loop: the federation publishes a rolling artifact
    every ``--publish-every`` rounds, and the serving side (engine + vote
    cache) folds each checkpoint in incrementally."""
    fed = _federation(args, device)
    Xte, yte = fed.X_test.cpu().numpy(), fed.y_test.cpu().numpy()
    engine = cache = None
    consumed = []  # (round, members, engine req/s) per checkpoint

    def consume(path, round_idx):
        nonlocal engine, cache
        art = load_artifact(path, device)
        if engine is None:  # first checkpoint: build the serving side
            engine = ServeEngine.from_artifact(art, batch_size=args.batch)
            engine.warmup()
            cache = ShardVoteCache.from_artifact(art)
        else:  # rolling checkpoint: a pure append
            engine.update_ensemble(art.ensemble)
            cache.update_ensemble(art.ensemble)
        pred, _, dt, _ = _drive_engine(args, engine, Xte)
        if not np.array_equal(cache.predict("test_split", Xte), pred):
            raise RuntimeError("cache diverged from engine")
        members = art.manifest["ensemble_count"]
        consumed.append((round_idx, members, Xte.shape[0] / dt))
        print(f"  checkpoint round {round_idx}: {members} members served, "
              f"{Xte.shape[0]/dt:.0f} req/s, cache {cache.stats()}")

    t0 = time.perf_counter()
    fed.run(
        rounds=args.rounds, eval_every=max(args.rounds // 2, 1),
        publish_every=args.publish_every, publish_dir=args.publish_dir,
        on_checkpoint=consume,
    )
    print(f"train+publish+serve loop: {len(fed.published)} checkpoints "
          f"in {time.perf_counter() - t0:.1f}s -> {args.publish_dir}")

    # the consumer only ever folded appended members: total folds == the
    # final member count (each member predicted exactly once per shard)
    final = load_artifact(fed.published[-1], device)
    if cache.stats()["members_folded"] != final.manifest["ensemble_count"]:
        raise RuntimeError(f"cache folded more than the appended members: {cache.stats()}")
    got = cache.predict("test_split")
    want = engine.predict(Xte)
    if not np.array_equal(got, want):
        raise RuntimeError("final checkpoint: cache diverged from engine")
    f1 = _f1(yte, got, fed.spec.n_classes)
    print(f"final checkpoint F1 {f1:.4f} (cache and engine agree on every row)")
    return {"f1": f1, "pred": got, "published": list(fed.published), "checkpoints": consumed,
            "stats": engine.stats, "cache": cache.stats()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve_fl")
    ap.add_argument("--dataset", default="pendigits", choices=sorted(PAPER_DATASETS))
    ap.add_argument("--learner", default="decision_tree", choices=LEARNERS)
    ap.add_argument("--learners", default=None,
                    help="comma-separated learner registry keys cycled across "
                         "collaborators: train/publish/serve a heterogeneous "
                         "federation; overrides --learner")
    ap.add_argument("--collaborators", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--artifact", default=None,
                    help="artifact path: written after training, or read with --load")
    ap.add_argument("--load", action="store_true",
                    help="skip training; serve the --artifact file")
    ap.add_argument("--publish-every", type=int, default=None,
                    help="train a federation that publishes a rolling artifact "
                         "every k rounds; serving consumes each checkpoint "
                         "incrementally (requires --publish-dir)")
    ap.add_argument("--publish-dir", default=None,
                    help="directory for the rolling artifact stream")
    ap.add_argument("--batch", type=int, default=256,
                    help="static serving batch size")
    ap.add_argument("--request-rows", type=int, default=37,
                    help="rows per submitted request (ragged on purpose)")
    ap.add_argument("--policy", choices=["sync", "deadline"], default="sync",
                    help="dispatch policy: sync submit/flush, or the async "
                         "deadline loop (partial batches run after --t-max-ms)")
    ap.add_argument("--t-max-ms", type=float, default=2.0,
                    help="deadline policy: max ms a partial batch may queue")
    ap.add_argument("--serve-seconds", type=float, default=0.0,
                    help="serve the test split again until this many seconds "
                         "have passed (0: one pass), so p99 rests on a longer "
                         "window than one pass")
    ap.add_argument("--cache-repeats", type=int, default=10)
    ap.add_argument("--quantize", choices=["bf16", "int8"], default=None,
                    help="write the --artifact file with quantized leaf "
                         "payloads, calibrated on the served split so its "
                         "votes stay bit-identical to the f32 ensemble")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record serve/dispatch spans and write a Chrome-trace "
                         "JSON; prints a phase-time summary table")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the process metrics registry (engine, scheduler "
                         "and vote-cache families) in Prometheus text format")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    args.learners = parse_learners(ap, args.learners)
    device = resolve_device(args.device)
    if args.trace:
        trace.enable()

    if args.publish_every is not None:
        if not args.publish_dir:
            ap.error("--publish-every requires --publish-dir")
        out = publish_and_consume(args, device)
        finish_obs(args)
        return out

    if args.load:
        if not args.artifact:
            ap.error("--load requires --artifact")
        art = load_artifact(args.artifact, device)
        learner, lspec, ensemble, committee = art.learner, art.spec, art.ensemble, art.committee
        print(f"loaded {args.artifact}: {art.manifest['learner']} x "
              f"{art.manifest['ensemble_count']} members"
              + (f", committees of {art.committee_size}" if committee else ""))
        # the served split: the dataset's test rows, drawn from --seed
        _, (_, _, X_test, y_test) = get_dataset(args.dataset, torch.Generator().manual_seed(args.seed))
    else:
        fed = train_ensemble(args, device)
        learner, lspec, ensemble, committee = fed.learner, fed.spec, fed.state.ensemble, False
        X_test, y_test = fed.X_test, fed.y_test
    Xte, yte = X_test.cpu().numpy(), y_test.cpu().numpy()
    if not args.load and args.artifact:
        p = save_artifact(args.artifact, lspec, ensemble,
                          extra={"dataset": args.dataset},
                          quantize=args.quantize,
                          calibrate=Xte if args.quantize else None)
        print(f"saved artifact {p} ({p.stat().st_size} bytes"
              + (f", {args.quantize} leaves" if args.quantize else "") + ")")
        if args.quantize:
            # a quantized artifact must serve the same votes it was
            # calibrated for — reload and serve the reloaded ensemble
            ensemble = load_artifact(p, device).ensemble

    out = serve(args, learner, lspec, ensemble, Xte, yte, committee=committee)
    finish_obs(args)
    return out


if __name__ == "__main__":
    main()
