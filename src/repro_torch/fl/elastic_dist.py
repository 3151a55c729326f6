"""Elastic multi-process federation on PyTorch (answers to
``repro/fl/elastic_dist.py``): the fault-tolerant mirror of
``fl/distributed.py``.

The lockstep runtime exchanges rounds over gloo collectives, which is
exactly what cannot survive a fault: a collective blocks until EVERY
process contributes, so one dead collaborator hangs the federation.  This
runtime replaces the collectives with a coordinator-centric TCP star
(process 0 owns the socket the ``--coordinator`` flag names), so the
coordinator can *close a round over whoever answered*:

  * a per-round straggler deadline (``ParticipationPolicy.deadline_s``)
    measured on real wall-clock arrivals;
  * dead-process detection: a collaborator's socket reaching EOF evicts
    it permanently (reason ``dead``) instead of hanging a collective;
  * late hypothesis uploads (an earlier round's ``hyp`` surfacing after
    its round closed) merge with the staleness-discounted alpha of
    ``fl/elastic.staleness_discount``;
  * deterministic fault injection: every process evaluates the same
    seeded ``FaultPlan`` schedule, so collaborators know when to sleep,
    skip or die, and the chaos runs replay exactly.

Scope and divergences from the in-process elastic path, as the JAX
package's (documented, not accidental): ``adaboost_f`` only (the other
algorithms raise); the error reduction runs over every *live* shard
rather than responders only (the errs exchange is cheap and every
connected shard answers it); an evicted collaborator's weight mass leaves
the federation at the next renormalisation instead of staying frozen;
the coordinator (process 0) is exempt from fault injection: it is the
aggregator, and killing it is a different failure class than
collaborator churn.  The coordinator owns the ensemble, evaluation and
history, and prints the ``final F1 x.xxxx`` line ``fl_spawn --min-f1``
asserts on.

The wire is plain sockets and bytes (a ``<II`` header of the JSON header
length and the payload length, the JSON header, the payload; hypotheses
as ``core/serialization.py``'s packed bytes), so the bytes on the wire are
the JAX package's.  A shard's fit launches ``tree_hist`` on the card and
its weight step the un-renormalised ``weight_update_product``; scoring is
plain tensor code, as the JAX package's.  A randomised learner draws from
a CPU generator seeded from ``(seed, round, collaborator)``, the
counterpart of the JAX package's folded keys.
"""
from __future__ import annotations

import json
import os
import queue
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import boosting, scoring
from repro_torch.core.metrics import f1_macro
from repro_torch.core.serialization import deserialize, serialize, wire_format
from repro_torch.device import resolve_device, synchronize
from repro_torch.fl.elastic import (
    _M_COMM, _M_DROPOUT, _M_LATE_MERGES, _M_ROUNDS,
    FaultPlan, ParticipationPolicy, staleness_discount,
)
from repro_torch.kernels.ref import one_hot
from repro_torch.learners.base import LearnerSpec, get_learner
from repro_torch.obs import trace

_HDR = struct.Struct("<II")  # (json header length, payload length)
_READY_TIMEOUT_S = 300.0  # round-0 handshake: a first kernel build must not trip deadlines
_PHASE_TIMEOUT_S = 120.0  # errs/wsum phases: generous, only real death should trip


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


def _send_msg(sock: socket.socket, kind: str, meta: Dict[str, Any],
              payload: bytes = b"") -> int:
    head = json.dumps({"kind": kind, **meta}).encode()
    sock.sendall(_HDR.pack(len(head), len(payload)) + head + payload)
    return _HDR.size + len(head) + len(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Tuple[str, Dict[str, Any], bytes]:
    hlen, plen = _HDR.unpack(_recv_exact(sock, _HDR.size))
    meta = json.loads(_recv_exact(sock, hlen))
    payload = _recv_exact(sock, plen) if plen else b""
    return meta.pop("kind"), meta, payload


def _pack_bufs(bufs: List[bytes]) -> bytes:
    return b"".join(struct.pack("<I", len(b)) + b for b in bufs)


def _unpack_bufs(payload: bytes) -> List[bytes]:
    bufs, off = [], 0
    while off < len(payload):
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        bufs.append(payload[off:off + n])
        off += n
    return bufs


# ---------------------------------------------------------------------------
# Shared shard-side machinery
# ---------------------------------------------------------------------------


class _Shard:
    """One process's local slice of the federation: the fit, score and
    weight step over its own ``[n, d]`` shard, on ``device``."""

    def __init__(self, pid: int, lspec: LearnerSpec, Xs, ys, masks, *,
                 device: str | torch.device = "cuda", seed: int = 0):
        self.pid = pid
        self.spec = lspec
        self.learner = get_learner(lspec.name)
        self.device = dev = resolve_device(device)
        self.seed = seed
        masks = torch.as_tensor(masks, dtype=torch.float32).to(dev)
        self.X = torch.as_tensor(Xs[pid], dtype=torch.float32).to(dev).contiguous()
        self.y = torch.as_tensor(ys[pid], dtype=torch.int32).to(dev).contiguous()
        self.mask = masks[pid].contiguous()
        # globally normalised initial weights: every process sees the full
        # masks, so the global sum needs no exchange (padded rows start at 0)
        self.w = self.mask / torch.clamp_min(torch.sum(masks), 1.0)
        self.fit_cache = (self.learner.precompute(lspec, self.X[None])
                          if self.learner.precompute is not None else None)
        self._fmt = None

    def fit_round(self, r: int):
        """This shard's hypothesis for round ``r`` from its current weights,
        rescaled locally so that a scale-sensitive learner keeps its
        regularisation."""
        w_fit = (self.w / torch.clamp_min(torch.sum(self.w), 1e-30)
                 * torch.clamp_min(torch.sum(self.mask), 1.0))
        seed = int(np.random.SeedSequence([self.seed, r, self.pid]).generate_state(1)[0])
        h = boosting._local_fits(self.learner, self.spec, w_fit[None], self.X[None],
                                 self.y[None], self.fit_cache, torch.Generator().manual_seed(seed))
        params = type(h)(*(x[0] for x in h))
        if self._fmt is None:
            self._fmt = wire_format(params)
        return params

    def serialize_hyp(self, params) -> bytes:
        return serialize(params, packed=True)[0]

    def deserialize_hyp(self, buf: bytes):
        params = deserialize([buf], self._fmt, packed=True)
        return type(params)(*(x.to(self.device) for x in params))

    def score_space(self, hyp_bufs: List[bytes]):
        """Per-hypothesis weighted error on this shard (float64 on the
        host, with the shard's weight sum, in one transfer), and the
        ``[H, n]`` mispredictions, kept so that the chosen hypothesis's
        update needs no second predict."""
        hyps = [self.deserialize_hyp(b) for b in hyp_bufs]
        stack = type(hyps[0])(*(torch.stack(leaves) for leaves in zip(*hyps)))
        preds = scoring.predict_matrix(self.learner, self.spec, stack, self.X)  # [H, n]
        mis = (preds != self.y).to(torch.float32)
        errs = torch.sum(self.w * mis, dim=-1)  # a row sum per hypothesis
        table = torch.cat([errs, torch.sum(self.w)[None]]).cpu().numpy().astype(np.float64)
        return table[:-1], float(table[-1]), mis

    def apply_update(self, mis: torch.Tensor, alpha: float) -> float:
        """The un-renormalised step 4 on this shard (one
        ``weight_update_product`` launch on the card); returns the new
        weight sum for the global renormalisation."""
        a = torch.tensor(alpha, dtype=torch.float32).to(self.device)
        self.w = scoring.update_weights(self.w, mis, self.mask, a, renormalize=False)
        return float(torch.sum(self.w))  # mafl: allow[host-sync] the sum the coordinator totals

    def renormalize(self, total: float) -> None:
        self.w = self.w / max(total, 1e-30)

    def warmup(self) -> None:
        """A fit and a scoring before the first round, so that the first
        round's deadline does not wait on the kernel build."""
        params = self.fit_round(0)
        self.score_space([self.serialize_hyp(params)])
        synchronize(self.device)


# ---------------------------------------------------------------------------
# Coordinator (process 0)
# ---------------------------------------------------------------------------


class _Peer:
    def __init__(self, pid: int, sock: socket.socket):
        self.pid = pid
        self.sock = sock
        self.alive = True


class ElasticCoordinator:
    def __init__(self, args, policy: ParticipationPolicy, faults: FaultPlan,
                 lspec, Xs, ys, masks, Xte, yte, *, device: str | torch.device = "cuda"):
        self.args = args
        self.policy = policy
        self.faults = faults
        self.C = args.num_processes
        self.shard = _Shard(0, lspec, Xs, ys, masks, device=device, seed=args.seed)
        dev = self.shard.device
        self.Xte = torch.as_tensor(Xte, dtype=torch.float32).to(dev).contiguous()
        self.yte = torch.as_tensor(yte, dtype=torch.int32).to(dev).contiguous()
        self.spec = lspec
        self.ensemble: List[Tuple[Any, float]] = []
        self.history: List[Dict[str, float]] = []
        self.late_log: List[Dict[str, float]] = []
        self.dropouts: Dict[str, int] = {}
        self.evicted: List[int] = []
        self.comm_bytes = 0
        self._votes = torch.zeros(self.Xte.shape[0], lspec.n_classes, dtype=torch.float32,
                                  device=dev)
        self._q: "queue.Queue[Tuple[int, str, Dict[str, Any], bytes]]" = queue.Queue()
        self.peers: Dict[int, _Peer] = {}
        # hyp uploads that surfaced after their round closed: whichever
        # collection phase drains them, they merge at the next round open
        self._late_uploads: List[Tuple[int, int, bytes]] = []

    def _vote(self, params, alpha: float) -> None:
        """Fold one member into the test-split tally (an out-of-range class
        votes for nothing)."""
        a = torch.tensor(alpha, dtype=torch.float32).to(self.shard.device)
        pred = self.shard.learner.predict(self.spec, params, self.Xte)
        self._votes = self._votes + a * one_hot(pred, self.spec.n_classes, torch.float32)

    # -- connection plumbing ------------------------------------------------
    def _reader(self, peer: _Peer) -> None:
        try:
            while True:
                kind, meta, payload = _recv_msg(peer.sock)
                self._q.put((peer.pid, kind, meta, payload))
        except (ConnectionError, OSError):
            self._q.put((peer.pid, "__dead__", {}, b""))

    def _accept_all(self, host: str, port: int) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(self.C)
        srv.settimeout(_READY_TIMEOUT_S)
        for _ in range(self.C - 1):
            sock, _ = srv.accept()
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            kind, meta, _ = _recv_msg(sock)
            if kind != "hello":
                raise ConnectionError(f"expected a hello, got {kind!r}")
            peer = _Peer(int(meta["pid"]), sock)  # mafl: allow[host-sync] a JSON int
            self.peers[peer.pid] = peer
            threading.Thread(target=self._reader, args=(peer,), daemon=True).start()
        srv.close()

    def _evict(self, pid: int) -> None:
        peer = self.peers.get(pid)
        if peer is not None and peer.alive:
            peer.alive = False
            self.evicted.append(pid)
            self.dropouts["dead"] = self.dropouts.get("dead", 0) + 1
            _M_DROPOUT.labels(reason="dead").inc()
            try:
                peer.sock.close()
            except OSError:
                pass

    def _broadcast(self, kind: str, meta: Dict[str, Any], payload: bytes = b"") -> None:
        sent = 0
        for peer in self.peers.values():
            if not peer.alive:
                continue
            try:
                sent += _send_msg(peer.sock, kind, meta, payload)
            except OSError:
                self._evict(peer.pid)
        self.comm_bytes += sent
        _M_COMM.inc(sent)

    def _collect(self, kind: str, round_idx: int, want: set, timeout_s: float,
                 *, min_have: int = 0) -> Dict[int, Tuple[Dict, bytes]]:
        """Drain the queue until every pid in ``want`` delivered ``kind``
        for ``round_idx``, the deadline passes (with at least ``min_have``
        arrivals), or everyone remaining is dead.  Off-round ``hyp``
        messages met along the way are stragglers surfacing late: they land
        in ``self._late_uploads`` whichever phase drains them."""
        have: Dict[int, Tuple[Dict, bytes]] = {}
        t0 = time.monotonic()
        while True:
            missing = {p for p in want if p not in have and self.peers[p].alive}
            if not missing:
                break
            remaining = t0 + timeout_s - time.monotonic()
            if remaining <= 0 and len(have) >= min_have:
                break
            try:
                pid, k, meta, payload = self._q.get(
                    timeout=max(remaining, 0.05) if len(have) >= min_have else 1.0
                )
            except queue.Empty:
                continue
            if k == "__dead__":
                self._evict(pid)
                continue
            nbytes = _HDR.size + len(payload)
            self.comm_bytes += nbytes
            _M_COMM.inc(nbytes)
            if k == kind and meta.get("round") == round_idx and pid in want:
                have[pid] = (meta, payload)
            elif k == "hyp":
                # a hyp that any phase drains without consuming is a
                # straggler's upload surfacing after its window closed,
                # including one for the CURRENT round landing mid-errs
                self._late_uploads.append((int(meta["round"]), pid, payload))  # mafl: allow[host-sync] a JSON int
        return have

    # -- the rounds ---------------------------------------------------------
    def run(self) -> List[Dict[str, float]]:
        args, pol = self.args, self.policy
        host, port = args.coordinator.rsplit(":", 1)
        self._accept_all(host, int(port))
        rounds = args.rounds
        sched = self.faults.schedule(rounds, self.C)
        membership = pol.membership(rounds, self.C)
        self.shard.warmup()
        self._collect("ready", -1, set(self.peers), _READY_TIMEOUT_S)
        gamma, max_stale = pol.staleness_gamma, pol.max_staleness
        deadline = pol.deadline_s

        for r in range(rounds):
            t_round = time.perf_counter()
            with trace.span("round", round=r, algorithm="adaboost_f", elastic=True):
                self._broadcast("begin", {"round": r})
                t0 = time.monotonic()
                own = self.shard.fit_round(r)
                own_buf = self.shard.serialize_hyp(own)

                # expected uploads this round: live, member, not scheduled
                # to drop or be offline (the schedule is shared knowledge)
                expected = {
                    p for p, peer in self.peers.items()
                    if peer.alive and membership[r, p]
                    and not sched.drop[r, p] and not sched.offline[r, p]
                }
                budget = None if deadline is None else \
                    max(deadline - (time.monotonic() - t0), 0.0)
                have = self._collect(
                    "hyp", r, expected,
                    _PHASE_TIMEOUT_S if budget is None else budget,
                    min_have=max(pol.min_responders - 1, 0),
                )
                wait_s = time.monotonic() - t0
                deadline_hit = deadline is not None and len(have) < len(expected)

                # dropout accounting over live members expected this round
                for p in expected:
                    if p not in have and self.peers[p].alive:
                        self.dropouts["deadline"] = self.dropouts.get("deadline", 0) + 1
                        _M_DROPOUT.labels(reason="deadline").inc()
                for p, peer in self.peers.items():
                    if peer.alive and membership[r, p] and sched.drop[r, p]:
                        self.dropouts["drop"] = self.dropouts.get("drop", 0) + 1
                        _M_DROPOUT.labels(reason="drop").inc()

                # the validation space: the coordinator's own hyp and the
                # responders', then the late candidates (scored for their
                # merge alpha)
                order = [0] + sorted(have)
                space = [own_buf] + [have[p][1] for p in sorted(have)]
                merge_now, stale_n = [], 0
                for sr, pid, buf in sorted(self._late_uploads, key=lambda t: (t[0], t[1])):
                    if pol.late_merge and r - sr <= max_stale:
                        merge_now.append((sr, pid, buf))
                    else:
                        stale_n += 1
                for _ in range(stale_n):
                    self.dropouts["stale"] = self.dropouts.get("stale", 0) + 1
                    _M_DROPOUT.labels(reason="stale").inc()
                self._late_uploads = []
                payload = _pack_bufs(space + [b for _, _, b in merge_now])
                self._broadcast("space", {
                    "round": r, "pids": order,
                    "late": [{"pid": p, "src_round": sr} for sr, p, _ in merge_now],
                }, payload)

                # every live shard scores the space (cheap, shape-static)
                errs0, wsum0, mis_rows = self.shard.score_space(
                    space + [b for _, _, b in merge_now]
                )
                live = {p for p, peer in self.peers.items() if peer.alive}
                err_msgs = self._collect("errs", r, live, _PHASE_TIMEOUT_S)
                for p in live - set(err_msgs):
                    self._evict(p)
                eps_rows = [errs0] + [
                    np.frombuffer(pl, dtype=np.float64) for _, (_, pl) in sorted(err_msgs.items())
                ]
                wsums = [wsum0] + [m["wsum"] for _, (m, _) in sorted(err_msgs.items())]
                eps = np.sum(eps_rows, axis=0) / max(sum(wsums), 1e-30)

                n_space = len(space)
                # float64 numpy aggregation on the coordinator's host: no device sync
                c_idx = int(np.argmin(eps[:n_space]))  # mafl: allow[host-sync] numpy on the host
                e = float(np.clip(eps[c_idx], 1e-10, 1 - 1e-10))  # mafl: allow[host-sync] numpy
                alpha = float(np.clip(  # mafl: allow[host-sync] numpy arithmetic on the host
                    np.log((1 - e) / e) + np.log(self.spec.n_classes - 1.0), -10, 10,
                ))
                chosen = self.shard.deserialize_hyp(space[c_idx])
                self.ensemble.append((chosen, alpha))
                self._vote(chosen, alpha)

                n_late = 0
                for j, (sr, pid, buf) in enumerate(merge_now):
                    lateness = r - sr
                    with trace.span("round.late_merge", round=r, src_round=sr,
                                    collaborator=pid, lateness=lateness):
                        le = float(np.clip(eps[n_space + j], 1e-10, 1 - 1e-10))  # mafl: allow[host-sync] numpy
                        base = float(np.clip(  # mafl: allow[host-sync] numpy arithmetic on the host
                            np.log((1 - le) / le) + np.log(self.spec.n_classes - 1.0), -10, 10,
                        ))
                        a_late = base * staleness_discount(gamma, lateness)
                        params = self.shard.deserialize_hyp(buf)
                        self.ensemble.append((params, a_late))
                        self._vote(params, a_late)
                        self.late_log.append({
                            "src_round": sr, "merged_round": r,
                            "collaborator": pid, "lateness": lateness,
                            "base_alpha": base, "alpha": a_late,
                        })
                        n_late += 1
                        _M_LATE_MERGES.inc()

                self._broadcast("update", {"round": r, "chosen": c_idx, "alpha": alpha})
                new_wsum = self.shard.apply_update(mis_rows[c_idx], alpha)
                live = {p for p, peer in self.peers.items() if peer.alive}
                wsum_msgs = self._collect("wsum", r, live, _PHASE_TIMEOUT_S)
                for p in live - set(wsum_msgs):
                    self._evict(p)
                total = new_wsum + sum(m["wsum"] for m, _ in wsum_msgs.values())
                self._broadcast("norm", {"round": r, "total": total})
                self.shard.renormalize(total)

                with trace.span("round.close", round=r, responders=len(order),
                                dropped=len(expected) - len(have), late=n_late,
                                deadline_hit=deadline_hit, wait_s=wait_s):
                    pass
                _M_ROUNDS.inc()

                if (r + 1) % self.args.eval_every == 0 or r == rounds - 1:
                    with trace.span("round.eval", round=r):
                        pred = torch.argmax(self._votes, dim=-1).to(torch.int32)
                        f1 = f1_macro(self.yte, pred, self.spec.n_classes)
                    self.history.append({
                        "round": r,
                        "f1": float(f1),  # mafl: allow[host-sync] once an evaluation: its output
                        "epsilon": eps[c_idx],
                        "alpha": alpha,
                        "chosen": order[c_idx],
                        "responders": len(order),
                        "late_merges": n_late,
                        "wait_s": wait_s,
                        "round_seconds": time.perf_counter() - t_round,
                    })
        self._broadcast("done", {})
        return self.history

    def summary(self) -> Dict[str, Any]:
        return {
            "rounds": self.args.rounds,
            "history": self.history,
            "dropouts": self.dropouts,
            "late": self.late_log,
            "evicted": self.evicted,
            "responders": [h["responders"] for h in self.history],
            "comm_bytes": self.comm_bytes,
            "final_f1": self.history[-1]["f1"] if self.history else 0.0,
            "device": str(self.shard.device),
        }


# ---------------------------------------------------------------------------
# Collaborator (process id >= 1)
# ---------------------------------------------------------------------------


class ElasticCollaborator:
    def __init__(self, args, policy: ParticipationPolicy, faults: FaultPlan,
                 lspec, Xs, ys, masks, *, device: str | torch.device = "cuda"):
        self.args = args
        self.pid = args.process_id
        self.policy = policy
        self.faults = faults
        self.shard = _Shard(self.pid, lspec, Xs, ys, masks, device=device, seed=args.seed)

    def _connect(self) -> socket.socket:
        host, port = self.args.coordinator.rsplit(":", 1)
        deadline = time.monotonic() + _READY_TIMEOUT_S
        while True:
            try:
                sock = socket.create_connection((host, int(port)), timeout=5.0)  # mafl: allow[host-sync] a port number
                sock.settimeout(None)  # the timeout bounds the connect, not a round's wait
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return sock
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)

    def run(self) -> None:
        sock = self._connect()
        _send_msg(sock, "hello", {"pid": self.pid})
        rounds = self.args.rounds
        sched = self.faults.schedule(rounds, self.args.num_processes)
        membership = self.policy.membership(rounds, self.args.num_processes)
        self.shard.warmup()
        _send_msg(sock, "ready", {"round": -1, "pid": self.pid})
        mis_cache: Optional[torch.Tensor] = None
        while True:
            kind, meta, payload = _recv_msg(sock)
            if kind == "done":
                break
            r = meta["round"]
            if kind == "begin":
                if not sched.alive[r, self.pid]:
                    # the injected death: drop the connection mid-round
                    # exactly as a crashed process would
                    os._exit(0)
                params = self.shard.fit_round(r)
                if (membership[r, self.pid] and not sched.drop[r, self.pid]
                        and not sched.offline[r, self.pid]):
                    d = float(sched.delay[r, self.pid])  # mafl: allow[host-sync] a numpy scalar
                    if d > 0:
                        time.sleep(d)
                    _send_msg(sock, "hyp", {"round": r, "pid": self.pid},
                              self.shard.serialize_hyp(params))
            elif kind == "space":
                errs, wsum, mis_cache = self.shard.score_space(_unpack_bufs(payload))
                _send_msg(sock, "errs", {"round": r, "pid": self.pid, "wsum": wsum},
                          errs.tobytes())
            elif kind == "update":
                new_wsum = self.shard.apply_update(mis_cache[meta["chosen"]], meta["alpha"])
                _send_msg(sock, "wsum", {"round": r, "pid": self.pid, "wsum": new_wsum})
            elif kind == "norm":
                self.shard.renormalize(meta["total"])
        sock.close()


def run_elastic_distributed(args, policy: ParticipationPolicy, faults: FaultPlan, lspec,
                            Xs, ys, masks, Xte, yte, *, device: str | torch.device = "cuda"):
    """Entry point of ``fl_run --distributed --elastic`` (spawned N times
    by ``fl_spawn``, one process per collaborator); returns ``(the
    coordinator, its history)`` on process 0 and ``(None, [])`` on the
    others."""
    if args.algorithm != "adaboost_f":
        raise NotImplementedError(
            "the elastic multi-process runtime covers adaboost_f; the other "
            "algorithms run elastically in-process (Federation.run(policy=...))"
        )
    if not isinstance(lspec, LearnerSpec):
        raise NotImplementedError("elastic distributed runs are homogeneous-only")
    if args.process_id == 0:
        coord = ElasticCoordinator(args, policy, faults, lspec, Xs, ys, masks, Xte, yte,
                                   device=device)
        return coord, coord.run()
    ElasticCollaborator(args, policy, faults, lspec, Xs, ys, masks, device=device).run()
    return None, []
