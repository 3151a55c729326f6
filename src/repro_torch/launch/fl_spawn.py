"""Local launcher for the port's process-per-collaborator runtime
(answers to ``repro/launch/fl_spawn.py``): spawns N ``fl_run
--distributed`` processes of ``repro_torch`` with the coordinator wiring
(a cluster launch runs one ``fl_run --distributed`` per node with the same
flags pointed at a shared coordinator address).

  # 4 collaborators = 4 OS processes sharing the card:
  PYTHONPATH=src python -m repro_torch.launch.fl_spawn --num-processes 4 -- \
      --dataset adult --rounds 20 --eval-every 5
  # the same on the CPU
  PYTHONPATH=src python -m repro_torch.launch.fl_spawn -n 4 -- --device cpu \
      --dataset vehicle --rounds 5

Everything after ``--`` is passed through to ``fl_run`` on every
process unchanged (``--device`` among it: the processes run on the card
unless it says ``cpu``); the launcher injects ``--distributed``, the
coordinator address (a free localhost port), per-process ids, and forces
``--collaborators N`` (process-per-collaborator).  The children import
the ``repro_torch`` this launcher was imported from.  Process 0 — the
coordinator: eval, history, checkpoints — streams to this terminal;
the other processes log to temp files whose tails are printed on
failure.  ``--min-f1 X`` turns the launcher into a convergence
assertion (non-zero exit unless process 0 reports ``final F1 >= X``).
"""
from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

SRC = str(Path(__file__).resolve().parents[2])  # the directory holding repro_torch


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Optional[str], n: int = 2000) -> str:
    if path is None:
        return ""
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return "<log unreadable>"


def _join_all(
    procs: List[subprocess.Popen],
    log_paths: List[Optional[str]],
    *,
    timeout: float,
    grace: float = 60.0,
    out_lines: Optional[List[str]] = None,
    stream=None,
) -> List[int]:
    """Join the process group with a hard deadline.

    Process 0's stdout (a pipe) is drained on a thread so a wedged
    process can never block the launcher on a ``readline`` — the old
    launcher hung forever on exactly that.  After process 0 exits, the
    orphans get ``grace`` seconds to finish; on ANY deadline the
    stragglers' log tails are printed FIRST (the evidence), then the
    whole group is killed and every timed-out slot reports exit code
    124."""
    stream = stream if stream is not None else sys.stdout

    def _drain():
        for line in procs[0].stdout:  # type: ignore[union-attr]
            stream.write(line)
            stream.flush()
            if out_lines is not None:
                out_lines.append(line)

    drainer = None
    if procs[0].stdout is not None:
        drainer = threading.Thread(target=_drain, daemon=True)
        drainer.start()

    deadline = time.monotonic() + timeout
    rcs: List[Optional[int]] = [None] * len(procs)

    def _await(i: int, until: float) -> None:
        if rcs[i] is None:
            try:
                rcs[i] = procs[i].wait(timeout=max(until - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                pass

    _await(0, deadline)
    # once the coordinator is done (or timed out), orphans get a short
    # grace window, never the full budget again
    until = min(deadline, time.monotonic() + grace) if rcs[0] is not None else \
        time.monotonic()
    for i in range(1, len(procs)):
        _await(i, until)

    hung = [i for i, rc in enumerate(rcs) if rc is None]
    if hung:
        for i in hung:  # tails first, then kill: keep the evidence
            print(f"--- process {i} hung past the deadline; log tail ---\n"
                  f"{_tail(log_paths[i]) or '<streamed to stdout>'}",
                  file=sys.stderr)
        for i in hung:
            procs[i].kill()
        for i in hung:
            try:
                procs[i].wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass
            rcs[i] = 124
    if drainer is not None:
        drainer.join(timeout=10.0)
    return [rc if rc is not None else 124 for rc in rcs]


def spawn(
    num_processes: int,
    run_args: List[str],
    *,
    timeout: float = 1800.0,
    min_f1: Optional[float] = None,
    python: str = sys.executable,
) -> int:
    """Launch the process group and wait; returns the exit code (0 = every
    process succeeded and the --min-f1 assertion, if any, held)."""
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ)
    paths = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if SRC not in paths:
        env["PYTHONPATH"] = os.pathsep.join([SRC, *paths])

    procs, logs = [], []
    for i in range(num_processes):
        cmd = [
            python, "-m", "repro_torch.launch.fl_run", "--distributed",
            "--coordinator", coord,
            "--num-processes", str(num_processes), "--process-id", str(i),
            *run_args,
            "--collaborators", str(num_processes),  # last flag wins in argparse
        ]
        if i == 0:
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ))
            logs.append(None)
        else:
            logf = tempfile.NamedTemporaryFile(
                "w+", prefix=f"fl_spawn_p{i}_", suffix=".log", delete=False
            )
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=logf, stderr=subprocess.STDOUT, text=True,
            ))
            logs.append(logf)

    # stream the coordinator's output live while joining with a deadline
    out_lines: List[str] = []
    try:
        rcs = _join_all(
            procs, [f.name if f is not None else None for f in logs],
            timeout=timeout, out_lines=out_lines,
        )
    except KeyboardInterrupt:
        for p in procs:
            p.kill()
        print("fl_spawn: interrupted; killed the process group", file=sys.stderr)
        return 124
    finally:
        for f in logs:
            if f is not None:
                f.close()

    rc = max(rcs)
    if rc != 0:
        for i, (r, f) in enumerate(zip(rcs, logs)):
            if r != 0 and f is not None:
                tail = _tail(f.name)
                print(f"--- process {i} exited {r}; log tail ---\n{tail}",
                      file=sys.stderr)
    for f in logs:
        if f is not None:
            os.unlink(f.name)

    if rc == 0 and min_f1 is not None:
        m = re.search(r"final F1 (\d+\.\d+)", "".join(out_lines))
        if m is None:
            print("fl_spawn: --min-f1 set but process 0 printed no 'final F1'",
                  file=sys.stderr)
            return 3
        if float(m.group(1)) < min_f1:
            print(f"fl_spawn: final F1 {m.group(1)} < required {min_f1}",
                  file=sys.stderr)
            return 4
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.fl_spawn",
        description="spawn N local fl_run --distributed processes "
                    "(args after -- go to fl_run)")
    ap.add_argument("--num-processes", "-n", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds before the whole process group is killed")
    ap.add_argument("--min-f1", type=float, default=None,
                    help="fail unless process 0's 'final F1' meets this floor")
    ap.add_argument("run_args", nargs=argparse.REMAINDER,
                    help="-- then fl_run flags (e.g. -- --dataset adult --rounds 20)")
    args = ap.parse_args(argv)
    run_args = args.run_args
    if run_args and run_args[0] == "--":
        run_args = run_args[1:]
    return spawn(args.num_processes, run_args,
                 timeout=args.timeout, min_f1=args.min_f1)


if __name__ == "__main__":
    sys.exit(main())
