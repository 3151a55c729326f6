"""The closed-loop generator: one client sends its next request-batch when
the last one has finished.  A mix (``traffic/<name>.json``) that names it
(``"generator": "closed_loop"``) says:

* ``loop``: ``closed``, and ``clients``: 1;
* ``batch``: rows a request-batch, all of one length;
* ``prompt``: the rows' text lengths: ``{"dist": "fixed", "value": n}``,
  or ``{"dist": "loguniform", "min", "max", "multiple", "block"}``: a block
  of ``block`` lengths at the quantiles ``i / (block - 1)`` of the
  log-uniform law between ``min`` and ``max``, each rounded to a multiple
  of ``multiple`` and cut to ``clip`` where given (a model's context);
  every block is the same lengths in an order drawn from the seed, so
  every seed serves the same work (a window ends with the block in
  progress);
* ``decode_steps``: greedy decode steps after the prefill (0: the prefill's
  first token ends the request);
* whatever the configuration's reference reads to draw a request's
  inputs (``refs/<reference>.py``'s ``inputs``: a VLM's ``prefix_std``);
* ``check``: ``rows``, how many finished rows the output check compares
  (the longest among them), and the window ``rehearse_seconds`` that the
  rehearsal of the check runs.

A batch's inputs are drawn on the device from the seed and the batch's
index, so the check draws the same inputs again after the window.
"""
from __future__ import annotations

import math
import random
import time
from typing import Callable, Dict, List

import torch
from torch.profiler import record_function

from gpubench.spec import reference, sub_seed


def block_lengths(prompt) -> List[int]:
    if prompt["dist"] == "fixed":
        return [int(prompt["value"])]
    if prompt["dist"] == "loguniform":
        lo, hi, m, n = prompt["min"], prompt["max"], prompt["multiple"], prompt["block"]
        out = []
        for i in range(n):
            x = math.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * i / (n - 1))
            out.append(int(min(prompt.get("clip", hi), max(lo, m * round(x / m)))))
        return out
    raise ValueError(f"unknown prompt dist {prompt['dist']!r}")


class Traffic:
    def __init__(self, spec, config, seed: int, device):
        if spec.get("loop") != "closed" or int(spec.get("clients", 1)) != 1:
            raise ValueError("the closed-loop generator drives one closed-loop client")
        self.spec, self.config, self.seed, self.device = spec, config, seed, torch.device(device)
        self.ref = reference(config["reference"])
        self.block = block_lengths(spec["prompt"])
        self.batch = int(spec["batch"])
        self.steps = int(spec.get("decode_steps", 0))

    def shapes(self) -> List[int]:
        """The distinct text lengths the mix sends (the shapes to warm)."""
        return sorted(set(self.block))

    def length(self, index: int) -> int:
        b, i = divmod(index, len(self.block))
        order = list(range(len(self.block)))
        random.Random(sub_seed(self.seed, "order", b)).shuffle(order)
        return self.block[order[i]]

    def positions(self, index: int, length: int = 0) -> int:
        """A row's prefill positions (a VLM's prefix and the text)."""
        return self.ref.positions(self.config, length or self.length(index))

    def inputs(self, index: int, length: int = 0, tag: str = "batch") -> Dict[str, torch.Tensor]:
        """Batch ``index``'s inputs on the device, as the reference draws
        them.  ``length`` and ``tag`` draw a batch outside the schedule (the
        warm-up's)."""
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, tag, index))
        return self.ref.inputs(self.config, self.spec, self.batch, length or self.length(index), gen, self.device)


def window(traffic: Traffic, send: Callable[[int], object], sync: Callable[[], None], seconds: float,
           start: int = 0):
    """Send batches ``start``, ``start + 1``, ... one after the other until
    ``seconds`` have passed and the block of lengths in progress is
    complete (so every window serves each of the mix's lengths equally
    often; at least one block: ``seconds`` 0 serves one).  ``start`` is a
    multiple of the block.  Returns (batches, window seconds)."""
    batches = []
    with record_function("window"):
        t0 = time.perf_counter()
        while not batches or time.perf_counter() - t0 < seconds or len(batches) % len(traffic.block):
            batches.append(send(start + len(batches)))
        sync()
        window_s = time.perf_counter() - t0
    return batches, window_s
