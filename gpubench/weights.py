"""The weights of a cell, drawn by the benchmark from ``--seed``.

The benchmark, not the program, makes the weights, so that the plain
reference reads the same numbers the program serves and nothing the
program derived.  Their layout is the architecture's, and its reference
states it: ``refs/<config["reference"]>.py``'s ``layout(config)`` gives
each leaf's ``name`` (the port's parameter name), ``shape``, ``dtype``,
``std`` and ``drawn_cols`` (None, or the columns of the last axis that are
drawn; the rest are zero, as a padded vocabulary's are).

Each dtype's leaves are views of one buffer filled by one ``normal_``
call on the device's generator, then scaled leaf by leaf.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from gpubench.spec import reference, sub_seed


class Weights:
    """The leaves of the configuration's layout on ``device``, as views of
    one buffer a dtype; :meth:`draw` fills them from a seed in place, so
    the tensors handed to the program stay the same objects from seed to
    seed."""

    def __init__(self, config, device):
        self.config, self.device = config, torch.device(device)
        self.leaves = reference(config["reference"]).layout(config)
        sizes: Dict[torch.dtype, int] = {}
        for leaf in self.leaves:
            sizes[leaf.dtype] = sizes.get(leaf.dtype, 0) + math.prod(leaf.shape)
        self.buffers = {dt: torch.empty(n, dtype=dt, device=self.device) for dt, n in sizes.items()}
        offsets = dict.fromkeys(sizes, 0)
        self.tensors: Dict[str, torch.Tensor] = {}
        for leaf in self.leaves:
            n, at = math.prod(leaf.shape), offsets[leaf.dtype]
            self.tensors[leaf.name] = self.buffers[leaf.dtype][at:at + n].view(leaf.shape)
            offsets[leaf.dtype] = at + n

    def draw(self, seed: int) -> "Weights":
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(seed, "weights"))
        for dt in sorted(self.buffers, key=str):
            self.buffers[dt].normal_(generator=gen)
        for leaf in self.leaves:
            t = self.tensors[leaf.name]
            t.mul_(leaf.std)
            if leaf.drawn_cols is not None:
                t[..., leaf.drawn_cols:] = 0
        self.drawn = self.fingerprint()
        return self

    def fingerprint(self) -> list:
        """Each buffer's sum: the check reads it again before the reference
        runs, so weights the program changed in place are caught."""
        return [float(torch.sum(self.buffers[dt], dtype=torch.float32)) for dt in sorted(self.buffers, key=str)]
