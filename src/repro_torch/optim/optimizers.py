"""AdamW with a cosine schedule and global-norm clipping: the port's copy
of ``repro/optim/optimizers.py``.

Parameters, gradients and moments are dicts of tensors keyed by parameter
name; the global norm sums the leaves in the dicts' order, which
``models/model.py`` makes the JAX package's leaf order.  The moments are
float32; each update casts a parameter to float32, updates it and casts it
back, as the JAX package does.  The update writes the moments and the
parameters in place: a ``TrainState`` is consumed by the step that
advances it.

``step`` is a device int32 scalar.  The learning rate and the bias
corrections are float32 values read from tables indexed by it, so a step
reads nothing back to the host.  The tables are computed on the host in
float32 as XLA compiles the JAX expressions (``schedule_table``), with the
C library's ``cosf``, ``powf`` and ``fmaf``, the functions XLA's CPU
backend calls for ``jnp.cos``, ``**`` and a fused multiply-add: ``torch.cos`` and ``torch.pow`` round 19 of the
306 cosines of a 300-step schedule and 5 of 306 powers differently.  The
tables equal the jitted JAX step's values to the bit.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor  # scalar int32 on the parameters' device
    mu: Tree  # first moment (f32, param-shaped)
    nu: Tree  # second moment (f32, param-shaped)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


def init_adamw(params: Tree) -> AdamWState:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
    device = next(iter(params.values())).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device), zeros,
                      {k: z.clone() for k, z in zeros.items()})


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name, n_args in (("cosf", 1), ("powf", 2), ("fmaf", 3)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float] * n_args
    return lib


@functools.lru_cache(maxsize=None)
def schedule_table(cfg: AdamWConfig) -> np.ndarray:
    """The learning rate at steps ``0 .. L - 1`` (float32), where ``L - 1``
    is the first step from which it stays constant: the JAX ``_schedule``
    as XLA compiles it into the jitted step, operation for operation.  XLA
    turns each division by a constant into a product with the constant's
    float32 reciprocal, folds ``0.9 * 0.5`` into ``0.45``, and its CPU
    backend fuses ``(cos + 1) * 0.45 + 0.1`` into one multiply-add."""
    f = np.float32
    s = np.arange(max(cfg.total_steps, cfg.warmup_steps) + 2, dtype=np.float32)
    warm = np.minimum(s * (f(1) / f(max(cfg.warmup_steps, 1))), f(1.0))
    prog = np.clip((s - f(cfg.warmup_steps)) * (f(1) / f(max(cfg.total_steps - cfg.warmup_steps, 1))),
                   f(0.0), f(1.0))
    libm = _libm()
    cos = np.array([libm.cosf(a) for a in prog * f(math.pi)], np.float32)
    half_range = f(0.9) * f(0.5)
    return (warm * f(cfg.lr)) * np.array([libm.fmaf(c, half_range, f(0.1)) for c in cos + f(1.0)],
                                         np.float32)


@functools.lru_cache(maxsize=None)
def bias_table(b: float) -> np.ndarray:
    """``1 - b ** n`` in float32 for ``n = 0 .. N``, where from ``N`` on
    ``b ** n <= 2**-25`` and the value stays ``1.0``."""
    if not 0.0 <= b < 1.0:
        raise ValueError(f"AdamW betas must lie in [0, 1), got {b}")
    powf, out, n = _libm().powf, [], 0
    while True:
        p = powf(np.float32(b), float(n))
        out.append(np.float32(1.0) - np.float32(p))
        if p <= 2.0 ** -25:
            return np.array(out, np.float32)
        n += 1


@functools.lru_cache(maxsize=None)
def _on(table_fn, arg, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(table_fn(arg)).to(device)


def clear_tables() -> None:
    """Drop the tables built for each device: a pass over fake tensors (the
    dry-run's) builds fake ones, which must not outlive it."""
    _on.cache_clear()


def _lookup(table: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """``table[min(step, len - 1)]`` as a 0-dim tensor, read on the device."""
    return torch.take(table, step.clamp(max=table.numel() - 1).long())


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    return _lookup(_on(schedule_table, cfg, step.device), step)


def global_norm(tree: Tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in tree.values())
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, params: Tree, grads: Tree, state: AdamWState
) -> Tuple[Tree, AdamWState, torch.Tensor]:
    """Clip, then one AdamW step; returns (params, state, grad norm), the
    parameters and moments updated in place."""
    gnorm = global_norm(grads)
    # cfg.clip_norm / max(gnorm, 1e-9): a true division (``float / tensor``
    # multiplies by the reciprocal)
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm) / torch.clamp_min(gnorm, 1e-9), max=1.0)
    step = state.step + 1
    lr = _schedule(cfg, step)
    b1t = _lookup(_on(bias_table, cfg.b1, step.device), step)
    b2t = _lookup(_on(bias_table, cfg.b2, step.device), step)
    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = state.mu[k], state.nu[k]
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        del g
        denom = (v / b2t).sqrt_().add_(cfg.eps)
        pf = p.float()
        delta = (m / b1t).div_(denom).add_(pf * cfg.weight_decay)
        del denom
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(pf.sub_(delta.mul_(lr)))
    return params, AdamWState(step, state.mu, state.nu), gnorm
