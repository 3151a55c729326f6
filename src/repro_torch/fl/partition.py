"""Federated data partitioning (answers to ``repro/fl/partition.py``): the
IID split (the paper's evaluation setting) and the Dirichlet label-skew
split.

Output layout is collaborator-stacked fixed shapes [C, n_local, ...] with
a mask; a Dirichlet split pads every shard to the largest one with zero
rows whose mask is 0.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

def iid_partition(
    X: torch.Tensor, y: torch.Tensor, n_collaborators: int, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform random split into equal chunks: (X [C, n, d], y [C, n], mask [C, n])."""
    n = X.shape[0]
    per = n // n_collaborators
    perm = torch.randperm(n, generator=generator)[: per * n_collaborators].to(X.device)
    Xs = X[perm].reshape(n_collaborators, per, -1)
    ys = y[perm].reshape(n_collaborators, per)
    mask = torch.ones(n_collaborators, per, dtype=torch.float32, device=X.device)
    return Xs, ys, mask


def dirichlet_partition(
    X: torch.Tensor,
    y: torch.Tensor,
    n_collaborators: int,
    *,
    alpha: float = 0.5,
    n_classes: int | None = None,
    seed: int | None = None,
    generator: torch.Generator | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Label-skew non-IID split: class c's samples are divided among the
    collaborators by Dirichlet(alpha) proportions, every shard padded to
    the largest one (zero rows, mask 0).

    The draws come from a numpy ``default_rng(seed)``.  ``seed`` is the one
    integer the JAX package draws with ``jax.random.randint`` to seed its
    generator: given it, this function returns the JAX package's split
    exactly, since the numpy code is the same.  Without it, the integer is
    drawn from ``generator`` (in ``[0, 2**31 - 1)``, as the JAX package's).

    Every collaborator gets at least one sample: a draw that leaves a
    shard empty is redrawn up to 20 times, then single samples move from
    the largest shards to the empty ones.  More collaborators than
    samples raises ``ValueError``."""
    if len(y) < n_collaborators:
        raise ValueError(
            f"cannot give each of {n_collaborators} collaborators a sample "
            f"from {len(y)} total"
        )
    if seed is None:
        if generator is None:
            raise ValueError("dirichlet_partition draws its seed: pass a generator or a seed")
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    Xn, yn = X.cpu().numpy(), y.cpu().numpy()
    K = n_classes or int(yn.max()) + 1
    rng = np.random.default_rng(seed)

    def draw() -> np.ndarray:
        owners = np.empty(len(yn), dtype=np.int64)
        for c in range(K):
            idx = np.where(yn == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * n_collaborators)
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx, cuts)):
                owners[part] = i
        return owners

    owners = draw()
    for _ in range(20):  # redraw while any collaborator is empty
        if np.bincount(owners, minlength=n_collaborators).min() > 0:
            break
        owners = draw()
    counts = np.bincount(owners, minlength=n_collaborators)
    for i in np.where(counts == 0)[0]:  # repair: move one sample from the richest
        donor = int(np.argmax(counts))
        owners[np.where(owners == donor)[0][0]] = i
        counts = np.bincount(owners, minlength=n_collaborators)
    if counts.min() == 0:
        raise RuntimeError("dirichlet_partition produced an empty collaborator")
    n_max = max(int(counts.max()), 1)
    Xs = np.zeros((n_collaborators, n_max, Xn.shape[1]), Xn.dtype)
    ys = np.zeros((n_collaborators, n_max), yn.dtype)
    mask = np.zeros((n_collaborators, n_max), np.float32)
    for i in range(n_collaborators):
        idx = np.where(owners == i)[0]
        Xs[i, : len(idx)] = Xn[idx]
        ys[i, : len(idx)] = yn[idx]
        mask[i, : len(idx)] = 1.0
    return (torch.from_numpy(Xs).to(X.device), torch.from_numpy(ys).to(X.device),
            torch.from_numpy(mask).to(X.device))


def partition(name: str, X, y, n_collaborators: int, generator: torch.Generator, **kw):
    """The split named ``name`` (``"iid"`` or ``"dirichlet"``; ``kw`` goes
    to :func:`dirichlet_partition`); an unknown name raises ``KeyError``."""
    if name == "iid":
        return iid_partition(X, y, n_collaborators, generator)
    if name == "dirichlet":
        return dirichlet_partition(X, y, n_collaborators, generator=generator, **kw)
    raise KeyError(f"unknown partitioner {name!r}")
