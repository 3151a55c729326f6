"""Checkpointing: a tree of tensors <-> ``.npz`` + a ``.json`` manifest,
the port's copy of ``repro/checkpoint.py``.

The files are the JAX package's: ``leaf_{i}`` arrays in the tree's flatten
order and a manifest that keeps ``n_leaves``.  A tree is nested dicts
(flattened in sorted key order, as ``jax.tree`` flattens them), lists,
tuples and NamedTuples, ``nn.Module``s (their parameters in registration
order) and leaves: tensors, numpy arrays and Python numbers.  A
``models.model.TrainState`` is such a tree.

numpy has no bfloat16, so a bfloat16 leaf is stored as its ``uint16`` bits
and the manifest keeps each leaf's dtype: it comes back bit for bit.
(The JAX package writes such a leaf as numpy's ``V2`` and cannot read it
back.)
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, List, Tuple

import numpy as np
import torch
from torch import nn

def _flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves, rebuild) where ``rebuild(new_leaves)`` puts new leaves in
    the same places; a module takes its new values in place."""
    if isinstance(tree, nn.Module):
        params = [p for _, p in tree.named_parameters()]

        def rebuild_module(new):
            with torch.no_grad():
                for p, x in zip(params, new):
                    p.copy_(x)
            return tree

        return params, rebuild_module
    if isinstance(tree, dict):
        keys = sorted(tree)
        return _flatten_seq([tree[k] for k in keys], lambda vals: type(tree)(zip(keys, vals)))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return _flatten_seq(list(tree), lambda vals: type(tree)(*vals))
    if isinstance(tree, (list, tuple)):
        return _flatten_seq(list(tree), type(tree))
    return [tree], lambda new: new[0]


def _flatten_seq(items: List[Any], make: Callable[[List[Any]], Any]):
    parts = [_flatten(x) for x in items]
    leaves = [leaf for p_leaves, _ in parts for leaf in p_leaves]

    def rebuild(new):
        out, i = [], 0
        for p_leaves, p_rebuild in parts:
            out.append(p_rebuild(new[i:i + len(p_leaves)]))
            i += len(p_leaves)
        return make(out)

    return leaves, rebuild


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:  # its bits, as numpy has no bfloat16
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    a = np.asarray(leaf)
    return a, str(a.dtype)


def save_checkpoint(tree: Any, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, _ = _flatten(tree)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"], dtype = _to_numpy(leaf)
        dtypes.append(dtype)
    np.savez(path.with_suffix(".npz"), **arrays)
    path.with_suffix(".json").write_text(json.dumps({"n_leaves": len(leaves), "dtypes": dtypes}))


def load_checkpoint(like: Any, path: str | Path) -> Any:
    """Restore into the structure of ``like`` (shape-checked; each leaf
    takes the dtype and device of ``like``'s leaf)."""
    path = Path(path)
    data = np.load(path.with_suffix(".npz"))
    dtypes = json.loads(path.with_suffix(".json").read_text()).get("dtypes")
    leaves, rebuild = _flatten(like)
    out = []
    for i, ref in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) else np.shape(ref)
        if tuple(arr.shape) != shape:
            raise ValueError(f"leaf {i}: checkpoint {arr.shape} != expected {shape}")
        if not isinstance(ref, torch.Tensor):
            out.append(np.asarray(arr, dtype=np.asarray(ref).dtype) if isinstance(ref, np.ndarray)
                       else type(ref)(arr))
            continue
        if dtypes and dtypes[i] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))  # a copy, C-ordered, 0-dim kept
        out.append(t.to(device=ref.device, dtype=ref.dtype))
    return rebuild(out)
