"""Carry state across from the JAX package.

The JAX state arrives as plain numpy arrays (the caller converts with
``np.asarray``), so this module needs neither JAX nor the JAX package.
With it, a test starts both sides of a comparison from the same weights,
bins and ensemble, and carries an ensemble back (``ensemble_to_numpy``).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.boosting import BoostState, Ensemble
from repro_torch.learners.binning import BinnedDataset
from repro_torch.learners.tree import TreeParams


def _t(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def tree_params_from_numpy(d: Mapping[str, np.ndarray], device="cpu") -> TreeParams:
    """``feature`` i32, ``threshold`` f32 ``[..., depth]`` and
    ``leaf_logits`` f32 ``[..., 2**depth, K]`` -> ``TreeParams``."""
    return TreeParams(
        feature=_t(d["feature"], torch.int32, device),
        threshold=_t(d["threshold"], torch.float32, device),
        leaf_logits=_t(d["leaf_logits"], torch.float32, device),
    )


def ensemble_from_numpy(d: Mapping[str, np.ndarray], device="cpu") -> Ensemble:
    """A tree ensemble as numpy arrays -> the port's ``Ensemble``.

    Keys: the tree slots ``feature [T, depth]``, ``threshold [T, depth]``,
    ``leaf_logits [T, 2**depth, K]``; ``alpha [T]`` and ``count``."""
    return Ensemble(
        params=tree_params_from_numpy(d, device),
        alpha=_t(d["alpha"], torch.float32, device),
        count=int(np.asarray(d["count"])),
    )


def ensemble_to_numpy(ens: Ensemble) -> Dict[str, np.ndarray]:
    """The reverse of :func:`ensemble_from_numpy`; ``count`` comes back as
    a 0-dim int32, as the JAX ensemble holds it."""
    out = {k: v.detach().cpu().numpy() for k, v in ens.params._asdict().items()}
    out["alpha"] = ens.alpha.detach().cpu().numpy()
    out["count"] = np.asarray(ens.count, np.int32)
    return out


def boost_state_from_numpy(d: Mapping[str, np.ndarray], device="cpu") -> BoostState:
    """A JAX AdaBoost.F state as numpy arrays -> the port's ``BoostState``.

    Keys: the ensemble's tree slots ``feature [T, depth]``, ``threshold
    [T, depth]``, ``leaf_logits [T, 2**depth, K]``; ``alpha [T]`` and
    ``count``; ``weights [C, n]``; the fit cache ``edges [C, d, B]`` and
    ``bin_idx [C, n, d]``."""
    ens = ensemble_from_numpy(d, device)
    cache = BinnedDataset(
        edges=_t(d["edges"], torch.float32, device),
        bin_idx=_t(d["bin_idx"], torch.int32, device),
    )
    return BoostState(ensemble=ens, weights=_t(d["weights"], torch.float32, device),
                      fit_cache=cache)
