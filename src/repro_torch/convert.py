"""Carry state across from the JAX package.

The JAX state arrives as plain numpy arrays (the caller converts with
``np.asarray``), so this module needs neither JAX nor the JAX package.
With it, a test starts both sides of a comparison from the same weights,
bins and ensemble, carries an ensemble back (``ensemble_to_numpy``), and
starts the port's decode from a JAX prefill's state (``caches_from_numpy``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.boosting import BoostState, Ensemble
from repro_torch.device import resolve_device
from repro_torch.learners.binning import BinnedDataset
from repro_torch.learners.centroid import CentroidParams
from repro_torch.learners.linear import RidgeParams
from repro_torch.learners.mlp import MLPParams
from repro_torch.learners.naive_bayes import GNBParams
from repro_torch.learners.tree import TreeParams

# each learner's parameter type; its fields are the JAX NamedTuple's, in order
PARAMS = {
    "decision_tree": TreeParams, "extra_tree": TreeParams, "ridge": RidgeParams,
    "gaussian_nb": GNBParams, "nearest_centroid": CentroidParams, "mlp": MLPParams,
}


def _t(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=resolve_device(device))


def tree_params_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> TreeParams:
    """``feature`` i32, ``threshold`` f32 ``[..., depth]`` and
    ``leaf_logits`` f32 ``[..., 2**depth, K]`` -> ``TreeParams``."""
    return TreeParams(
        feature=_t(d["feature"], torch.int32, device),
        threshold=_t(d["threshold"], torch.float32, device),
        leaf_logits=_t(d["leaf_logits"], torch.float32, device),
    )


def params_from_numpy(learner: str, d: Mapping[str, np.ndarray], device="cuda"):
    """One learner's parameters as numpy arrays, keyed by field name (any
    leading hypothesis or collaborator axes) -> its parameter type:
    ``ridge`` ``W``; ``gaussian_nb`` ``log_prior``, ``mean``, ``var``;
    ``nearest_centroid`` ``centroid``, ``log_prior``; ``mlp`` ``W1``,
    ``b1``, ``W2``, ``b2``; the trees' fields as :func:`tree_params_from_numpy`
    takes them.
    Integer arrays become int32 tensors, the rest float32."""
    cls = PARAMS[learner]

    def leaf(a):
        a = np.asarray(a)
        return _t(a, torch.int32 if np.issubdtype(a.dtype, np.integer) else torch.float32, device)

    return cls(*(leaf(d[f]) for f in cls._fields))


def ensemble_from_numpy(d: Mapping[str, np.ndarray], device="cuda",
                        learner: str = "decision_tree") -> Ensemble:
    """An ensemble as numpy arrays -> the port's ``Ensemble``.

    Keys: ``learner``'s parameter fields with a leading slot axis (the
    trees: ``feature [T, depth]``, ``threshold [T, depth]``, ``leaf_logits
    [T, 2**depth, K]``; a DistBoost.F committee ensemble adds a ``[T, C]``
    lead), ``alpha [T]`` and ``count``."""
    return Ensemble(
        params=params_from_numpy(learner, d, device),
        alpha=_t(d["alpha"], torch.float32, device),
        count=int(np.asarray(d["count"])),
    )


def hetero_ensemble_from_numpy(groups: Sequence[Mapping[str, np.ndarray]], learners: Sequence[str],
                               device="cuda") -> Tuple[Ensemble, ...]:
    """A heterogeneous ensemble (the JAX package's tuple of per-group
    ensembles) as numpy arrays, one mapping per group with its learner's
    key in ``learners`` -> the port's group tuple."""
    return tuple(ensemble_from_numpy(d, device, name) for d, name in zip(groups, learners))


def ensemble_to_numpy(ens: Ensemble) -> Dict[str, np.ndarray]:
    """The reverse of :func:`ensemble_from_numpy`; ``count`` comes back as
    a 0-dim int32, as the JAX ensemble holds it."""
    out = {k: v.detach().cpu().numpy() for k, v in ens.params._asdict().items()}
    out["alpha"] = ens.alpha.detach().cpu().numpy()
    out["count"] = np.asarray(ens.count, np.int32)
    return out


def boost_state_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> BoostState:
    """A JAX boosting state as numpy arrays -> the port's ``BoostState``.

    Keys: the ensemble's tree slots ``feature [T, depth]``, ``threshold
    [T, depth]``, ``leaf_logits [T, 2**depth, K]`` (a DistBoost.F state's
    committee slots carry a ``[T, C, ...]`` lead); ``alpha [T]`` and
    ``count``; ``weights [C, n]``; the fit cache ``edges [C, d, B]`` and
    ``bin_idx [C, n, d]``."""
    ens = ensemble_from_numpy(d, device)
    cache = BinnedDataset(
        edges=_t(d["edges"], torch.float32, device),
        bin_idx=_t(d["bin_idx"], torch.int32, device),
    )
    return BoostState(ensemble=ens, weights=_t(d["weights"], torch.float32, device),
                      fit_cache=cache)


def _assign(targets: Dict[str, torch.Tensor], tree: Mapping, cfg: ArchConfig) -> None:
    """Copy a JAX params-shaped tree into ``targets`` (port parameter name
    -> tensor): ``embed`` and ``final_norm`` by name, port layer ``r`` from
    ``unit["L{r % p}"]`` at slice ``r // p`` (``p`` layers a unit), and an
    audio model's encoder layer ``i`` from ``encoder["unit"]`` (single-layer
    dicts stacked ``[encoder_layers, ...]``) at slice ``i``.  A norm's array
    goes to its ``.gamma``.  Every target must be assigned, each with its
    own shape."""
    period = len(cfg.pattern()[0])
    assigned = set()

    def put(prefix: str, sub: Mapping, index=None) -> None:
        for name, leaf in sub.items():
            full = f"{prefix}{name}"
            if isinstance(leaf, Mapping):
                put(full + ".", leaf, index)
                continue
            if full + ".gamma" in targets:
                full += ".gamma"
            if full not in targets:
                raise ValueError(f"{full}: no counterpart in the port")
            target = targets[full]
            a = np.asarray(leaf if index is None else leaf[index], np.float32)
            if tuple(a.shape) != tuple(target.shape):
                raise ValueError(f"{full}: shape {a.shape} != the port's {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.tensor(a))
            assigned.add(full)

    put("", {"embed": tree["embed"], "final_norm": tree["final_norm"]})
    for r in range(cfg.n_layers):
        put(f"layers.{r}.", tree["unit"][f"L{r % period}"], r // period)
    if "encoder" in tree:
        put("encoder.", {"final_norm": tree["encoder"]["final_norm"]})
        for i in range(cfg.encoder_layers):
            put(f"encoder.layers.{i}.", tree["encoder"]["unit"], i)
    missing = set(targets) - assigned
    if missing:
        raise ValueError(f"parameters with no counterpart in the tree: {sorted(missing)}")


def model_params_from_numpy(cfg: ArchConfig, tree: Mapping, device="cuda"):
    """A JAX model's params pytree as numpy -> the port's ``Transformer``.

    ``tree`` is ``repro.models.transformer.init_params``'s layout:
    ``embed`` (``embedding``, and ``unembed`` unless tied), ``final_norm``,
    and ``unit``, whose ``L{i}`` leaves (one per layer of the repeating
    unit of ``p`` layers) are stacked ``[n_layers // p, ...]``: port layer
    ``r`` takes ``unit["L{r % p}"]`` at slice ``r // p``.  An MoE layer's
    ``ffn`` holds ``router [d, E]``, ``w_gate``/``w_up [E, d, ff]`` and
    ``w_down [E, ff, d]``, carried across by the same names, and so is a
    recurrent layer's ``mixer`` (``models/ssm.py``: Mamba's ``in_proj``,
    ``conv_w``, ``x_proj``, ``dt_proj``, ``dt_bias``, ``A_log``, ``D``,
    ``out_proj``; the mLSTM's ``up_proj``, ``wq``, ``wk``, ``wv``, ``w_if``,
    ``b_if``, ``down_proj``; the sLSTM's ``w_x``, ``r_h``, ``b``,
    ``w_ff_up``, ``w_ff_down``).  A layer without an FFN (``ffn ==
    "none"``) has no ``norm2`` on either side.  gemma2's ``post_norm1`` and
    ``post_norm2``, an audio decoder layer's ``cross`` (an attention's
    ``wq``, ``wk``, ``wv``, ``wo``) and ``norm_cross``, and an audio
    model's ``encoder`` (``unit``, ``final_norm``) map by name too."""
    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, torch.Generator(device=resolve_device(device)).manual_seed(0))
    _assign(dict(model.named_parameters()), tree, cfg)
    return model


def train_state_from_numpy(cfg: ArchConfig, params_tree: Mapping, opt_tree, device="cuda"):
    """A JAX ``TrainState`` as numpy -> the port's ``TrainState``:
    ``params_tree`` as :func:`model_params_from_numpy` takes it, and the
    JAX ``AdamWState`` (or a mapping) with ``step`` and the float32 moments
    ``mu``, ``nu`` in the parameters' layout."""
    from repro_torch.models.model import TrainState, param_tree
    from repro_torch.optim.optimizers import AdamWState

    model = model_params_from_numpy(cfg, params_tree, device)
    params = param_tree(model)
    step, mu, nu = (opt_tree[k] if isinstance(opt_tree, Mapping) else getattr(opt_tree, k)
                    for k in ("step", "mu", "nu"))

    def moments(tree: Mapping) -> Dict[str, torch.Tensor]:
        out = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
        _assign(out, tree, cfg)
        return out

    return TrainState(model, AdamWState(_t(step, torch.int32, device), moments(mu), moments(nu)))


def caches_from_numpy(cfg: ArchConfig, caches: Mapping, device="cuda") -> list:
    """A JAX prefill's caches (``ServeState.caches``: ``L{i}`` -> a layer
    state whose leaves are numpy arrays stacked ``[R, ...]`` over the
    unit's repeats) -> the port's per-layer list: layer ``r`` takes
    ``L{r % p}`` at slice ``r // p``, as the port's class of the JAX
    state's name (``MambaState``, ``MLSTMState``, ``SLSTMState`` or an
    attention ``LayerCache``); an audio layer's (self, cross) pair as a
    pair.  The recurrent states stay float32; Mamba's ``conv`` and the K/V
    take the activation type."""
    from repro_torch.models import attention, ssm
    from repro_torch.models.layers import pdtype

    def one(state, i: int):
        if not hasattr(state, "_asdict"):  # an audio layer's (self, cross) pair
            return tuple(one(s, i) for s in state)
        name = type(state).__name__
        cls = attention.LayerCache if name == "LayerCache" else getattr(ssm, name)
        return cls(**{f: _t(np.asarray(a, np.float32)[i], pdtype(cfg) if f in ("conv", "k", "v") else torch.float32,
                            device)
                      for f, a in state._asdict().items()})

    period = len(cfg.pattern()[0])
    return [one(caches[f"L{r % period}"], r // period) for r in range(cfg.n_layers)]
