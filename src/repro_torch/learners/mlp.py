"""A small MLP weak learner (answers to ``repro/learners/mlp.py``): the
'Neural Networks' family (the paper's §5.3 used scikit-learn's
MLPClassifier).  One tanh hidden layer, full-batch Adam on a weighted
cross-entropy; the step counter is a float32 tensor and the gradients
come from ``torch.autograd``.

``fit`` takes a leading collaborator axis natively: the C collaborators'
losses are summed, so one backward pass gives each collaborator the
gradient of its own loss, and one Adam loop trains all C.  Each fit
starts from fresh random parameters (``init`` itself gives zeros, the
ensemble's slot template): :func:`draw_init` draws them on the host from
the federation's CPU generator, one collaborator after another, and the
tests inject the JAX package's instead (``init=``).  ``warm_fit``
continues from given parameters for ``local_steps`` steps (FedAvg's local
training; FedAvg itself is ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.learners.base import LearnerSpec, WeakLearner, register


class MLPParams(NamedTuple):
    W1: torch.Tensor  # [..., d, h]
    b1: torch.Tensor  # [..., h]
    W2: torch.Tensor  # [..., h, K]
    b2: torch.Tensor  # [..., K]


def init_mlp(spec: LearnerSpec, device) -> MLPParams:
    d, h, K = spec.n_features, spec.hp("hidden", 64), spec.n_classes
    return MLPParams(torch.zeros(d, h, device=device), torch.zeros(h, device=device),
                     torch.zeros(h, K, device=device), torch.zeros(K, device=device))


def draw_init(spec: LearnerSpec, C: int, generator: torch.Generator, device) -> dict:
    """Fresh parameters for C fits, ``{"init": MLPParams [C, ...]}``:
    normal weights scaled by 1/sqrt(fan-in), zero biases, drawn on the
    host from ``generator`` (W1 then W2 for each collaborator in turn) and
    moved to ``device``, so the card and the CPU draw the same numbers."""
    d, h, K = spec.n_features, spec.hp("hidden", 64), spec.n_classes
    s1, s2 = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h)
    W1, W2 = [], []
    for _ in range(C):
        W1.append(torch.randn(d, h, generator=generator) * s1)
        W2.append(torch.randn(h, K, generator=generator) * s2)
    return {"init": MLPParams(torch.stack(W1).to(device), torch.zeros(C, h, device=device),
                              torch.stack(W2).to(device), torch.zeros(C, K, device=device))}


def _forward(p: MLPParams, X: torch.Tensor) -> torch.Tensor:
    """Logits; params and X share their leading axes ([C, ...] with [C, n, d])."""
    hidden = torch.tanh(X @ p.W1 + p.b1.unsqueeze(-2))
    return hidden @ p.W2 + p.b2.unsqueeze(-2)


def _train_mlp(params: MLPParams, X, y, w, steps: int, lr: float) -> MLPParams:
    """``steps`` full-batch Adam steps (β = 0.9, 0.999, ε = 1e-8) from
    ``params`` on the weighted cross-entropy; the weights are normalised
    per collaborator."""
    wn = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-12)
    label = y.long().unsqueeze(-1)
    p = [x.detach().clone() for x in params]
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    t = torch.zeros((), dtype=torch.float32, device=X.device)
    for _ in range(steps):
        with torch.enable_grad():
            leaves = [x.requires_grad_(True) for x in p]
            logp = torch.log_softmax(_forward(MLPParams(*leaves), X), dim=-1)
            nll = -torch.gather(logp, -1, label).squeeze(-1)
            g = torch.autograd.grad(torch.sum(wn * nll), leaves)
        with torch.no_grad():
            t = t + 1
            m = torch._foreach_add(torch._foreach_mul(m, 0.9), torch._foreach_mul(g, 0.1))
            v = torch._foreach_add(torch._foreach_mul(v, 0.999),
                                   torch._foreach_mul(torch._foreach_mul(g, g), 0.001))
            mh = torch._foreach_div(m, 1 - 0.9 ** t)
            vh = torch._foreach_div(v, 1 - 0.999 ** t)
            step = torch._foreach_div(torch._foreach_mul(mh, lr),
                                      torch._foreach_add(torch._foreach_sqrt(vh), 1e-8))
            p = torch._foreach_sub([x.detach() for x in p], step)
    return MLPParams(*p)


def _batched(fn, spec, params, X, y, w, **kw):
    """Run a [C, ...]-batched ``fn`` on one collaborator's [n, ...] inputs."""
    if X.dim() == 3:
        return fn(spec, params, X, y, w, **kw)
    if params is not None:
        params = MLPParams(*(x[None] for x in params))
    kw = {k: (MLPParams(*(x[None] for x in a)) if isinstance(a, MLPParams) else a)
          for k, a in kw.items()}
    out = fn(spec, params, X[None], y[None], w[None], **kw)
    return MLPParams(*(x[0] for x in out))


def _fit(spec, params, X, y, w, *, generator=None, init=None) -> MLPParams:
    del params
    if init is None:
        if generator is None:
            raise ValueError("mlp draws its initial parameters: pass a generator or init")
        init = draw_init(spec, X.shape[0], generator, X.device)["init"]
    return _train_mlp(init, X, y, w, spec.hp("steps", 200), spec.hp("lr", 0.05))


def fit_mlp(spec: LearnerSpec, params, X, y, w, *, generator=None, init=None) -> MLPParams:
    """A fresh MLP per fit: X [..., n, d] from ``init`` (injected) or from
    parameters drawn from ``generator``; ``params`` is ignored."""
    return _batched(_fit, spec, params, X, y, w, generator=generator, init=init)


def _warm(spec, params, X, y, w, *, generator=None):
    del generator
    return _train_mlp(params, X, y, w, spec.hp("local_steps", 20), spec.hp("lr", 0.05))


def warm_fit_mlp(spec: LearnerSpec, params, X, y, w, *, generator=None) -> MLPParams:
    """FedAvg's local training: ``local_steps`` Adam steps from ``params``."""
    return _batched(_warm, spec, params, X, y, w, generator=generator)


def mlp_logits(spec: LearnerSpec, params: MLPParams, X: torch.Tensor) -> torch.Tensor:
    """params unbatched or [H, ...]; X [..., n, d] -> [..., n, K] or [..., H, n, K]."""
    if params.W1.dim() == 3:
        X = X.unsqueeze(-3)
    return _forward(params, X)


mlp = register(WeakLearner("mlp", init_mlp, fit_mlp, mlp_logits, warm_fit=warm_fit_mlp,
                           draw=draw_init))
