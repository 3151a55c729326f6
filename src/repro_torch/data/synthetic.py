"""Synthetic analogues of the paper's ten evaluation datasets (answers to
``repro/data/synthetic.py``).

Each dataset is replaced by a generator matched in (n_samples,
n_features, n_classes): Gaussian class clusters on a random low-rank
manifold, a random linear embedding, feature noise and label flips.  The
draws come from a ``torch.Generator`` on the CPU, so the same seed gives
the same data whatever device the run uses; they differ from the JAX
package's ``jax.random`` draws by construction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_train: int
    n_test: int
    n_features: int
    n_classes: int
    n_clusters_per_class: int = 2
    class_sep: float = 1.2
    label_noise: float = 0.05


# (n_train, n_test, d, K) as in the JAX package's table.
PAPER_DATASETS: Dict[str, DatasetSpec] = {
    "adult": DatasetSpec("adult", 32561, 16281, 14, 2, class_sep=1.0, label_noise=0.12),
    "forestcover": DatasetSpec("forestcover", 50000, 10000, 54, 2, class_sep=0.9, label_noise=0.10),
    "kr-vs-kp": DatasetSpec("kr-vs-kp", 2557, 639, 36, 2, class_sep=1.8, label_noise=0.01),
    "splice": DatasetSpec("splice", 2552, 638, 61, 3, class_sep=1.4, label_noise=0.03),
    "vehicle": DatasetSpec("vehicle", 677, 169, 18, 4, class_sep=1.1, label_noise=0.05),
    "segmentation": DatasetSpec("segmentation", 209, 2101, 19, 7, class_sep=1.5, label_noise=0.02),
    "sat": DatasetSpec("sat", 4435, 2000, 36, 8, class_sep=1.2, label_noise=0.04),
    "pendigits": DatasetSpec("pendigits", 7494, 3498, 16, 10, class_sep=1.4, label_noise=0.02),
    "vowel": DatasetSpec("vowel", 792, 198, 10, 11, class_sep=1.0, label_noise=0.05),
    "letter": DatasetSpec("letter", 16000, 4000, 16, 26, class_sep=1.0, label_noise=0.03),
}


def make_classification(
    spec: DatasetSpec, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(X_train, y_train, X_test, y_test) on the CPU, features standardized
    with train statistics; X f32, y int32."""
    g = generator
    n = spec.n_train + spec.n_test
    K, d, Q = spec.n_classes, spec.n_features, spec.n_clusters_per_class

    informative = max(2, min(d, math.ceil(math.log2(K * Q)) + 3))
    centers = torch.randn(K * Q, informative, generator=g) * spec.class_sep * 2.0

    y = torch.randint(0, K, (n,), generator=g)
    cluster = y * Q + torch.randint(0, Q, (n,), generator=g)
    Xi = centers[cluster] + torch.randn(n, informative, generator=g)

    # Embed into d dims with a random linear map, then add per-feature noise.
    A = torch.randn(informative, d, generator=g) / math.sqrt(informative)
    X = Xi @ A + 0.1 * torch.randn(n, d, generator=g)

    # Label noise
    flip = torch.rand(n, generator=g) < spec.label_noise
    y = torch.where(flip, torch.randint(0, K, (n,), generator=g), y).to(torch.int32)

    Xtr, Xte = X[: spec.n_train], X[spec.n_train:]
    mu, sd = Xtr.mean(dim=0), Xtr.std(dim=0, unbiased=False) + 1e-6
    return (Xtr - mu) / sd, y[: spec.n_train], (Xte - mu) / sd, y[spec.n_train:]


def get_dataset(name: str, generator: torch.Generator):
    if name not in PAPER_DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(PAPER_DATASETS)}")
    return PAPER_DATASETS[name], make_classification(PAPER_DATASETS[name], generator)
