"""Fixed-shape weak learners behind a string registry: the oblivious
trees (``decision_tree``, ``extra_tree``), ``ridge``, ``gaussian_nb``,
``nearest_centroid`` and ``mlp`` — one per family of the paper's §5.3."""
from repro_torch.learners import centroid, linear, mlp, naive_bayes, tree  # noqa: F401  (registration)
from repro_torch.learners.base import (
    LearnerSpec,
    WeakLearner,
    available_learners,
    get_learner,
    register,
)

__all__ = ["LearnerSpec", "WeakLearner", "available_learners", "get_learner", "register"]
