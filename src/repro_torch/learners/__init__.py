"""Fixed-shape weak learners behind a string registry (``decision_tree``
so far)."""
from repro_torch.learners import tree  # noqa: F401  (registration)
from repro_torch.learners.base import LearnerSpec, WeakLearner, get_learner, register

__all__ = ["LearnerSpec", "WeakLearner", "get_learner", "register"]
