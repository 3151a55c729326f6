"""PyTorch/CUDA port of the MAFL reproduction.

Mirrors ``src/repro/`` module for module (``repro_torch/core/boosting.py``
answers to ``repro/core/boosting.py`` and so on).  The slice ported so far
is the default federation: AdaBoost.F over oblivious ``decision_tree``
learners on the fused round, whose three hot spots (``tree_hist``,
``weighted_errors``, ``weight_update``) run as hand-written CUDA kernels
for Hopper (``csrc/``).

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``;
without a card it raises unless the caller asked for ``"cpu"``, where the
kernels' plain PyTorch versions run instead.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
