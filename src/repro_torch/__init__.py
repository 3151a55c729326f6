"""PyTorch/CUDA port of the MAFL reproduction.

Mirrors ``src/repro/`` module for module (``repro_torch/core/boosting.py``
answers to ``repro/core/boosting.py`` and so on).  These paths are ported,
each kernel the JAX path reaches a hand-written CUDA kernel for Hopper
(``csrc/``):

* the default federation: AdaBoost.F over oblivious ``decision_tree``
  learners on the fused round (``launch/fl_run.py``), with ``tree_hist``,
  ``weighted_errors`` and ``weight_update``;
* serving the trained ensemble (``launch/serve_fl.py``, ``serve/``), with
  ``vote_argmax``;
* LLM serving for dense architectures, gemma-2b (``launch/serve.py``,
  ``models/``, ``configs/``), full-attention or with sliding-window layers:
  prefill and greedy decode against KV caches (ring buffers for window
  layers), with ``flash_attention`` in every prefill;
* LM training (``launch/train.py``, ``models/model.py``, ``optim/``,
  ``data/pipeline.py``, ``checkpoint.py``), whose forward runs the plain
  attention, as the JAX package's training path does.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``;
without a card it raises unless the caller asked for ``"cpu"``, where the
kernels' plain PyTorch versions run instead.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
