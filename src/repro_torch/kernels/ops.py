"""The kernel entry points the rest of the port calls.

Dispatch is by the tensors' device and nothing else: on CUDA tensors the
hand-written kernels always run, on CPU tensors their plain versions
(``ref.py``).  There is no switch between the two on the card — the JAX
package's ``use_pallas`` flag has no counterpart here.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.boost_update import weight_update, weight_update_product, weighted_errors
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.tree_hist import tree_hist
from repro_torch.kernels.vote_argmax import vote_argmax

KERNELS = {
    "tree_hist": tree_hist,
    "weighted_errors": weighted_errors,
    "weight_update": weight_update,
    "weight_update_product": weight_update_product,
    "vote_argmax": vote_argmax,
    "flash_attention": flash_attention,
}


def reset_launches() -> None:
    """Set every kernel's launch and capture counts to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
        fn.captures = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def capture_counts() -> Dict[str, int]:
    """Each kernel's wrapper calls captured into a CUDA graph since the
    last reset (no launch: the graph's replays launch them)."""
    return {name: fn.captures for name, fn in KERNELS.items()}


def count_replay(captured: Dict[str, int]) -> None:
    """Count the launches one replay of a CUDA graph makes: ``captured``
    holds the kernels the graph's capture recorded, by name."""
    for name, n in captured.items():
        KERNELS[name].launches += n


__all__ = [
    "tree_hist", "weighted_errors", "weight_update", "weight_update_product", "vote_argmax",
    "flash_attention",
    "reset_launches", "launch_counts", "capture_counts", "count_replay",
]
