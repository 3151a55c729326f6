"""The kernel entry points the rest of the port calls.

Dispatch is by the tensors' device and nothing else: on CUDA tensors the
hand-written kernels always run, on CPU tensors their plain versions
(``ref.py``).  There is no switch between the two on the card — the JAX
package's ``use_pallas`` flag has no counterpart here.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.boost_update import weight_update, weighted_errors
from repro_torch.kernels.tree_hist import tree_hist

KERNELS = {
    "tree_hist": tree_hist,
    "weighted_errors": weighted_errors,
    "weight_update": weight_update,
}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["tree_hist", "weighted_errors", "weight_update", "reset_launches", "launch_counts"]
