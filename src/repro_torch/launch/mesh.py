"""The torch form of the JAX package's device meshes (``repro/launch/mesh.py``):
``make_host_mesh`` and ``make_mesh`` for runs over real ranks, and
``make_production_mesh`` for the dry-run's 256- or 512-device meshes.

A ``jax.sharding.Mesh((C, m), ("data", "model"))`` is one program over
C·m devices.  Here it is C·m processes of one ``torch.distributed``
group, one rank per mesh position in row-major order (the JAX mesh's
device order), and one process group per axis: the ranks that differ
only in that axis's coordinate.  The groups come from
``torch.distributed.device_mesh.init_device_mesh`` with ``mesh_dim_names``
over the host ("cpu") device type: every collective of the SPMD round
moves host tensors over gloo, as ``fl/distributed.py``'s do, because NCCL
refuses several ranks on one card and gloo's handling of CUDA tensors
depends on the build.  The computation itself stays on each rank's
device.  A mesh of one position needs no process group: a collective over
an axis of size 1 is the identity, and is skipped.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Sequence

import torch.distributed as dist


class Mesh:
    """``shape`` maps each axis name to its size, in axis order (as the
    JAX ``Mesh.shape`` does); ``coords`` this rank's coordinate on each."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} disagree")
        if any(int(s) < 1 for s in shape):
            raise ValueError(f"mesh axes must have positive sizes, got {tuple(shape)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(s) for a, s in zip(axis_names, shape)}
        self.size = math.prod(self.shape.values())
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.size != world:
            raise ValueError(f"a mesh of {self.size} positions {tuple(shape)} needs {self.size} "
                             f"ranks; the process group has {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self._device_mesh = None
        if self.size > 1:
            from torch.distributed.device_mesh import init_device_mesh

            self._device_mesh = init_device_mesh("cpu", tuple(self.shape.values()),
                                                 mesh_dim_names=self.axis_names)
        coords, r = {}, self.rank
        for a in reversed(self.axis_names):  # row-major, the last axis fastest
            coords[a] = r % self.shape[a]
            r //= self.shape[a]
        self.coords: Dict[str, int] = {a: coords[a] for a in self.axis_names}

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over this mesh's ranks (None for a one-position
        mesh outside ``fake_mesh``)."""
        return self._device_mesh

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The process group along ``axis`` (None for an axis of size 1)."""
        if self.shape[axis] == 1:
            return None
        return self._device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh over the process group this process has joined (every rank
    calls this with the same arguments, as every device of a JAX mesh
    runs one program)."""
    return Mesh(shape, axis_names)


def make_host_mesh() -> Mesh:
    """The degenerate ``(1, 1)`` mesh over ``("data", "model")``: the same
    code paths in one process."""
    return Mesh((1, 1), ("data", "model"))


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False) -> Iterator[Mesh]:
    """The production mesh: ``(16, 16)`` over ``("data", "model")``, or
    ``(2, 16, 16)`` over ``("pod", "data", "model")`` with ``multi_pod``
    (256 or 512 devices; ``pod`` is the federation axis).

    It lives in this one process: a ``"fake"`` process group of that world
    size (``torch.testing._internal.distributed.fake_pg``), whose
    collectives complete at once without moving data, so DTensors over the
    mesh propagate shardings and issue their collectives as on the real
    mesh.  The group is process-wide state, so this is a context manager
    that destroys it on exit; it refuses to start while another process
    group is live.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    with fake_mesh(shape, axes) as mesh:
        yield mesh


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Iterator[Mesh]:
    """A mesh of any shape over a ``"fake"`` process group in this process,
    seen from rank 0 (``make_production_mesh``'s; the tests' small ones);
    its ``device_mesh`` exists even at one position.  The group is
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; a fake mesh needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        mesh = Mesh(shape, axis_names)
        if mesh._device_mesh is None:
            from torch.distributed.device_mesh import init_device_mesh

            mesh._device_mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axis_names))
        yield mesh
    finally:
        dist.destroy_process_group()
