"""Device meshes (the port of ``repro.launch.mesh``).

A :class:`Mesh` names the axes of a grid of ranks, one card per rank
process, as ``jax.make_mesh`` names a grid of devices: ``axis_names``, and
``devices``, an array of the ranks in the mesh's shape.  Every sharding
rule reads a mesh through those two alone (:func:`dp_axes`,
:func:`axis_size`), so a stand-in with the same two attributes serves
both packages' rules.

When a process group is up and its world size equals the mesh's size, the
mesh also carries the ``torch.distributed`` ``DeviceMesh`` over those ranks
(``init_device_mesh(device_type, shape, mesh_dim_names=axes)``), which
``distributed/sharding.py`` distributes tensors on.  The caller starts the
group (``torch.distributed.init_process_group``): building a mesh never
does, so importing or calling this module in a process that shares its
state with others (a test run's worker) starts nothing.

Production meshes: single pod 16x16 = 256 ranks, axes ("data", "model");
multi-pod 2x16x16 = 512, ("pod", "data", "model"), where "pod" is an outer
data-parallel axis.  With no process group one card cannot build them:
:func:`make_mesh` raises, as ``jax.make_mesh`` does with too few devices.
The dry run (``launch/dryrun.py``) starts a fake process group of 256 or
512 ranks in one process, and the mesh is built on it: the ranks counted
are the group's, never the cards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    axis_names: Tuple[str, ...]
    devices: np.ndarray          # the mesh's ranks, laid out in its shape
    device_type: str             # "cuda" or "cpu"
    device_mesh: Optional[Any] = None   # torch.distributed DeviceMesh, or None


def _ranks_available(device_type: str) -> int:
    """The process group's world size, or with none this process's cards
    (one process: a CPU process is one rank)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count() if device_type == "cuda" else 1


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the ranks of the process
    group (or this process's cards when there is none) on ``device``'s type:
    the card unless the caller asks for the CPU.  Raises when there are
    fewer ranks than the mesh needs."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    device_type = resolve_device(device).type
    n = math.prod(shape)
    have = _ranks_available(device_type)
    if n > have:
        raise ValueError(f"a {shape} mesh needs {n} ranks ({device_type}); "
                         f"{have} available")
    device_mesh = None
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() == n:
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return Mesh(axes, np.arange(n).reshape(shape), device_type, device_mesh)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_data_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D mesh over the first ``num_devices`` ranks (all of them by
    default), single axis ``"data"``."""
    have = _ranks_available(resolve_device(device).type)
    n = have if num_devices is None else int(num_devices)
    if not 1 <= n <= have:
        raise ValueError(f"need 1 <= num_devices <= {have}, got {n}")
    return make_mesh((n,), ("data",), device)


def dp_axes(mesh) -> tuple:
    """Data-parallel axes: ('pod', 'data') when a pod axis exists."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, name: str) -> int:
    names = mesh.axis_names
    if name not in names:
        return 1
    return mesh.devices.shape[names.index(name)]
