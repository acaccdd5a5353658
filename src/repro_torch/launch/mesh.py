"""Meshes over the ranks of a ``torch.distributed`` process group.

Port of ``repro.launch.mesh``.  A JAX mesh names the devices of one
process; the port's is a ``DeviceMesh`` over processes, so every
function here needs an initialised process group (``launch.dist``), and
every rank of the world must call it: building a mesh's groups is a
collective over the world.  A mesh of ``n`` ranks takes the first ``n``
of the world, as ``jax.make_mesh`` takes the first devices; a rank
outside it gets a mesh whose ``get_coordinate()`` is ``None``.

A mesh with a ``pod`` axis also gets its batch group here
(``launch.sharding.batch_group``: the pod x data ranks, a group of its
own where both axes are above 1), so that every rank of the world makes
it together.

``MeshShape`` is a shape-only mesh (axis sizes and names, no ranks) for
the sharding rules of a mesh that no process group holds, such as the
production meshes, as the reference's ``FakeMesh`` test does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis sizes by name (``shape``) and their order (``axis_names``):
    what ``launch.sharding.ShardingRules`` reads of a mesh."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]

    @classmethod
    def of(cls, shape: Sequence[int], axes: Sequence[str]) -> "MeshShape":
        return cls(dict(zip(axes, shape)), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` over the first ``prod(shape)`` ranks,
    its dimensions named ``axes``; ``device`` gives its device type."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialised torch.distributed process "
            f"group (launch.dist.process_group, or torchrun); none is")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {world}")
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.sharding import batch_group
    mesh = DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)
    if "pod" in axes:
        batch_group(mesh)
    return mesh


def make_host_mesh(n_data: int = 1, n_model: int = 1, device="cuda"):
    """A ("data", "model") mesh over the first ``n_data * n_model`` ranks
    of the process group."""
    return make_mesh((n_data, n_model), ("data", "model"), device=device)
