"""Logical-axis sharding rules (MaxText-style) with divisibility fallbacks.

Port of ``repro.launch.sharding``.  Models name their tensors' dimensions
with *logical* axes; the rules map them to mesh axes, with the
reference's preferences, its divisibility fallback (a dimension that
does not divide over its axes is replicated) and its dedup (a mesh axis
is used once, by the earliest dimension):

  batch        -> ("pod", "data")
  vocab / embed_tp / heads / kv_heads / ff / expert_ff / experts /
  cache_seq / d_inner / conv_dim / ssm_heads -> "model" where it divides
  cache_batch  -> ("pod", "data")
  head_dim / ssm_state / embed / seq / layers / periods / stack -> None

A spec is a tuple with one entry per dimension, the reference's
``PartitionSpec``: ``None`` (replicated), an axis name, or a tuple of
names, major to minor.  ``NamedSharding(mesh, spec)`` pairs it with a
mesh, and ``NamedSharding.placements`` turns it into DTensor placements,
one per mesh dimension.

The rules read a mesh through its axis sizes and names only: a
``DeviceMesh`` (``mesh_dim_names``, ``shape``) or any object with a
``shape`` mapping axis to size and ``axis_names`` (``launch.mesh.
MeshShape``, the reference's ``FakeMesh``), so the specs of a production
mesh can be worked out with no process group.

The port keeps parameters and activations as plain tensors on each rank:
the data axis splits the batch and, with ZeRO-1, the optimizer state
(``models.model_zoo.DataParallel``).  So ``constrain`` is a no-op, with
rules or without, and the 26 ``constrain`` calls inside the reference's
models have no counterpart yet: they wait for tensor parallelism over
the ``model`` axis (ROADMAP item 13a, third step).
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

_state = threading.local()


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size: a ``DeviceMesh``'s ``shape`` is a tuple of
    sizes in ``mesh_dim_names`` order, a shape-only mesh's a mapping."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[n] for n in names)


def _names(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding(NamedTuple):
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dimension: ``Shard(dim)`` for a
        mesh axis that splits tensor dimension ``dim``, ``Replicate()``
        for one that splits none.  Where several axes split one
        dimension, the spec lists them major to minor and DTensor splits
        in mesh order, major first; an axis whose entry puts axes of
        later mesh dimensions before it gets ``_StridedShard(dim,
        split_factor=their size)`` (as FSDP over tensor parallelism
        does), so every rank's shard is the block JAX's ``NamedSharding``
        gives the same mesh coordinate."""
        from torch.distributed.tensor import Replicate, Shard
        names, sizes = axis_names(self.mesh), axis_sizes(self.mesh)
        out = []
        for i, name in enumerate(names):
            place = Replicate()
            for dim, entry in enumerate(self.spec):
                axes = _names(entry)
                if name not in axes:
                    continue
                split = math.prod(sizes[a] for a in axes[:axes.index(name)]
                                  if names.index(a) > i)
                if split == 1:
                    place = Shard(dim)
                else:
                    from torch.distributed.tensor.placement_types import (
                        _StridedShard)
                    place = _StridedShard(dim, split_factor=split)
            out.append(place)
        return tuple(out)


class ShardingRules:
    """Maps logical axis names -> mesh axis names with divisibility checks."""

    # logical name -> preferred mesh axes (tuple entries = multi-axis)
    PREFERRED = {
        "batch": ("pod", "data"),
        "vocab": ("model",),
        "embed_tp": ("model",),      # embedding-table d_model fallback dim
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": None,   # the reference measured contraction-dim TP far
        # worse than replicated attention (per-layer all-reduces)
        "ff": ("model",),
        "expert_ff": ("model",),
        "experts": ("model",),
        "cache_seq": ("model",),
        "cache_batch": ("pod", "data"),
        "d_inner": ("model",),
        "conv_dim": ("model",),
        "ssm_heads": ("model",),
        "ssm_state": None,
        "embed": None,               # activation d_model: replicated
        "seq": None,
        "layers": None,
        "periods": None,
        "stack": None,
        None: None,
    }

    def __init__(self, mesh):
        self.mesh = mesh
        self.axes = set(axis_names(mesh))

    def mesh_axes_for(self, logical: Optional[str], dim_size: int):
        pref = self.PREFERRED.get(logical, None)
        if pref is None:
            return None
        present = tuple(a for a in pref if a in self.axes)
        if not present:
            return None
        if dim_size % _axis_size(self.mesh, present) != 0:
            return None  # fallback: replicate this dim
        return present if len(present) > 1 else present[0]

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> tuple:
        # earlier dims take priority; a mesh axis is used at most once
        used = set()
        parts = []
        for ax, d in zip(logical_axes, shape):
            m = self.mesh_axes_for(ax, d)
            names = _names(m)
            if m is None or any(n in used for n in names):
                parts.append(None)
            else:
                used.update(names)
                parts.append(m)
        return tuple(parts)

    def sharding(self, logical_axes, shape) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical_axes, shape))


@contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def active_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


def constrain(x, *logical_axes):
    """The reference's ``with_sharding_constraint`` by logical names.  The
    port's tensors are plain local tensors (data parallelism), which the
    constraint leaves as they are: ``x`` comes back unchanged, after the
    reference's rank check when rules are active."""
    if active_rules() is not None and len(logical_axes) != x.ndim:
        raise ValueError(f"{len(logical_axes)} logical axes for a tensor of "
                         f"shape {tuple(x.shape)}")
    return x


def param_shardings(rules: ShardingRules, schema):
    """Tree of ``NamedSharding``s for a param schema (models/schema.py)."""
    from repro_torch.models.schema import map_specs
    return map_specs(lambda s: rules.sharding(s.axes, s.shape), schema)


def zero1_extend(sharding: NamedSharding, shape, rules: ShardingRules):
    """Additionally shard one dim over 'data' (ZeRO-1 optimizer state /
    reduce-scattered gradient accumulation)."""
    if "data" not in rules.axes:
        return sharding
    sizes = axis_sizes(rules.mesh)
    dsize = sizes["data"]
    parts = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
    for i, (p, d) in enumerate(zip(parts, shape)):
        if p is None and d % dsize == 0:
            parts[i] = "data"
            return NamedSharding(rules.mesh, tuple(parts))
        if p is not None:
            cur = _names(p)
            if "data" not in cur and "pod" not in cur:
                total = dsize
                for a in cur:
                    total *= sizes[a]
                if d % total == 0:
                    parts[i] = cur + ("data",)
                    return NamedSharding(rules.mesh, tuple(parts))
    return sharding


def zero1_shardings(rules: ShardingRules, schema):
    """Param shardings additionally scattered over 'data' (ZeRO-1)."""
    from repro_torch.models.schema import map_specs
    return map_specs(
        lambda s: zero1_extend(rules.sharding(s.axes, s.shape), s.shape,
                               rules), schema)
