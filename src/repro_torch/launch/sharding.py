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

The port keeps parameters and activations as plain tensors on each rank
(never a DTensor: the kernels take plain tensors).  The batch group
(``batch_group``: the pod x data ranks, flattened pod-major, as the
rules' ``("pod", "data")`` entry orders them) splits the batch, and the
data axis alone, with ZeRO-1, the optimizer state
(``models.model_zoo.DataParallel``).  The model axis is tensor
parallelism: each model rank holds the block of every leaf that its
``NamedSharding`` gives it (``local_block``; ``gather_block`` is the
inverse), and the blocks compute with the two autograd-aware
collectives of Megatron-style tensor parallelism over the active rules'
``model`` group, ``copy_to_model`` (f: identity forward, all-reduce
backward) at the entry of a column-parallel region and
``reduce_from_model`` (g: all-reduce forward, identity backward) at the
exit of a row-parallel one.  Both are identities without rules or at a
model axis of 1, where every model runs as before.  ``constrain`` itself
stays a no-op (after the reference's rank check): GSPMD turns the
reference's constraints into collectives, while the port's blocks call
those collectives where its layout needs them.  The reference's 26
sites, and what the port does at each:

=====================================  ====================================
reference site                         port
=====================================  ====================================
layers.py:166 ``q`` (heads)            ``attention_block``: f on the normed
                                       input, q/k/v column-parallel over
                                       the rank's contiguous heads and KV
                                       heads (all KV heads, f on wk/wv,
                                       where ``kv_heads`` does not divide)
layers.py:198 attention out (heads)    nothing: the heads stay local
layers.py:200 block out (embed)        g after ``wo`` (row-parallel), in
                                       the block's dtype
layers.py:357 ``act`` (ff)             ``swiglu_block``: f, then gate/up
                                       column-parallel over ``ff``
layers.py:359 block out (embed)        g after ``w_down``
mamba2.py:174 ``proj`` (d_inner)       ``mamba2_block``: f on the normed
                                       input, z / x / dt over the rank's
                                       contiguous heads, B and C whole
                                       (``mamba2.head_leaves`` cuts
                                       ``in_proj`` and ``conv_w``: in
                                       training from the whole leaves
                                       ``model_zoo.DataParallel`` gathers
                                       once a step, in serving once, in
                                       ``model_zoo.mesh_blocks``)
mamba2.py:215 block out (embed)        g after ``out_proj`` (row-parallel
                                       over the heads' channels); the
                                       ``ssm_norm`` squares summed over
                                       the group (``sum_over_model``)
model_zoo.py:344 patch embeds          nothing: a batch leaf, split by
transformer.py:170 patch embeds        rows over the batch group
                                       (``DataParallel.micro_blocks``)
                                       and replicated over
                                       model, put in front of the
                                       embedding's output (after its g)
transformer.py:227 encoder frames      nothing likewise; the encoder's
                                       blocks are ``attention_block`` and
                                       ``swiglu_block`` as above, and cross
                                       attention (no reference constraint)
                                       is ``transformer.cross_kv``: f on
                                       the encoder output, k / v over the
                                       rank's KV heads; q after f on the
                                       normed input, g after ``wo``
transformer.py:131 embedding (embed)   ``embed_tokens``: vocab-parallel
                                       lookup (out-of-block ids give zero
                                       rows), then g
transformer.py:141 logits (vocab)      ``lm_logits``: f, the rank's vocab
                                       block; ``model_zoo.lm_loss``
                                       reduces max, sum of exps and the
                                       target logit over the group
moe.py:215 explicit-EP out (embed)     ``_moe_explicit_ep``: one float32
                                       g of the routed experts' combine,
                                       g after the shared experts
moe.py:231, 263, 264 routing (batch)   each rank routes its rows of the
                                       micro-batch (``routing_pool``):
                                       groups that span ranks take their
                                       positions from count tables
                                       all-gathered over the batch
                                       group (``gather_over_batch``)
moe.py:272, 277, 280 (experts)         ``moe._routed``: f on the normed
moe.py:287, 299 combine, out           input and the router, the rank's
                                       experts' slots (``experts`` split)
                                       or every expert on its ``d_ff``
                                       block (``expert_ff`` split), one
                                       float32 g of the combine; whole,
                                       with no collective, where the rules
                                       replicate the expert weights
                                       (``model_split_dim``); over batch
                                       ranks the router statistics are
                                       all-reduced over the pool
                                       (``sum_over_pool``)
moe.py:330, 334, 336, 349 (one-hot)    ``moe_block_onehot``: the same over
                                       a model axis and over batch ranks
model_zoo.py:241 ``_scatter_grads``    ``DataParallel.reduce``: a
                                       reduce-scatter over data, then an
                                       all-reduce of the block over pod
model_zoo.py:294-312 decode state      ``model_zoo.ServingMesh``: a rank
(``cache_batch``, ``cache_seq``,       holds its rows and its S / m
``kv_heads``, ``ssm_heads``,           positions of every KV head
``conv_dim``; layers.py:179            (``local_block`` / ``gather_block``
"seq-sharded on the model axis")       of the specs); a prefill's k and v
                                       gathered over model where the rules
                                       shard ``kv_heads``, then sliced
                                       (``layers.cache_block``); a decode
                                       step's attention a split softmax
                                       over the ranks' positions (one
                                       gather of q / k / v, one of each
                                       rank's largest logit and sum,
                                       merged by log-sum-exp, and an
                                       all-reduce of the outputs:
                                       ``layers.seq_sharded_attention``);
                                       where m does not divide S
                                       (``cache_seq_split``), every
                                       position of the rank's KV heads and
                                       tensor-parallel attention; the
                                       rank's SSM heads' ``ssm`` and its
                                       own ``conv`` block (its heads' x
                                       channels, B and C); the logits
                                       gathered to every rank
=====================================  ====================================
"""

from __future__ import annotations

import copy
import math
import threading
from contextlib import contextmanager
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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
        # the batch ranks ``(lo, size)`` that hold this rank's micro-batch
        # (``routing_pool``); ``None``: all of them
        self.pool = None
        # the positions of the decode state's KV cache that a serving
        # mesh lays out (``cache_seq_split``); ``None`` outside serving
        self.cache_positions = None

    def with_pool(self, lo: int, size: int) -> "ShardingRules":
        """These rules, with this rank's micro-batch held by the batch
        ranks ``[lo, lo + size)`` (``batch_group``)."""
        rules = copy.copy(self)
        rules.pool = (lo, size)
        return rules

    def with_cache(self, positions: int) -> "ShardingRules":
        """These rules, serving a decode state of ``positions`` cache
        positions."""
        rules = copy.copy(self)
        rules.cache_positions = positions
        return rules

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


# ------------------------------------------------------------ the model axis
class Axis(NamedTuple):
    """One mesh axis of the active rules, as this rank sees it."""
    group: object     # its ProcessGroup
    rank: int         # this rank's coordinate on it
    size: int


def _mesh_axis(name: str) -> Optional[Axis]:
    """``name``'s axis of the active rules' ``DeviceMesh``; ``None``
    without rules, on a shape-only mesh, or where the axis is missing or
    has size 1."""
    rules = active_rules()
    if rules is None or name not in rules.axes:
        return None
    mesh = rules.mesh
    if getattr(mesh, "mesh_dim_names", None) is None:
        return None
    size = axis_sizes(mesh)[name]
    if size == 1:
        return None
    return Axis(mesh.get_group(name), mesh.get_local_rank(name), size)


def model_axis() -> Optional[Axis]:
    """The active rules' ``model`` axis above size 1, else ``None``."""
    return _mesh_axis("model")


BATCH_AXES = ("pod", "data")


def batch_group(mesh) -> Axis:
    """The batch group of a ``DeviceMesh``: its ``pod`` x ``data`` ranks
    (those of the mesh's axes), flattened pod-major, the order of the
    rules' ``("pod", "data")`` entry: batch rank ``pod * data_size +
    data``.  The rows of the batch and of the decode state go over it,
    the gradient is summed over it and moe's routing pool is drawn from
    it; ZeRO-1 stays on ``data`` alone (``zero1_extend``).

    One axis above 1 is that axis's own group; with both above 1 the
    group is made here once per mesh, by ``dist.new_group`` for every
    coordinate of the other axes: a collective over the world, which
    every rank of it must make the first time (``launch.mesh.make_mesh``
    does, for every mesh with a pod axis).  Size 1: no group."""
    cached = getattr(mesh, "_batch_group", None)
    if cached is not None:
        return cached
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    axes = [a for a in BATCH_AXES if a in names and sizes[a] > 1]
    size = math.prod(sizes[a] for a in axes)
    coord = mesh.get_coordinate()      # None: a rank outside the mesh
    rank, group = 0, None
    if coord is not None:
        for a in axes:
            rank = rank * sizes[a] + coord[names.index(a)]
    if len(axes) == 1 and coord is not None:
        group = mesh.get_group(axes[0])
    elif len(axes) == 2:
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        for row in mesh.mesh.permute(rest + dims).reshape(-1, size).tolist():
            # a group's ranks are in rank order: batch rank order only
            # where the mesh lists its ranks so
            if row != sorted(row):
                raise ValueError(f"a {sizes} mesh whose pod and data ranks "
                                 f"are not in rank order")
            made = dist.new_group(row)
            if dist.get_rank() in row:
                group = made
    ax = Axis(group, rank, size)
    mesh._batch_group = ax
    return ax


def batch_axis() -> Optional[Axis]:
    """The active rules' batch group (``batch_group``) above size 1, else
    ``None`` (also without rules or on a shape-only mesh)."""
    rules = active_rules()
    if rules is None or getattr(rules.mesh, "mesh_dim_names", None) is None:
        return None
    ax = batch_group(rules.mesh)
    return ax if ax.size > 1 else None


class Pool(NamedTuple):
    """A rank's routing pool: the batch ranks ``[lo, lo + size)``, in
    rank order, whose rows make up the micro-batch that this rank holds a
    block of (every rank of the pool as many rows)."""
    axis: Axis        # the batch group
    lo: int
    size: int

    @property
    def index(self) -> int:
        """This rank's block of the micro-batch."""
        return self.axis.rank - self.lo


def routing_pool() -> Optional[Pool]:
    """The active rules' routing pool (``ShardingRules.with_pool``; the
    whole batch group where none is set), ``None`` without a batch group
    above 1.  A pool of one rank: the rank holds the micro-batch
    whole."""
    ax = batch_axis()
    if ax is None:
        return None
    lo, size = active_rules().pool or (0, ax.size)
    return Pool(ax, lo, size)


def model_split(logical: str, size: int) -> int:
    """How many blocks the active rules cut a ``size`` dimension named
    ``logical`` into over the model axis: its size where they shard it
    over ``model`` alone, else 1 (replicated)."""
    tp = model_axis()
    if tp is None:
        return 1
    return tp.size if active_rules().mesh_axes_for(logical, size) == \
        "model" else 1


def cache_seq_split() -> bool:
    """Whether the active rules cut the decode state's KV cache by
    positions over a model axis above 1: ``cache_seq`` over ``model``
    for the positions ``ShardingRules.with_cache`` set, where the axis
    divides them.  Where it does not, the reference's rules give
    ``model`` to the cache's ``kv_heads`` where they divide (each rank
    its block of them at every position), else keep the cache whole on
    every rank."""
    rules = active_rules()
    return (model_axis() is not None and rules.cache_positions is not None
            and rules.mesh_axes_for("cache_seq", rules.cache_positions)
            == "model")


def model_split_dim(logical_axes: Sequence[Optional[str]],
                    shape: Sequence[int]) -> Optional[int]:
    """The dimension of a ``shape`` tensor named ``logical_axes`` that the
    active rules split over a model axis above 1, or ``None``.  Read from
    the rules' ``spec``, which gives the axis to the earliest dimension
    it divides and to no later one: for the expert weights'
    ``("experts", "embed", "expert_ff")`` the experts where the axis
    divides them, else each expert's ``d_ff`` where it divides that,
    else neither (the weights replicated)."""
    if model_axis() is None:
        return None
    spec = active_rules().spec(logical_axes, shape)
    return next((i for i, e in enumerate(spec) if "model" in _names(e)),
                None)


# all-reduces made by the collectives below (forward and backward): a
# plain count for readings, like a kernel wrapper's launches
all_reduces = 0


def all_reduce(x, group, op=dist.ReduceOp.SUM):
    """``x`` reduced over ``group`` into a new tensor, counted in
    ``all_reduces`` (no gradient of its own)."""
    global all_reduces
    all_reduces += 1
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _CopyToGroup(torch.autograd.Function):
    """f: identity forward, all-reduce of the gradient backward."""
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverGroup(torch.autograd.Function):
    """All-reduce forward and its adjoint, all-reduce, backward: for a sum
    over ranks whose every copy enters the loss."""
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward, the gradient times ``scale`` backward."""
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def copy_to_model(x):
    """Entry of a column-parallel region (Megatron's f): ``x`` forward;
    backward, the gradient all-reduced over the model group, so that the
    ranks' partial gradients (each through its block of the weights)
    sum to the whole one.  The identity without a model axis."""
    tp = model_axis()
    if tp is None:
        return x
    return _CopyToGroup.apply(x, tp.group)


def reduce_from_model(x):
    """Exit of a row-parallel region (Megatron's g): the ranks' partial
    sums all-reduced over the model group, in ``x``'s dtype; backward the
    identity (the output is the same on every model rank, and each
    rank's copy of the loss counts once).  The identity without a model
    axis."""
    tp = model_axis()
    if tp is None:
        return x
    return _ReduceFromGroup.apply(x, tp.group)


def max_over_model(x):
    """The element-wise maximum over the model group, with no gradient
    (for a shift that cancels, such as a softmax's)."""
    tp = model_axis()
    if tp is None:
        return x
    return all_reduce(x.detach(), tp.group, dist.ReduceOp.MAX)


def sum_over_model(x):
    """``x`` summed over the model group, with the adjoint gradient (an
    all-reduce): for a sum whose every copy feeds the rank's own part of
    a replicated output (a norm's mean of squares over a sharded
    dimension), so that each rank's partial gradient reaches every
    term.  The identity without a model axis."""
    tp = model_axis()
    if tp is None:
        return x
    return _SumOverGroup.apply(x, tp.group)


def sum_over_batch(x):
    """``x`` summed over the batch group, with the adjoint gradient (an
    all-reduce): every batch rank's loss holds the sum, and the batch
    ranks' gradients are summed.  The identity without a batch group."""
    ax = batch_axis()
    if ax is None:
        return x
    return _SumOverGroup.apply(x, ax.group)


def sum_over_pool(x, pool: Pool):
    """``x`` summed over the ranks of ``pool``, with the adjoint gradient:
    ``sum_over_batch`` where the pool is the whole batch group, else each
    rank's ``x`` in its row of a (batch ranks, ...) tensor, all-reduced
    over the batch group, and the pool's rows summed."""
    if pool.size == pool.axis.size:
        return _SumOverGroup.apply(x, pool.axis.group)
    rows = torch.stack([x if r == pool.axis.rank else torch.zeros_like(x)
                        for r in range(pool.axis.size)])
    rows = _SumOverGroup.apply(rows, pool.axis.group)
    return rows[pool.lo:pool.lo + pool.size].sum(0)


# all-gathers made by ``gather_parts`` (``gather_over_batch``, the serving
# paths' gathers): a plain count for readings
all_gathers = 0


def gather_parts(x, group, size: int, count: bool = True):
    """Every rank of ``group`` (``size`` ranks)'s ``x``, in rank order (no
    gradient); counted in ``all_gathers`` unless ``count`` is false."""
    global all_gathers
    all_gathers += count
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def gather_over_batch(x):
    """Every batch rank's ``x`` (no gradient), stacked in batch-rank
    order: (batch ranks, ...); counted in ``all_gathers``."""
    ax = batch_axis()
    return torch.stack(gather_parts(x, ax.group, ax.size))


def gather_over_model(x, dim: int):
    """Every model rank's ``x`` concatenated along ``dim`` in rank order
    (no gradient; an all-gather counted in ``all_gathers``); ``x``
    without a model axis."""
    tp = model_axis()
    if tp is None:
        return x
    return torch.cat(gather_parts(x, tp.group, tp.size), dim)


def scale_grad(x, scale: float):
    """``x`` forward, its gradient times ``scale`` backward."""
    if scale == 1:
        return x
    return _ScaleGrad.apply(x, scale)


def model_dim(sharding: NamedSharding) -> Optional[int]:
    """The dimension that ``sharding`` splits over the ``model`` axis of
    its mesh (from its placements), or ``None``."""
    names = axis_names(sharding.mesh)
    if "model" not in names:
        return None
    place = sharding.placements[names.index("model")]
    return getattr(place, "dim", None)


def coordinate(mesh) -> Dict[str, int]:
    """This rank's index on each axis of ``mesh``: a ``DeviceMesh``'s
    ``get_coordinate()``; 0 on every axis of a shape-only mesh (its first
    device)."""
    names = axis_names(mesh)
    if getattr(mesh, "mesh_dim_names", None) is None:
        return {n: 0 for n in names}
    return dict(zip(names, mesh.get_coordinate()))


def local_block(t, sharding: NamedSharding, coord: Dict[str, int]):
    """The block of a whole leaf ``t`` that ``sharding`` gives the mesh
    coordinate ``coord`` (``coordinate(mesh)``): each dimension cut into
    equal blocks over the axes of its spec entry, the block at the
    coordinate's index over them, major to minor (the block JAX's
    ``NamedSharding`` gives the device there).  A view of ``t``."""
    sizes = axis_sizes(sharding.mesh)
    for dim, entry in enumerate(sharding.spec):
        n, i = 1, 0
        for a in _names(entry):
            n, i = n * sizes[a], i * sizes[a] + coord[a]
        if n > 1:
            t = t.narrow(dim, i * (t.shape[dim] // n), t.shape[dim] // n)
    return t


def gather_block(t, sharding: NamedSharding, count: bool = True):
    """``local_block``'s inverse on a ``DeviceMesh``: the whole leaf on
    every rank from the ranks' blocks, all-gathered over each axis above
    1 that splits a dimension (the minor axes of an entry first; each
    gather counted in ``all_gathers`` unless ``count`` is false)."""
    mesh, sizes = sharding.mesh, axis_sizes(sharding.mesh)
    for dim, entry in enumerate(sharding.spec):
        for a in reversed(_names(entry)):
            if sizes[a] > 1:
                t = torch.cat(gather_parts(t, mesh.get_group(a), sizes[a],
                                           count), dim)
    return t


def position_owner(pos, seq_len: int, model_size: int):
    """The model rank whose block of a ``seq_len``-position cache holds
    position ``pos`` (``cache_seq`` over a model axis of ``model_size``:
    rank ``r`` holds ``[r S/m, (r+1) S/m)``): ``pos // (S / m)``; a
    position at or past ``seq_len`` gives ``model_size`` (no rank)."""
    return pos // (seq_len // model_size)


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
