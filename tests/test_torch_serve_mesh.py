"""Serving over a ``("data", "model")`` mesh, the parts that need no
process group, on the CPU in this process: the split softmax of a decode
step over the model ranks' position blocks (``layers.block_logits``,
``block_stats``, ``merge_stats`` and ``block_attention``) against
``full_attention``, in float32 and in bf16, including a block that
holds no valid position; the position-to-owner arithmetic
(``sharding.position_owner``); each mesh coordinate's block of a decode
state (``sharding.local_block`` of ``ServingMesh.state_shardings``)
against the block JAX's ``NamedSharding`` of the reference's
``decode_state_shardings`` gives the device there; the ssm and hybrid
layouts, whose blocks join back into the whole state; and the pod
axis's layout (the rows over the pod x data ranks, pod-major).  The runs
over gloo ranks are ``tests/test_torch_multirank.py``'s.

Tolerances: the merge is the softmax's sum in another order (blocks,
then log-sum-exp weights), float32: within 2e-6 relative per element of
the one-pass ``full_attention``.  In bf16 both round the same float32
probabilities to bf16 before the product (the denominators differ in
float32 rounding only), so the outputs, rounded to bf16, agree within
one bf16 ulp (2^-8 relative) of each element.
"""

import itertools

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.sharding import ShardingRules as JShardingRules
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.sharding import local_block, position_owner
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as ssm_lib
from repro_torch.models import model_zoo as zoo

torch.set_num_threads(1)


def _qkv(seed, b=3, h=4, kv=2, s=64, d=16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, 1, h, d, generator=g) * 2,
            torch.randn(b, s, kv, d, generator=g),
            torch.randn(b, s, kv, d, generator=g))


def _split(q, k, v, blocks, kv_len):
    """``seq_sharded_attention`` over ``blocks`` equal position blocks, as
    the model ranks run it: each block's ``block_logits`` and
    ``block_stats``, stacked, ``merge_stats``, each block's
    ``block_attention`` summed: (B, 1, H, D) float32, and the blocks'
    (m, l, o) stacked."""
    n = k.shape[1] // blocks
    logits = [L.block_logits(q, k[:, r * n:(r + 1) * n], lo=r * n,
                             kv_len=kv_len) for r in range(blocks)]
    m, l = (torch.stack(t) for t in zip(*map(L.block_stats, logits)))
    mx, den = L.merge_stats(m, l)
    o = torch.stack([L.block_attention(t, mx, den, v[:, r * n:(r + 1) * n])
                     for r, t in enumerate(logits)])
    b, _, h, d = q.shape
    return (o.sum(0).permute(0, 3, 1, 2, 4).reshape(b, 1, h, d),
            (m, l, o))


@pytest.mark.parametrize("blocks", [2, 4, 16])
@pytest.mark.parametrize("lens", [(1, 17, 64), (32, 33, 40), None])
def test_split_softmax_equals_full_attention(blocks, lens):
    """A decode step's attention over ``blocks`` position blocks, merged by
    log-sum-exp, against ``full_attention`` over the whole cache with
    the same ``kv_len`` (lanes ending in the first block, across a block
    boundary, at the end; ``None``: every position, as cross attention
    reads them)."""
    q, k, v = _qkv(blocks)
    kv_len = None if lens is None else torch.tensor(lens)
    got, _ = _split(q, k, v, blocks, kv_len)
    want = L.full_attention(q, k, v, causal=False, kv_len=kv_len)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("blocks", [2, 16])
def test_split_softmax_rounds_as_full_attention_in_bf16(blocks):
    """bf16 q, k, v (a bf16 model's decode step): the split softmax rounds
    its probabilities to bf16 before the product, as ``full_attention``
    does, so its output rounded to bf16 is ``full_attention``'s within
    one bf16 ulp of each element; the unrounded probabilities' product
    is not (the check has teeth)."""
    q, k, v = (t.bfloat16() for t in _qkv(blocks, s=256))
    kv_len = torch.tensor([3, 130, 256])
    got, _ = _split(q, k, v, blocks, kv_len)
    want = L.full_attention(q, k, v, causal=False, kv_len=kv_len).float()
    ulp = 2.0 ** -8 * want.abs()
    assert bool(((got.bfloat16().float() - want).abs() <= ulp).all())
    b, _, h, d = q.shape
    unrounded = torch.einsum(
        "bkgqs,bskd->bqkgd",
        torch.softmax(L.block_logits(q, k, kv_len=kv_len), -1),
        v.float()).reshape(b, 1, h, d)
    assert not bool(((unrounded.bfloat16().float() - want).abs()
                     <= ulp).all())


def test_merge_with_a_block_that_holds_no_valid_position():
    """A lane whose ``kv_len`` ends in the first of two blocks: the second
    block's logits are all masked to ``NEG_INF``, so its ``m`` is
    ``NEG_INF`` and its ``l`` counts every one of its positions; its
    merge weight ``exp(m_r - max m)`` is exactly 0, so the merged
    statistics are the first block's alone, the second block's output is
    exactly 0, and the sum equals ``full_attention``."""
    q, k, v = _qkv(7, b=1)
    kv_len = torch.tensor([5])
    got, (m, l, o) = _split(q, k, v, 2, kv_len)
    assert (m[1] == L.NEG_INF).all()
    assert (l[1] == 32).all()
    assert (torch.exp(m - m.amax(0))[1] == 0).all()
    mx, den = L.merge_stats(m, l)
    assert torch.equal(mx, m[0]) and torch.equal(den, l[0])
    assert bool((o[1] == 0).all())
    torch.testing.assert_close(
        got, L.full_attention(q, k, v, causal=False, kv_len=kv_len),
        rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("S,m", [(64, 2), (32768, 16), (18432, 2)])
def test_position_owner(S, m):
    """Position ``p`` of an ``S``-position cache over a model axis of ``m``
    lies on rank ``p // (S / m)``, the block ``local_block`` gives that
    rank; ``S`` itself (a full lane's ``cache_len``) on none."""
    pos = torch.tensor([0, S // m - 1, S // m, S // 2, S - 1, S])
    owner = position_owner(pos, S, m)
    assert owner.tolist() == [0, 0, 1, (S // 2) // (S // m), m - 1, m]
    cfg = get_config("granite-8b").reduced()
    shape = ShapeConfig("decode", S, 2, "decode")
    mesh = MeshShape.of((1, m), ("data", "model"))
    sh = zoo.ServingMesh(cfg, shape, mesh).state_shardings.cache["k"]
    ids = torch.arange(S).view(1, 1, S, 1, 1)
    for p, r in zip(pos[:-1].tolist(), owner[:-1].tolist()):
        block = local_block(ids, sh, {"data": 0, "model": r})
        assert p in block.flatten().tolist()


@pytest.mark.parametrize("name", ["granite-8b", "qwen2-moe-a2.7b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 1), (2, 2), (4, 2),
                                        (2, 1, 1), (2, 2, 1), (2, 1, 2),
                                        (2, 2, 2)])
def test_state_blocks_are_the_references(name, mesh_shape):
    """Every leaf of a reduced decode_32k state (4 lanes of 64 positions)
    cut by ``local_block`` at each mesh coordinate: the block that JAX's
    ``NamedSharding`` of the reference's ``decode_state_shardings`` gives
    the device there (``cache_batch`` over data, or over pod and data,
    pod-major, where the mesh has a pod axis; ``cache_seq`` over model,
    every KV head; ``cache_len`` by lanes)."""
    cfg = get_config(name).reduced()
    shape = SHAPES["decode_32k"].reduced()
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = jmake_mesh(mesh_shape, axes)
    want = jspecs.decode_state_shardings(
        jax_config(name).reduced(), JSHAPES["decode_32k"].reduced(),
        JShardingRules(mesh))
    sm = zoo.ServingMesh(cfg, shape, MeshShape.of(mesh_shape, axes))
    whole = zoo.init_decode_state(cfg, shape, device="cpu")
    gen = torch.Generator().manual_seed(0)
    whole.cache = {k: torch.randn(v.shape, generator=gen)
                   for k, v in whole.cache.items()}
    whole.cache_len = torch.arange(shape.global_batch, dtype=torch.int32)
    pairs = [(whole.cache[k], sm.state_shardings.cache[k], want.cache[k])
             for k in whole.cache] + [(whole.cache_len,
                                       sm.state_shardings.cache_len,
                                       want.cache_len)]
    for t, ours, theirs in pairs:
        index = theirs.devices_indices_map(tuple(t.shape))
        for coord in np.ndindex(*mesh_shape):
            block = local_block(t, ours, dict(zip(axes, coord)))
            want_block = t.numpy()[index[mesh.devices[coord]]]
            assert torch.equal(block, torch.from_numpy(want_block)), coord


class At:
    """A shape-only ``("data", "model")`` mesh seen from one coordinate:
    what ``ServingMesh`` reads of a ``DeviceMesh`` to place a state."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coord):
        self.shape, self.coord = tuple(shape), tuple(coord)

    def get_coordinate(self):
        return list(self.coord)


def _joined(cfg, shape, mesh_shape, whole):
    """``ServingMesh.place_state``'s blocks of ``whole`` at every
    coordinate of ``mesh_shape``, joined back into one state as the ranks'
    ``gather_state`` joins them: each leaf's blocks put where its
    sharding says, and the ``conv`` blocks of the model ranks of each
    data rank through ``mamba2.whole_channels``."""
    out = {k: torch.zeros_like(v) for k, v in whole.cache.items()}
    out_len = torch.zeros_like(whole.cache_len)
    conv = {}
    for coord in np.ndindex(*mesh_shape):
        sm = zoo.ServingMesh(cfg, shape, At(mesh_shape, coord))
        block = sm.place_state(whole)
        at = dict(zip(("data", "model"), coord))
        for k, v in block.cache.items():
            if k == "conv":
                conv.setdefault(coord[0], []).append(v)
            else:
                local_block(out[k], sm.state_shardings.cache[k], at).copy_(v)
        local_block(out_len, sm.state_shardings.cache_len, at).copy_(
            block.cache_len)
    for d, parts in conv.items():
        rows = ssm_lib.whole_channels(parts, cfg) if sm.heads is not None \
            else parts[0]
        local_block(out["conv"], sm.conv_rows, {"data": d, "model": 0}
                    ).copy_(rows)
    return out, out_len


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-2.7b"])
def test_recurrent_families_over_a_mesh_are_refused(name):
    """ssm and hybrid prefill and decode over a mesh, which ``ServingMesh``
    lays out, the multi-pod mesh too: no mesh of the production shapes
    is refused.

    * At full size on (16, 16) and (2, 16, 16), for prefill_32k,
      decode_32k and long_500k (1 lane, replicated over pod and data),
      on meta tensors: rank 0's ``ssm`` block is its SSM heads' (the
      reference's block), its ``conv`` block the x channels of those
      heads then B and C, its ``k`` / ``v`` the reference's block (2,048
      of 32,768 positions), its lanes ``cache_batch``'s first block over
      the 16 data ranks, or over the 32 pod x data ranks.
    * granite-8b's decode_32k on (2, 16, 16): rank 0 holds lanes [0, 4)
      of 128 and 2,048 positions of every KV head.
    * Reduced, on the CPU, at (1, 2), (2, 2), (4, 2) and (1, 16) (whose
      16 model ranks do not divide the 8 SSM heads: both leaves whole
      on every rank): the blocks ``place_state`` gives each coordinate,
      joined back, are the whole state bit for bit (``gather_state``
      joins them so over gloo ranks in ``tests/test_torch_multirank.py``).
    * A 100-position cache over (1, 16) and (1, 8) builds with the
      reference's layout: ``cache_seq`` replicated, ``kv_heads`` (8)
      over model at (1, 8) and whole at (1, 16)."""
    cfg = ARCHS[name]
    d_inner, nheads, conv_dim, _ = ssm_lib.mamba2_dims(cfg)
    for shape, mesh in itertools.product(
            ("prefill_32k", "decode_32k", "long_500k"),
            (((16, 16), ("data", "model")),
             ((2, 16, 16), ("pod", "data", "model")))):
        sh = SHAPES[shape]
        state = zoo.abstract_decode_state(cfg, sh, MeshShape.of(*mesh))
        lead = state.cache["ssm"].shape[:-4]
        n = np.prod(mesh[0][:-1])
        lanes = sh.global_batch // n if sh.global_batch % n == 0 else 1
        assert state.cache["ssm"].shape == lead + (
            lanes, nheads // 16, cfg.ssm_head_dim, cfg.ssm_state), shape
        assert state.cache["conv"].shape == lead + (
            lanes, cfg.conv_width - 1, d_inner // 16 + 2 * cfg.ssm_state)
        if cfg.family == "hybrid":
            assert state.cache["k"].shape == (
                cfg.num_layers // cfg.attn_every, lanes, sh.seq_len // 16,
                cfg.num_kv_heads, cfg.head_dim)
    small = get_config(name).reduced()
    shape = SHAPES["decode_32k"].reduced()
    whole = zoo.init_decode_state(small, shape, device="cpu")
    gen = torch.Generator().manual_seed(1)
    whole.cache = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
                   for k, v in whole.cache.items()}
    whole.cache_len = torch.arange(shape.global_batch, dtype=torch.int32)
    for mesh_shape in ((1, 2), (2, 2), (4, 2), (1, 16)):
        cache, lens = _joined(small, shape, mesh_shape, whole)
        for k, v in whole.cache.items():
            assert torch.equal(cache[k], v), (mesh_shape, k)
        assert torch.equal(lens, whole.cache_len)
    # the multi-pod mesh: rank 0 holds lanes [0, 4) of 128 (cache_batch
    # over the 32 pod x data ranks), 2,048 of 32,768 positions
    pod = MeshShape.of((2, 16, 16), ("pod", "data", "model"))
    sh = SHAPES["decode_32k"]
    sm = zoo.ServingMesh(ARCHS["granite-8b"], sh, pod)
    assert sm.state_shardings.cache["k"].spec == \
        (None, ("pod", "data"), "model", None, None)
    lanes = local_block(torch.arange(sh.global_batch),
                        sm.state_shardings.cache_len, sm.coord)
    assert lanes.tolist() == [0, 1, 2, 3]
    k = zoo.abstract_decode_state(ARCHS["granite-8b"], sh, pod).cache["k"]
    assert tuple(k.shape) == (ARCHS["granite-8b"].num_layers, 4, 2048,
                              ARCHS["granite-8b"].num_kv_heads,
                              ARCHS["granite-8b"].head_dim)
    odd = ShapeConfig("decode", 100, 4, "decode")
    for m, kv in ((16, None), (8, "model")):
        sm = zoo.ServingMesh(ARCHS["granite-8b"], odd,
                             MeshShape.of((1, m), ("data", "model")))
        assert sm.state_shardings.cache["k"].spec[2:] == (None, kv, None)
