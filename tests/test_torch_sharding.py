"""The port's sharding rules and specs, held against the JAX package.

First the reference's ``tests/test_sharding.py``, case for case, on the
port (its ``(1, 1)`` mesh a shape-only ``MeshShape``: a pytest worker
opens no process group).  Then the port's ``ShardingRules.spec`` against
the reference's ``PartitionSpec``, entry for entry, for every parameter
leaf of every arch, the train / prefill / decode batches and the decode
state, with and without ZeRO-1: on the reference's real host meshes
(1,1), (2,1), (4,1), (4,2) and (8,1) (the test process has 8 JAX host
devices, ``tests/conftest.py``), and on the production meshes (16,16)
and (2,16,16), where both sides read a shape-only mesh, as the
reference's own ``FakeMesh`` test does.  The port's side never needs a
process group: the rules read axis names and sizes only.  The DTensor
placements of the same specs are held to JAX's shards on real gloo ranks
in ``tests/test_torch_multirank.py``.
"""

import jax
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.sharding import ShardingRules as JShardingRules
from repro.models import model_zoo as jzoo
from repro.models import transformer as JT
from repro.models.schema import is_spec as jis_spec
from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.sharding import (NamedSharding, ShardingRules,
                                         constrain, use_rules)
from repro_torch.launch.specs import (_zero1_extend, batch_shardings,
                                      decode_state_shardings,
                                      metrics_shardings, params_shardings,
                                      state_shardings)
from repro_torch.models import model_zoo as zoo
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.schema import _leaves
from repro_torch.optim import adamw

REAL_MESHES = [(1, 1), (2, 1), (4, 1), (4, 2), (8, 1)]
PRODUCTION_MESHES = [((16, 16), ("data", "model")),
                     ((2, 16, 16), ("pod", "data", "model"))]


@pytest.fixture(scope="module")
def rules():
    # CPU-scale stand-in mesh with the production axis names
    return ShardingRules(MeshShape.of((1, 1), ("data", "model")))


# ------------------------------------------- tests/test_sharding.py, mirrored
def test_spec_dedup_never_reuses_axis(rules):
    # both dims prefer 'model'; only the first may take it
    spec = rules.spec(("experts", "expert_ff"), (16, 32))
    flat = [a for part in spec for a in
            ((part,) if isinstance(part, str) else (part or ()))]
    assert len(flat) == len(set(flat))


def test_divisibility_fallback():
    rules4 = ShardingRules(MeshShape.of((1, 1), ("data", "model")))
    assert rules4.mesh_axes_for("heads", 24) in ("model", None)
    # non-divisible -> None (llama 24 heads on a 16-way axis)

    class FakeMesh:
        shape = {"data": 1, "model": 16}
        axis_names = ("data", "model")
    fr = ShardingRules.__new__(ShardingRules)
    fr.mesh = FakeMesh()
    fr.axes = {"data", "model"}
    assert fr.mesh_axes_for("heads", 24) is None
    assert fr.mesh_axes_for("heads", 32) == "model"
    assert fr.mesh_axes_for("experts", 60) is None
    assert fr.mesh_axes_for("experts", 128) == "model"


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_params_shardings_cover_schema(name, rules):
    sch = T.model_schema(ARCHS[name])
    psh = params_shardings(ARCHS[name], rules)
    specs = list(_leaves(sch))
    shardings = adamw.flatten(psh)[0]
    assert len(specs) == len(shardings)
    for s, sh in zip(specs, shardings):
        assert isinstance(sh, NamedSharding)
        assert len(sh.spec) <= len(s.shape)


def test_padded_vocab_always_divides_production_axis():
    for cfg in ARCHS.values():
        assert cfg.padded_vocab % 16 == 0
        assert cfg.padded_vocab >= cfg.vocab_size


def test_zero1_extends_first_free_dim():
    mesh = MeshShape.of((1, 1), ("data", "model"))
    rules = ShardingRules(mesh)
    sh = NamedSharding(mesh, (None, "model"))
    out = _zero1_extend(sh, (8, 16), rules)
    assert out.spec[0] == "data"


@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (2, 2, 2), (2, 16, 16)])
@pytest.mark.parametrize("spec, shape", [
    ((None, "model"), (8, 16)),          # the first free dim takes data
    (("model", None), (16, 3)),          # none divides: unchanged
    (("model",), (256,)),                # model then data on one dim
    ((("pod", "data"), None), (32, 16)), # pod already splits dim 0
    ((("pod", "data"),), (64,)),         # and nothing else is free
    (("pod", None), (4, 32)),            # pod alone: data on dim 1
    ((None, None, "model"), (3, 5, 32))])
def test_zero1_extend_never_scatters_over_pod(mesh_shape, spec, shape,
                                              monkeypatch):
    """``zero1_extend`` on meshes with a pod axis, against the
    reference's (``repro/launch/sharding.py:142-162``): it adds ``data``
    to the first dimension that takes it and never to one that ``pod``
    already splits, so ZeRO-1 blocks are over ``data`` alone and the
    same on every pod."""
    axes = ("pod", "data", "model")
    jr, _ = _reference_rules(mesh_shape, axes)
    ours = ShardingRules(MeshShape.of(mesh_shape, axes))
    got = _zero1_extend(NamedSharding(ours.mesh, spec), shape, ours).spec
    assert got == _fake_zero1(jr, spec, shape, monkeypatch), (spec, got)
    assert all("pod" not in (e if isinstance(e, tuple) else (e,))
               for e, before in zip(got, spec + (None,) * len(shape))
               if e != before)


def test_batch_shardings_match_batch_spec(rules):
    cfg = ARCHS["internvl2-26b"]
    bsh = batch_shardings(cfg, SHAPES["train_4k"], rules)
    assert set(bsh) == {"tokens", "labels", "patch_embeds"}


# ------------------------------------------- the port's specs vs the reference's
def _jax_spec(p) -> tuple:
    return tuple(p)


def _reference_rules(shape, axes):
    """The reference's rules on a real host mesh, or (production shapes)
    on a shape-only mesh set up as its ``FakeMesh`` test does."""
    if len(jax.devices()) >= _prod(shape):
        return JShardingRules(jmake_mesh(shape, axes)), True

    class FakeMesh:
        pass
    fake = FakeMesh()
    fake.shape = dict(zip(axes, shape))
    fake.axis_names = tuple(axes)
    jr = JShardingRules.__new__(JShardingRules)
    jr.mesh = fake
    jr.axes = set(axes)
    return jr, False


def _prod(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def _cells(name):
    cfg = ARCHS[name]
    return [SHAPES[s] for s in ("train_4k", "prefill_32k", "decode_32k",
                                "long_500k")
            if shape_applicable(cfg, SHAPES[s])[0]]


# the pod axis on real host meshes: the shapes the multi-rank tests run
POD_MESHES = [(s, ("pod", "data", "model"))
              for s in ((2, 1, 1), (2, 2, 1), (2, 1, 2))]
MESHES = ([(s, ("data", "model")) for s in REAL_MESHES] + PRODUCTION_MESHES
          + POD_MESHES)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_specs_equal_the_references(name, mesh, monkeypatch):
    """Every parameter leaf (plain and ZeRO-1), every batch leaf of every
    cell the arch runs, every decode-state leaf: the port's spec is the
    reference's ``PartitionSpec``, entry for entry."""
    shape, axes = mesh
    cfg, jcfg = ARCHS[name], JARCHS[name]
    jr, real = _reference_rules(shape, axes)
    ours = ShardingRules(MeshShape.of(shape, axes))
    sch = T.model_schema(cfg)
    jsch = jax.tree.leaves(JT.model_schema(jcfg), is_leaf=jis_spec)
    pleaves = list(_leaves(sch))
    assert [(s.shape, s.axes) for s in pleaves] == \
        [(s.shape, s.axes) for s in jsch]
    checked = 0
    for zero1 in (False, True):
        got = state_shardings(cfg.with_(zero1=zero1), ours)
        got_opt = adamw.flatten(got.opt.m)[0]
        assert got.step.spec == ()
        assert [s.spec for s in adamw.flatten(got.opt.v)[0]] == \
            [s.spec for s in got_opt]
        if real:
            want = jspecs.state_shardings(jcfg.with_(zero1=zero1), jr)
            want_opt = [_jax_spec(s.spec)
                        for s in jax.tree.leaves(want.opt.m)]
            want_params = [_jax_spec(s.spec)
                           for s in jax.tree.leaves(want.params)]
        else:       # the reference's functions, through its rules' spec()
            want_params = [_jax_spec(jr.spec(s.axes, s.shape)) for s in jsch]
            want_opt = want_params
            if zero1:
                want_opt = [_fake_zero1(jr, p, s.shape, monkeypatch)
                            for p, s in zip(want_params, jsch)]
        assert [s.spec for s in adamw.flatten(got.params)[0]] == want_params
        assert [s.spec for s in got_opt] == want_opt
        checked += 2 * len(pleaves)
    for cell in _cells(name):
        got = batch_shardings(cfg, cell, ours)
        spec = zoo.batch_spec(cfg, cell)
        jcell = JSHAPES[cell.name]
        if real:
            want = {k: _jax_spec(v.spec) for k, v in
                    jspecs.batch_shardings(jcfg, jcell, jr).items()}
        else:
            want = {k: _jax_spec(jr.spec(("batch",) + (None,) * (
                len(v.shape) - 1), v.shape)) for k, v in
                jzoo.batch_spec(jcfg, jcell).items()}
        assert {k: tuple(v.shape) for k, v in spec.items()} == \
            {k: tuple(v.shape) for k, v in
             jzoo.batch_spec(jcfg, jcell).items()}
        assert {k: v.spec for k, v in got.items()} == want
        checked += len(want)
        if cell.kind != "decode":
            continue
        got = decode_state_shardings(cfg, cell, ours)
        ab = jzoo.abstract_decode_state(jcfg, jcell)
        assert {k: tuple(v.shape) for k, v in
                zoo.abstract_decode_state(cfg, cell).cache.items()} == \
            {k: tuple(v.shape) for k, v in ab.cache.items()}
        if real:
            w = jspecs.decode_state_shardings(jcfg, jcell, jr)
            want = ({k: _jax_spec(v.spec) for k, v in w.cache.items()},
                    _jax_spec(w.cache_len.spec))
        else:
            ax = jzoo.decode_state_logical_axes(jcfg)
            want = ({k: _jax_spec(jr.spec(ax.cache[k], v.shape))
                     for k, v in ab.cache.items()},
                    _jax_spec(jr.spec(ax.cache_len, (jcell.global_batch,))))
        assert ({k: v.spec for k, v in got.cache.items()},
                got.cache_len.spec) == want
        checked += len(want[0]) + 1
    assert checked > 0


def _fake_zero1(jr, spec, shape, monkeypatch):
    """The reference's ``zero1_extend`` on a shape-only mesh.  It returns
    a ``NamedSharding``, which needs a real mesh, so the test hands it a
    stand-in that keeps the spec (``repro/launch/sharding.py:142-162``)."""
    from repro.launch import sharding as js

    class Carrier:
        def __init__(self, spec):
            self.spec = spec
    with monkeypatch.context() as m:
        m.setattr(js, "NamedSharding", lambda mesh, p: Carrier(p))
        return tuple(js.zero1_extend(Carrier(tuple(spec)), shape, jr).spec)


def test_constrain_is_a_no_op_on_local_tensors(rules):
    import torch
    x = torch.ones(2, 3)
    assert constrain(x, "batch", None) is x
    with use_rules(rules):
        assert constrain(x, "batch", "embed") is x
        with pytest.raises(ValueError):
            constrain(x, "batch")
    assert metrics_shardings(rules)["loss"].spec == ()


def test_placements_follow_the_mesh_order():
    """Shard per mesh dimension; a dimension split over axes listed
    against the mesh's order takes ``_StridedShard`` on the minor axis
    (the layout the multi-rank file checks against JAX's shards)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    mesh = MeshShape.of((4, 2), ("data", "model"))
    assert NamedSharding(mesh, ("data", None)).placements == \
        (Shard(0), Replicate())
    assert NamedSharding(mesh, (None, ("data", "model"))).placements == \
        (Shard(1), Shard(1))
    assert NamedSharding(mesh, (("model", "data"), None)).placements == \
        (_StridedShard(0, split_factor=2), Shard(0))
    pod = MeshShape.of((2, 16, 16), ("pod", "data", "model"))
    assert NamedSharding(pod, (("pod", "data"), "model")).placements == \
        (Shard(0), Shard(0), Shard(1))
    assert NamedSharding(pod, ()).placements == (Replicate(),) * 3


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("name", ["granite-8b", "mamba2-780m",
                                  "internvl2-26b", "seamless-m4t-medium"])
def test_input_specs_equal_the_references(name, cell):
    """``input_specs`` on a real (4, 2) host mesh: the abstract args'
    shapes and dtypes and every in / out sharding's spec are the
    reference's, leaf for leaf (prefill's and decode's parameters in the
    serving layout ``cell_fn`` reads: the reference's stacked leaves
    through ``convert.params_from_numpy``); ``cell_fn`` gives the cell's
    function."""
    from repro_torch.launch.specs import cell_fn, input_specs
    cfg, jcfg = ARCHS[name], JARCHS[name]
    got = input_specs(cfg, SHAPES[cell], ShardingRules(
        MeshShape.of((4, 2), ("data", "model"))))
    want = jspecs.input_specs(jcfg, JSHAPES[cell], JShardingRules(
        jmake_mesh((4, 2), ("data", "model"))))
    assert got["kind"] == want["kind"] == SHAPES[cell].kind

    def flat(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k])]
        if isinstance(tree, (tuple, list)) and not isinstance(
                tree, NamedSharding) and not hasattr(tree, "shape"):
            return [x for t in tree for x in flat(t)]
        if hasattr(tree, "cache"):          # a DecodeState
            return flat(tree.cache) + flat(tree.cache_len)
        return [tree]

    def jflat(tree):
        return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
            x, jax.sharding.NamedSharding))
    for key in ("in_shardings", "out_shardings"):
        g, w = flat(got[key]), jflat(want[key])
        assert len(g) == len(w) > 1
        assert [s.spec for s in g] == [_jax_spec(s.spec) for s in w], key
    got_args, want_args = got["args"], want["args"]
    if cell != "train_4k":
        ref_params = params_from_numpy(jax.tree.map(
            lambda s: torch.empty(s.shape, device="meta"), want_args[0]),
            cfg, device=None)
        g, w = flat(got_args[0]), flat(ref_params)
        assert len(g) == len(w) > 1
        assert [(tuple(a.shape), a.dtype) for a in g] == \
            [(tuple(a.shape), a.dtype) for a in w]
        got_args, want_args = got_args[1:], want_args[1:]
    g, w = flat(got_args), jax.tree.leaves(want_args)
    assert len(g) == len(w) >= 1
    assert [tuple(a.shape) for a in g] == [tuple(a.shape) for a in w]
    assert [str(a.dtype).replace("torch.", "") for a in g] == \
        [str(a.dtype) for a in w]
    assert callable(cell_fn(cfg, SHAPES[cell]))
