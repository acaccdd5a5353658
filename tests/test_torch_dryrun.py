"""The port's cost analysis (``launch/{hlo_analysis,dryrun,roofline}.py``)
held against the JAX package's.

* The roofline arithmetic: ``wire_bytes_per_device``,
  ``collective_summary`` and ``RooflineTerms`` on the same collective
  lists, and ``extrapolate``, ``cell_roofline``, ``load_table`` and
  ``markdown_table`` on the same records (written in the reference's
  schema): equal, once each package's chip constants are divided out.
* ``cell_fn(cfg, shape)(*input_specs(...)["args"])`` on meta tensors for
  every family and kind at reduced size: the outputs' shapes and dtypes
  are the reference's ``jax.eval_shape`` of its own ``cell_fn``.
* The four kernels' meta branches: outputs of the plain version's shapes,
  one call counted with ``kernel.cost``'s numbers, nothing launched,
  built or run (the plain version is made to raise).
* Reduced granite-8b and mamba2-780m prefills at (1, 1): the per-layer
  FLOP slope against the reference's ``compile_cell`` + ``extract_terms``
  slope (tolerances below), the products in closed form exactly, and the
  L = 4 extrapolation against a direct L = 4 trace exactly.
* Meshes of more than one rank in child processes (the pytest worker
  opens no process group): reduced ``train_4k`` records at (2, 2) and
  (16, 16), reduced prefill and decode records at (2, 2) with their
  collectives in closed form, granite-8b's decode_32k and
  qwen3-moe-30b-a3b's prefill_32k, mamba2-780m's prefill_32k and
  zamba2-2.7b's decode_32k at production size on (16, 16), reduced ssm
  and hybrid serving cells at (16, 16), and the refused cell's named
  error (the pod axis).

Tolerances of the FLOP slope.  XLA's compiled count of a reduced cell is
of its fused CPU program: a fusion recomputes an elementwise producer in
each consumer and counts it again.  granite-8b's slope reads 4.1% under
the compiled one (products are 96% of it), held within 5%.
mamba2-780m's reads 0.58 of it (its Mamba2 block's elementwise work is
fused into many consumers), held between 0.5 and 1.  Against the
reference's unfused count (``Lowered.cost_analysis()``, the same lowering
before XLA's passes) both are held within 8%: granite-8b reads 0.35%
under it, mamba2-780m 5.5% (the SSD kernel counts the causal half of its
chunk products, the reference's jnp form computes the whole square).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import hlo_analysis as JH
from repro.launch import specs as jspecs
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.sharding import ShardingRules as JShardingRules
from repro.launch.sharding import use_rules as juse_rules
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.sharding import ShardingRules, local_block
from repro_torch.launch.specs import cell_fn, input_specs, params_shardings
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
ONE = MeshShape.of((1, 1), ("data", "model"))
FAMILIES = ["granite-8b", "qwen2-moe-a2.7b", "mamba2-780m", "zamba2-2.7b",
            "seamless-m4t-medium", "internvl2-26b"]


def _reference(name):
    """``repro.launch.dryrun`` or ``.roofline``: importing the dry run sets
    ``XLA_FLAGS`` to 512 host devices for its own process; the worker's
    JAX is up already, and its later children keep the worker's flags."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun, roofline
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return {"dryrun": dryrun, "roofline": roofline}[name]


# ------------------------------------------------------- roofline arithmetic
COLLECTIVES = [("all-reduce", 4096, 2), ("all-reduce", 1 << 20, 16),
               ("all-gather", 3 << 16, 4), ("reduce-scatter", 1 << 14, 16),
               ("all-to-all", 8192, 8), ("collective-permute", 512, 2),
               ("all-reduce", 100, 1)]


def test_wire_bytes_and_summary_equal_the_references(monkeypatch):
    port = [H.Collective(*c) for c in COLLECTIVES]
    ref = [JH.Collective(*c) for c in COLLECTIVES]
    assert [H.wire_bytes_per_device(c) for c in port] == \
        [JH.wire_bytes_per_device(c) for c in ref]
    monkeypatch.setattr(JH, "parse_collectives", lambda text: ref)
    want = JH.collective_summary("")
    got = H.collective_summary(port)
    assert got == want
    assert H.total_wire_bytes(got) == JH.total_wire_bytes(want)


def test_roofline_terms_equal_the_references_over_their_constants():
    for args in ((3e14, 2e12, 5e10), (1e9, 4e12, 0.0), (7e13, 1e9, 9e11)):
        got, want = H.RooflineTerms(*args), JH.RooflineTerms(*args)
        g, w = got.as_dict(), want.as_dict()
        for k in ("flops_per_device", "hbm_bytes_per_device",
                  "wire_bytes_per_device"):
            assert g[k] == w[k]
        assert g["t_compute_s"] * H.PEAK_FLOPS == \
            pytest.approx(w["t_compute_s"] * JH.PEAK_FLOPS, rel=1e-12)
        assert g["t_memory_s"] * H.HBM_BW == \
            pytest.approx(w["t_memory_s"] * JH.HBM_BW, rel=1e-12)
        assert g["t_collective_s"] * H.LINK_BW == \
            pytest.approx(w["t_collective_s"] * JH.ICI_BW, rel=1e-12)
    # one dominant term in both
    big = (1e18, 1.0, 1.0)
    assert H.RooflineTerms(*big).dominant() == \
        JH.RooflineTerms(*big).dominant() == "compute"


def _point(L, M, flops, nbytes, wire):
    return {"L": L, "M": M, "flops": flops, "bytes_accessed": nbytes,
            "wire_bytes": wire, "collectives": {}, "compile_s": 0.1}


def _records():
    """Records in the reference's schema: a train cell, a prefill cell, a
    skipped and a failed one."""
    train = {"arch": "granite-8b", "shape": "train_4k", "kind": "train",
             "production_L_units": 36, "production_M": 4, "ok": True,
             "analysis_points": [_point(1, 1, 4e12, 1e11, 2e9),
                                 _point(2, 1, 7e12, 1.8e11, 3.5e9),
                                 _point(1, 2, 8e12, 1.9e11, 3.9e9)],
             "production_single": {"memory": {"peak_hbm_estimate": 3e10},
                                   "n_devices": 256}}
    prefill = {"arch": "mamba2-780m", "shape": "prefill_32k",
               "kind": "prefill", "production_L_units": 48,
               "production_M": 1, "ok": True,
               "analysis_points": [_point(1, 1, 5e12, 2e11, 0.0),
                                   _point(2, 1, 9e12, 3.1e11, 0.0)]}
    return [train, prefill,
            {"arch": "granite-8b", "shape": "long_500k", "kind": "decode",
             "skipped": "long_500k skipped"},
            {"arch": "zamba2-2.7b", "shape": "decode_32k", "kind": "decode",
             "ok": False, "error": "NotImplementedError: refused"}]


def test_roofline_table_equals_the_references(tmp_path):
    JR = _reference("roofline")
    for rec in _records():
        (tmp_path / f"{rec['arch']}__{rec['shape']}.json").write_text(
            json.dumps(rec))
    for rec in _records()[:2]:
        L, M = rec["production_L_units"], rec["production_M"]
        for key in ("flops", "bytes_accessed", "wire_bytes"):
            assert R.extrapolate(rec["analysis_points"], key, rec["kind"],
                                 L, M) == JR.extrapolate(
                rec["analysis_points"], key, rec["kind"], L, M)
        assert R.model_flops(rec["arch"], rec["shape"]) == \
            JR.model_flops(rec["arch"], rec["shape"])
    got, want = R.load_table(tmp_path), JR.load_table(tmp_path)
    assert len(got) == len(want) == 4
    scale = {"t_compute_s": (H.PEAK_FLOPS, JH.PEAK_FLOPS),
             "t_memory_s": (H.HBM_BW, JH.HBM_BW),
             "t_collective_s": (H.LINK_BW, JH.ICI_BW)}
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k in scale:
                assert g[k] * scale[k][0] == pytest.approx(
                    w[k] * scale[k][1], rel=1e-12)
            elif k not in ("dominant", "roofline_fraction"):
                assert g[k] == w[k], k
    assert R.cell_roofline(_records()[0]) == got[1]
    table, ref_table = (R.markdown_table(got).splitlines(),
                        JR.markdown_table(want).splitlines())
    assert len(table) == len(ref_table) == 6
    for a, b in zip(table, ref_table):
        assert a.split("|")[1:3] == b.split("|")[1:3]   # arch, shape
    assert "SKIP" in table[2] and "ERROR" in table[5]   # sorted by file
    assert R.fmt_seconds(2.5) == JR.fmt_seconds(2.5)
    assert R.fmt_seconds(3e-3) == JR.fmt_seconds(3e-3)


def test_roofline_reads_the_traced_terms_of_either_mesh(tmp_path):
    """``--traced`` and ``--mesh multi``: a record's terms read from its
    full-depth production trace on that mesh (rank 0 of 256 or of 512),
    with the useful ratio over that many chips and the trace's own peak;
    a record without a multi-pod trace has no multi-pod row."""
    train = _records()[0]
    for mesh, flops, hbm, wire in (("single", 9e12, 2e11, 4e9),
                                   ("multi", 5e12, 1e11, 6e9)):
        train[f"production_{mesh}"] = {
            "n_devices": R.CHIPS[mesh],
            "memory": {"peak_hbm_estimate": 2**30 * R.CHIPS[mesh] / 256},
            "raw_terms_body_once": {"flops": flops, "bytes_accessed": hbm,
                                    "wire_bytes": wire}}
    for mesh, traced in (("single", True), ("multi", False),
                         ("multi", True)):
        got = R.cell_roofline(train, mesh, traced)
        terms = train[f"production_{mesh}"]["raw_terms_body_once"]
        assert got["t_compute_s"] == terms["flops"] / H.PEAK_FLOPS
        assert got["t_memory_s"] == terms["bytes_accessed"] / H.HBM_BW
        assert got["t_collective_s"] == terms["wire_bytes"] / H.LINK_BW
        assert got["useful_ratio"] == R.model_flops(
            "granite-8b", "train_4k") / (terms["flops"] * R.CHIPS[mesh])
        assert got["peak_hbm_gib"] == R.CHIPS[mesh] / 256
    assert R.cell_roofline(train) != R.cell_roofline(train, traced=True)
    (tmp_path / "a.json").write_text(json.dumps(train))
    (tmp_path / "b.json").write_text(json.dumps(_records()[1]))
    assert [r["arch"] for r in R.load_table(tmp_path, "multi")] == \
        ["granite-8b"]
    assert len(R.load_table(tmp_path, "single")) == 2


# ------------------------------------------------------- cell_fn on meta
def _shapes(tree, jax_side):
    if jax_side:
        return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree)]
    if isinstance(tree, torch.Tensor):
        return [(tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]
    if hasattr(tree, "cache_len"):                     # a DecodeState
        return _shapes((tree.cache, tree.cache_len), False)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _shapes(tree[k], False)]
    return [x for t in tree for x in _shapes(t, False)]


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("name", FAMILIES)
def test_cell_fn_runs_on_meta_as_the_reference_traces(name, kind):
    """The repaired specs compose: ``cell_fn`` runs on ``input_specs``'
    meta args, and its outputs' shapes and dtypes are those of the
    reference's ``cell_fn`` under ``jax.eval_shape``."""
    cfg, jcfg = ARCHS[name].reduced(), JARCHS[name].reduced()
    shape, jshape = SHAPES[kind].reduced(), JSHAPES[kind].reduced()
    args = input_specs(cfg, shape, ShardingRules(ONE))["args"]
    assert all(t.device.type == "meta" for t in
               jax.tree.leaves(args, is_leaf=torch.is_tensor)
               if isinstance(t, torch.Tensor))
    got = cell_fn(cfg, shape)(*args)
    jrules = JShardingRules(jmake_mesh((1, 1), ("data", "model")))
    jargs = jspecs.input_specs(jcfg, jshape, jrules)["args"]
    with juse_rules(jrules):
        want = jax.eval_shape(jspecs.cell_fn(jcfg, jshape), *jargs)
    if kind == "train_4k":       # (state, metrics): the state as trees
        got = (got[0].step, got[0].params, got[0].opt.m, got[0].opt.v,
               got[1])
        want = (want[0].step, want[0].params, want[0].opt.m, want[0].opt.v,
                want[1])
    assert _shapes(got, False) == _shapes(want, True)


# ------------------------------------------------------- kernel meta branches
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _plain_raises(monkeypatch, module, name):
    def plain(*a, **k):
        raise AssertionError(f"{name}: the plain version ran")
    monkeypatch.setattr(module, name, plain)


def _no_build(monkeypatch):
    from repro_torch.kernels import build

    def load(*a, **k):
        raise AssertionError("a kernel was built")
    monkeypatch.setattr(build, "load", load)


def _one_call(counter, name, flops, nbytes):
    assert counter.kernels == {name: {"calls": 1, "flops": flops,
                                      "bytes": nbytes}}
    # nothing but the outputs' allocations and views ran around the call
    assert counter.flops == flops and counter.bytes == nbytes
    assert counter.flops_by_op == {}


def test_ssd_meta_branch(monkeypatch):
    from repro_torch.kernels.ssd import kernel, ops, ssd_intra_chunk_ref
    _no_build(monkeypatch)
    b, nc, l, h, p, n = 2, 3, 16, 4, 8, 16
    cpu = [torch.zeros(s) for s in ((b, nc, l, h, p), (b, nc, l, h),
                                    (b, nc, l, h), (b, nc, l, n),
                                    (b, nc, l, n))]
    want = [t.shape for t in ssd_intra_chunk_ref(*cpu)]
    _plain_raises(monkeypatch, ops, "ssd_intra_chunk_ref")
    args = [t.to("meta") for t in cpu]
    before = kernel.launches
    c = H.CostCounter()
    y, st = c.run(lambda *a: ops.ssd_intra_chunk(*a), *args)
    assert [y.shape, st.shape] == want and y.device.type == "meta"
    assert y.dtype == st.dtype == torch.float32
    _one_call(c, "ssd_intra_chunk", *kernel.cost(*args))
    assert kernel.launches == before


def test_ssd_meta_branch_under_autograd():
    """Forward through ``SSDIntraChunk`` (one counted call), backward the
    plain version's VJP on meta, as on the card (no call counted)."""
    from repro_torch.kernels.ssd import kernel, ops
    args = [_meta(*s).requires_grad_() for s in
            ((1, 2, 16, 4, 8), (1, 2, 16, 4), (1, 2, 16, 4), (1, 2, 16, 16),
             (1, 2, 16, 16))]
    before = kernel.launches

    def step(*a):
        y, st = ops.ssd_intra_chunk(*a)
        (y.sum() + st.sum()).backward()
        return y
    c = H.CostCounter()
    c.run(step, *args)
    assert c.kernels["ssd_intra_chunk"]["calls"] == 1
    assert all(a.grad is not None and a.grad.shape == a.shape
               for a in args)
    assert c.flops > kernel.cost(*args)[0]       # the VJP's own work
    assert kernel.launches == before


def test_paged_meta_branch(monkeypatch):
    from repro_torch.kernels.paged_attention import kernel, ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    _no_build(monkeypatch)
    B, H_, KV, D_, nb, bs, mb = 3, 8, 2, 16, 9, 16, 4
    cpu = (torch.zeros(B, H_, D_), torch.zeros(nb, bs, KV, D_),
           torch.zeros(nb, bs, KV, D_), torch.zeros(B, mb,
                                                    dtype=torch.int32),
           torch.ones(B, dtype=torch.int32))
    want = paged_attention_ref(*cpu).shape
    _plain_raises(monkeypatch, ops, "paged_attention_ref")
    args = [t.to("meta") for t in cpu]
    before = kernel.launches
    c = H.CostCounter()
    out = c.run(ops.paged_attention, *args)
    assert out.shape == want and out.dtype == torch.float32
    flops, nbytes = kernel.cost(*args)
    # on meta every lane counts its table's full width
    assert (flops, nbytes) == kernel.cost(*args, lens=[mb * bs] * B)
    assert flops == 4 * B * mb * bs * H_ * D_
    _one_call(c, "paged_attention", flops, nbytes)
    assert kernel.launches == before


def test_flash_meta_branch(monkeypatch):
    from repro_torch.kernels.flash_attention import kernel, ops
    _no_build(monkeypatch)
    q = torch.zeros(1, 64, 4, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, 16, dtype=torch.bfloat16)
    want = ops.attention(q, k, k, block_q=32, block_kv=32)
    _plain_raises(monkeypatch, ops, "flash_attention_ref")
    before = kernel.launches
    for causal in (True, False):
        c = H.CostCounter()
        out = c.run(lambda a, b: ops.attention(a, b, b, causal=causal,
                                               block_q=32, block_kv=32),
                    q.to("meta"), k.to("meta"))
        assert out.shape == want.shape and out.dtype == want.dtype
        assert out.is_contiguous()      # the kernel writes (B, S, H, D)
        qm, km = q.to("meta").transpose(1, 2), k.to("meta").transpose(1, 2)
        flops, nbytes = kernel.cost(qm, km, km, causal)
        pairs = 64 * 65 // 2 if causal else 64 * 64
        assert flops == 4 * 4 * 16 * pairs
        _one_call(c, "flash_attention", flops, nbytes)
    assert kernel.launches == before


def test_jacobi_meta_branches(monkeypatch):
    from repro_torch.kernels.jacobi import kernel, ops
    _no_build(monkeypatch)
    _plain_raises(monkeypatch, ops, "jacobi_step_ref")
    _plain_raises(monkeypatch, ops, "jacobi_tiles_ref")
    before = kernel.launches
    c = H.CostCounter()
    out = c.run(ops.jacobi, _meta(48, 40))
    assert out.shape == (48, 40) and out.dtype == torch.float32
    _one_call(c, "jacobi", 4 * 48 * 40, 2 * 48 * 40 * 4)
    tiles, dest = _meta(4, 8, 8, dtype=torch.bfloat16), \
        _meta(4, 8, 8, dtype=torch.bfloat16)
    ids, nbr = _meta(3, dtype=torch.int32), _meta(4, 4, dtype=torch.int32)
    c = H.CostCounter()
    out = c.run(ops.jacobi_tiles, tiles, ids, nbr, dest)
    assert out is dest
    _one_call(c, "jacobi", 4 * 3 * 64, 2 * 3 * 64 * 2)
    assert kernel.launches == before


# ------------------------------------------------------- prefill slopes
def _port_points(cfg, shape, Ls):
    out = {}
    for L in Ls:
        counter, _ = D.trace_cell(D._analysis_cfg(cfg, L,
                                                  cfg.num_microbatches),
                                  shape, ONE)
        out[L] = counter
    return out


def _reference_slopes(jcfg, jshape):
    """Per-layer FLOP slope of the reference's compiled cell
    (``compile_cell`` + ``extract_terms``) and of the same lowering
    before XLA's passes."""
    JD = _reference("dryrun")
    mesh = jmake_mesh((1, 1), ("data", "model"))
    compiled, lowered = [], []
    for L in (1, 2):
        c = JD._analysis_cfg(jcfg, L, jcfg.num_microbatches)
        art, _ = JD.compile_cell(c, jshape, mesh, unroll=True,
                                 with_out_shardings=False)
        compiled.append(JH.extract_terms(art)["flops"])
        rules = JShardingRules(mesh)
        spec = jspecs.input_specs(c, jshape, rules)
        with mesh, juse_rules(rules):
            lo = jax.jit(jspecs.cell_fn(c, jshape, unroll=True),
                         in_shardings=spec["in_shardings"]).lower(
                *spec["args"])
        lowered.append(lo.cost_analysis()["flops"])
    return compiled[1] - compiled[0], lowered[1] - lowered[0]


PRODUCTS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm")


def _products(counter):
    return sum(counter.flops_by_op.get(k, 0) for k in PRODUCTS)


def _check_extrapolation(cfg, shape, pts):
    direct = _port_points(cfg, shape, (4,))[4]
    points = [dict(H.extract_terms(pts[L]), L=L, M=1) for L in (1, 2)]
    for key, value in (("flops", direct.flops),
                       ("bytes_accessed", direct.bytes)):
        assert R.extrapolate(points, key, "prefill", 4, 1) == value, key


def test_granite_prefill_costs():
    name = "granite-8b"
    cfg, shape = ARCHS[name].reduced(), SHAPES["prefill_32k"].reduced()
    pts = _port_points(cfg, shape, (1, 2))
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    T, hd, ff = B * S, cfg.head_dim, cfg.d_ff
    H_, KV, V = cfg.num_heads, cfg.num_kv_heads, cfg.padded_vocab
    per_layer = (2 * T * d * (H_ + 2 * KV) * hd + 2 * T * H_ * hd * d
                 + 6 * T * d * ff + 4 * B * H_ * S * S * hd)
    for L in (1, 2):
        assert _products(pts[L]) == L * per_layer + 2 * B * d * V
        assert pts[L].kernels == {}
    slope = pts[2].flops - pts[1].flops
    compiled, lowered = _reference_slopes(JARCHS[name].reduced(),
                                          JSHAPES["prefill_32k"].reduced())
    assert slope == pytest.approx(compiled, rel=0.05)
    assert slope == pytest.approx(lowered, rel=0.08)
    _check_extrapolation(cfg, shape, pts)


def test_mamba2_prefill_costs():
    name = "mamba2-780m"
    cfg, shape = ARCHS[name].reduced(), SHAPES["prefill_32k"].reduced()
    pts = _port_points(cfg, shape, (1, 2))
    B, S, d, V = shape.global_batch, shape.seq_len, cfg.d_model, \
        cfg.padded_vocab
    T, n, p, l = B * S, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk
    d_inner = cfg.ssm_expand * d
    h = d_inner // p
    d_in_proj = 2 * d_inner + 2 * n + h
    # in_proj, out_proj, and the entering states' contribution (y_off)
    per_layer = 2 * T * d * d_in_proj + 2 * T * d_inner * d + 2 * T * n * h * p
    chunks, tri = B * S // l, l * (l + 1) // 2
    kernel_flops = 2 * chunks * (tri * n + h * tri * p + h * l * p * n)
    kernel_bytes = 4 * chunks * (2 * l * h * p + 2 * l * h + 2 * l * n
                                 + h * p * n)
    for L in (1, 2):
        assert _products(pts[L]) == L * per_layer + 2 * B * d * V
        assert pts[L].kernels == {"ssd_intra_chunk": {
            "calls": L, "flops": L * kernel_flops,
            "bytes": L * kernel_bytes}}
    slope = pts[2].flops - pts[1].flops
    compiled, lowered = _reference_slopes(JARCHS[name].reduced(),
                                          JSHAPES["prefill_32k"].reduced())
    assert 0.5 * compiled < slope < compiled
    assert slope == pytest.approx(lowered, rel=0.08)
    _check_extrapolation(cfg, shape, pts)


# ------------------------------------------------------- over meshes
_CHILD = """
import json, sys
from pathlib import Path
from repro_torch.launch import dryrun as D
if sys.argv[4:] != ["full"]:
    D.ARCHS = {k: v.reduced() for k, v in D.ARCHS.items()}
    D.SHAPES = {k: v.reduced() for k, v in D.SHAPES.items()}
mesh = tuple(json.loads(sys.argv[2]))
D.PRODUCTION_MESHES["single"] = (mesh, ("pod", "data", "model")[-len(mesh):])
out = Path(sys.argv[1])
for arch, shape, meshes, *more in json.loads(sys.argv[3]):
    opts, tag = (more + [[], ""][len(more):])[:2]
    D.run_cell(arch, shape, meshes=tuple(meshes), out_dir=out / tag,
               opts=tuple(opts))
"""


def _child(tmp_path, mesh, cells, full=False):
    """The cells traced in a child process (reduced; ``full``: at their
    production size) over a ``mesh`` mesh in place of the single-pod one
    (a shape of 3: with a pod axis): their records, by name (a cell
    ``[arch, shape, meshes, opts, tag]`` traced with ``run_cell``'s
    ``opts``, its record named ``tag/arch__shape``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path),
                          json.dumps(mesh), json.dumps(cells)]
                         + (["full"] if full else []),
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-4000:]
    return {p.relative_to(tmp_path).with_suffix("").as_posix():
            json.loads(p.read_text()) for p in tmp_path.rglob("*.json")}


def _ok(rec):
    assert rec["ok"], rec.get("error")
    points = ([(1, 1), (2, 1), (1, 2)] if rec["kind"] == "train"
              else [(1, 1), (2, 1)])
    assert [(p["L"], p["M"]) for p in rec["analysis_points"]] == points
    assert rec["production_single"]["memory"]["peak_hbm_estimate"] > 0
    return [rec["production_single"]["raw_terms_body_once"]] + \
        rec["analysis_points"]


def test_mesh_records_at_2x2(tmp_path):
    """Rank 0 of a fake group of 4: granite-8b's step all-reduces over
    groups of 2 (wire = result bytes).  Its prefill and decode cells run
    rank 0's per-rank program over the (2, 2) mesh (2 of 4 rows, 32 of 64
    positions of every KV head), their collectives in closed form for L
    layers, B_r = 2 rows, bf16 activations: 1 + 2L all-reduces of
    (B_r, S_q, d) (the embedding, each layer's attention and MLP g), and
    a step's L more of every head's split softmax output (B_r, H, D)
    float32; all-gathers over groups of 2 (wire = half the result, each
    result the gathered whole): a prefill's k and v to (B_r, S, KV, D)
    bf16 before the cache's positions are cut, a step's q/k/v to (B_r,
    1, H + 2 KV, D) bf16 and the softmax statistics (m and l of every
    head, float32) of both ranks, each layer; then the logits' vocab
    blocks to (B_r, 1, V) and rows to (B, 1, V), float32."""
    recs = _child(tmp_path, [2, 2], [
        ["granite-8b", "train_4k", ["single"]],
        ["granite-8b", "prefill_32k", ["single"]],
        ["granite-8b", "decode_32k", ["single"]]])
    for terms in _ok(recs["granite-8b__train_4k"]):
        colls = terms["collectives"]
        assert set(colls) == {"all-reduce"}
        assert colls["all-reduce"]["wire_bytes"] == \
            colls["all-reduce"]["result_bytes"] > 0
    cfg = ARCHS["granite-8b"].reduced()
    d, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    V, B, Br = cfg.padded_vocab, 4, 2
    logits = 4 * (Br * V + B * V)
    for kind, S_q, per_layer, softmax_out in (
            ("prefill", 64, 2 * 2 * Br * 64 * KV * D, 0),
            ("decode", 1, 2 * Br * (H + 2 * KV) * D + 4 * 2 * Br * H * 2,
             4 * Br * H * D)):
        rec = recs[f"granite-8b__{kind}_32k"]
        for terms, L_ in zip(_ok(rec), (cfg.num_layers, 1, 2)):
            colls = terms["collectives"]
            assert set(colls) == {"all-reduce", "all-gather"}
            reduced = (1 + 2 * L_) * 2 * Br * S_q * d + L_ * softmax_out
            assert colls["all-reduce"] == {
                "count": 1 + 2 * L_ + (L_ if softmax_out else 0),
                "result_bytes": reduced, "wire_bytes": reduced}, kind
            gathered = L_ * per_layer + logits
            assert colls["all-gather"] == {
                "count": 2 * L_ + 2, "result_bytes": gathered,
                "wire_bytes": gathered / 2}, kind
        assert rec["production_single"]["n_devices"] == 4


def test_mamba2_mesh_record_at_2x2(tmp_path):
    """mamba2-780m over (2, 2) also all-gathers ``in_proj`` and ``conv_w``
    whole over the model ranks once a step (2 stacked float32 leaves) and
    reduce-scatters their gradients back to the rank's blocks; the SSD
    kernel's calls are counted."""
    recs = _child(tmp_path, [2, 2], [["mamba2-780m", "train_4k",
                                      ["single"]]])
    cfg = ARCHS["mamba2-780m"].reduced()
    d_inner = cfg.ssm_expand * cfg.d_model
    conv_dim = d_inner + 2 * cfg.ssm_state
    d_in_proj = conv_dim + d_inner + d_inner // cfg.ssm_head_dim
    whole = 4 * (cfg.d_model * d_in_proj + cfg.conv_width * conv_dim)
    rec = recs["mamba2-780m__train_4k"]
    for terms, L in zip(_ok(rec), (cfg.num_layers, 1, 2, 1)):
        colls = terms["collectives"]
        assert set(colls) == {"all-reduce", "all-gather", "reduce-scatter"}
        assert colls["all-gather"] == {"count": 2,
                                       "result_bytes": L * whole,
                                       "wire_bytes": L * whole / 2}
        assert colls["reduce-scatter"] == {"count": 2,
                                           "result_bytes": L * whole // 2,
                                           "wire_bytes": L * whole / 2}
        assert terms["kernels"]["ssd_intra_chunk"]["calls"] > 0


def test_pod_mesh_record_at_2x2x1_against_4x1(tmp_path):
    """Reduced granite-8b's train step on a fake (2, 2, 1) ``("pod",
    "data", "model")`` mesh against (4, 1): the 4 rows over the 4 batch
    ranks either way, so rank 0 runs the same FLOPs and bytes, and
    without ZeRO-1 the same collectives (the gradient and metrics
    all-reduced over a group of 4), at the production point and at every
    analysis point.  With ZeRO-1 the blocks are over ``data`` alone:
    halves on (2, 2, 1), quarters on (4, 1).  So, with N leaves of P
    float32 bytes: N reduce-scatters of P / 2 bytes (P / 4 on (4, 1)),
    then the pod all-reduce of each block, N more all-reduces of P / 2
    in all, beside the norm's and the metrics' 2; the same N all-gathers
    of the params, P.  The update on blocks twice as large adds a third
    of the FLOPs that ZeRO-1 saved on (4, 1)."""
    cells = [["granite-8b", "train_4k", ["single"], [], "plain"],
             ["granite-8b", "train_4k", ["single"], ["zero1"], "zero1"]]
    four = _child(tmp_path / "4x1", [4, 1], cells)
    pod = _child(tmp_path / "2x2x1", [2, 2, 1], cells)
    for rec in list(four.values()) + list(pod.values()):
        _ok(rec)
    name = "granite-8b__train_4k"
    for got, want in zip(_ok(pod[f"plain/{name}"]),
                         _ok(four[f"plain/{name}"])):
        got.pop("compile_s", None)
        want.pop("compile_s", None)
        assert got == want
    assert pod[f"plain/{name}"]["production_single"]["n_devices"] == 4
    cfg = ARCHS["granite-8b"].reduced()
    leaves = adamw.flatten(zoo.abstract_state(cfg).params)[0]
    N, P = len(leaves), sum(4 * t.numel() for t in leaves)
    plain, z4, z2 = (r["production_single"]["raw_terms_body_once"]
                     for r in (four[f"plain/{name}"], four[f"zero1/{name}"],
                               pod[f"zero1/{name}"]))
    count = {k: (c["count"], c["result_bytes"])
             for k, c in z4["collectives"].items()}
    assert count == {"reduce-scatter": (N, P // 4), "all-gather": (N, P),
                     "all-reduce": (2, 16)}
    count = {k: (c["count"], c["result_bytes"])
             for k, c in z2["collectives"].items()}
    assert count == {"reduce-scatter": (N, P // 2), "all-gather": (N, P),
                     "all-reduce": (N + 2, P // 2 + 16)}
    assert plain["flops"] - z4["flops"] == 3 * (z2["flops"] - z4["flops"])


def test_mesh_records_at_16x16(tmp_path):
    """The single-pod mesh: rank 0 of a fake group of 256, every
    all-reduce over a group of 16 (ring wire bytes 2 x 15/16 of the
    result).  The multi-pod mesh, rank 0 of a fake group of 512: a train
    and a decode record ``ok`` with ``n_devices`` 512; the reduced
    batch's 4 rows replicated over the 32 pod x data ranks as over the
    16 data ranks, so rank 0 runs the same FLOPs and bytes and the same
    collectives, but for the gradient's and the metrics' all-reduces
    (float32, every parameter and 3 metrics), now over the batch group of
    32 (2 x 31/32 of their result bytes on the wire against 2 x 15/16).
    Reduced mamba2-780m's prefill and zamba2-2.7b's decode over the mesh
    trace: their 8 SSM heads do not split over 16, so each rank runs the
    Mamba2 blocks whole (the SSD kernel's meta branch once a layer in
    the prefill) and the model axis carries only the vocab-parallel
    embedding's all-reduce and the logits' gather (the 4 rows are
    replicated over the 16 data ranks), plus, in zamba2-2.7b's step,
    each period's attention over the cache's 4 positions a rank (heads
    and KV heads whole: a gather of the softmax statistics and an
    all-reduce of the output) and its MLP's g (d_ff split)."""
    recs = _child(tmp_path, [16, 16], [
        ["granite-8b", "train_4k", ["single", "multi"]],
        ["mamba2-780m", "prefill_32k", ["single"]],
        ["zamba2-2.7b", "decode_32k", ["single", "multi"]]])
    for terms in _ok(recs["granite-8b__train_4k"]):
        ar = terms["collectives"]["all-reduce"]
        assert ar["wire_bytes"] == pytest.approx(
            2 * ar["result_bytes"] * 15 / 16, rel=1e-12)
    train = recs["granite-8b__train_4k"]
    assert train["production_single"]["n_devices"] == 256
    # the bytes of rank 0's gradient (its model blocks) and 3 metrics
    rules = ShardingRules(MeshShape.of((16, 16), ("data", "model")))
    dense = ARCHS["granite-8b"].reduced()
    grads = 3 * 4 + 4 * sum(
        local_block(t, s, {"data": 0, "model": 0}).numel()
        for t, s in zip(adamw.flatten(zoo.abstract_state(dense).params)[0],
                        adamw.flatten(params_shardings(dense, rules))[0]))
    for rec in (train, recs["zamba2-2.7b__decode_32k"]):
        one, two = (rec[f"production_{k}"] for k in ("single", "multi"))
        assert two["n_devices"] == 512
        one, two = one["raw_terms_body_once"], two["raw_terms_body_once"]
        for key in ("flops", "bytes_accessed", "kernels"):
            assert one[key] == two[key], key
        gap = 2 * grads * (31 / 32 - 15 / 16) if rec is train else 0
        for kind, c in one["collectives"].items():
            d = two["collectives"][kind]
            assert (d["count"], d["result_bytes"]) == \
                (c["count"], c["result_bytes"]), kind
            assert d["wire_bytes"] - c["wire_bytes"] == pytest.approx(
                gap if kind == "all-reduce" else 0, rel=1e-9, abs=1e-6)
    ssm = ARCHS["mamba2-780m"].reduced()
    for terms, L_ in zip(_ok(recs["mamba2-780m__prefill_32k"]),
                         (ssm.num_layers, 1, 2)):
        assert terms["kernels"]["ssd_intra_chunk"]["calls"] == L_
        assert {k: c["count"] for k, c in terms["collectives"].items()} == \
            {"all-reduce": 1, "all-gather": 1}
    hybrid = ARCHS["zamba2-2.7b"].reduced()
    for terms, P in zip(_ok(recs["zamba2-2.7b__decode_32k"]),
                        (hybrid.num_layers // hybrid.attn_every, 1, 2)):
        assert "kernels" not in terms or not terms["kernels"]
        assert {k: c["count"] for k, c in terms["collectives"].items()} == \
            {"all-reduce": 1 + 2 * P, "all-gather": 1 + P}


@pytest.mark.parametrize("cell", ["granite-8b__decode_32k",
                                  "qwen3-moe-30b-a3b__prefill_32k",
                                  "mamba2-780m__prefill_32k",
                                  "zamba2-2.7b__decode_32k"])
def test_serving_records_at_16x16_full_size(cell, tmp_path):
    """Four cells at their production size on (16, 16), rank 0 of a fake
    group of 256, each in a child of its own within its timeout.
    granite-8b's decode_32k, 8 of 128 lanes a data rank, 2048 of 32768
    positions of all 8 KV heads (which do not divide 16: each rank
    projects them whole) and 2 of 32 query heads a model rank: 1 + 2 x
    36 all-reduces of (8, 1, 4096) bf16 and 36 of the split softmax
    output (8, 8, 4, 1, 128) float32; all-gathers each layer of q (to
    (8, 1, 32, 128) bf16) and of the softmax statistics (16 x (8, 8, 4,
    1, 2) float32), then the logits' vocab blocks and rows.
    qwen3-moe-30b-a3b's prefill_32k, 2 of 32 rows, its 128 experts split
    over 16 (explicit expert parallelism): 1 + 3 x 48 all-reduces (the
    embedding; each layer's attention g, the experts' float32 combine
    and the aux loss over the data ranks); its 4 KV heads replicated, so
    the cache's positions are a slice and the logits' two gathers are
    the only all-gathers; the flash kernel's meta branch counted once a
    layer.  mamba2-780m's prefill_32k, 2 of 32 rows of 32768 tokens, 3
    of 48 SSM heads a model rank: 1 + 2 x 48 all-reduces, the
    embedding's and each layer's ``out_proj`` (2, 32768, 1536) bf16 and
    ``ssm_norm``'s squares (2, 32768, 1) float32; the logits' two
    gathers; the SSD kernel once a layer.  zamba2-2.7b's decode_32k, 8
    of 128 lanes, 5 of 80 SSM heads, 2 of 32 attention and KV heads and
    2048 positions a rank: 1 + 2 x 54 Mamba2 all-reduces as mamba2's
    (of (8, 1, 2560)), and each of the 9 periods' shared attention as
    granite-8b's layer (its g, the MLP's g, the split softmax output (8,
    32, 1, 1, 80) float32; its q/k/v to (8, 1, 96, 80) bf16 and the
    statistics); no kernel in a step."""
    arch, shape = cell.split("__")
    rec = _child(tmp_path, [16, 16], [[arch, shape, ["single"]]],
                 full=True)[cell]
    terms = _ok(rec)[0]
    colls = terms["collectives"]
    cfg = ARCHS[arch]
    L_, V = cfg.num_layers, cfg.padded_vocab
    if arch == "granite-8b":
        assert colls["all-reduce"]["count"] == 1 + 3 * L_
        assert colls["all-reduce"]["result_bytes"] == \
            (1 + 2 * L_) * 8 * 4096 * 2 + L_ * 8 * 8 * 4 * 128 * 4
        assert colls["all-gather"]["count"] == 2 * L_ + 2
        assert colls["all-gather"]["result_bytes"] == L_ * (
            8 * 32 * 128 * 2 + 16 * 8 * 8 * 4 * 2 * 4) + 4 * (
            8 * V + 128 * V)
    elif arch == "mamba2-780m":
        S, d = 32768, cfg.d_model
        assert colls["all-reduce"]["count"] == 1 + 2 * L_
        assert colls["all-reduce"]["result_bytes"] == \
            (1 + L_) * 2 * S * d * 2 + L_ * 2 * S * 4
        assert colls["all-gather"]["count"] == 2
        assert colls["all-gather"]["result_bytes"] == 4 * (2 * V + 32 * V)
        assert terms["kernels"]["ssd_intra_chunk"]["calls"] == L_
    elif arch == "zamba2-2.7b":
        P, d = L_ // cfg.attn_every, cfg.d_model
        assert colls["all-reduce"]["count"] == 1 + 2 * L_ + 3 * P
        assert colls["all-reduce"]["result_bytes"] == \
            (1 + L_ + 2 * P) * 8 * d * 2 + L_ * 8 * 4 + P * 8 * 32 * 80 * 4
        assert colls["all-gather"]["count"] == 2 * P + 2
        assert colls["all-gather"]["result_bytes"] == P * (
            8 * 96 * 80 * 2 + 16 * 8 * 32 * 2 * 4) + 4 * (8 * V + 128 * V)
        assert not terms.get("kernels")
    else:
        assert colls["all-reduce"]["count"] == 1 + 3 * L_
        assert colls["all-gather"]["count"] == 2
        assert terms["kernels"]["flash_attention"]["calls"] == L_
    assert rec["production_single"]["n_devices"] == 256
