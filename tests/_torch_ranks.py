"""Rank programs for ``tests/test_torch_multirank.py``.

Each rank is a process of its own, started by the test with
``subprocess``:

    python tests/_torch_ranks.py SCENARIO RANK WORLD INIT_METHOD OUT_DIR

It runs one thread (``OMP_NUM_THREADS=1`` in its environment before
torch is imported, and ``torch.set_num_threads(1)``), joins a gloo group
through the test's ``file://`` rendezvous, runs the scenario's programs
on the CPU with reduced models, and writes what the test checks to
``OUT_DIR/<scenario>-<rank>.pt``.  It imports torch and the port only,
never JAX: the test process holds the results against the reference.
The ``cuda_one`` scenario is ``tests/test_torch_cuda.py``'s: one NCCL
rank on the card.
"""

import datetime
import os
import sys
from pathlib import Path

os.environ["OMP_NUM_THREADS"] = "1"
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

torch.set_num_threads(1)

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dist as launch_dist  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.train import ElasticTrainer  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

HP = dict(lr=1e-3, warmup_steps=2, total_steps=100)
STEPS = 3
SHAPE = SHAPES["train_4k"].reduced()


def cfg_of(arch, **kw):
    return get_config(arch).reduced().with_(**kw)


def leaves(state):
    """A whole state's leaves as CPU tensors: params, then m, then v."""
    return [t.detach().cpu().clone() for tree in
            (state.params, state.opt.m, state.opt.v)
            for t in adamw.flatten(tree)[0]]


def trained(cfg, n_devices, steps=STEPS, seed=0, model_par=1):
    """``steps`` steps of an ``ElasticTrainer`` over the first
    ``n_devices`` ranks (a ``(n_devices // model_par, model_par)``
    mesh): its metrics, the whole state after (rank 0's), this rank's
    parameter, m and v leaves as the step keeps them, and the routing
    all-gathers of its steps (``launch.sharding.all_gathers``)."""
    tr = ElasticTrainer(cfg, SHAPE, n_devices=n_devices, seed=seed,
                        hp=adamw.HParams(**HP), device="cpu",
                        model_par=model_par)
    before = sharding.all_gathers
    tr.train(steps, log_every=0)
    gathers = sharding.all_gathers - before
    whole = tr.runtime.gathered_state()
    out = {"metrics": tr.metrics_log, "all_gathers": gathers}
    if whole is not None:
        out["state"] = leaves(whole)
        for key, tree in (("local_params", tr.state.params),
                          ("local_m", tr.state.opt.m),
                          ("local_v", tr.state.opt.v)):
            out[key] = [t.detach().clone() for t in adamw.flatten(tree)[0]]
        out["coord"] = tuple(tr.runtime.mesh.get_coordinate())
    return out


POD_AXES = ("pod", "data", "model")


def mesh_axes(mesh_shape):
    """A mesh shape's axis names: ``("data", "model")``, or with a pod
    axis first for a shape of 3."""
    return POD_AXES[-len(mesh_shape):]


def trained_on(cfg, mesh_shape, steps=STEPS, seed=0):
    """``steps`` of ``make_train_step`` over a ``("pod", "data",
    "model")`` mesh of ``mesh_shape`` (the world's first ranks), fed
    ``ElasticTrainer``'s batches (``SyntheticLM`` of ``seed``) from its
    seeded state placed by ``DataParallel.place``: ``trained``'s
    readings, and the all-reduces ``launch.sharding`` counts in the
    steps (the pod all-reduces of the ZeRO-1 blocks)."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(mesh_shape, POD_AXES, device="cpu")
    dp = zoo.DataParallel(cfg, mesh)
    state = dp.place(zoo.init_state(cfg, seed, device="cpu"))
    step = zoo.make_train_step(cfg, adamw.HParams(**HP), mesh=mesh)
    data = SyntheticLM(cfg, SHAPE, seed=seed)
    before = sharding.all_reduces, sharding.all_gathers
    metrics = []
    for i in range(steps):
        state, m = step(state, to_device(data.batch_at(i), "cpu"))
        metrics.append(dict({k: float(v) for k, v in m.items()}, step=i))
    out = {"metrics": metrics,
           "all_reduces": sharding.all_reduces - before[0],
           "all_gathers": sharding.all_gathers - before[1],
           "state": leaves(dp.gather_state(state)),
           "coord": tuple(mesh.get_coordinate())}
    for key, tree in (("local_params", state.params),
                      ("local_m", state.opt.m), ("local_v", state.opt.v)):
        out[key] = [t.detach().clone() for t in adamw.flatten(tree)[0]]
    return out


def placements_of(mesh_shape, cfg):
    """Every ZeRO-1 opt leaf of ``cfg`` distributed over a ``mesh_shape``
    mesh by its placements: this rank's block of a seeded whole."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import ShardingRules
    from repro_torch.launch.specs import state_shardings
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    sh = adamw.flatten(state_shardings(cfg.with_(zero1=True),
                                       ShardingRules(mesh)).opt.m)[0]
    schema = adamw.flatten(zoo.abstract_state(cfg).params)[0]
    gen = torch.Generator().manual_seed(5)
    out = []
    for s, leaf in zip(sh, schema):
        whole = torch.randn(leaf.shape, generator=gen)
        d = distribute_tensor(whole, mesh, s.placements)
        out.append((tuple(mesh.get_coordinate()), s.spec, d.to_local()))
    return out


def elastic(cfg, world):
    """The reference's ``test_elastic_shrink_expand_8dev`` at ``world``
    ranks: ``world -> world/2 -> world`` beside an unrescaled twin, the
    gathered state before and after each rescale."""
    a = ElasticTrainer(cfg, SHAPE, n_devices=world, seed=11, device="cpu")
    b = ElasticTrainer(cfg, SHAPE, n_devices=world, seed=11, device="cpu")
    a.train(2, log_every=0)
    b.train(2, log_every=0)
    same = []
    for n, steps in ((world // 2, 2), (world, 2)):
        before = b.runtime.gathered_state()
        before = leaves(before) if before is not None else None
        b.rescale(n)
        after = b.runtime.gathered_state()
        if before is not None:
            same.append(after is not None and all(
                x.dtype == y.dtype and torch.equal(x, y)
                for x, y in zip(before, leaves(after))))
        b.train(steps, log_every=0)
    a.train(4, log_every=0)
    return {"a": [m["loss"] for m in a.metrics_log],
            "b": [m["loss"] for m in b.metrics_log],
            "b_steps": [m["step"] for m in b.metrics_log],
            "events": [(e.kind, e.from_devices, e.to_devices, e.stages)
                       for e in b.runtime.events],
            "bit_equal": same}


def scenario_two(world):
    granite = cfg_of("granite-8b", compute_dtype="float32")
    out = {"float32": trained(granite, world),
           "bf16": trained(cfg_of("granite-8b"), world),
           "zero1": trained(granite.with_(zero1=True,
                                          grad_schedule="overlapped"), world),
           "bf16_reduce": trained(granite.with_(
               zero1=True, grad_reduce_dtype="bfloat16"), world),
           "mamba2": trained(cfg_of("mamba2-780m", compute_dtype="float32"),
                             world),
           "placements": placements_of((world, 1), granite)}
    out["pod"] = trained_on(granite, (world, 1, 1))
    from repro_torch.launch import mesh as launch_mesh
    host = launch_mesh.make_host_mesh(world, 1, device="cpu")
    out["host_mesh"] = (tuple(host.shape), host.mesh_dim_names,
                        tuple(host.get_coordinate()))
    for key, make in (("too_big", lambda: launch_mesh.make_mesh(
            (2 * world, 1), ("data", "model"), device="cpu")),
            ("production", lambda: launch_mesh.make_production_mesh(
                device="cpu"))):
        try:
            make()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    for key, cfg, model_par, error in (
            ("one_head_tp", cfg_of("mamba2-780m", ssm_head_dim=128), 2,
             ValueError),
            ("micro3", granite.with_(num_microbatches=3), 1, ValueError),
            ("moe_micro3", cfg_of("qwen2-moe-a2.7b", num_microbatches=3),
             1, ValueError)):
        try:
            trained(cfg, world, steps=1, model_par=model_par)
            out[key] = None
        except error as e:
            out[key] = str(e)
    return out


def spmd_stencil(world):
    """The SPMD Jacobi step over the world's ranks (a (world,) mesh, odf
    4, 5 iterations) on the reference test's grid shape, from a seeded
    numpy draw: the global grid after, and this rank's block through
    ``local``."""
    import numpy as np
    from repro_torch.core.spmd_stencil import make_jacobi_spmd_step
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("data",), device="cpu")
    grid = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (world * 4 * 4, 32)).astype(np.float32))
    step = make_jacobi_spmd_step(mesh, odf=4, n_iters=5)
    b = grid.shape[0] // world
    rank = mesh.get_local_rank("data")
    return {"global": step(grid),
            "local": step.local(grid[rank * b:(rank + 1) * b])}


# qwen2-moe-a2.7b's layouts over a model axis (reduced: 8 experts of
# d_ff 32): the experts split (grouped, one-hot), each expert's d_ff split
# (5 experts: the axis does not divide them), the expert weights
# replicated (5 experts of d_ff 33), and capacity drops in one group
MOE_LAYOUTS = {"moe_grouped": dict(moe_impl="grouped"),
               "moe_onehot": dict(moe_impl="onehot"),
               "moe_ff": dict(num_experts=5),
               "moe_replicated": dict(num_experts=5, d_ff=33),
               "moe_drops": dict(moe_impl="grouped", moe_groups=1,
                                 capacity_factor=0.5)}


# qwen2-moe-a2.7b's batch over data ranks (reduced: 8 experts, top 2, a
# batch of 4 rows of 64 tokens in 2 micro-batches): the one-hot dispatch
# and one routing group, each routing a micro-batch across the ranks
# (also with tokens dropped across the rank boundary), one-row
# micro-batches (each whole on a rank), and the reduced default (2-row
# micro-batches over 4 ranks: 2 ranks a micro-batch)
MOE_DATA = {"moe_onehot": dict(moe_impl="onehot"),
            "moe_groups1": dict(moe_impl="grouped", moe_groups=1),
            "moe_onehot_drops": dict(moe_impl="onehot", capacity_factor=0.5),
            "moe_micro4": dict(num_microbatches=4),
            "moe_default": {}}


def scenario_moe_two(world):
    """moe over 2 data ranks, (2, 1), float32: ``MOE_DATA``'s one-hot,
    one-group, dropping and one-row micro-batch cases."""
    return {key: trained(cfg_of("qwen2-moe-a2.7b", compute_dtype="float32",
                                **MOE_DATA[key]), world)
            for key in ("moe_onehot", "moe_groups1", "moe_onehot_drops",
                        "moe_micro4")}


def scenario_moe_four(world):
    """moe over the data ranks of 4: the one-hot, one-group and one-row
    micro-batch cases at (2, 2) in float32 (the last with "auto": the
    explicit-EP fallback), the reduced default at (4, 1), and the
    one-hot dispatch in bf16 at (2, 2)."""
    out = {key: trained(cfg_of("qwen2-moe-a2.7b", compute_dtype="float32",
                               **MOE_DATA[key]), world, model_par=2)
           for key in ("moe_onehot", "moe_groups1", "moe_micro4")}
    out["moe_default"] = trained(cfg_of("qwen2-moe-a2.7b",
                                        compute_dtype="float32"), world)
    out["moe_onehot_bf16"] = trained(cfg_of("qwen2-moe-a2.7b",
                                            **MOE_DATA["moe_onehot"]),
                                     world, model_par=2)
    return out


def own_storage(state) -> bool:
    """Whether every leaf of a placed state owns a storage of its own
    size (not a view of a larger, whole leaf)."""
    return all(t.untyped_storage().nbytes() == t.numel() * t.element_size()
               for tree in (state.params, state.opt.m, state.opt.v)
               for t in adamw.flatten(tree)[0])


def scenario_tp_two(world):
    """The model axis over 2 ranks: the SPMD stencil; reduced granite-8b
    (float32) and qwen2-moe-a2.7b (float32) at (1, 2), granite-8b with
    one KV head (replicated KV heads, sharded query heads) at (1, 2),
    qwen2-moe-a2.7b at (2, 1); mamba2-780m and zamba2-2.7b (float32) at
    (1, 2); seamless-m4t-medium (also with one KV head: cross attention's
    KV heads replicated) and internvl2-26b (float32) at (1, 2); every
    moe layout of ``MOE_LAYOUTS`` (float32) at (1, 2), and the one-hot
    dispatch in bf16; whether a placed state's leaves own their
    storage."""
    f32 = dict(compute_dtype="float32")
    moe = {key: trained(cfg_of("qwen2-moe-a2.7b", **kw, **f32), world,
                        model_par=2) for key, kw in MOE_LAYOUTS.items()}
    placed = {}
    for key, arch, kw in (("dense", "granite-8b", dict(zero1=True)),
                          ("moe_ff", "qwen2-moe-a2.7b",
                           dict(num_experts=5))):
        tr = ElasticTrainer(cfg_of(arch, **kw), SHAPE, n_devices=world,
                            device="cpu", model_par=2)
        placed[key] = own_storage(tr.state)
    return {"stencil": spmd_stencil(world), **moe, "own_storage": placed,
            "moe_onehot_bf16": trained(cfg_of("qwen2-moe-a2.7b",
                                              moe_impl="onehot"), world,
                                       model_par=2),
            "enc_dec": trained(cfg_of("seamless-m4t-medium", **f32), world,
                               model_par=2),
            "enc_dec_kv1": trained(cfg_of("seamless-m4t-medium",
                                          num_kv_heads=1, **f32), world,
                                   model_par=2),
            "vlm": trained(cfg_of("internvl2-26b", **f32), world,
                           model_par=2),
            "ssm": trained(cfg_of("mamba2-780m", **f32), world, model_par=2),
            "hybrid": trained(cfg_of("zamba2-2.7b", **f32), world,
                              model_par=2),
            "dense": trained(cfg_of("granite-8b", **f32), world,
                             model_par=2),
            "dense_kv1": trained(cfg_of("granite-8b", num_kv_heads=1,
                                        **f32), world, model_par=2),
            "moe": trained(cfg_of("qwen2-moe-a2.7b", **f32), world,
                           model_par=2),
            "moe_data": trained(cfg_of("qwen2-moe-a2.7b", **f32), world)}


def elastic_tp(cfg, world):
    """``elastic`` over a model axis of 2: ``(world/2, 2) -> (world/4, 2)
    -> (world/2, 2)`` beside an unrescaled twin."""
    def trainer():
        return ElasticTrainer(cfg, SHAPE, n_devices=world, seed=11,
                              device="cpu", model_par=2)
    a, b = trainer(), trainer()
    a.train(2, log_every=0)
    b.train(2, log_every=0)
    same = []
    for n in (world // 2, world):
        before = b.runtime.gathered_state()
        before = leaves(before) if before is not None else None
        b.rescale(n)
        after = b.runtime.gathered_state()
        if before is not None:
            same.append(after is not None and all(
                x.dtype == y.dtype and torch.equal(x, y)
                for x, y in zip(before, leaves(after))))
        b.train(2, log_every=0)
    a.train(4, log_every=0)
    return {"a": [m["loss"] for m in a.metrics_log],
            "b": [m["loss"] for m in b.metrics_log],
            "b_steps": [m["step"] for m in b.metrics_log],
            "events": [(e.kind, e.from_devices, e.to_devices)
                       for e in b.runtime.events],
            "bit_equal": same}


def scenario_tp_four(world):
    """The model axis over 4 ranks: the SPMD stencil; reduced granite-8b
    at (2, 2) in float32, with ZeRO-1 (overlapped) and in bf16;
    qwen2-moe-a2.7b at (2, 2) in float32; the 4 -> 2 -> 4 rescale with a
    model axis of 2; mamba2-780m and zamba2-2.7b at (2, 2) in float32
    and in bf16, and mamba2-780m's 4 -> 2 -> 4 rescale with ZeRO-1;
    seamless-m4t-medium and internvl2-26b at (2, 2) in float32 and in
    bf16, and seamless-m4t-medium's 4 -> 2 -> 4 rescale with ZeRO-1 in
    float32; qwen2-moe-a2.7b grouped (the experts split) and with 5
    experts (each expert's d_ff split) at (2, 2) in float32, the latter
    in bf16 and across the 4 -> 2 -> 4 rescale with ZeRO-1 in float32;
    whether a
    placed ZeRO-1 state's leaves own their storage."""
    f32 = dict(compute_dtype="float32")
    granite = cfg_of("granite-8b", **f32)
    tr = ElasticTrainer(cfg_of("qwen2-moe-a2.7b", num_experts=5,
                               zero1=True), SHAPE, n_devices=world,
                        device="cpu", model_par=2)
    placed = {"moe_ff": own_storage(tr.state)}
    del tr
    return {"stencil": spmd_stencil(world), "own_storage": placed,
            "moe_grouped": trained(cfg_of("qwen2-moe-a2.7b",
                                          moe_impl="grouped", **f32), world,
                                   model_par=2),
            "moe_ff": trained(cfg_of("qwen2-moe-a2.7b", num_experts=5,
                                     **f32), world, model_par=2),
            "moe_ff_bf16": trained(cfg_of("qwen2-moe-a2.7b", num_experts=5),
                                   world, model_par=2),
            "moe_ff_elastic": elastic_tp(cfg_of("qwen2-moe-a2.7b",
                                                num_experts=5, zero1=True,
                                                **f32), world),
            "enc_dec": trained(cfg_of("seamless-m4t-medium", **f32), world,
                               model_par=2),
            "vlm": trained(cfg_of("internvl2-26b", **f32), world,
                           model_par=2),
            "enc_dec_bf16": trained(cfg_of("seamless-m4t-medium"), world,
                                    model_par=2),
            "vlm_bf16": trained(cfg_of("internvl2-26b"), world, model_par=2),
            "enc_dec_elastic": elastic_tp(cfg_of("seamless-m4t-medium",
                                                 zero1=True, **f32), world),
            "ssm": trained(cfg_of("mamba2-780m", **f32), world, model_par=2),
            "hybrid": trained(cfg_of("zamba2-2.7b", **f32), world,
                              model_par=2),
            "ssm_bf16": trained(cfg_of("mamba2-780m"), world, model_par=2),
            "hybrid_bf16": trained(cfg_of("zamba2-2.7b"), world,
                                   model_par=2),
            "ssm_elastic": elastic_tp(cfg_of("mamba2-780m", zero1=True),
                                      world),
            "dense": trained(granite, world, model_par=2),
            "zero1": trained(granite.with_(zero1=True,
                                           grad_schedule="overlapped"),
                             world, model_par=2),
            "bf16": trained(cfg_of("granite-8b"), world, model_par=2),
            "moe": trained(cfg_of("qwen2-moe-a2.7b", **f32), world,
                           model_par=2),
            "elastic": elastic_tp(cfg_of("granite-8b", zero1=True), world)}


def scenario_four(world):
    granite = cfg_of("granite-8b", compute_dtype="float32")
    return {"float32": trained(granite, world),
            "zero1": trained(granite.with_(zero1=True,
                                           grad_schedule="overlapped"), world),
            "placements": placements_of((2, 2), granite),
            "elastic": elastic(cfg_of("granite-8b", zero1=True), world)}


def scenario_cuda_one(world):
    """One NCCL rank on the card: a data-parallel step (plain and ZeRO-1)
    against the single-device step from one state, for reduced
    granite-8b and mamba2-780m (the SSD kernel); and every ZeRO-1 leaf's
    placements through ``distribute_tensor`` on a CUDA mesh of 1."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import ShardingRules
    from repro_torch.launch.specs import state_shardings
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    out = {}
    for arch in ("granite-8b", "mamba2-780m"):
        for zero1 in (False, True):
            cfg = cfg_of(arch, zero1=zero1)
            batch = zoo.make_batch(cfg, SHAPE, seed=1, device=dev)
            runs = []
            for m in (None, mesh):
                state = zoo.init_state(cfg, 0, device=dev)
                step = zoo.make_train_step(cfg, adamw.HParams(**HP), mesh=m)
                if m is not None:
                    state = zoo.DataParallel(cfg, m).place(state)
                state, metrics = step(state, batch)
                if m is not None:
                    state = zoo.DataParallel(cfg, m).gather_state(state)
                runs.append(({k: float(v) for k, v in metrics.items()},
                             leaves(state)))
            (m1, s1), (m2, s2) = runs
            out[(arch, zero1)] = m1 == m2 and all(
                torch.equal(a, b) for a, b in zip(s1, s2))
    cfg = cfg_of("granite-8b", zero1=True)
    sh = adamw.flatten(state_shardings(cfg, ShardingRules(mesh)).opt.m)[0]
    gen = torch.Generator(dev).manual_seed(3)
    same = []
    for s, leaf in zip(sh, adamw.flatten(zoo.abstract_state(cfg).params)[0]):
        whole = torch.randn(leaf.shape, generator=gen, device=dev)
        d = distribute_tensor(whole, mesh, s.placements)
        same.append(d.to_local().is_cuda and torch.equal(d.to_local(), whole)
                    and torch.equal(d.full_tensor(), whole))
    out["placements"] = same
    return out


# serving over a mesh: (case, arch, config overrides, mesh shape, decode?)
# at the reduced prefill_32k / decode_32k shapes (4 rows of 64
# positions; a case of SERVE_SEQ at its own positions); the 2-rank group
# runs the (1, 2) and (2, 1) cases, the 4-rank group the (2, 2) ones
F32 = dict(compute_dtype="float32")
SERVE_CASES = {
    2: (("dense", "granite-8b", F32, (1, 2), True),
        ("dense", "granite-8b", F32, (2, 1), True),
        ("blockwise", "granite-8b", dict(attn_impl="blockwise", **F32),
         (1, 2), False),
        ("kv1", "granite-8b", dict(num_kv_heads=1, **F32), (1, 2), True),
        ("moe_grouped", "qwen2-moe-a2.7b", dict(moe_impl="grouped", **F32),
         (1, 2), True),
        ("moe_onehot", "qwen2-moe-a2.7b", dict(moe_impl="onehot", **F32),
         (1, 2), True),
        ("vlm", "internvl2-26b", F32, (1, 2), True),
        ("enc_dec", "seamless-m4t-medium", F32, (1, 2), True),
        ("bf16", "granite-8b", {}, (1, 2), True),
        ("ssm", "mamba2-780m", F32, (1, 2), True),
        ("ssm", "mamba2-780m", F32, (2, 1), True),
        ("hybrid", "zamba2-2.7b", F32, (1, 2), True),
        ("hybrid", "zamba2-2.7b", F32, (2, 1), True),
        ("dense63", "granite-8b", F32, (1, 2), True),
        ("kv1_63", "granite-8b", dict(num_kv_heads=1, **F32), (1, 2), True),
        ("hybrid63", "zamba2-2.7b", F32, (1, 2), True),
        ("dense", "granite-8b", F32, (2, 1, 1), True),
        ("hybrid", "zamba2-2.7b", F32, (2, 1, 1), True)),
    4: (("dense", "granite-8b", F32, (2, 2), True),
        ("moe_grouped", "qwen2-moe-a2.7b", dict(moe_impl="grouped", **F32),
         (2, 2), True),
        ("moe_onehot", "qwen2-moe-a2.7b", dict(moe_impl="onehot", **F32),
         (2, 2), True),
        ("ssm", "mamba2-780m", F32, (2, 2), True),
        ("hybrid", "zamba2-2.7b", F32, (2, 2), True))}
# cases at other positions than 64: (prefill, decode) positions; 63 is
# not a multiple of a model axis of 2, so the decode state's cache keeps
# every position on each rank (its KV heads over model where they
# divide); hybrid63's prefill stays at 64 (the SSD chunk must divide it)
SERVE_SEQ = {"dense63": (63, 63), "kv1_63": (63, 63), "hybrid63": (64, 63)}
SERVE_STEPS = 4
# the decode lanes' cache_len (S = 64; a model axis of 2 holds 32
# positions a rank): lane 0 writes position 31 on rank 0, then 32-34 on
# rank 1; lane 1 is inactive; lane 2 is full (cache_len == S: no write);
# lane 3's positions all lie on rank 0 (rank 1 holds none of them); each
# at most S where S is smaller
SERVE_LENS = (31, 40, 64, 3)
SERVE_ACTIVE = (1, 0, 1, 1)


def serve_shapes(case):
    """A case's prefill and decode shapes: the reduced prefill_32k and
    decode_32k, at ``SERVE_SEQ``'s positions where it lists the case."""
    import dataclasses
    pshape, dshape = (SHAPES["prefill_32k"].reduced(),
                      SHAPES["decode_32k"].reduced())
    if case in SERVE_SEQ:
        p, d = SERVE_SEQ[case]
        pshape = dataclasses.replace(pshape, seq_len=p)
        dshape = dataclasses.replace(dshape, seq_len=d)
    return pshape, dshape


def serve_inputs(cfg, case, seed=0):
    """A case's inputs, made from ``seed`` with numpy (float32 where the
    model reads bf16; both packages round them to bf16 the same way; the
    float32 ``ssm`` leaf stays float32): the whole parameter tree (the
    port's draw, as numpy), the prefill batch, a decode state (random
    cache, ``SERVE_LENS``) and ``SERVE_STEPS`` steps of tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pshape, dshape = serve_shapes(case)
    B, S = pshape.global_batch, pshape.seq_len
    st = S - cfg.frontend_seq if cfg.family == "vlm" else S
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, st),
                                    dtype=np.int32)}
    if cfg.family == "enc_dec":
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model),
                                              dtype=np.float32)
    elif cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.frontend_seq, cfg.d_model), dtype=np.float32)
    ab = zoo.abstract_decode_state(cfg, dshape)
    cache = {k: rng.standard_normal(tuple(v.shape), dtype=np.float32)
             for k, v in ab.cache.items()}
    params = adamw.tree_map(lambda t: t.numpy(),
                            zoo.init_state(cfg, seed, device="cpu").params)
    lens = [min(n, dshape.seq_len) for n in SERVE_LENS]
    return {"params": params, "batch": batch, "cache": cache,
            "cache_len": np.array(lens, np.int32)[:dshape.global_batch],
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (SERVE_STEPS, dshape.global_batch, 1),
                                   dtype=np.int32),
            "active": np.array(SERVE_ACTIVE, np.int32)}


def _torch_leaf(x, key=None):
    """A numpy input -> a tensor: float32 arrays are bf16 model inputs,
    but for the float32 ``ssm`` leaf."""
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if t.dtype == torch.float32 and \
        key != "ssm" else t


def served(cfg, case, mesh_shape, decode: bool) -> dict:
    """One case over a ``mesh_shape`` mesh of the world's first ranks: the
    prefill's logits and this rank's block of its decode state, then
    (``decode``) ``SERVE_STEPS`` serve steps from the seeded state's
    block, their logits and the final block; the all-reduces and
    all-gathers of the prefill and of each step; the states gathered
    whole (``gather_state``) after them; rank 0 also keeps the inputs
    (the test hands them to the reference)."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(mesh_shape, mesh_axes(mesh_shape), device="cpu")
    if mesh.get_coordinate() is None:
        return {}
    inp = serve_inputs(cfg, case)
    pshape, dshape = serve_shapes(case)
    params = zoo.serving_params(inp["params"], cfg, mesh, device="cpu")

    def counted(fn, *args):
        before = sharding.all_reduces, sharding.all_gathers
        out = fn(*args)
        return out, (sharding.all_reduces - before[0],
                     sharding.all_gathers - before[1])

    batch = {k: _torch_leaf(v) for k, v in inp["batch"].items()}
    (logits, state), colls = counted(
        zoo.make_prefill(cfg, pshape, mesh=mesh), params, batch)
    out = {"coord": tuple(mesh.get_coordinate()),
           "prefill": {"logits": logits, "cache": state.cache,
                       "cache_len": state.cache_len,
                       "collectives": colls,
                       "gathered": zoo.ServingMesh(
                           cfg, pshape, mesh).gather_state(state).cache}}
    if decode:
        sm = zoo.ServingMesh(cfg, dshape, mesh)
        state = sm.place_state(zoo.DecodeState(
            {k: _torch_leaf(v, k) for k, v in inp["cache"].items()},
            torch.from_numpy(inp["cache_len"])))
        step = zoo.make_serve_step(cfg, dshape, mesh=mesh)
        active = torch.from_numpy(inp["active"])
        steps = []
        for tokens in inp["tokens"]:
            (logits, state), colls = counted(
                step, params, state, torch.from_numpy(tokens), active)
            steps.append((logits, colls))
        whole = sm.gather_state(state)
        out["decode"] = {"logits": [lg for lg, _ in steps],
                         "collectives": [c for _, c in steps],
                         "cache": state.cache, "cache_len": state.cache_len,
                         "gathered": whole.cache,
                         "gathered_len": whole.cache_len,
                         "gathered_equal": all(
                             torch.equal(sm.place_state(whole).cache[k],
                                         state.cache[k])
                             for k in state.cache)}
    if torch.distributed.get_rank() == 0:
        out["inputs"] = inp
    return out


def scenario_serve(world, cases=None):
    """``SERVE_CASES[world]`` (or ``cases``): prefill and decode over
    meshes of the world's ranks, each case's readings by name and
    mesh."""
    return {f"{key} {shape}": served(cfg_of(arch, **kw), key, shape, decode)
            for key, arch, kw, shape, decode in (cases or
                                                 SERVE_CASES[world])}


# the pod axis's cases that need 4 ranks: served on (2, 1, 2) and (2, 2, 1)
POD_SERVE_CASES = (("dense", "granite-8b", F32, (2, 1, 2), True),
                   ("dense", "granite-8b", F32, (2, 2, 1), True))


def scenario_pod_four(world):
    """The pod axis over 4 ranks: reduced granite-8b in float32 at (2, 2,
    1), without and with ZeRO-1 (overlapped: the pod all-reduce of each
    block a micro-batch; m and v blocks over data, the same on both
    pods); qwen2-moe-a2.7b one-hot with one micro-batch of the 4 rows,
    routed across both pods, at (2, 2, 1); mamba2-780m at (2, 1, 2);
    granite-8b served at (2, 1, 2) and (2, 2, 1)."""
    granite = cfg_of("granite-8b", **F32)
    out = {"dense": trained_on(granite, (2, 2, 1)),
           "zero1": trained_on(granite.with_(
               zero1=True, grad_schedule="overlapped"), (2, 2, 1)),
           "moe_onehot": trained_on(cfg_of(
               "qwen2-moe-a2.7b", moe_impl="onehot", num_microbatches=1,
               **F32), (2, 2, 1)),
           "ssm": trained_on(cfg_of("mamba2-780m", **F32), (2, 1, 2))}
    out.update(scenario_serve(world, POD_SERVE_CASES))
    return out


def hang(rank, world, device, seconds):
    """A rank that outlives any sensible limit (``launch.dist.spawn``'s
    wall-clock limit is tested with it)."""
    import time
    time.sleep(seconds)


def main():
    scenario, rank, world, init, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    run = {"two": scenario_two, "four": scenario_four,
           "tp_two": scenario_tp_two, "tp_four": scenario_tp_four,
           "moe_two": scenario_moe_two, "moe_four": scenario_moe_four,
           "serve_two": scenario_serve, "serve_four": scenario_serve,
           "pod_four": scenario_pod_four,
           "cuda_one": scenario_cuda_one}[scenario]
    device = "cuda" if scenario.startswith("cuda") else "cpu"
    with launch_dist.process_group(rank, world, init, device,
                                   timeout=datetime.timedelta(seconds=60)):
        out = run(world)
    torch.save(out, Path(out_dir) / f"{scenario}-{rank}.pt")


if __name__ == "__main__":
    main()
