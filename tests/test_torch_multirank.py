"""The port's training over the data and model axes of gloo ranks, and
its SPMD stencil, held against the JAX package.

Every process group of this file lives in child processes: each rank is
``python tests/_torch_ranks.py ...`` started with ``subprocess`` (no
``fork`` of this worker, which has JAX's threads), one thread a rank,
a ``file://`` rendezvous under ``tmp_path`` (no fixed port), and a
timeout a group; this pytest worker never opens a process group.  All
of them are in this one file, so that ``--dist loadfile`` runs them on
one worker, one group at a time: a 2-rank group runs the 2-rank cases, a
4-rank group the cases about 4 (1 row a rank, ZeRO-1 over 4, the
4 -> 2 -> 4 rescale, a (2, 2) mesh's placements), and the launcher
spawns its own 2.  Two more groups hold the model axis: 2 ranks the
SPMD stencil, (1, 2) meshes for dense, ssm, hybrid, enc_dec and vlm
tensor parallelism and moe expert parallelism, and moe at (2, 1); 4
ranks the stencil, (2, 2) meshes (float32, ZeRO-1, bf16, moe, and the
other families) and the 4 -> 2 -> 4 rescales with a model axis of 2.
Two more hold moe's batch over the data ranks: 2 ranks at (2, 1), 4 at
(2, 2) and (4, 1).  The pod axis (``("pod", "data", "model")`` meshes:
the rows over the pod x data ranks, ZeRO-1 over data alone) rides the
2-rank groups at (2, 1, 1) and has a 4-rank group of its own for (2, 2,
1) and (2, 1, 2).  The ranks run reduced models on the CPU (~10-20 s a
group here).

The reference runs in this process: its ``jit`` with ``in_shardings`` on
a real host mesh of the same shape (``tests/conftest.py`` gives 8 host
devices), from the state the port draws (carried as numpy), on the same
``SyntheticLM`` batches.  At a model axis above 1 the reference's moe
takes its explicit expert parallelism, whose routing groups and aux
loss differ from a single device's: the port follows the reference at
each mesh.  Tolerances:

* float32: the same sums in other orders, ~1e-7 relative a step; loss,
  nll and grad_norm within 1e-5 relative, params within 1e-5 relative
  L2 per leaf, m and v within 5e-5 (they carry the gradient's noise
  undamped, as ``tests/test_torch_train.py`` holds them);
* bf16 loss within the reference's own 8e-3 between a sharded and a
  single-device run (``tests/test_multidevice.py:80``);
* elastic: the losses of a rescaled run within 5e-4 of an unrescaled
  twin's (``tests/test_multidevice.py:106``), and the state gathered
  after each rescale equal to the one before it, bit for bit;
* the SPMD stencil: the reference's grid bit for bit.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JSHAPES
from repro.core.spmd_stencil import make_jacobi_spmd_step as jspmd_step
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import specs as jspecs
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.sharding import ShardingRules as JShardingRules
from repro.launch.sharding import use_rules as juse_rules
from repro.models import model_zoo as jzoo
from repro.optim import adamw as jadamw
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dist as launch_dist
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.train import ElasticTrainer
from repro_torch.models import model_zoo as tzoo
from repro_torch.optim import adamw

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RANKS = ROOT / "tests" / "_torch_ranks.py"
GROUP_TIMEOUT_S = 90
HP = dict(lr=1e-3, warmup_steps=2, total_steps=100)
STEPS = 3
F32_METRIC, F32_PARAM, F32_MOMENT = 1e-5, 1e-5, 5e-5
BF16_LOSS = 8e-3
ELASTIC_LOSS = 5e-4
_RUNS = {}


def run_ranks(scenario, world, out_dir):
    """``world`` rank processes of ``scenario``; their results by rank.
    Every rank is killed if the group outlives ``GROUP_TIMEOUT_S``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    init = f"file://{out_dir / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(RANKS), scenario, str(r), str(world), init,
         str(out_dir)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-6000:]}"
    return [torch.load(out_dir / f"{scenario}-{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return run_ranks("two", 2, tmp_path_factory.mktemp("two"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return run_ranks("four", 4, tmp_path_factory.mktemp("four"))


@pytest.fixture(scope="module")
def tp_two(tmp_path_factory):
    return run_ranks("tp_two", 2, tmp_path_factory.mktemp("tp_two"))


@pytest.fixture(scope="module")
def tp_four(tmp_path_factory):
    return run_ranks("tp_four", 4, tmp_path_factory.mktemp("tp_four"))


@pytest.fixture(scope="module")
def moe_two(tmp_path_factory):
    return run_ranks("moe_two", 2, tmp_path_factory.mktemp("moe_two"))


@pytest.fixture(scope="module")
def moe_four(tmp_path_factory):
    return run_ranks("moe_four", 4, tmp_path_factory.mktemp("moe_four"))


# ------------------------------------------------------------- references
def initial(arch, **kw):
    """The state every trainer here starts from (seed 0), as numpy."""
    cfg = get_config(arch).reduced().with_(**kw)
    return tzoo.state_to_numpy(tzoo.init_state(cfg, 0, device="cpu"))


def to_jax(state):
    return jzoo.TrainState(
        jnp.asarray(state.step), jax.tree.map(jnp.asarray, state.params),
        jadamw.AdamWState(jax.tree.map(jnp.asarray, state.opt.m),
                          jax.tree.map(jnp.asarray, state.opt.v)))


def state_leaves(state):
    """A numpy state's leaves, params then m then v (either package)."""
    return [np.asarray(x) for tree in (state.params, state.opt.m,
                                       state.opt.v)
            for x in jax.tree.leaves(tree)]


def mesh_axes(mesh_shape):
    """A mesh shape's axis names: ``("data", "model")``, or with a pod
    axis first for a shape of 3."""
    return ("pod", "data", "model")[-len(mesh_shape):]


def reference(arch, dtype, *mesh_shape, **kw):
    """The reference's 3 steps of reduced ``arch``, jitted with
    ``in_shardings`` on a real host mesh of ``mesh_shape`` ((n_data,),
    (n_data, n_model) or (n_pod, n_data, n_model)): (metrics per step,
    final state leaves).  Cached for the module."""
    if len(mesh_shape) == 1:
        mesh_shape += (1,)
    key = ("jax", arch, dtype, mesh_shape, tuple(sorted(kw.items())))
    if key not in _RUNS:
        cfg = jax_config(arch).reduced().with_(compute_dtype=dtype, **kw)
        shape = JSHAPES["train_4k"].reduced()
        mesh = jmake_mesh(mesh_shape, mesh_axes(mesh_shape))
        rules = JShardingRules(mesh)
        ssh = jspecs.state_shardings(cfg, rules)
        bsh = jspecs.batch_shardings(cfg, shape, rules)
        state = jax.device_put(to_jax(initial(arch, **kw)), ssh)
        step = jax.jit(jzoo.make_train_step(cfg, jadamw.HParams(**HP)),
                       in_shardings=(ssh, bsh))
        data = JSyntheticLM(cfg, shape, seed=0)
        metrics = []
        with mesh, juse_rules(rules):
            for i in range(STEPS):
                state, m = step(state, jax.device_put(data.batch_at(i), bsh))
                # back to the input layout (an exact reshard: the update
                # may hand ZeRO-1's layout to the params)
                state = jax.device_put(state, ssh)
                metrics.append({k: float(v) for k, v in m.items()})
        _RUNS[key] = (metrics, state_leaves(jax.tree.map(np.asarray, state)))
    return _RUNS[key]


def one_device(arch, **kw):
    """The port's single-device trainer, the same 3 steps."""
    key = ("torch", arch, tuple(sorted(kw.items())))
    if key not in _RUNS:
        cfg = get_config(arch).reduced().with_(**kw)
        tr = ElasticTrainer(cfg, SHAPES["train_4k"].reduced(), n_devices=1,
                            seed=0, hp=adamw.HParams(**HP), device="cpu")
        tr.train(STEPS, log_every=0)
        _RUNS[key] = (tr.metrics_log, [t.numpy() for t in (
            adamw.flatten(tr.state.params)[0] + adamw.flatten(
                tr.state.opt.m)[0] + adamw.flatten(tr.state.opt.v)[0])])
    return _RUNS[key]


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def assert_same_run(got, want, what, params=True):
    """Metrics and state leaves of two float32 runs of the same steps
    (without ``params``: the metrics, m and v only)."""
    (gm, gs), (wm, ws) = got, want
    assert len(gm) == len(wm) == STEPS
    for g, w in zip(gm, wm):
        for k in ("loss", "nll", "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=F32_METRIC), (what, k, g, w)
    n = len(gs) // 3
    assert len(gs) == len(ws) == 3 * n
    for i, (a, b) in enumerate(zip(gs, ws)):
        tol = F32_PARAM if i < n else F32_MOMENT
        assert a.shape == b.shape, (what, i)
        assert rel_l2(b, a) <= tol or (i < n and not params), (what, i)


def run_of(out):
    return out["metrics"], [t.numpy() for t in out["state"]]


# ------------------------------------------------------------- the tests
@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_float32_matches_reference_and_one_device(
        world, two, four):
    """Reduced granite-8b, float32, 3 steps over 2 ranks (2 rows each, in
    2 micro-batches) and over 4 (1 row each: the reduced shape's 2
    micro-batches become one-row blocks): the reference's sharded jit on
    a (world, 1) mesh and the port's single device, every rank equal."""
    ranks = two if world == 2 else four
    got = run_of(ranks[0]["float32"])
    assert_same_run(got, reference("granite-8b", "float32", world),
                    "vs reference")
    assert_same_run(got, one_device("granite-8b", compute_dtype="float32"),
                    "vs one device")
    for r in ranks[1:]:
        assert r["float32"]["metrics"] == ranks[0]["float32"]["metrics"]
        assert all(torch.equal(a, b) for a, b in
                   zip(r["float32"]["state"], ranks[0]["float32"]["state"]))


def test_data_parallel_bf16_loss_within_reference_tolerance(two):
    """bf16 compute (the config's own) over 2 ranks: every step's loss
    within 8e-3 of the reference's sharded run on a (2, 1) mesh, and of
    the port's single device."""
    got = [m["loss"] for m in two[0]["bf16"]["metrics"]]
    ref = [m["loss"] for m in reference("granite-8b", "bfloat16", 2)[0]]
    one = [m["loss"] for m in one_device("granite-8b")[0]]
    assert len(got) == STEPS
    for g, r, o in zip(got, ref, one):
        assert abs(g - r) < BF16_LOSS and abs(g - o) < BF16_LOSS, (got, ref)


@pytest.mark.parametrize("world", [2, 4])
def test_zero1_matches_data_parallel_and_shards_moments(world, two, four):
    """ZeRO-1 with the overlapped schedule (a reduce-scatter a
    micro-batch) against plain data parallelism: the whole state after 3
    steps within float32 tolerance; each rank keeps of m and v exactly
    the block the reference's ZeRO-1 ``NamedSharding`` gives its device
    on a (world, 1) mesh, 1/world of each leaf it splits."""
    ranks = two if world == 2 else four
    assert_same_run(run_of(ranks[0]["zero1"]), run_of(ranks[0]["float32"]),
                    "zero1 vs data parallel")
    cfg = jax_config("granite-8b").reduced().with_(zero1=True)
    mesh = jmake_mesh((world, 1), ("data", "model"))
    zsh = jax.tree.leaves(jspecs.state_shardings(
        cfg, JShardingRules(mesh)).opt.m)
    whole = ranks[0]["zero1"]["state"]
    n = len(zsh)
    split = 0
    for i, sh in enumerate(zsh):
        for kind, offset in (("local_m", n), ("local_v", 2 * n)):
            full = whole[offset + i]
            index = sh.devices_indices_map(tuple(full.shape))
            for r, out in enumerate(ranks):
                block = out["zero1"][kind][i]
                want = full[index[mesh.devices[r, 0]]]
                assert block.shape == want.shape, (i, r)
                assert torch.equal(block, want), (kind, i, r)
        if "data" in jax.tree.leaves(tuple(sh.spec)):
            split += 1
            assert ranks[0]["zero1"]["local_m"][i].numel() * world == \
                whole[n + i].numel()
    assert split == n     # every leaf of reduced granite-8b divides


def test_bf16_gradient_reduce_matches_reference(two):
    """``grad_reduce_dtype="bfloat16"`` with ZeRO-1 over 2 ranks (the
    reduce-scatter in bf16: half the bytes) against the reference's bf16
    reduce on a (2, 1) mesh (without ZeRO-1, which moves the state's
    layout, not its arithmetic).  The two round once each, the port each
    rank's share and the reference the sum, so the gradient differs by
    about one bf16 rounding (2^-8): grad_norm within 2^-8 relative, loss
    and nll within float32 tolerance, params within 1e-3 relative L2 per
    leaf, m and v within 2e-2 (v squares the rounding; read on the CPU:
    9.3e-5, 7.2e-5, 5.5e-3)."""
    (gm, gs) = run_of(two[0]["bf16_reduce"])
    wm, ws = reference("granite-8b", "float32", 2,
                       grad_reduce_dtype="bfloat16")
    for g, w in zip(gm, wm):
        for k in ("loss", "nll"):
            assert g[k] == pytest.approx(w[k], rel=F32_METRIC), (k, g, w)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"],
                                               rel=2.0 ** -8), (g, w)
    n = len(gs) // 3
    for i, (a, b) in enumerate(zip(gs, ws)):
        assert rel_l2(b, a) <= (1e-3 if i < n else 2e-2), i


def test_elastic_shrink_expand_4_2_4(four):
    """The reference's ``test_elastic_shrink_expand_8dev`` at 4 ranks
    (reduced granite-8b, ZeRO-1, bf16 compute): 4 -> 2 -> 4 beside an
    unrescaled 4-rank twin."""
    e = four[0]["elastic"]
    assert len(e["a"]) == len(e["b"]) == 6
    assert e["b_steps"] == list(range(6))
    assert all(abs(x - y) < ELASTIC_LOSS for x, y in zip(e["a"], e["b"])), \
        (e["a"], e["b"])
    assert [ev[:3] for ev in e["events"]] == [("shrink", 4, 2),
                                             ("expand", 2, 4)]
    for ev in e["events"]:
        assert set(ev[3]) == {"checkpoint", "restart", "restore",
                              "loadbalance"}
        assert ev[3]["restart"] > 0
    assert e["bit_equal"] == [True, True]
    # ranks 2 and 3 sat out the 2-rank steps: they logged the others
    for r in (2, 3):
        assert four[r]["elastic"]["b_steps"] == [0, 1, 4, 5]
        assert four[r]["elastic"]["b"] == [e["b"][i] for i in (0, 1, 4, 5)]


def test_mamba2_data_parallel_matches_one_device(two):
    """Reduced mamba2-780m (the ssm route, through the SSD's plain
    version on the CPU) over 2 ranks against the port's single device,
    float32."""
    assert_same_run(run_of(two[0]["mamba2"]),
                    one_device("mamba2-780m", compute_dtype="float32"),
                    "mamba2")


def test_uneven_micro_batches_and_one_head_raise(two):
    """What still raises over 2 ranks: 4 rows in 3 micro-batches raise
    ``ValueError`` (the reference's ``assert`` fails there), for the moe
    family too, and a Mamba2 head count that the model axis does not
    divide raises ``ValueError``.  moe trains over data ranks in every
    dispatch (``test_moe_over_data_ranks_*``) and in every layout over a
    model axis (``test_moe_matches_reference_at_each_mesh``,
    ``test_moe_layouts_*``), and every other family over a model axis
    (``test_tensor_parallel_*``, ``test_ssm_hybrid_*``,
    ``test_enc_dec_vlm_*``)."""
    # a Mamba2 head count the model axis does not divide, with the sizes
    assert "1 SSM heads do not split over a model axis of 2" in \
        two[0]["one_head_tp"], two[0]["one_head_tp"]
    for key in ("micro3", "moe_micro3"):
        assert "4 rows does not split into 3 micro-batches" in \
            two[0][key], two[0][key]


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
def test_placements_give_the_references_blocks(mesh_shape, two, four):
    """``NamedSharding.placements`` of every ZeRO-1 leaf of reduced
    granite-8b, through ``distribute_tensor`` on a real ``DeviceMesh``:
    each rank's block is the one JAX's ``NamedSharding`` of the same spec
    gives the device at its mesh coordinate (on (2, 2), leaves split over
    ``("model", "data")`` take ``_StridedShard``)."""
    ranks = two if mesh_shape == (2, 1) else four
    mesh = jmake_mesh(mesh_shape, ("data", "model"))
    gen = torch.Generator().manual_seed(5)
    cfg = get_config("granite-8b").reduced()
    shapes = [t.shape for t in
              adamw.flatten(tzoo.abstract_state(cfg).params)[0]]
    strided = 0
    for i, shape in enumerate(shapes):
        whole = torch.randn(shape, generator=gen)
        for out in ranks:
            coord, spec, block = out["placements"][i]
            sharding = jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(*spec))
            index = sharding.devices_indices_map(tuple(shape))
            assert torch.equal(block, whole[index[mesh.devices[coord]]]), \
                (i, coord, spec)
            strided += any(isinstance(e, tuple) and e[0] == "model"
                           for e in spec)
    if mesh_shape == (2, 2):
        assert strided > 0


def test_launcher_spawns_two_ranks():
    """``python -m repro_torch.launch.train --device cpu --reduced
    --n-devices 2 --steps 2``: the launcher spawns its 2 gloo ranks,
    and rank 0 alone logs, the first loss within bf16 tolerance of a
    single device's."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--n-devices", "2", "--steps", "2"], env=env,
        cwd=ROOT, capture_output=True, text=True, timeout=GROUP_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert sum(line.startswith("done:") for line in lines) == 1, out.stdout
    cfg = get_config("granite-8b").reduced()
    tr = ElasticTrainer(cfg, SHAPES["train_4k"].reduced(), n_devices=1,
                        seed=0, device="cpu")
    tr.train(1, log_every=0)
    logged = [line.split() for line in lines if line.startswith("step")]
    assert [(w[1], w[2], w[4]) for w in logged] == [("0", "loss", "gnorm")]
    assert abs(float(logged[0][3]) - tr.metrics_log[0]["loss"]) < BF16_LOSS


def test_spawn_kills_a_group_past_its_limit():
    """``launch.dist.spawn`` with a wall-clock limit: a group whose ranks
    outlive it (here they sleep 120 s) is killed, every rank, and
    ``TimeoutError`` names what was running, long before the ranks (or a
    collective's 300 s) would end.  In a child process: this worker
    never starts ranks itself."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    code = ("import sys, time; sys.path[:0] = ['tests']\n"
            "import _torch_ranks as r\n"
            "from repro_torch.launch import dist\n"
            "t0 = time.monotonic()\n"
            "try:\n"
            "    dist.spawn(r.hang, 2, 120, device='cpu', timeout=5,\n"
            "               what='phase x')\n"
            "except TimeoutError as e:\n"
            "    print('raised', round(time.monotonic() - t0), e)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True,
                         timeout=GROUP_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    words = out.stdout.split()
    assert words[0] == "raised", out.stdout
    assert int(words[1]) < 60, out.stdout
    assert "phase x: 2 ranks still running after 5 s; killed" in out.stdout


def test_meshes_over_the_process_group(two):
    """``make_host_mesh`` over the world's ranks; a mesh larger than the
    world, and the production (16, 16) mesh on 2 ranks, raise."""
    for r, out in enumerate(two):
        assert out["host_mesh"] == ((2, 1), ("data", "model"), (r, 0))
    assert "needs 4 ranks" in two[0]["too_big"], two[0]["too_big"]
    assert "needs 256 ranks" in two[0]["production"]


def test_no_process_group_here(tmp_path, monkeypatch):
    """In this worker (no process group): a mesh raises naming the
    missing group; ``torchrun_env`` reads torchrun's variables only when
    all four are set; a rendezvous file is used once."""
    with pytest.raises(RuntimeError, match="process group"):
        launch_mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        launch_mesh.make_production_mesh(device="cpu")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert launch_dist.torchrun_env() is None
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert launch_dist.torchrun_env() is None
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert launch_dist.torchrun_env() == (1, 2)
    assert launch_dist.backend_for("cpu") == "gloo"
    assert launch_dist.backend_for("cuda") == "nccl"
    init = launch_dist.file_rendezvous(tmp_path)
    assert init == f"file://{tmp_path / 'rendezvous'}"
    (tmp_path / "rendezvous").touch()
    with pytest.raises(FileExistsError):
        launch_dist.file_rendezvous(tmp_path)


# ------------------------------------------------------------- the model axis
@pytest.mark.parametrize("world", [2, 4])
def test_spmd_stencil_matches_reference(world, tp_two, tp_four):
    """``make_jacobi_spmd_step`` over ``world`` gloo ranks (odf 4, 5
    iterations, grid ``(world * 4 * 4, 32)``, as
    ``tests/test_multidevice.py:35-49``) against the reference's on a
    ``(world,)`` host mesh: the global grid bit for bit on every rank,
    and each rank's ``local`` block is its rows of it."""
    ranks = tp_two if world == 2 else tp_four
    grid = np.random.default_rng(0).standard_normal(
        (world * 4 * 4, 32)).astype(np.float32)
    mesh = jmake_mesh((world,), ("data",))
    want = np.asarray(jspmd_step(mesh, odf=4, n_iters=5)(jnp.asarray(grid)))
    b = grid.shape[0] // world
    for r, out in enumerate(ranks):
        got = out["stencil"]["global"].numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), r
        assert torch.equal(out["stencil"]["local"],
                           out["stencil"]["global"][r * b:(r + 1) * b])


TP_ARCHS = {"moe": "qwen2-moe-a2.7b", "moe_ff": "qwen2-moe-a2.7b",
            "ssm": "mamba2-780m", "hybrid": "zamba2-2.7b",
            "enc_dec": "seamless-m4t-medium", "vlm": "internvl2-26b"}
# the config overrides of a case's key (``tests/_torch_ranks.py``)
TP_KW = {"moe_ff": dict(num_experts=5)}
MOE_LAYOUTS = {"moe_grouped": dict(moe_impl="grouped"),
               "moe_onehot": dict(moe_impl="onehot"),
               "moe_ff": dict(num_experts=5),
               "moe_replicated": dict(num_experts=5, d_ff=33),
               "moe_drops": dict(moe_impl="grouped", moe_groups=1,
                                 capacity_factor=0.5)}


def tp_run(ranks, key):
    """Rank 0's run of ``key``, with the whole state it gathered."""
    return run_of(ranks[0][key])


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_tensor_parallel_float32_matches_reference(mesh_shape, tp_two,
                                                   tp_four):
    """Reduced granite-8b, float32, 3 steps over a ``mesh_shape`` mesh
    (heads, KV heads, ff and the vocabulary split over the model axis):
    the reference's sharded jit at the same mesh, and the port's single
    device (tensor parallelism leaves the function alone)."""
    ranks = tp_two if mesh_shape == (1, 2) else tp_four
    got = tp_run(ranks, "dense")
    assert_same_run(got, reference("granite-8b", "float32", *mesh_shape),
                    "vs reference")
    assert_same_run(got, one_device("granite-8b", compute_dtype="float32"),
                    "vs one device")
    for r in ranks[1:]:
        assert r["dense"]["metrics"] == ranks[0]["dense"]["metrics"]


def test_tensor_parallel_replicated_kv_heads(tp_two):
    """One KV head on a model axis of 2 (the rules replicate ``kv_heads``
    and shard ``heads``): every rank holds the KV head and reads it for
    its query heads; the reference's sharded jit at (1, 2)."""
    assert_same_run(tp_run(tp_two, "dense_kv1"),
                    reference("granite-8b", "float32", 1, 2,
                              num_kv_heads=1), "kv heads replicated")


def test_tensor_parallel_zero1_matches_reference(tp_four):
    """ZeRO-1 (overlapped: a reduce-scatter a micro-batch) on a (2, 2)
    mesh against the reference's ZeRO-1 run at (2, 2); each rank keeps of
    m and v exactly the block the reference's ``NamedSharding`` gives its
    device, and of each parameter its model block."""
    got = tp_run(tp_four, "zero1")
    assert_same_run(got, reference("granite-8b", "float32", 2, 2,
                                   zero1=True, grad_schedule="overlapped"),
                    "zero1 (2, 2)")
    cfg = jax_config("granite-8b").reduced().with_(zero1=True)
    mesh = jmake_mesh((2, 2), ("data", "model"))
    state_sh = jspecs.state_shardings(cfg, JShardingRules(mesh))
    zsh = jax.tree.leaves(state_sh.opt.m)
    psh = jax.tree.leaves(state_sh.params)
    whole = tp_four[0]["zero1"]["state"]
    n = len(zsh)
    for i in range(n):
        for kind, sh, offset in (("local_params", psh[i], 0),
                                 ("local_m", zsh[i], n),
                                 ("local_v", zsh[i], 2 * n)):
            full = whole[offset + i]
            index = sh.devices_indices_map(tuple(full.shape))
            for out in tp_four:
                block = out["zero1"][kind][i]
                want = full[index[mesh.devices[out["zero1"]["coord"]]]]
                assert block.shape == want.shape, (kind, i)
                assert torch.equal(block, want), (kind, i)


def test_tensor_parallel_bf16_loss_within_reference_tolerance(tp_four):
    """bf16 compute on a (2, 2) mesh: every step's loss within 8e-3 of
    the reference's sharded run at (2, 2) and of the port's single
    device (``tests/test_multidevice.py:80``)."""
    got = [m["loss"] for m in tp_four[0]["bf16"]["metrics"]]
    ref = [m["loss"] for m in reference("granite-8b", "bfloat16", 2, 2)[0]]
    one = [m["loss"] for m in one_device("granite-8b")[0]]
    assert len(got) == STEPS
    for g, r, o in zip(got, ref, one):
        assert abs(g - r) < BF16_LOSS and abs(g - o) < BF16_LOSS, (got, ref)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2), (2, 2)])
def test_moe_matches_reference_at_each_mesh(mesh_shape, tp_two, tp_four):
    """Reduced qwen2-moe-a2.7b, float32, 3 steps, against the reference's
    sharded jit at the same mesh.  (2, 1): ``_moe_grouped`` over data
    ranks, the single device's loss; (1, 2): explicit expert
    parallelism, 4 experts a rank, each rank routing its tokens as one
    group: a single device with ``moe_groups=1``; (2, 2): each data
    rank's aux loss averaged, neither of those."""
    ranks = tp_four if mesh_shape == (2, 2) else tp_two
    key = "moe_data" if mesh_shape == (2, 1) else "moe"
    got = tp_run(ranks, key)
    want = reference("qwen2-moe-a2.7b", "float32", *mesh_shape)
    assert_same_run(got, want, f"moe {mesh_shape}")
    if mesh_shape == (2, 1):
        assert_same_run(got, one_device("qwen2-moe-a2.7b",
                                        compute_dtype="float32"), "one")
    elif mesh_shape == (1, 2):
        assert_same_run(got, one_device("qwen2-moe-a2.7b",
                                        compute_dtype="float32",
                                        moe_groups=1), "one, one group")
    else:
        ep = reference("qwen2-moe-a2.7b", "float32", 1, 2)[0]
        assert got[0][0]["aux"] != pytest.approx(ep[0]["aux"], rel=1e-3)


@pytest.mark.parametrize("case", [
    "moe_grouped (1, 2)", "moe_onehot (1, 2)", "moe_ff (1, 2)",
    "moe_ff (2, 2)", "moe_replicated (1, 2)", "moe_drops (1, 2)",
    "moe_grouped (2, 2)"])
def test_moe_layouts_float32_match_reference_and_one_device(case, tp_two,
                                                            tp_four):
    """Reduced qwen2-moe-a2.7b, float32, 3 steps, in every layout of its
    expert weights over a model axis: ``moe_impl="grouped"`` with the 8
    experts split (4 a rank), the one-hot dispatch likewise, 5 experts
    (the axis does not divide them: each expert's d_ff splits, "auto"
    falls back to the grouped dispatch), 5 experts of d_ff 33 (neither
    divides: the expert weights replicated), and one routing group at
    capacity factor 0.5 (tokens dropped, in the single device's order).
    The grouped and one-hot dispatches leave the function alone: each
    run matches the reference's sharded jit at its mesh and the port's
    single device; every rank logs the same metrics.

    The replicated case's parameters are held against the reference
    alone: one embedding element of this run has a gradient of ~1e-8,
    float32 rounding of a cancelling sum, and Adam turns it into a step
    of the learning rate's size in either direction.  Any two summation
    orders move that leaf: 5.9e-6 between the reference's own (1, 1)
    and (1, 2) runs, 1.01e-5 between the port's single device and the
    reference's (1, 2) run, 1.33e-5 between the port's two runs (the
    parameters after the first step equal bit for bit, m and v within
    1e-6)."""
    key, shape = case.split(" ", 1)
    ranks = tp_two if shape == "(1, 2)" else tp_four
    kw = MOE_LAYOUTS[key]
    got = tp_run(ranks, key)
    assert_same_run(got, reference("qwen2-moe-a2.7b", "float32",
                                   *eval(shape), **kw), f"{case} vs reference")
    assert_same_run(got, one_device("qwen2-moe-a2.7b",
                                    compute_dtype="float32", **kw),
                    f"{case} vs one device", params=key != "moe_replicated")
    for r in ranks[1:]:
        assert r[key]["metrics"] == ranks[0][key]["metrics"]


@pytest.mark.parametrize("case", ["moe_ff_bf16 (2, 2)",
                                  "moe_onehot_bf16 (1, 2)"])
def test_moe_layouts_bf16_loss_within_reference_tolerance(case, tp_two,
                                                          tp_four):
    """bf16 compute (the config's own): 5 experts (each expert's d_ff
    split) on a (2, 2) mesh and the one-hot dispatch on (1, 2), whose
    rank sums its weighted contributions in float32 before the
    all-reduce: every step's loss within 8e-3 of the reference's sharded
    run at the mesh and of the port's single device."""
    key, shape = case.split(" ", 1)
    ranks = tp_two if shape == "(1, 2)" else tp_four
    kw = MOE_LAYOUTS[key[:-len("_bf16")]]
    got = [m["loss"] for m in ranks[0][key]["metrics"]]
    ref = [m["loss"] for m in reference("qwen2-moe-a2.7b", "bfloat16",
                                        *eval(shape), **kw)[0]]
    one = [m["loss"] for m in one_device("qwen2-moe-a2.7b", **kw)[0]]
    assert len(got) == STEPS
    for g, r, o in zip(got, ref, one):
        assert abs(g - r) < BF16_LOSS and abs(g - o) < BF16_LOSS, (got, ref)
    for r in ranks[1:]:
        assert r[key]["metrics"] == ranks[0][key]["metrics"]


# the config overrides of ``tests/_torch_ranks.py``'s MOE_DATA cases
MOE_DATA = {"moe_onehot": dict(moe_impl="onehot"),
            "moe_groups1": dict(moe_impl="grouped", moe_groups=1),
            "moe_onehot_drops": dict(moe_impl="onehot", capacity_factor=0.5),
            "moe_micro4": dict(num_microbatches=4),
            "moe_default": {}}


@pytest.mark.parametrize("case", [
    "moe_onehot (2, 1)", "moe_onehot (2, 2)", "moe_groups1 (2, 1)",
    "moe_groups1 (2, 2)", "moe_onehot_drops (2, 1)", "moe_micro4 (2, 1)",
    "moe_micro4 (2, 2)", "moe_default (4, 1)"])
def test_moe_over_data_ranks_float32_matches_reference_and_one_device(
        case, moe_two, moe_four):
    """Reduced qwen2-moe-a2.7b, float32, 3 steps, its batch over the data
    ranks: the one-hot dispatch and one routing group (``moe_impl=
    "grouped", moe_groups=1``), whose 2-row micro-batches are routed
    across 2 data ranks, at (2, 1) and (2, 2) (the experts split over
    the model axis); the one-hot dispatch at capacity factor 0.5 (tokens
    dropped past the rank boundary); one-row micro-batches (each whole
    on a rank) at (2, 1) and at (2, 2) with "auto" (the reference's
    explicit EP falls back to the grouped dispatch); the reduced default
    at (4, 1) (2-row micro-batches over 4 ranks, 2 ranks a micro-batch).
    Each is the single device's function: it matches the reference's
    sharded jit at its mesh and the port's single device, and every rank
    logs the same metrics.  Where a micro-batch's groups span ranks the
    ranks all-gather their count tables once a moe layer a piece,
    forward and remat's recompute (2 layers, 2 micro-batches a step);
    elsewhere the moe blocks run no all-gather."""
    key, shape = case.split(" ", 1)
    mesh_shape = eval(shape)
    ranks = moe_two if mesh_shape == (2, 1) else moe_four
    kw = MOE_DATA[key]
    got = tp_run(ranks, key)
    assert_same_run(got, reference("qwen2-moe-a2.7b", "float32",
                                   *mesh_shape, **kw), f"{case} vs reference")
    assert_same_run(got, one_device("qwen2-moe-a2.7b",
                                    compute_dtype="float32", **kw),
                    f"{case} vs one device")
    spans = key in ("moe_onehot", "moe_groups1", "moe_onehot_drops")
    for r in ranks:
        assert r[key]["metrics"] == ranks[0][key]["metrics"]
        assert r[key]["all_gathers"] == (STEPS * 2 * 2 * 2 if spans else 0)


def test_moe_over_data_ranks_bf16_loss_within_reference_tolerance(moe_four):
    """The one-hot dispatch in bf16 (the config's own) at (2, 2), each
    micro-batch routed across the 2 data ranks and the experts split over
    the model axis: every step's loss within 8e-3 of the reference's
    sharded run at the mesh and of the port's single device; every rank
    logs the same metrics."""
    kw = MOE_DATA["moe_onehot"]
    got = [m["loss"] for m in moe_four[0]["moe_onehot_bf16"]["metrics"]]
    ref = [m["loss"] for m in reference("qwen2-moe-a2.7b", "bfloat16", 2, 2,
                                        **kw)[0]]
    one = [m["loss"] for m in one_device("qwen2-moe-a2.7b", **kw)[0]]
    assert len(got) == STEPS
    for g, r, o in zip(got, ref, one):
        assert abs(g - r) < BF16_LOSS and abs(g - o) < BF16_LOSS, (got, ref)
    for r in moe_four[1:]:
        assert r["moe_onehot_bf16"]["metrics"] == \
            moe_four[0]["moe_onehot_bf16"]["metrics"]


def test_elastic_tensor_parallel_moe_expert_ff_4_2_4(tp_four):
    """``ElasticTrainer(model_par=2)`` of reduced qwen2-moe-a2.7b with 5
    experts (each expert's d_ff split over the model axis) over 4 ranks,
    ZeRO-1: (2, 2) -> (1, 2) -> (2, 2) beside an unrescaled twin; the
    losses within 5e-4, the state gathered over both axes bit for bit
    across each rescale.  In float32, as the seamless-m4t-medium case:
    in bf16 the two steps on (1, 2) round otherwise and the last loss
    drifts 5.45e-4 from the twin's, rounding rather than the rescale."""
    e = tp_four[0]["moe_ff_elastic"]
    assert len(e["a"]) == len(e["b"]) == 6
    assert e["b_steps"] == list(range(6))
    assert all(abs(x - y) < ELASTIC_LOSS for x, y in zip(e["a"], e["b"])), \
        (e["a"], e["b"])
    assert e["events"] == [("shrink", 4, 2), ("expand", 2, 4)]
    assert e["bit_equal"] == [True, True]
    for r in (2, 3):
        assert tp_four[r]["moe_ff_elastic"]["b_steps"] == [0, 1, 4, 5]


@pytest.mark.parametrize("case", ["dense (1, 2)", "moe_ff (1, 2)",
                                  "moe_ff (2, 2)"])
def test_placed_leaves_own_their_storage(case, tp_two, tp_four):
    """``DataParallel.place`` leaves each rank its own copy of every
    block it cuts (granite-8b with ZeRO-1 and moe with its expert d_ff
    split at (1, 2); moe with ZeRO-1 at (2, 2)), not a view that keeps
    the whole drawn state alive: every leaf's storage is its own size."""
    key, shape = case.split(" ", 1)
    ranks = tp_two if shape == "(1, 2)" else tp_four
    assert [r["own_storage"][key] for r in ranks] == [True] * len(ranks)


@pytest.mark.parametrize("case", ["dense (1, 2)", "dense (2, 2)",
                                  "moe (1, 2)", "moe (2, 2)",
                                  "moe_ff (1, 2)",
                                  "zero1 (2, 2)", "ssm (1, 2)", "ssm (2, 2)",
                                  "hybrid (1, 2)", "hybrid (2, 2)",
                                  "enc_dec (1, 2)", "enc_dec (2, 2)",
                                  "vlm (1, 2)", "vlm (2, 2)"])
def test_model_ranks_hold_blocks_and_identical_replicas(case, tp_two,
                                                        tp_four):
    """After 3 steps, each model rank's parameters: of a leaf the rules
    shard over ``model``, its block only (1/m of the leaf, the block of
    the gathered whole); of a replicated leaf (norms, the router, the
    moe biases of none), a copy bit-identical on every rank.  For ssm and
    hybrid the stored blocks of Mamba2's packed ``in_proj`` and
    ``conv_w`` are the reference's too, though each rank computes with
    the whole leaf.  For moe with 5 experts (``moe_ff``: the axis does
    not divide them) each expert weight keeps every expert and half of
    its ``d_ff``."""
    key, shape = case.split(" ", 1)
    ranks = tp_two if shape == "(1, 2)" else tp_four
    arch = TP_ARCHS.get(key, "granite-8b")
    cfg = jax_config(arch).reduced().with_(**TP_KW.get(key, {}))
    mesh = jmake_mesh(eval(shape), ("data", "model"))
    paths, psh = zip(*jax.tree_util.tree_leaves_with_path(
        jspecs.state_shardings(cfg, JShardingRules(mesh)).params))
    whole = ranks[0][key]["state"]
    split = replicated = 0
    for i, sh in enumerate(psh):
        name = str(paths[i][-1].key)
        if key == "moe_ff" and name.startswith("we_"):
            # (layers, experts, d, d_ff) or (layers, experts, d_ff, d)
            ff = 3 if name != "we_down" else 2
            for out in ranks:
                block = out[key]["local_params"][i]
                assert block.shape[1] == cfg.num_experts, name
                assert block.shape[ff] * 2 == cfg.d_ff, name
        index = sh.devices_indices_map(tuple(whole[i].shape))
        for out in ranks:
            block = out[key]["local_params"][i]
            if "model" in jax.tree.leaves(tuple(sh.spec)):
                assert block.numel() * 2 == whole[i].numel(), i
                want = whole[i][index[mesh.devices[out[key]["coord"]]]]
                assert torch.equal(block, want), (i, out[key]["coord"])
            else:
                assert torch.equal(block, ranks[0][key]["local_params"][i])
        if "model" in jax.tree.leaves(tuple(sh.spec)):
            split += 1
        else:
            replicated += 1
    assert split and replicated, (split, replicated)


def test_elastic_tensor_parallel_4_2_4(tp_four):
    """``ElasticTrainer(model_par=2)`` over 4 ranks, ZeRO-1, bf16:
    (2, 2) -> (1, 2) -> (2, 2) beside an unrescaled twin; the losses
    within 5e-4, the state gathered over both axes bit for bit across
    each rescale."""
    e = tp_four[0]["elastic"]
    assert len(e["a"]) == len(e["b"]) == 6
    assert e["b_steps"] == list(range(6))
    assert all(abs(x - y) < ELASTIC_LOSS for x, y in zip(e["a"], e["b"])), \
        (e["a"], e["b"])
    assert e["events"] == [("shrink", 4, 2), ("expand", 2, 4)]
    assert e["bit_equal"] == [True, True]
    for r in (2, 3):
        assert tp_four[r]["elastic"]["b_steps"] == [0, 1, 4, 5]


def test_launcher_tensor_parallel_two_ranks():
    """``python -m repro_torch.launch.train --device cpu --reduced
    --n-devices 2 --model-par 2 --steps 2``: the launcher spawns its 2
    gloo ranks on a (1, 2) mesh, rank 0 alone logs, and the first loss
    is within bf16 tolerance of a single device's."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--n-devices", "2", "--model-par", "2", "--steps",
         "2"], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=GROUP_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert sum(line.startswith("done:") for line in lines) == 1, out.stdout
    logged = [line.split() for line in lines if line.startswith("step")]
    assert [(w[1], w[2], w[4]) for w in logged] == [("0", "loss", "gnorm")]
    one = one_device("granite-8b")[0]
    assert abs(float(logged[0][3]) - one[0]["loss"]) < BF16_LOSS


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("key", ["ssm", "hybrid"])
def test_ssm_hybrid_tensor_parallel_float32(key, mesh_shape, tp_two,
                                            tp_four):
    """Reduced mamba2-780m (ssm) and zamba2-2.7b (hybrid: Mamba2 layers
    and the shared attention and MLP), float32, 3 steps over a
    ``mesh_shape`` mesh: each model rank computes 4 of the 8 SSM heads
    (the SSD on them; its plain version here), B and C whole, ``ssm_norm``
    over the group, and the hybrid's 2 of 4 attention heads and half of
    ``ff``.  Against the reference's sharded jit at the same mesh, and
    the port's single device; every rank logs the same metrics."""
    ranks = tp_two if mesh_shape == (1, 2) else tp_four
    arch = TP_ARCHS[key]
    got = tp_run(ranks, key)
    assert_same_run(got, reference(arch, "float32", *mesh_shape),
                    f"{key} {mesh_shape} vs reference")
    assert_same_run(got, one_device(arch, compute_dtype="float32"),
                    f"{key} {mesh_shape} vs one device")
    for r in ranks[1:]:
        assert r[key]["metrics"] == ranks[0][key]["metrics"]


@pytest.mark.parametrize("key", ["ssm", "hybrid"])
def test_ssm_hybrid_tensor_parallel_bf16_loss(key, tp_four):
    """bf16 compute (the configs' own) on a (2, 2) mesh: every step's
    loss within 8e-3 of the reference's sharded run at (2, 2) and of the
    port's single device (``tests/test_multidevice.py:80``)."""
    arch = TP_ARCHS[key]
    got = [m["loss"] for m in tp_four[0][f"{key}_bf16"]["metrics"]]
    ref = [m["loss"] for m in reference(arch, "bfloat16", 2, 2)[0]]
    one = [m["loss"] for m in one_device(arch)[0]]
    assert len(got) == STEPS
    for g, r, o in zip(got, ref, one):
        assert abs(g - r) < BF16_LOSS and abs(g - o) < BF16_LOSS, (got, ref)


def test_elastic_tensor_parallel_mamba2_4_2_4(tp_four):
    """``ElasticTrainer(model_par=2)`` of reduced mamba2-780m over 4
    ranks, ZeRO-1, bf16: (2, 2) -> (1, 2) -> (2, 2) beside an unrescaled
    twin; the losses within 5e-4, the state gathered over both axes bit
    for bit across each rescale (the packed leaves' stored blocks
    included)."""
    e = tp_four[0]["ssm_elastic"]
    assert len(e["a"]) == len(e["b"]) == 6
    assert e["b_steps"] == list(range(6))
    assert all(abs(x - y) < ELASTIC_LOSS for x, y in zip(e["a"], e["b"])), \
        (e["a"], e["b"])
    assert e["events"] == [("shrink", 4, 2), ("expand", 2, 4)]
    assert e["bit_equal"] == [True, True]
    for r in (2, 3):
        assert tp_four[r]["ssm_elastic"]["b_steps"] == [0, 1, 4, 5]


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("key", ["enc_dec", "vlm"])
def test_enc_dec_vlm_tensor_parallel_float32(key, mesh_shape, tp_two,
                                             tp_four):
    """Reduced seamless-m4t-medium (enc_dec: the encoder's attention and
    MLP blocks and the decoder's cross attention over the rank's 2 of 4
    heads, 1 of 2 KV heads and half of ``ff``, the frames replicated over
    the model axis) and internvl2-26b (vlm: the patch embeddings
    replicated over it, the loss on the text positions), float32, 3
    steps over a ``mesh_shape`` mesh: the reference's sharded jit at the
    same mesh and the port's single device; every rank logs the same
    metrics."""
    ranks = tp_two if mesh_shape == (1, 2) else tp_four
    arch = TP_ARCHS[key]
    got = tp_run(ranks, key)
    assert_same_run(got, reference(arch, "float32", *mesh_shape),
                    f"{key} {mesh_shape} vs reference")
    assert_same_run(got, one_device(arch, compute_dtype="float32"),
                    f"{key} {mesh_shape} vs one device")
    for r in ranks[1:]:
        assert r[key]["metrics"] == ranks[0][key]["metrics"]


@pytest.mark.parametrize("key", ["enc_dec", "vlm"])
def test_enc_dec_vlm_tensor_parallel_bf16_loss(key, tp_four):
    """bf16 compute (the configs' own) on a (2, 2) mesh: every step's
    loss within 8e-3 of the reference's sharded run at (2, 2) and of the
    port's single device (``tests/test_multidevice.py:80``); every rank
    logs the same metrics."""
    arch = TP_ARCHS[key]
    got = [m["loss"] for m in tp_four[0][f"{key}_bf16"]["metrics"]]
    ref = [m["loss"] for m in reference(arch, "bfloat16", 2, 2)[0]]
    one = [m["loss"] for m in one_device(arch)[0]]
    assert len(got) == STEPS
    for g, r, o in zip(got, ref, one):
        assert abs(g - r) < BF16_LOSS and abs(g - o) < BF16_LOSS, (got, ref)
    for r in tp_four[1:]:
        assert r[f"{key}_bf16"]["metrics"] == \
            tp_four[0][f"{key}_bf16"]["metrics"]


def test_cross_attention_replicated_kv_heads(tp_two):
    """Reduced seamless-m4t-medium with one KV head on a model axis of 2
    (the rules replicate ``kv_heads`` and shard ``heads``): every rank
    projects the encoder output to the KV head, self and cross attention
    alike, and reads it for its query heads; the reference's sharded jit
    at (1, 2)."""
    assert_same_run(tp_run(tp_two, "enc_dec_kv1"),
                    reference("seamless-m4t-medium", "float32", 1, 2,
                              num_kv_heads=1), "cross kv heads replicated")


def test_elastic_tensor_parallel_enc_dec_4_2_4(tp_four):
    """``ElasticTrainer(model_par=2)`` of reduced seamless-m4t-medium over
    4 ranks, ZeRO-1: (2, 2) -> (1, 2) -> (2, 2) beside an unrescaled
    twin; the losses within 5e-4, the state of both stacks gathered over
    both axes bit for bit across each rescale.  In float32: on this
    schedule the reference's own bf16 run drifts 5.1e-4 from its twin
    (the data axis's reduction order alone), so the bound would read
    bf16 rounding rather than the rescale."""
    e = tp_four[0]["enc_dec_elastic"]
    assert len(e["a"]) == len(e["b"]) == 6
    assert e["b_steps"] == list(range(6))
    assert all(abs(x - y) < ELASTIC_LOSS for x, y in zip(e["a"], e["b"])), \
        (e["a"], e["b"])
    assert e["events"] == [("shrink", 4, 2), ("expand", 2, 4)]
    assert e["bit_equal"] == [True, True]
    for r in (2, 3):
        assert tp_four[r]["enc_dec_elastic"]["b_steps"] == [0, 1, 4, 5]


# ------------------------------------------------------------- the pod axis
@pytest.fixture(scope="module")
def pod_four(tmp_path_factory):
    return run_ranks("pod_four", 4, tmp_path_factory.mktemp("pod_four"))


# the pod axis's training cases: key -> (arch, config overrides beside
# float32 compute; ``tests/_torch_ranks.py``)
POD_TRAIN = {"pod": ("granite-8b", {}), "dense": ("granite-8b", {}),
             "zero1": ("granite-8b", dict(zero1=True,
                                          grad_schedule="overlapped")),
             "moe_onehot": ("qwen2-moe-a2.7b", dict(moe_impl="onehot",
                                                    num_microbatches=1)),
             "ssm": ("mamba2-780m", {})}


@pytest.mark.parametrize("case", ["pod (2, 1, 1)", "dense (2, 2, 1)",
                                  "zero1 (2, 2, 1)", "moe_onehot (2, 2, 1)",
                                  "ssm (2, 1, 2)"])
def test_pod_axis_training_matches_reference(case, request):
    """Reduced models, float32, 3 steps over a ``("pod", "data",
    "model")`` mesh, the batch's rows over the pod x data ranks
    (pod-major) and the gradient summed over them: granite-8b at (2, 1,
    1) (each pod rank 2 rows) and at (2, 2, 1), also with ZeRO-1
    (overlapped: a reduce-scatter over data, then the block all-reduced
    over pod, a micro-batch); qwen2-moe-a2.7b one-hot with one
    micro-batch of the 4 rows, routed across both pods (the count tables
    all-gathered over the 4 batch ranks); mamba2-780m at (2, 1, 2) (the
    SSM heads over the model axis).  Each matches the reference's
    sharded jit on a host mesh of the same shape and the port's single
    device, and every rank logs the same metrics."""
    key, shape = case.split(" ", 1)
    mesh_shape = eval(shape)
    ranks = request.getfixturevalue("two" if mesh_shape == (2, 1, 1)
                                    else "pod_four")
    arch, kw = POD_TRAIN[key]
    got = run_of(ranks[0][key])
    assert_same_run(got, reference(arch, "float32", *mesh_shape, **kw),
                    f"{case} vs reference")
    one = {k: v for k, v in kw.items() if k not in ("zero1",
                                                    "grad_schedule")}
    assert_same_run(got, one_device(arch, compute_dtype="float32", **one),
                    f"{case} vs one device")
    coords = [r[key]["coord"] for r in ranks]
    assert sorted(coords) == [tuple(c) for c in np.ndindex(*mesh_shape)]
    for r in ranks:
        assert r[key]["metrics"] == ranks[0][key]["metrics"], case
    if key == "moe_onehot":
        # one routing group over the 4 ranks: the count tables gathered
        # once a moe layer, forward and remat's recompute
        assert all(r[key]["all_gathers"] == STEPS * 2 * 2 for r in ranks)


def test_pod_axis_zero1_blocks_over_data_same_on_both_pods(pod_four):
    """ZeRO-1 at (2, 2, 1): each rank keeps of m and v exactly the block
    the reference's ZeRO-1 ``NamedSharding`` gives its device on a host
    mesh of the same shape (``zero1_extend`` scatters over ``data``
    only), half of each leaf, bit for bit the same on the two pods; the
    parameters whole on every rank; one pod all-reduce of each leaf's
    block a step (each rank runs one piece a step: 1 of the 4 rows)."""
    cfg = jax_config("granite-8b").reduced().with_(zero1=True)
    mesh = jmake_mesh((2, 2, 1), ("pod", "data", "model"))
    zsh = jax.tree.leaves(jspecs.state_shardings(
        cfg, JShardingRules(mesh)).opt.m)
    whole = pod_four[0]["zero1"]["state"]
    n = len(zsh)
    by_coord = {tuple(r["zero1"]["coord"]): r["zero1"] for r in pod_four}
    for i, sh in enumerate(zsh):
        assert "pod" not in jax.tree.leaves(tuple(sh.spec)), sh.spec
        for kind, offset in (("local_m", n), ("local_v", 2 * n)):
            full = whole[offset + i]
            index = sh.devices_indices_map(tuple(full.shape))
            for coord, out in by_coord.items():
                block = out[kind][i]
                want = full[index[mesh.devices[coord]]]
                assert block.shape == want.shape, (kind, i, coord)
                assert torch.equal(block, want), (kind, i, coord)
                assert block.numel() * 2 == full.numel(), (kind, i)
            for d in range(2):
                assert torch.equal(by_coord[(0, d, 0)][kind][i],
                                   by_coord[(1, d, 0)][kind][i]), (kind, i)
        for out in by_coord.values():
            assert torch.equal(out["local_params"][i], whole[i]), i
    for out in by_coord.values():
        assert out["all_reduces"] == STEPS * n


# ------------------------------------------------- serving over the mesh
@pytest.fixture(scope="module")
def serve_two(tmp_path_factory):
    return run_ranks("serve_two", 2, tmp_path_factory.mktemp("serve_two"))


@pytest.fixture(scope="module")
def serve_four(tmp_path_factory):
    return run_ranks("serve_four", 4, tmp_path_factory.mktemp("serve_four"))


# ``tests/_torch_ranks.py``'s SERVE_CASES: case -> (arch, config overrides)
F32 = dict(compute_dtype="float32")
SERVE = {"dense": ("granite-8b", F32),
         "blockwise": ("granite-8b", dict(attn_impl="blockwise", **F32)),
         "kv1": ("granite-8b", dict(num_kv_heads=1, **F32)),
         "moe_grouped": ("qwen2-moe-a2.7b", dict(moe_impl="grouped", **F32)),
         "moe_onehot": ("qwen2-moe-a2.7b", dict(moe_impl="onehot", **F32)),
         "vlm": ("internvl2-26b", F32),
         "enc_dec": ("seamless-m4t-medium", F32),
         "bf16": ("granite-8b", {}),
         "ssm": ("mamba2-780m", F32),
         "hybrid": ("zamba2-2.7b", F32),
         "dense63": ("granite-8b", F32),
         "kv1_63": ("granite-8b", dict(num_kv_heads=1, **F32)),
         "hybrid63": ("zamba2-2.7b", F32)}
# and its SERVE_SEQ: case -> (prefill, decode) positions
SERVE_SEQ = {"dense63": (63, 63), "kv1_63": (63, 63), "hybrid63": (64, 63)}
RECURRENT = ("ssm", "hybrid", "hybrid63")


def _jax_leaf(x, key=None):
    """A numpy input as the reference takes it: float32 arrays are bf16
    model inputs (rounded as the port rounds them), but for the float32
    ``ssm`` leaf."""
    x = jnp.asarray(x)
    return x.astype(jnp.bfloat16) if x.dtype == jnp.float32 and \
        key != "ssm" else x


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def serve_shapes(case):
    """The reference's prefill and decode shapes of ``case``."""
    import dataclasses
    pshape = JSHAPES["prefill_32k"].reduced()
    dshape = JSHAPES["decode_32k"].reduced()
    if case in SERVE_SEQ:
        p, d = SERVE_SEQ[case]
        pshape = dataclasses.replace(pshape, seq_len=p)
        dshape = dataclasses.replace(dshape, seq_len=d)
    return pshape, dshape


def serve_reference(case, mesh_shape, inputs, decode):
    """The reference's prefill and (``decode``) serve steps of ``case`` on
    a real ``mesh_shape`` host mesh: ``jax.jit(cell_fn(...),
    in_shardings=..., out_shardings=...)`` of ``input_specs``, from the
    inputs the ranks used.  Returns the logits and the decode states'
    leaves as arrays with their output shardings.  Cached.

    The reference runs the ssm and hybrid families in float32 here: its
    float32 step returns a float32 ``conv`` leaf (the state it declares
    is bf16), which is cast back to bf16 before the next step, the
    rounding the port makes when it writes the leaf (as
    ``tests/test_torch_mamba2.py`` casts it)."""
    key = ("serve", case, mesh_shape)
    if key in _RUNS:
        return _RUNS[key]
    arch, kw = SERVE[case]
    cfg = jax_config(arch).reduced().with_(**kw)
    mesh = jmake_mesh(mesh_shape, mesh_axes(mesh_shape))
    rules = JShardingRules(mesh)
    pshape, dshape = serve_shapes(case)
    out = {}
    with mesh, juse_rules(rules):
        spec = jspecs.input_specs(cfg, pshape, rules)
        params = jax.device_put(jax.tree.map(jnp.asarray, inputs["params"]),
                                spec["in_shardings"][0])
        batch = jax.device_put({k: _jax_leaf(v) for k, v in
                                inputs["batch"].items()},
                               spec["in_shardings"][1])
        prefill = jax.jit(jspecs.cell_fn(cfg, pshape),
                          in_shardings=spec["in_shardings"],
                          out_shardings=spec["out_shardings"])
        out["prefill"] = prefill(params, batch)
        if decode:
            dspec = jspecs.input_specs(cfg, dshape, rules)
            state = jax.device_put(jzoo.DecodeState(
                {k: _jax_leaf(v, k) for k, v in inputs["cache"].items()},
                jnp.asarray(inputs["cache_len"])), dspec["in_shardings"][1])
            step = jax.jit(jspecs.cell_fn(cfg, dshape),
                           in_shardings=dspec["in_shardings"],
                           out_shardings=dspec["out_shardings"])
            logits = []
            for tokens in inputs["tokens"]:
                lg, state = step(params, state, jax.device_put(
                    {"tokens": jnp.asarray(tokens),
                     "active": jnp.asarray(inputs["active"])},
                    dspec["in_shardings"][2]))
                if "conv" in state.cache:
                    state = jzoo.DecodeState(dict(
                        state.cache,
                        conv=state.cache["conv"].astype(jnp.bfloat16)),
                        state.cache_len)
                logits.append(lg)
            out["decode"] = (logits, state)
    out["mesh"] = mesh
    _RUNS[key] = out
    return out


def _one_bf16_ulp(x):
    """The spacing of bf16 numbers at each element of ``x``."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
                   - 7)


def assert_blocks(got, want_state, mesh, coord, what, ulps=1, skip=()):
    """A rank's decode-state block (``got``: its ``cache`` dict and
    ``cache_len``) against the block the reference's output sharding
    gives the device at ``coord``: ``cache_len`` equal, each bf16 cache
    element within ``ulps`` bf16 ulps of the reference's, over the
    float32 values' own difference before the rounding (1e-5 of the
    leaf's largest element: near zero, a float32 difference of that
    size spans several bf16 ulps of the element); the leaves in
    ``skip`` are left out."""
    device = mesh.devices[coord]
    for k, arr in list(want_state.cache.items()) + [
            ("cache_len", want_state.cache_len)]:
        if k in skip:
            continue
        index = arr.sharding.devices_indices_map(arr.shape)[device]
        want = _f32(arr)[index] if k != "cache_len" else \
            np.asarray(arr)[index]
        block = got["cache_len"] if k == "cache_len" else got["cache"][k]
        assert tuple(block.shape) == want.shape, (what, k, coord)
        if k == "cache_len":
            assert np.array_equal(block.numpy(), want), (what, coord)
            continue
        g = block.float().numpy()
        bound = ulps * _one_bf16_ulp(np.maximum(np.abs(g), np.abs(want))) \
            + F32_PARAM * np.abs(want).max()
        assert (np.abs(g - want) <= bound).all(), \
            (what, k, coord, float(np.abs(g - want).max()))


def _within_bf16_ulp(got, want, what):
    """``assert_blocks``' bound on one bf16 leaf."""
    bound = _one_bf16_ulp(np.maximum(np.abs(got), np.abs(want))) \
        + F32_PARAM * np.abs(want).max()
    assert got.shape == want.shape, what
    assert (np.abs(got - want) <= bound).all(), \
        (what, float(np.abs(got - want).max()))


def assert_recurrent_state(got, want_state, mesh, coord, cfg, what):
    """A rank's ssm / hybrid decode-state block and the state gathered
    whole against the reference's: ``k``, ``v`` and ``cache_len`` by
    ``assert_blocks``; ``ssm`` (float32) the reference's block within
    1e-4 relative and absolute (``tests/test_torch_mamba2.py``'s F32);
    ``conv`` the port's block, the x channels of the rank's heads then B
    and C, cut here from the reference's rows, within one bf16 ulp (the
    reference's float32 leaf before the port's rounding); the gathered
    whole state within the same bounds of the reference's whole."""
    assert_blocks(got, want_state, mesh, coord, what, skip=("ssm", "conv"))
    device = mesh.devices[coord]
    ssm = want_state.cache["ssm"]
    index = ssm.sharding.devices_indices_map(ssm.shape)[device]
    np.testing.assert_allclose(got["cache"]["ssm"].numpy(),
                               np.asarray(ssm)[index], rtol=1e-4,
                               atol=1e-4, err_msg=what)
    conv = want_state.cache["conv"]
    index = conv.sharding.devices_indices_map(conv.shape)[device]
    rows = _f32(conv)[index[:-1] + (slice(None),)]
    m = mesh.devices.shape[-1]
    if m > 1 and cfg.ssm_heads % m == 0:
        di = cfg.d_inner // m
        r = coord[-1]
        rows = np.concatenate([rows[..., r * di:(r + 1) * di],
                               rows[..., cfg.d_inner:]], -1)
    _within_bf16_ulp(got["cache"]["conv"].float().numpy(), rows,
                     (what, "conv", coord))
    whole = got["gathered"]
    np.testing.assert_allclose(whole["ssm"].numpy(), np.asarray(ssm),
                               rtol=1e-4, atol=1e-4, err_msg=what)
    for k in whole:
        if k != "ssm":
            _within_bf16_ulp(whole[k].float().numpy(),
                             _f32(want_state.cache[k]),
                             (what, k, "gathered"))


def serve_ranks(request, name):
    """The group that ran the served case ``name``: ``serve_two`` for 2
    ranks, ``serve_four`` for a (2, 2) mesh, ``pod_four`` for 4 ranks
    with a pod axis."""
    mesh_shape = eval(name.split(" ", 1)[1])
    group = ("serve_two" if np.prod(mesh_shape) == 2 else
             "pod_four" if len(mesh_shape) == 3 else "serve_four")
    return request.getfixturevalue(group)


def serve_case(ranks, name):
    case, shape = name.split(" ", 1)
    mesh_shape = eval(shape)
    mine = [r[name] for r in ranks if r.get(name)]
    assert len(mine) == np.prod(mesh_shape)
    decode = "decode" in mine[0]
    want = serve_reference(case, mesh_shape, mine[0]["inputs"], decode)
    return mine, want


RECURRENT_CASES = ["ssm (1, 2)", "ssm (2, 1)", "ssm (2, 2)",
                   "hybrid (1, 2)", "hybrid (2, 1)", "hybrid (2, 2)"]
UNDIVIDED_CASES = ["dense63 (1, 2)", "kv1_63 (1, 2)", "hybrid63 (1, 2)"]
POD_CASES = ["dense (2, 1, 1)", "hybrid (2, 1, 1)", "dense (2, 1, 2)",
             "dense (2, 2, 1)"]


@pytest.mark.parametrize("name", ["dense (1, 2)", "dense (2, 1)",
                                  "dense (2, 2)", "blockwise (1, 2)",
                                  "kv1 (1, 2)", "moe_grouped (1, 2)",
                                  "moe_onehot (1, 2)", "moe_grouped (2, 2)",
                                  "moe_onehot (2, 2)", "vlm (1, 2)",
                                  "enc_dec (1, 2)"] + RECURRENT_CASES
                         + UNDIVIDED_CASES + POD_CASES)
def test_prefill_over_the_mesh_matches_reference(name, request):
    """Reduced models, float32, the reduced prefill_32k cell (4 rows of
    64 positions) over a (data, model) mesh of gloo ranks against the
    reference's sharded jit of ``cell_fn`` on a host mesh of the same
    shape, ``in_shardings`` and ``out_shardings`` from ``input_specs``:
    granite-8b at (1, 2), (2, 1) and (2, 2), with ``attn_impl=
    "blockwise"`` (its plain form on the CPU) and with one KV head (the
    rules replicate ``kv_heads``); qwen2-moe-a2.7b grouped and one-hot
    (the experts split over the model axis, the rows routed over the
    data ranks); internvl2-26b (patch embeddings) and
    seamless-m4t-medium (frames; xk / xv in the decode state).  Every
    rank's logits (replicated: the whole (B, 1, V)) within 1e-5
    relative L2, and its block of the decode state (cache_batch over
    data, cache_seq over model, every KV head) within one bf16 ulp of
    the reference's block, cache_len equal.  Reduced mamba2-780m and
    zamba2-2.7b at (1, 2), (2, 1) and (2, 2): the Mamba2 blocks on each
    rank's SSM heads (the SSD's plain version on the CPU), the state
    held by ``assert_recurrent_state``.  granite-8b at 63 positions
    (which a model axis of 2 does not divide), with 2 KV heads and with
    one: the cache keeps every position, its KV heads over model where
    they divide; zamba2-2.7b's at 64 (hybrid63's decode cell is at
    63).  With a pod axis, the rows over the pod x data ranks
    (pod-major): granite-8b and zamba2-2.7b at (2, 1, 1), each pod rank
    2 rows, and granite-8b at (2, 1, 2) and (2, 2, 1)."""
    mine, want = serve_case(serve_ranks(request, name), name)
    logits, state = want["prefill"]
    case = name.split(" ", 1)[0]
    for r in mine:
        got = r["prefill"]
        assert rel_l2(np.asarray(logits), got["logits"].numpy()) <= \
            F32_METRIC, name
        if case in RECURRENT:
            assert_recurrent_state(got, state, want["mesh"], r["coord"],
                                   jax_config(SERVE[case][0]).reduced(),
                                   name)
        else:
            assert_blocks(got, state, want["mesh"], r["coord"], name)


@pytest.mark.parametrize("name", ["dense (1, 2)", "dense (2, 1)",
                                  "dense (2, 2)", "kv1 (1, 2)",
                                  "moe_grouped (1, 2)", "moe_onehot (1, 2)",
                                  "moe_grouped (2, 2)", "moe_onehot (2, 2)",
                                  "vlm (1, 2)", "enc_dec (1, 2)"]
                         + RECURRENT_CASES + UNDIVIDED_CASES + POD_CASES)
def test_decode_over_the_mesh_matches_reference(name, request):
    """4 serve steps from a seeded decode state (random bf16 cache of 64
    positions), each rank holding its block: lane 0 at cache_len 31
    writes position 31 on model rank 0 and 32-34 on rank 1, lane 1 is
    inactive, lane 2 is full (cache_len == S: no write), and lane 3's
    positions all lie on rank 0 (rank 1 holds no valid position of it:
    its share of the split softmax must add nothing).  Against the
    reference's sharded jit of the serve step: every step's logits within
    1e-5 relative L2 on every rank (seamless-m4t-medium within 5e-5: its
    cross attention reads the seeded N(0, 1) xk of 64 positions, whose
    logits are tens, and a float32 difference in q of 1e-7 relative
    moves lane 0's softmax by ~1e-5; the port's single device reads
    1.1-1.5e-5 from the reference here, the mesh the same), the final
    blocks within one bf16 ulp, cache_len equal; the blocks gathered
    back over the mesh give the same blocks again.  The ssm and hybrid
    cases (float32 wherever the reference's sharded jit runs: its conv
    leaf is cast back to bf16 between steps) step each rank's SSM
    heads' states, an inactive lane keeping both of its own; their
    state is held by ``assert_recurrent_state``.  The 63-position
    cases (granite-8b with 2 KV heads, split over model, and with one,
    whole on each rank; zamba2-2.7b's shared attention) run the
    tensor-parallel attention over every position, each rank writing
    its KV heads' new token (lane 2 is full at 63).  The pod cases
    (``POD_CASES``) step each rank's rows of the pod x data ranks."""
    mine, want = serve_case(serve_ranks(request, name), name)
    logits, state = want["decode"]
    case = name.split(" ", 1)[0]
    tol = 5e-5 if name.startswith("enc_dec") else F32_METRIC
    for r in mine:
        got = r["decode"]
        assert len(got["logits"]) == len(logits) == 4
        for a, b in zip(logits, got["logits"]):
            assert rel_l2(np.asarray(a), b.numpy()) <= tol, name
        if case in RECURRENT:
            assert_recurrent_state(got, state, want["mesh"], r["coord"],
                                   jax_config(SERVE[case][0]).reduced(),
                                   name)
        else:
            assert_blocks(got, state, want["mesh"], r["coord"], name)
        assert got["gathered_equal"]
        assert np.array_equal(got["gathered_len"].numpy(),
                              np.asarray(state.cache_len))


@pytest.mark.parametrize("name", ["dense (1, 2)", "dense (2, 1)",
                                  "dense (2, 2)"] + RECURRENT_CASES
                         + UNDIVIDED_CASES + POD_CASES)
def test_serving_collectives_in_closed_form(name, request):
    """Per prefill and per serve step on a (d, m) or (p, d, m) mesh, as
    ``launch.sharding`` counts them; every model-axis term is there only
    where m > 1, and the logits' rows add 1 all-gather for each of the
    pod and data axes above 1 (``gather_block``: over data, then pod).

    * Reduced granite-8b (L = 2 layers): 1 + 2L all-reduces (the
      vocab-parallel embedding, each layer's attention and MLP g), and a
      step's L more (each layer's split softmax output summed over the
      ranks); all-gathers 2L (prefill: k and v to the cache's positions;
      a step: q/k/v, then each rank's largest logit and sum) + 1 (the
      logits' vocabulary blocks).  At 63 positions (the cache keeps
      every position): 1 + 2L all-reduces and the logits' gather alone,
      a prefill and a step.
    * Reduced mamba2-780m (L = 2): 1 + 2L all-reduces (the embedding,
      each layer's ``ssm_norm`` squares and ``out_proj``) and the
      logits' gather, a prefill and a step.
    * Reduced zamba2-2.7b (L = 4 Mamba2 layers, P = 2 periods of shared
      attention): the same 1 + 2L, and each period's attention as
      granite-8b's layer: 2P all-reduces and 2P all-gathers a prefill,
      3P and 2P a step; at 63 decode positions a step's 2P all-reduces
      alone."""
    ranks = serve_ranks(request, name)
    case, shape = name.split(" ", 1)
    *batch, m = eval(shape)
    mamba, periods = {"ssm": (2, 0), "hybrid": (4, 2),
                      "hybrid63": (4, 2)}.get(case, (0, 2))
    seq_split = case not in ("dense63", "kv1_63")
    step_split = seq_split and case != "hybrid63"
    prefill = (1 + 2 * mamba + 2 * periods,
               1 + 2 * periods * seq_split)
    step = (1 + 2 * mamba + (2 + step_split) * periods,
            1 + 2 * periods * step_split)
    if m == 1:
        prefill, step = (0, 0), (0, 0)
    rows = sum(n > 1 for n in batch)
    prefill, step = ((n, g + rows) for n, g in (prefill, step))
    for r in ranks:
        got = r[name]
        assert tuple(got["prefill"]["collectives"]) == prefill, name
        assert [tuple(c) for c in got["decode"]["collectives"]] == \
            [step] * 4, name


def test_bf16_serving_within_the_bf16_rule(serve_two):
    """granite-8b in bf16 (the config's own) on (1, 2): the prefill's and
    every step's logits within 8 bf16 ulps (8 * 2^-8) of the largest
    reference logit, and the greedy token equal wherever the reference's
    top-2 gap exceeds twice that; the cache blocks within 8 bf16 ulps of
    each leaf's largest element (layer 1 reads layer 0's output, whose
    tensor-parallel sums round otherwise)."""
    name = "bf16 (1, 2)"
    mine, want = serve_case(serve_two, name)
    (p_logits, _), (d_logits, state) = want["prefill"], want["decode"]
    pairs = [(p_logits, r["prefill"]["logits"]) for r in mine] + [
        (a, r["decode"]["logits"][i]) for r in mine
        for i, a in enumerate(d_logits)]
    for ref, got in pairs:
        ref, got = _f32(ref)[..., :256], got.numpy()[..., :256]
        tol = 8 * 2.0 ** -8 * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
        top2 = np.sort(ref, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 2 * tol
        assert (got.argmax(-1) == ref.argmax(-1))[clear].all()
    mesh = want["mesh"]
    for r in mine:
        for k, arr in state.cache.items():
            index = arr.sharding.devices_indices_map(arr.shape)[
                mesh.devices[r["coord"]]]
            ref = _f32(arr)[index]
            got = r["decode"]["cache"][k].float().numpy()
            assert np.abs(got - ref).max() <= 8 * 2.0 ** -8 * \
                np.abs(ref).max(), k
