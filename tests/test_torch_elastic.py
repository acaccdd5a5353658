"""The port's elastic runtime and training launcher on the CPU.

Mirrors of the reference's ``test_runtime.py::
test_elastic_trainer_continuity_single_device`` and ``test_system.py::
test_training_loss_decreases`` on the port; the rescale protocol's four
stages and the restored state for each store kind; the port's
``ElasticTrainer`` across a ``rescale(1)`` against the reference's
``ElasticTrainer`` from one state (float32 compute, so the two loss
trajectories agree to the float32 summation noise of a step, held to
1e-5 relative); and the launcher.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JSHAPES
from repro.launch.train import ElasticTrainer as JElasticTrainer
from repro.models import model_zoo as jzoo
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.core.checkpointing import make_store
from repro_torch.core.elastic import ElasticRuntime, devices_for
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import ElasticTrainer
from repro_torch.models import model_zoo as tzoo
from repro_torch.optim import adamw

torch.set_num_threads(1)

HP = dict(lr=1e-3, warmup_steps=2, total_steps=100)
STAGES = {"checkpoint", "restart", "restore", "loadbalance"}


def test_elastic_trainer_continuity_single_device():
    """A rescale (restart + restore round trip) must not perturb
    training."""
    cfg = ARCHS["granite-8b"].reduced()
    shape = SHAPES["train_4k"].reduced()
    a = ElasticTrainer(cfg, shape, n_devices=1, seed=3, device="cpu")
    b = ElasticTrainer(cfg, shape, n_devices=1, seed=3, device="cpu")
    a.train(2, log_every=0)
    b.train(2, log_every=0)
    b.rescale(1)                    # checkpoint -> restart -> restore
    a.train(2, log_every=0)
    b.train(2, log_every=0)
    la = [m["loss"] for m in a.metrics_log]
    lb_ = [m["loss"] for m in b.metrics_log]
    assert la == pytest.approx(lb_, abs=1e-6)


def test_training_loss_decreases():
    cfg = ARCHS["llama3.2-3b"].reduced()
    shape = SHAPES["train_4k"].reduced()
    # default HParams warm up over 100 steps; at 15 test steps the lr is
    # still ~0, so use a test-scale schedule that actually optimizes
    hp = adamw.HParams(**HP)
    tr = ElasticTrainer(cfg, shape, n_devices=1, seed=0, hp=hp,
                        device="cpu")
    tr.train(15, log_every=0)
    first = np.mean([m["loss"] for m in tr.metrics_log[:3]])
    last = np.mean([m["loss"] for m in tr.metrics_log[-3:]])
    assert last < first, (first, last)


@pytest.mark.parametrize("kind", ["memory", "device", "filesystem"])
def test_rescale_records_four_stages_and_restores_the_state(kind, tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cfg = get_config("mamba2-780m").reduced()
    state = tzoo.init_state(cfg, 0, device="cpu")
    built = []

    def step_factory(devices):
        built.append(list(devices))
        return tzoo.make_train_step(cfg, adamw.HParams(**HP))
    store = make_store(kind, root=tmp_path) if kind == "filesystem" \
        else make_store(kind)
    rt = ElasticRuntime(step_factory=step_factory, init_state=state,
                        n_devices=1, store=store, device="cpu")
    batch = tzoo.make_batch(cfg, SHAPES["train_4k"].reduced(), seed=1,
                            device="cpu")
    for _ in range(2):
        rt.step(batch)
    before = [t.clone() for t in adamw.flatten(rt.state.params)[0]
              + adamw.flatten(rt.state.opt.m)[0]
              + adamw.flatten(rt.state.opt.v)[0]]
    step_before = int(rt.state.step)
    ev = rt.rescale_to(1)
    assert set(ev.stages) == STAGES
    assert all(v >= 0 for v in ev.stages.values())
    assert ev.total == pytest.approx(sum(ev.stages.values()))
    assert (ev.kind, ev.from_devices, ev.to_devices) == ("expand", 1, 1)
    assert rt.events == [ev] and len(built) == 2
    assert built[-1] == [torch.device("cpu")]
    after = (adamw.flatten(rt.state.params)[0]
             + adamw.flatten(rt.state.opt.m)[0]
             + adamw.flatten(rt.state.opt.v)[0])
    assert int(rt.state.step) == step_before == 2
    assert len(after) == len(before)
    for a, b in zip(before, after):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the restored state trains on
    out = rt.step(batch)
    assert bool(torch.isfinite(out["loss"]))


def test_more_than_one_device_raises():
    """Without a process group the port trains on one device: more
    raises, naming how to start the ranks, and so does a model axis of
    2 (the multi-rank paths are ``tests/test_torch_multirank.py``'s),
    for every family: enc_dec at a model axis of 2 asks for the process
    group as granite-8b does."""
    with pytest.raises(RuntimeError, match="process group"):
        devices_for(2, "cpu")
    with pytest.raises(ValueError):
        devices_for(0, "cpu")
    cfg = ARCHS["granite-8b"].reduced()
    with pytest.raises(RuntimeError, match="process group"):
        ElasticTrainer(cfg, SHAPES["train_4k"].reduced(), n_devices=2,
                       device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        ElasticTrainer(cfg, SHAPES["train_4k"].reduced(), model_par=2,
                       device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        ElasticTrainer(ARCHS["seamless-m4t-medium"].reduced(),
                       SHAPES["train_4k"].reduced(), model_par=2,
                       device="cpu")


def test_port_trainer_matches_reference_trainer_across_a_rescale(monkeypatch):
    """The reference's ``ElasticTrainer`` and the port's, from one float32
    state and the same batches: 2 steps, ``rescale(1)``, 2 steps."""
    arch = "granite-8b"
    jcfg = jax_config(arch).reduced().with_(compute_dtype="float32")
    tcfg = get_config(arch).reduced().with_(compute_dtype="float32")
    jshape = JSHAPES["train_4k"].reduced()
    tshape = SHAPES["train_4k"].reduced()
    # both trainers draw their initial state from the seed; the
    # reference's draw is replaced by the port's (JAX's eager init of a
    # reduced model takes seconds), so both start from one state
    init = tzoo.state_to_numpy(tzoo.init_state(tcfg, 3, device="cpu"))
    monkeypatch.setattr(jzoo, "init_state", lambda cfg, rng: jzoo.TrainState(
        jnp.asarray(init.step), jax.tree.map(jnp.asarray, init.params),
        jadamw.AdamWState(jax.tree.map(jnp.asarray, init.opt.m),
                          jax.tree.map(jnp.asarray, init.opt.v))))
    ref = JElasticTrainer(jcfg, jshape, n_devices=1, seed=3,
                          hp=jadamw.HParams(**HP))
    ours = ElasticTrainer(tcfg, tshape, n_devices=1, seed=3,
                          hp=adamw.HParams(**HP), device="cpu")
    start = tzoo.state_to_numpy(ours.state).params
    for a, b in zip(jax.tree.leaves(ref.state.params),
                    jax.tree.leaves(start)):
        assert np.array_equal(np.asarray(a), b)
    for tr in (ref, ours):
        tr.train(2, log_every=0)
        tr.rescale(1)
        tr.train(2, log_every=0)
    for a, b in zip(ref.metrics_log, ours.metrics_log):
        assert a["step"] == b["step"]
        for k in ("loss", "nll", "grad_norm"):
            assert b[k] == pytest.approx(a[k], rel=1e-5), (a["step"], k)
    assert [e.kind for e in ref.runtime.events] == \
        [e.kind for e in ours.runtime.events]
    assert set(ours.runtime.events[0].stages) == \
        set(ref.runtime.events[0].stages)
    # the final masters, leaf by leaf (relative L2, as test_torch_train
    # holds them: Adam's normalised step moves a lone element whose m and
    # v are tiny by more than its neighbours)
    final = tzoo.state_to_numpy(ours.state)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray,
                                                 ref.state.params)),
                    jax.tree.leaves(final.params)):
        assert np.linalg.norm(b - a) <= 2e-5 * np.linalg.norm(a)


def test_launcher_cli(capsys):
    launch_train.main(["--device", "cpu", "--arch", "mamba2-780m",
                       "--reduced", "--steps", "2"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "done:" in out
    with pytest.raises(RuntimeError, match="process group"):
        launch_train.main(["--device", "cpu", "--reduced",
                           "--model-par", "2", "--steps", "1"])
