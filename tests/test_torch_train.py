"""The port's training path, held against the JAX package on the CPU.

Cross-package parity: the same float32 masters (the port's
``init_state``, carried to JAX as numpy) and the same ``SyntheticLM``
batches go through ``repro.models.model_zoo.make_train_step`` (jitted) and the
port's for reduced granite-8b (dense), qwen2-moe-a2.7b (moe),
mamba2-780m (ssm), zamba2-2.7b (hybrid), seamless-m4t-medium (enc_dec:
bf16 frames into the encoder) and internvl2-26b (vlm: bf16 patch
embeddings, the loss on the text positions), 3 steps with a test-scale
schedule (``schedule(0)`` is 0: the first step moves nothing).

Tolerances:

* float32 compute: the same ops summed in other orders agree to ~1e-7
  relative a step; over 3 steps the leaves read <= 4e-6 relative L2
  on the CPU.  Metrics are held to 1e-5 relative, params to 2e-5
  relative L2 per leaf, m and v to 5e-5 (m and v follow the gradient,
  which carries the summation noise undamped).
* bf16 compute (the configs' own): every activation is rounded to bf16
  (2^-9 relative), and where the two packages round differs, so the
  gradients of one step differ by ~3% relative L2 between them, as
  much as the reference's bf16 gradient differs from its own float32
  one.  So the port's bf16 move over 3 steps (a leaf's value less its
  initial one) must be no farther from the reference's float32 move
  than 1.5 times the reference's bf16 move is, over all params, all m
  and all v (read on the CPU: 0.9-1.1x), and 4 times for each leaf
  (small leaves, a norm's 64 values, read up to 2.7x: a single draw of
  rounding noise); loss and nll are held to 2e-3 relative, aux and
  grad_norm to 2e-2.

Then the mirrors of the reference's training tests (``test_models.py``,
``test_moe_impls.py``), the optimizer against ``repro.optim.adamw``,
remat on against off, the SSD gradient's wiring and the guards of the
kernel wrappers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JSHAPES
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.jacobi import kernel as jacobi_kernel
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as T
from repro_torch.models.convert import _convert, compute_view
from repro_torch.models.schema import init_params
from repro_torch.optim import adamw

torch.set_num_threads(1)

CPU = torch.device("cpu")
PARITY_ARCHS = ("granite-8b", "qwen2-moe-a2.7b", "mamba2-780m",
                "zamba2-2.7b", "seamless-m4t-medium", "internvl2-26b")
PORTED = sorted(ARCHS)
HP = dict(lr=1e-3, warmup_steps=2, total_steps=100)
STEPS = 3
F32_METRIC = 1e-5
F32_PARAM, F32_MOMENT = 2e-5, 5e-5
BF16_METRIC = dict(loss=2e-3, nll=2e-3, aux=2e-2, grad_norm=2e-2)
BF16_RATIO, BF16_LEAF_RATIO = 1.5, 4.0
_RUNS = {}


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def initial_state(arch):
    """Float32 masters of reduced ``arch`` as numpy, drawn by the port's
    ``init_state`` (milliseconds; JAX's eager init of reduced zamba2 takes
    seconds): both packages start from them."""
    cfg = get_config(arch).reduced()
    return tzoo.state_to_numpy(tzoo.init_state(cfg, 0, device="cpu"))


def to_jax(state):
    """A numpy state (either package's layout: they are the same) ->
    ``repro``'s ``TrainState``."""
    return jzoo.TrainState(
        jnp.asarray(state.step), jax.tree.map(jnp.asarray, state.params),
        jadamw.AdamWState(jax.tree.map(jnp.asarray, state.opt.m),
                          jax.tree.map(jnp.asarray, state.opt.v)))


def jax_run(arch, dtype):
    """The reference's 3 steps of reduced ``arch`` in ``dtype`` compute:
    (the initial state as numpy, its metrics per step, its final state
    as numpy).  Cached for the module: one jitted step per (arch, dtype)."""
    key = ("jax", arch, dtype)
    if key not in _RUNS:
        cfg = jax_config(arch).reduced().with_(compute_dtype=dtype)
        init = initial_state(arch)
        state = to_jax(init)
        step = jax.jit(jzoo.make_train_step(cfg, jadamw.HParams(**HP)))
        data = JSyntheticLM(cfg, JSHAPES["train_4k"].reduced(), seed=0)
        metrics = []
        for i in range(STEPS):
            state, m = step(state, jax.tree.map(jnp.asarray,
                                                data.batch_at(i)))
            metrics.append({k: float(v) for k, v in m.items()})
        _RUNS[key] = (init, metrics, jax.tree.map(np.asarray, state))
    return _RUNS[key]


def torch_run(arch, dtype, init):
    """The port's 3 steps from the reference's initial state."""
    cfg = get_config(arch).reduced().with_(compute_dtype=dtype)
    state = tzoo.state_from_numpy(init, device="cpu")
    step = tzoo.make_train_step(cfg, adamw.HParams(**HP))
    data = SyntheticLM(cfg, SHAPES["train_4k"].reduced(), seed=0)
    metrics = []
    for i in range(STEPS):
        batch = {k: torch.as_tensor(v) for k, v in data.batch_at(i).items()}
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, tzoo.state_to_numpy(state)


def leaves(state):
    """(kind, leaf) pairs of a numpy state, either package's, in
    ``jax.tree.leaves`` order."""
    out = []
    for kind, tree in (("params", state.params), ("m", state.opt.m),
                       ("v", state.opt.v)):
        out += [(kind, x) for x in jax.tree.leaves(tree)]
    return out


# ------------------------------------------------------ cross-package parity
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_train_step_matches_reference_float32(arch):
    init, jm, jstate = jax_run(arch, "float32")
    tm, tstate = torch_run(arch, "float32", init)
    for step, (a, b) in enumerate(zip(jm, tm)):
        for k in ("loss", "nll", "grad_norm"):
            assert b[k] == pytest.approx(a[k], rel=F32_METRIC), (step, k)
        assert b["aux"] == pytest.approx(a["aux"], rel=F32_METRIC,
                                         abs=1e-7), step
    assert int(tstate.step) == int(jstate.step) == STEPS
    for (kind, a), (_, b) in zip(leaves(jstate), leaves(tstate)):
        assert a.shape == b.shape and b.dtype == np.float32
        tol = F32_PARAM if kind == "params" else F32_MOMENT
        assert rel_l2(a, b) <= tol, (kind, rel_l2(a, b))


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_train_step_matches_reference_bf16(arch):
    init, j32, j32_state = jax_run(arch, "float32")
    _, j16, j16_state = jax_run(arch, "bfloat16")
    t16, t16_state = torch_run(arch, "bfloat16", init)
    for step, (a, b) in enumerate(zip(j16, t16)):
        for k, tol in BF16_METRIC.items():
            assert b[k] == pytest.approx(a[k], rel=tol, abs=1e-5), (step, k)
    # each leaf's move from the initial state (m and v start at 0)
    moves = {}
    for (kind, start), (_, exact), (_, ref), (_, ours) in zip(
            leaves(init), leaves(j32_state), leaves(j16_state),
            leaves(t16_state)):
        exact, ref, ours = exact - start, ref - start, ours - start
        bound = BF16_LEAF_RATIO * rel_l2(exact, ref) + 1e-6
        assert rel_l2(exact, ours) <= bound, (kind, rel_l2(exact, ours),
                                              rel_l2(exact, ref))
        for i, x in enumerate((exact, ref, ours)):
            moves.setdefault(kind, ([], [], []))[i].append(x.ravel())
    for kind, (exact, ref, ours) in moves.items():
        exact, ref, ours = (np.concatenate(x) for x in (exact, ref, ours))
        assert rel_l2(exact, ours) <= BF16_RATIO * rel_l2(exact, ref), kind


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_state_is_the_references_tree(arch):
    """The port's state is leaf for leaf, shape for shape the reference's
    (``abstract_state``), and crosses both ways unchanged."""
    init = initial_state(arch)
    want = jzoo.abstract_state(jax_config(arch).reduced())
    assert jax.tree.structure(to_jax(init)) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(to_jax(init)), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = tzoo.state_to_numpy(tzoo.state_from_numpy(
        jax.tree.map(np.asarray, to_jax(init)), device="cpu"))
    assert int(back.step) == 0
    for (_, a), (_, b) in zip(leaves(init), leaves(back)):
        assert np.array_equal(a, b)


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("step", [0, 1, 2, 3, 50, 99, 100, 150])
def test_schedule_matches_reference(step):
    hp = adamw.HParams(**HP)
    want = float(jadamw.schedule(jnp.int32(step), jadamw.HParams(**HP)))
    assert float(adamw.schedule(torch.tensor(step), hp)) == want


@pytest.mark.parametrize("step", [0, 1, 5, 60, 99])
def test_adamw_update_matches_reference(step):
    """At warmup (0, 1), at the peak (5 of warmup 5) and in the cosine
    tail: new params, m and v, with clipping active (|g| > clip)."""
    hp = dict(lr=1e-2, warmup_steps=5, total_steps=100)
    rng = np.random.default_rng(step)
    tree = {"b": rng.standard_normal((3, 4)).astype(np.float32),
            "a": {"x": rng.standard_normal(5).astype(np.float32)}}
    grads = {"b": 4 * rng.standard_normal((3, 4)).astype(np.float32),
             "a": {"x": rng.standard_normal(5).astype(np.float32)}}
    m = jax.tree.map(lambda x: 0.1 * np.abs(x), tree)
    v = jax.tree.map(lambda x: 0.01 * x * x, tree)
    jp, jst = jadamw.update(jax.tree.map(jnp.asarray, tree),
                            jax.tree.map(jnp.asarray, grads),
                            jadamw.AdamWState(jax.tree.map(jnp.asarray, m),
                                              jax.tree.map(jnp.asarray, v)),
                            jnp.int32(step), jadamw.HParams(**hp))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    tp, tst = adamw.update(adamw.tree_map(t, tree), adamw.tree_map(t, grads),
                           adamw.AdamWState(adamw.tree_map(t, m),
                                            adamw.tree_map(t, v)),
                           torch.tensor(step, dtype=torch.int32),
                           adamw.HParams(**hp))
    for a, b in ((jp, tp), (jst.m, tst.m), (jst.v, tst.v)):
        for x, y in zip(jax.tree.leaves(a), adamw.flatten(b)[0]):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6,
                                       atol=1e-9)
    assert float(adamw.global_norm(adamw.tree_map(t, grads))) == \
        pytest.approx(float(jadamw.global_norm(grads)), rel=1e-6)


def test_adamw_keeps_dtype_and_leaves_arguments():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    g = {"w": torch.full((4,), 0.5)}
    st = adamw.init(p)
    assert st.m["w"].dtype == torch.float32
    new, st2 = adamw.update(p, g, st, torch.tensor(3), adamw.HParams(**HP))
    assert new["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"], torch.ones(4, dtype=torch.bfloat16))
    assert float(st.m["w"].abs().sum()) == 0.0
    assert float(st2.m["w"].abs().sum()) > 0.0


# ------------------------------------------------- mirrors: test_models.py
@pytest.mark.parametrize("name", PORTED)
def test_arch_train_step(name):
    cfg = ARCHS[name].reduced()
    shape = SHAPES["train_4k"].reduced()
    state = tzoo.init_state(cfg, 0, device="cpu")
    batch = tzoo.make_batch(cfg, shape, seed=0, device="cpu")
    step = tzoo.make_train_step(cfg)
    state2, metrics = step(state, batch)
    assert int(state2.step) == 1
    assert not torch.isnan(metrics["loss"]), name
    state2, metrics = step(state2, batch)  # step 2: warmup lr > 0
    assert not torch.isnan(metrics["loss"]), name
    # params changed and have the same structure/shapes
    p0 = adamw.flatten(state.params)[0]
    p1 = adamw.flatten(state2.params)[0]
    assert len(p0) == len(p1)
    assert all(a.shape == b.shape for a, b in zip(p0, p1))
    assert any(float((a - b).abs().max()) > 0 for a, b in zip(p0, p1))


def test_grad_accum_matches_single_batch():
    """n_micro=4 grad accumulation == single-shot full batch."""
    cfg = ARCHS["granite-3-2b"].reduced().with_(
        remat="none", num_microbatches=4)
    cfg1 = cfg.with_(num_microbatches=1)
    shape = SHAPES["train_4k"].reduced()
    state = tzoo.init_state(cfg, 0, device="cpu")
    batch = tzoo.make_batch(cfg, shape, seed=1, device="cpu")
    _, m4 = tzoo.make_train_step(cfg)(state, batch)
    _, m1 = tzoo.make_train_step(cfg1)(state, batch)
    assert abs(float(m4["loss"]) - float(m1["loss"])) < 5e-3


def test_padded_vocab_masked():
    cfg = ARCHS["granite-3-2b"].reduced()  # vocab 256 -> padded 256
    cfg = cfg.with_(vocab_size=250)        # force padding
    state = tzoo.init_state(cfg, 0, device="cpu")
    view = compute_view(state.params, cfg)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    h, _ = T.decoder_forward(view, toks, cfg)
    logits = T.lm_logits(view, h, cfg)
    assert logits.shape[-1] == cfg.padded_vocab
    assert float(logits[..., cfg.vocab_size:].max()) <= -1e29


# ---------------------------------------------- mirror: test_moe_impls.py
def test_grouped_gradients_finite():
    cfg = get_config("qwen3-moe-30b-a3b").reduced().with_(
        num_experts=8, top_k=2, capacity_factor=1.0, num_shared_experts=0,
        moe_groups=4)
    tree = init_params(tmoe.moe_schema(cfg), torch.Generator().manual_seed(0),
                       "cpu")
    p = {k: v.requires_grad_() for k, v in tree.items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 32, cfg.d_model)).astype(np.float32))
    o, a = tmoe._moe_grouped(_convert(p, cfg, CPU), x, cfg)
    ((o.float() ** 2).mean() + a).backward()
    for leaf in p.values():
        assert leaf.grad is not None
        assert bool(torch.isfinite(leaf.grad).all())


def test_moe_aux_gradient_matches_reference():
    """The aux loss reaches the router: its gradient equals JAX's."""
    cfg = jax_config("qwen2-moe-a2.7b").reduced().with_(
        compute_dtype="float32")
    p = jax.tree.map(lambda a: a[0], initial_state(
        "qwen2-moe-a2.7b").params["layers"]["moe"])
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda q: jmoe.moe_block(q, jnp.asarray(x),
                                                   cfg)[1]))(
        jax.tree.map(jnp.asarray, p))
    tcfg = get_config("qwen2-moe-a2.7b").reduced().with_(
        compute_dtype="float32")
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tmoe.moe_block(tp, torch.from_numpy(x), tcfg)[1].backward()
    np.testing.assert_allclose(tp["router"].grad.numpy(),
                               np.asarray(jg["router"]), rtol=1e-5,
                               atol=1e-8)


# ----------------------------------------------------------------- remat
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_remat_on_and_off_give_equal_gradients(arch):
    cfg = get_config(arch).reduced().with_(compute_dtype="float32")
    state = tzoo.init_state(cfg, 0, device="cpu")
    batch = tzoo.make_batch(cfg, SHAPES["train_4k"].reduced(), seed=4,
                            device="cpu")
    on = tzoo.train_grads(state.params, batch, cfg.with_(remat="full"))
    off = tzoo.train_grads(state.params, batch, cfg.with_(remat="none"))
    for a, b in zip(adamw.flatten(on[0])[0], adamw.flatten(off[0])[0]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    for a, b in zip(on[1:], off[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_train_grads_leave_the_state_alone():
    cfg = get_config("mamba2-780m").reduced().with_(compute_dtype="float32")
    state = tzoo.init_state(cfg, 0, device="cpu")
    before = [p.clone() for p in adamw.flatten(state.params)[0]]
    batch = tzoo.make_batch(cfg, SHAPES["train_4k"].reduced(), device="cpu")
    grads = tzoo.train_grads(state.params, batch, cfg)[0]
    for p, b, g in zip(adamw.flatten(state.params)[0], before,
                       adamw.flatten(grads)[0]):
        assert torch.equal(p, b) and p.grad is None and not p.requires_grad
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    bf = tzoo.train_grads(state.params, batch,
                          cfg.with_(grad_reduce_dtype="bfloat16"))[0]
    assert all(g.dtype == torch.bfloat16 for g in adamw.flatten(bf)[0])


# --------------------------------------------------------- the SSD gradient
def ssd_inputs(b, nc, l, h, p, n, seed=0, decay=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    dtr = torch.from_numpy(rng.uniform(0.01, 0.1, (b, nc, l, h))
                           .astype(np.float32))
    A = -torch.from_numpy(rng.uniform(1, 16, h).astype(np.float32)) * decay
    dA_cs = torch.cumsum(dtr * A, dim=2)
    return [t.requires_grad_() for t in
            (f(b, nc, l, h, p), dtr, dA_cs, f(b, nc, l, n), f(b, nc, l, n))]


def test_ssd_function_backward_is_the_plain_vjp(monkeypatch):
    """``SSDIntraChunk`` with the kernel's forward stood in for by its
    plain version: one forward call, none in the backward, and the
    gradients autograd gives through the plain version, bit for bit."""
    calls = []

    def fake_kernel(*args):
        assert not torch.is_grad_enabled()
        calls.append(1)
        return ssd_intra_chunk_ref(*args)
    monkeypatch.setattr(ssd_kernel, "ssd_intra_chunk", fake_kernel)
    args = ssd_inputs(2, 3, 16, 4, 8, 16)
    g = [torch.randn(2, 3, 16, 4, 8), torch.randn(2, 3, 4, 8, 16)]
    y, s = ssd_ops.SSDIntraChunk.apply(*args)
    got = torch.autograd.grad((y, s), args, g)
    assert len(calls) == 1
    want_out = ssd_intra_chunk_ref(*args)
    want = torch.autograd.grad(want_out, args, g)
    assert torch.equal(y, want_out[0]) and torch.equal(s, want_out[1])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ssd_cpu_route_is_the_plain_version():
    args = ssd_inputs(1, 2, 8, 2, 4, 8)
    y, s = ssd_ops.ssd_intra_chunk(*args)
    assert y.grad_fn is not None and "SSDIntraChunk" not in type(
        y.grad_fn).__name__


def test_ssd_plain_gradient_is_finite_where_decay_overflows():
    """Decays large enough that exp(seg) above the diagonal is inf in
    float32: the plain version masks seg before the exp, so its values
    are unchanged and its gradient stays finite."""
    args = ssd_inputs(1, 1, 64, 2, 4, 8, decay=40.0)
    seg_max = float((args[2][0, 0, 0] - args[2][0, 0, -1]).max().detach())
    assert seg_max > 89.0          # exp overflows float32 past ~88.7
    y, s = ssd_intra_chunk_ref(*args)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    grads = torch.autograd.grad((y.sum() + s.sum()), args)
    for g in grads:
        assert bool(torch.isfinite(g).all())


# ------------------------------------------------ guards of the wrappers
def _grad_inputs():
    q = torch.zeros(1, 2, 16, 16, requires_grad=True)
    return {
        "flash_attention": (flash_kernel.flash_attention, (q, q, q)),
        "paged_attention": (paged_kernel.paged_attention, (
            torch.zeros(1, 2, 16, requires_grad=True),
            torch.zeros(2, 16, 2, 16), torch.zeros(2, 16, 2, 16),
            torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))),
        "jacobi": (jacobi_kernel.jacobi_step,
                   (torch.zeros(64, 64, requires_grad=True),)),
        "ssd_intra_chunk": (ssd_kernel.ssd_intra_chunk,
                            tuple(ssd_inputs(1, 1, 16, 2, 8, 16))),
    }


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                  "jacobi", "ssd_intra_chunk"])
def test_wrappers_refuse_inputs_that_require_grad(name):
    """A wrapper whose output would be cut off from the graph raises
    before anything else; under no_grad the same call reaches the
    argument checks (which want a card)."""
    fn, args = _grad_inputs()[name]
    with pytest.raises(RuntimeError, match="no backward|SSDIntraChunk"):
        fn(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(*args)

