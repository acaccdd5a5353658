"""The port's flash attention and its long-prompt prefill path, held
against JAX.

Inputs are drawn with numpy from a seed and handed to both packages; the
JAX parameters of the reduced models are carried across with
``params_from_numpy``.  Compared with JAX:

* ``ops.attention`` (its CPU route, ``flash_attention_ref``) against the
  Pallas kernel in interpret mode, at ``tests/test_kernels.py``'s shapes;
* ``blockwise_attention`` against JAX's, in float32 and bf16;
* ``attention_block`` with ``attn_impl="blockwise"``, and at the real
  switch (``s > 8192``) on a one-layer model;
* ``make_prefill`` (dense and hybrid) and the dense engine with
  ``attn_impl="blockwise"``; a dense engine whose bucket is past 8192.

Beside them, the bf16 CUDA kernel's numerical argument in plain float32
(no JAX): p split into two bf16 terms keeps attention within one bf16
ulp of ``flash_attention_ref``.

Tolerances.  Float32: both sides compute the same float32 operations and
sum in another order; the largest differences seen are 7.2e-7
(ops.attention against the Pallas kernel) and 5.1e-7 (blockwise), so the
first is held to 2e-6 and the rest to 1e-5.  bf16: float32 values that
agree to ~1e-6 are
rounded to bf16 at the end (and ``p`` before ``p @ v`` in blockwise); a
value near a rounding boundary lands on the other neighbour, so outputs
are held to one bf16 ulp of their largest magnitude.

Sizes: every case stays under ~10 s and well under 0.5 GiB; the case at
s = 8704 uses blocks of 512 (a (1, 2, 2, 512, 512) float32 score block)
and never materialises full attention at that length.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShape
from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ref import flash_ref as jflash_ref
from repro.models import layers as JL
from repro.models import model_zoo as jzoo
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config as torch_config
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.kernels.flash_attention import attention, flash_attention_ref
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

# One intra-op thread: the suite runs in parallel workers beside tests
# that time the wall clock.
torch.set_num_threads(1)

KERNEL_F32_ATOL = 2e-6
F32 = dict(rtol=1e-5, atol=1e-5)
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py::test_flash_kernel: (b, h, kv, s, d, bq, bkv)
FLASH_SHAPES = [
    (1, 4, 2, 128, 32, 32, 32),
    (2, 8, 8, 64, 16, 32, 16),
    (1, 4, 4, 128, 64, 64, 64),
    (1, 6, 3, 96, 32, 32, 32),
    (1, 2, 1, 64, 16, 16, 32),
]


def _qkv(b, h, kv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, kv, sk, d)).astype(np.float32),
            rng.standard_normal((b, kv, sk, d)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt = DT[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _one_bf16_ulp(ref):
    """One bf16 ulp at the largest magnitude of ``ref`` (8 bits kept)."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _seq_major(arrays):
    """Heads-major (B, H, S, D) numpy arrays -> the model's (B, S, H, D)."""
    return [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in arrays]


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("b,h,kv,s,d,bq,bkv", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_pallas_kernel(b, h, kv, s, d, bq, bkv, causal):
    arrays = _qkv(b, h, kv, s, s, d)
    (jq, jk, jv), _ = _both(arrays, "float32")
    want = jflash(jq, jk, jv, causal=causal, block_q=bq, block_kv=bkv,
                  interpret=True)
    _, (tq, tk, tv) = _both(_seq_major(arrays), "float32")
    got = attention(tq, tk, tv, causal=causal, block_q=bq, block_kv=bkv)
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got).transpose(0, 2, 1, 3), _f32(want),
                               rtol=0, atol=KERNEL_F32_ATOL)
    # the heads-major plain version is the same function
    heads = flash_attention_ref(*[torch.from_numpy(a) for a in arrays],
                                causal=causal, block_q=bq, block_kv=bkv)
    np.testing.assert_array_equal(heads.numpy(),
                                  _f32(got).transpose(0, 2, 1, 3))


def test_attention_bf16_matches_pallas_kernel():
    """tests/test_kernels.py::test_flash_kernel_bf16's case: against the
    Pallas kernel within one bf16 ulp, and against ``flash_ref`` within
    the reference's 3e-2."""
    arrays = _qkv(1, 4, 2, 64, 64, 32, seed=1)
    (jq, jk, jv), _ = _both(arrays, "bfloat16")
    want = jflash(jq, jk, jv, causal=True, block_q=32, block_kv=32,
                  interpret=True)
    _, (tq, tk, tv) = _both(_seq_major(arrays), "bfloat16")
    got = attention(tq, tk, tv, causal=True, block_q=32, block_kv=32)
    assert got.dtype == torch.bfloat16
    got = _f32(got).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, _f32(want), rtol=0,
                               atol=_one_bf16_ulp(_f32(want)))
    full = jflash_ref(jq, jk, jv, causal=True)
    assert float(np.abs(got - _f32(full)).max()) < 3e-2


@pytest.mark.parametrize("block_q,block_kv", [(0, 32), (48, 32), (32, 48)])
def test_attention_refuses_what_the_reference_asserts(block_q, block_kv):
    """Blocks that do not divide the lengths after ``min(block, S)``."""
    _, (tq, tk, tv) = _both(_seq_major(_qkv(1, 2, 1, 64, 64, 16)),
                            "float32")
    with pytest.raises(ValueError, match="divide"):
        attention(tq, tk, tv, block_q=block_q, block_kv=block_kv)
    with pytest.raises(ValueError, match="divide"):
        attention(tq, tk, tv, block_q=block_q, block_kv=block_kv,
                  impl="ref")
    with pytest.raises(ValueError, match="divide"):
        TL.blockwise_attention(tq, tk, tv, causal=True, block_q=block_q,
                               block_kv=block_kv)
    with pytest.raises(ValueError, match="impl"):
        attention(tq, tk, tv, block_q=32, block_kv=32, impl="auto")


# The shapes of test_torch_cuda.py::test_flash_kernel_matches_plain_on_card
CUDA_FLASH_SHAPES = FLASH_SHAPES + [
    (1, 32, 8, 320, 128, 64, 64),
    (2, 4, 4, 200, 80, 512, 512),
    (1, 4, 1, 48, 48, 48, 16),
    (1, 4, 2, 128, 96, 64, 64),
    (2, 2, 1, 80, 112, 16, 16),
]
BF16_ULP_TOL = dict(rtol=2.0 ** -7, atol=1e-5)  # one bf16 ulp of each |x|


def _split_p_attention(q, k, v, causal):
    """Attention as the bf16 CUDA kernel computes it, in plain float32:
    q.k^T of bf16 inputs (products exact in float32), the softmax weights
    p in float32, and p.v with p split into two bf16 terms
    ``hi = bf16(p)``, ``lo = bf16(p - hi)`` against v in bf16.  Heads-major
    (B, H, S, D) in, (output float32, p, hi + lo) out."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    sc = torch.matmul(q.float(), kf.transpose(-1, -2)) * d ** -0.5
    if causal:
        sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                            -1e30)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    out = torch.matmul(hi + lo, vf) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out, p, hi + lo


@pytest.mark.parametrize("b,h,kv,s,d,bq,bkv", CUDA_FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_split_p_keeps_the_bf16_kernel_within_one_ulp(b, h, kv, s, d, bq,
                                                      bkv, causal):
    """The bf16 kernel's numerical argument, on the CPU: p as two bf16
    terms is within 2^-16 of p, and attention with that p rounds to
    within one bf16 ulp of the plain version, which keeps p in float32."""
    q, k, v = [torch.from_numpy(a).bfloat16()
               for a in _qkv(b, h, kv, s, s, d, seed=s + d)]
    out, p, split = _split_p_attention(q, k, v, causal)
    assert bool(((p - split).abs() <= 2.0 ** -16 * p).all())
    ref = flash_attention_ref(q, k, v, causal=causal, block_q=bq,
                              block_kv=bkv)
    np.testing.assert_allclose(_f32(out.bfloat16()), _f32(ref),
                               **BF16_ULP_TOL)


# -------------------------------------------------- blockwise_attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,d,bq,bkv,causal", [
    (1, 4, 2, 128, 32, 32, 32, True),
    (2, 4, 4, 64, 16, 16, 32, True),     # bq < bkv: partial n_valid block
    (1, 6, 3, 96, 32, 32, 16, True),     # bq > bkv
    (1, 4, 2, 128, 32, 64, 32, False),
    (1, 2, 1, 40, 16, 512, 512, True),   # blocks cut to the length
])
def test_blockwise_attention_matches_jax(dtype, b, h, kv, s, d, bq, bkv,
                                         causal):
    arrays = _seq_major(_qkv(b, h, kv, s, s, d, seed=2))
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    want = _f32(JL.blockwise_attention(jq, jk, jv, causal=causal,
                                       block_q=bq, block_kv=bkv))
    got = TL.blockwise_attention(tq, tk, tv, causal=causal, block_q=bq,
                                 block_kv=bkv)
    assert got.dtype == DT[dtype][1] and got.shape == (b, s, h, d)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), want, **F32)
    else:
        np.testing.assert_allclose(_f32(got), want, rtol=0,
                                   atol=_one_bf16_ulp(want))


# ---------------------------------------------------------- the layer
def _layer_params(cfg, seed=0):
    """numpy params of one attention block of ``cfg``."""
    rng = np.random.default_rng(seed)
    d, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def w(fan_in, *shape):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return {"norm": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            "wq": w(d, d, H, D), "wk": w(d, d, KV, D), "wv": w(d, d, KV, D),
            "wo": w(H * D, H, D, d)}


def _block_params(tree, tcfg, dtype):
    """The layer's params as ``convert`` stores them: matmul weights in
    the compute dtype, the norm float32."""
    return {k: torch.from_numpy(v).to(torch.float32 if k == "norm" else
                                      DT[dtype][1]) for k, v in tree.items()}


def _cfgs(**kw):
    jcfg = jax_config("granite-8b").reduced().with_(**kw)
    tcfg = torch_config("granite-8b").reduced().with_(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _spy_blockwise(monkeypatch):
    """Record the length of every ``blockwise_attention`` call."""
    seen = []
    blockwise = TL.blockwise_attention

    def spy(q, k, v, **kw):
        seen.append(q.shape[1])
        return blockwise(q, k, v, **kw)

    monkeypatch.setattr(TL, "blockwise_attention", spy)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_blockwise_matches_jax(dtype):
    jcfg, tcfg = _cfgs(compute_dtype=dtype, attn_impl="blockwise",
                       flash_block_q=16, flash_block_kv=32)
    tree = _layer_params(jcfg)
    x = np.random.default_rng(4).standard_normal((2, 64, 64)).astype(
        np.float32)
    (jx,), (tx,) = _both([x], dtype)
    jout, (jk, jv) = JL.attention_block(
        {k: jnp.asarray(v) for k, v in tree.items()}, jx, jcfg)
    tout, (tk, tv) = TL.attention_block(_block_params(tree, tcfg, dtype), tx,
                                        tcfg)
    for t, j in ((tout, jout), (tk, jk), (tv, jv)):
        want = _f32(j)
        if dtype == "float32":
            np.testing.assert_allclose(_f32(t), want, **F32)
        else:
            # the residual sum and projections round in bf16 on both
            # sides; XLA may fuse and round once where torch rounds per
            # op: two ulps at the largest magnitude
            np.testing.assert_allclose(_f32(t), want, rtol=0,
                                       atol=2 * _one_bf16_ulp(want))


def test_attention_block_switches_past_8192_as_the_reference(monkeypatch):
    """A one-layer model (d_model 64, 4 heads of 16) at s = 8704 with the
    default ``attn_impl="auto"`` and blocks of 512: the port takes
    ``blockwise_attention`` exactly as JAX does, and agrees with it; at
    s = 8192 it takes ``full_attention`` (stubbed here: the real call
    would hold 1 GiB of logits)."""
    jcfg, tcfg = _cfgs(compute_dtype="float32", num_layers=1)
    assert (tcfg.d_model, tcfg.num_heads, tcfg.head_dim) == (64, 4, 16)
    assert (tcfg.attn_impl, tcfg.flash_block_q) == ("auto", 512)
    tree = _layer_params(jcfg, seed=5)
    rng = np.random.default_rng(6)
    seen = _spy_blockwise(monkeypatch)
    full = []

    def full_stub(q, k, v, **kw):
        full.append(q.shape[1])
        return torch.zeros_like(q)

    monkeypatch.setattr(TL, "full_attention", full_stub)
    x = (0.5 * rng.standard_normal((1, 8704, 64))).astype(np.float32)
    jout, (jk, _) = JL.attention_block(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x), jcfg)
    tout, (tk, _) = TL.attention_block(_block_params(tree, tcfg, "float32"),
                                       torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(tout.numpy(), _f32(jout), **F32)
    np.testing.assert_allclose(tk.numpy(), _f32(jk), **F32)
    TL.attention_block(_block_params(tree, tcfg, "float32"),
                       torch.from_numpy(x[:, :8192]), tcfg)
    assert (seen, full) == ([8704], [8192])


# --------------------------------------------------------- model and engine
_MODELS = {}


def _models(arch, **kw):
    """(jcfg, jparams, tcfg, tparams) of reduced ``arch``."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg = jax_config(arch).reduced().with_(**kw)
        tcfg = torch_config(arch).reduced().with_(**kw)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jparams = jzoo.init_state(jcfg, jax.random.PRNGKey(0)).params
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
        _MODELS[key] = jcfg, jparams, tcfg, tparams
    return _MODELS[key]


BLOCKWISE = dict(compute_dtype="float32", attn_impl="blockwise",
                 flash_block_q=16, flash_block_kv=16)


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b"])
def test_make_prefill_blockwise_matches_jax_f32(arch, monkeypatch):
    """Logits and every cache leaf.  Float32 logits to 1e-4 (as the ssm
    family's prefill tests hold them); the caches are stored in bf16, so
    k, v (and zamba2's conv tails) within one bf16 ulp, 2^-7 relative,
    and the SSD states to 1e-4."""
    jcfg, jparams, tcfg, tparams = _models(arch, **BLOCKWISE)
    seen = _spy_blockwise(monkeypatch)
    B, S = 2, 64
    toks = np.random.default_rng(3).integers(0, 250, (B, S)).astype(np.int32)
    jlogits, jstate = jzoo.make_prefill(jcfg, JShape("p", S, B, "prefill"))(
        jparams, {"tokens": jnp.asarray(toks)})
    tlogits, tstate = tzoo.make_prefill(tcfg, TShape("p", S, B, "prefill"))(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert seen == [S] * tzoo._attn_layers(tcfg)
    np.testing.assert_allclose(tlogits.numpy(), _f32(jlogits), rtol=1e-4,
                               atol=1e-4)
    assert set(tstate.cache) == set(jstate.cache)
    for key, jleaf in jstate.cache.items():
        tleaf = tstate.cache[key]
        assert tuple(tleaf.shape) == tuple(jleaf.shape), key
        if key == "ssm":
            np.testing.assert_allclose(_f32(tleaf), _f32(jleaf), rtol=1e-4,
                                       atol=1e-4)
        else:
            np.testing.assert_allclose(_f32(tleaf), _f32(jleaf),
                                       rtol=2.0 ** -7, atol=1e-5)


# prompt lengths within the 16 bucket, the 64 bucket and past it (the
# rest streams), as tests/test_torch_engine.py draws them
PROMPTS = (5, 20, 70, 90, 12, 40)
MAX_NEW = (6, 4, 5, 3, 8, 6)


def _serve(engine, request_cls, prompts, max_new):
    reqs = [request_cls(rid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    assert all(r.done for r in reqs)
    assert [len(r.out_tokens) for r in reqs] == list(max_new)
    counters = {"host_syncs": engine.host_syncs,
                "chunk_prefills": engine.chunk_prefills,
                "peak_slots": engine._peak_slots,
                "processed": engine.processed_tokens}
    return {r.rid: list(r.out_tokens) for r in reqs}, counters


def test_dense_engine_blockwise_matches_jax_engine_f32():
    jcfg, jparams, tcfg, tparams = _models("granite-8b", **BLOCKWISE)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 250, n).astype(np.int32) for n in PROMPTS]
    engine = dict(batch_size=3, max_seq=96, prefill_buckets=(16, 64))
    jstreams, jcount = _serve(JEngine(jcfg, jparams, **engine), JRequest,
                              prompts, MAX_NEW)
    tstreams, tcount = _serve(TEngine(tcfg, tparams, device="cpu", **engine),
                              TRequest, prompts, MAX_NEW)
    assert tstreams == jstreams
    assert tcount == jcount


def test_dense_engine_bucket_past_8192_prefills_blockwise(monkeypatch):
    """A dense engine with a bucket past 8192 (one layer, d_model 64):
    the long prompt's bulk prefill runs ``blockwise_attention`` (once per
    layer, at the bucket's length), the short one ``full_attention``, and
    the greedy streams and counters equal the JAX engine's."""
    jcfg, jparams, tcfg, tparams = _models("granite-8b", num_layers=1,
                                           compute_dtype="float32")
    seen = _spy_blockwise(monkeypatch)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 250, n).astype(np.int32) for n in (8300, 30)]
    engine = dict(batch_size=2, max_seq=8720, prefill_buckets=(16, 64, 8704))
    tstreams, tcount = _serve(TEngine(tcfg, tparams, device="cpu", **engine),
                              TRequest, prompts, (3, 3))
    assert seen == [8704]
    jstreams, jcount = _serve(JEngine(jcfg, jparams, **engine), JRequest,
                              prompts, (3, 3))
    assert tstreams == jstreams
    assert tcount == jcount
