"""Model-level invariants on the port: the cases of ``test_models.py``
that ``test_torch_train.py`` does not hold (the train step smoke, grad
accumulation and the padded vocabulary are there).

* Every arch, reduced: a prefill of ``prefill_32k.reduced()`` and one
  serve step of ``decode_32k.reduced()`` give finite logits of the
  reference's shapes (the port's own seeded draw).
* Decode == forward: ten tokens fed one serve step at a time against
  one forward pass, on the reference's weights carried across, in bf16
  (the reference test's default) and float32.  In bf16 the port's
  decode is within the reference's 1e-3 of its forward and within 8
  bf16 ulps of the largest logit of the reference's decode.  In float32
  the port's decode is within ``F32_DECODE`` of the reference's decode,
  and its distance from its own forward is the reference's within 1e-5:
  a float32 forward attends over float32 k and v and a step over the
  bf16 cache in both packages (granite-8b and llama3.2-3b read ~2.7e-3
  and ~3.1e-3 on both sides), and the recurrent families' conv state
  carries float32 between steps as the reference's does
  (``model_zoo.conv_dtype``; before it did, mamba2-780m read 3.3e-3).
* An inactive slot keeps its cache and length; blockwise attention
  equals full attention; parameter counts lie in the reference's ranges
  and equal the reference's for every arch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import ShapeConfig as JShape
from repro.models import model_zoo as jzoo
from repro.models import transformer as jT
from repro.models.schema import init_params as jinit_params
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models import model_zoo as zoo
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

ARCH_NAMES = sorted(ARCHS)
DECODE_ARCHS = ["granite-8b", "mamba2-780m", "zamba2-2.7b", "llama3.2-3b"]
# float32: port decode vs reference decode, relative to the largest logit
# (attention rounds its probabilities to bf16, where sums in another
# order can land on neighbouring values)
F32_DECODE = {"granite-8b": 5e-4, "llama3.2-3b": 5e-4, "zamba2-2.7b": 5e-4,
              "mamba2-780m": 1e-5}


# ------------------------------------------------------------- smoke: serve
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_arch_prefill_decode(name):
    cfg = ARCHS[name].reduced()
    params = zoo.init_serving_params(cfg, seed=0, device="cpu")
    pshape = SHAPES["prefill_32k"].reduced()
    with torch.no_grad():
        logits, _ = zoo.make_prefill(cfg, pshape)(
            params, zoo.make_batch(cfg, pshape, device="cpu"))
        assert tuple(logits.shape) == (pshape.global_batch, 1,
                                       cfg.padded_vocab)
        assert not bool(torch.isnan(logits).any())

        dshape = SHAPES["decode_32k"].reduced()
        ds = zoo.init_decode_state(cfg, dshape, device="cpu")
        len0 = int(ds.cache_len[0])
        batch = zoo.make_batch(cfg, dshape, device="cpu")
        lg, ds2 = zoo.make_serve_step(cfg, dshape)(
            params, ds, batch["tokens"], batch["active"])
    assert tuple(lg.shape) == (dshape.global_batch, 1, cfg.padded_vocab)
    assert not bool(torch.isnan(lg).any())
    assert int(ds2.cache_len[0]) == len0 + 1


# ------------------------------------------------------- decode == forward
@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """The reference's seeded float32 masters of reduced ``name`` (the
    same in both compute dtypes)."""
    cfg = JARCHS[name].reduced()
    schema = jT.model_schema(cfg)
    return jax.jit(lambda key: jinit_params(schema, key, cfg.param_dtype))(
        jax.random.PRNGKey(0))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _reference_logits(cfg, params, toks):
    """The reference test's forward and fed-one-at-a-time decode."""
    S = toks.shape[1]
    h, _ = jT.decoder_forward(params, jnp.asarray(toks), cfg)
    full = np.asarray(jT.lm_logits(params, h, cfg).astype(jnp.float32))
    shape = JShape("t", S + 2, 2, "decode")
    step = jax.jit(jzoo.make_serve_step(cfg, shape))
    ds = jzoo.init_decode_state(cfg, shape, fill_len=0)
    outs = []
    for i in range(S):
        lg, ds = step(params, ds, {"tokens": jnp.asarray(toks[:, i:i + 1]),
                                   "active": jnp.ones((2,), jnp.int32)})
        outs.append(np.asarray(lg[:, 0].astype(jnp.float32)))
    return full, np.stack(outs, axis=1)


def _port_logits(cfg, params, toks):
    S = toks.shape[1]
    with torch.no_grad():
        h, _ = T.decoder_forward(params, torch.from_numpy(toks), cfg)
        full = T.lm_logits(params, h, cfg).float().numpy()
        shape = ShapeConfig("t", S + 2, 2, "decode")
        step = zoo.make_serve_step(cfg, shape)
        ds = zoo.init_decode_state(cfg, shape, fill_len=0, device="cpu")
        outs = []
        for i in range(S):
            lg, ds = step(params, ds, torch.from_numpy(toks[:, i:i + 1]),
                          torch.ones(2, dtype=torch.int32))
            outs.append(lg[:, 0].float().numpy())
    return full, np.stack(outs, axis=1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_matches_forward(name, dtype):
    kw = dict(remat="none", capacity_factor=100.0, compute_dtype=dtype)
    jcfg = JARCHS[name].reduced().with_(**kw)
    cfg = ARCHS[name].reduced().with_(**kw)
    jparams = _jax_params(name)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jfull, jdec = _reference_logits(jcfg, jparams, toks)
    full, dec = _port_logits(cfg, params, toks)
    if dtype == "bfloat16":
        assert _rel(dec, full) < 1e-3, (name, _rel(dec, full))
        top = np.abs(jdec).max()
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert np.abs(dec - jdec).max() <= 8 * ulp, name
    else:
        assert _rel(dec, jdec) < F32_DECODE[name], (name, _rel(dec, jdec))
        assert abs(_rel(dec, full) - _rel(jdec, jfull)) < 1e-5, \
            (name, _rel(dec, full), _rel(jdec, jfull))


def test_inactive_slots_frozen():
    """Continuous batching: an inactive slot's cache and length do not
    change."""
    cfg = ARCHS["granite-8b"].reduced()
    params = zoo.init_serving_params(cfg, seed=0, device="cpu")
    shape = ShapeConfig("t", 8, 2, "decode")
    ds = zoo.init_decode_state(cfg, shape, fill_len=2, device="cpu")
    k_old = ds.cache["k"][:, 1].clone()
    with torch.no_grad():
        _, ds2 = zoo.make_serve_step(cfg, shape)(
            params, ds, torch.tensor([[3], [5]], dtype=torch.int32),
            torch.tensor([1, 0], dtype=torch.int32))
    assert ds2.cache_len.tolist() == [3, 2]
    assert torch.equal(ds2.cache["k"][:, 1], k_old)
    assert not torch.equal(ds2.cache["k"][:, 0, 2],
                           torch.zeros_like(ds2.cache["k"][:, 0, 2]))


# ------------------------------------------------------- attention oracle
def test_blockwise_attention_matches_full():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    for causal in (True, False):
        o1 = L.blockwise_attention(q, k, v, causal=causal, block_q=16,
                                   block_kv=16)
        o2 = L.full_attention(q, k, v, causal=causal)
        assert float((o1 - o2).abs().max()) < 1e-4


# --------------------------------------------------------- param counts
def test_param_counts_plausible():
    """Full-config parameter counts are in the ranges the names promise,
    moe's active count is below its total, and both counts are the
    reference's for every arch."""
    expect = {
        "command-r-35b": (30e9, 40e9),
        "granite-8b": (7e9, 9e9),
        "llama3.2-3b": (3e9, 4.5e9),
        "qwen3-moe-30b-a3b": (25e9, 35e9),
        "mamba2-780m": (0.7e9, 0.9e9),
        "zamba2-2.7b": (2e9, 3.3e9),
    }
    for name, (lo, hi) in expect.items():
        n = zoo.num_params(ARCHS[name])
        assert lo <= n <= hi, (name, n)
    assert zoo.active_params(ARCHS["qwen3-moe-30b-a3b"]) < \
        zoo.num_params(ARCHS["qwen3-moe-30b-a3b"])
    for name in ARCHS:
        assert zoo.num_params(ARCHS[name]) == jzoo.num_params(JARCHS[name])
        assert zoo.active_params(ARCHS[name]) == \
            jzoo.active_params(JARCHS[name])
