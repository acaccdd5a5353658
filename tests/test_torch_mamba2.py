"""The port's Mamba2 block and the ssm/hybrid model zoo, held against JAX.

Reduced ``mamba2-780m`` (ssm) and ``zamba2-2.7b`` (hybrid) in float32
compute; the JAX parameters are carried across with
``params_from_numpy``.  Compared with JAX:

* ``mamba2_block``: prefill, state-continued prefill, and the decode
  recurrence with a mixed ``active`` mask;
* ``make_prefill``, one ``make_serve_step``, one
  ``make_paged_serve_step`` and a two-chunk ``make_paged_bulk_prefill``
  (``off`` 0, then ``off`` > 0): logits and every cache leaf.  Pools are
  compared as ``pool[:num_blocks]`` (the port's pool has one sink row).
  The port's conv leaf is float32 in float32 compute
  (``model_zoo.conv_dtype``), the dtype of the reference's leaf after a
  float32 step, and is compared with JAX's float32 leaf as it is; after
  a prefill, which rounds the conv tail to bf16 on both sides, it is
  compared with JAX's bf16 leaf;
* ten chained ``make_serve_step`` calls, and ten chained
  ``make_paged_serve_step`` calls after a ``make_paged_bulk_prefill``:
  every step's logits and the final ``ssm`` and ``conv`` leaves against
  the reference's chain, each relative to its largest element.

Tolerances: float32 results of the same ops summed in another order
agree to ~1e-6 relative here, so logits and float32 leaves are held to
1e-4 relative and absolute.  bf16 leaves (k, v, a prefill's conv tail)
are roundings of float32 values that agree to ~1e-6, which may land on
neighbouring bf16 values: one bf16 ulp, 2^-7 relative.  The chains hold
mamba2-780m to 1e-5 and zamba2-2.7b to 5e-4: its shared attention rounds
its probabilities to bf16, where float32 sums in another order can land
on neighbouring values (granite-8b's float32 decode differs from the
reference's by ~1e-4 for that reason).  Before the conv leaf followed
the compute dtype the chains read 3.3e-3 and 9.6e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShape
from repro.models import mamba2 as jm
from repro.models import model_zoo as jzoo
from repro_torch.configs import get_config as torch_config
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.models import mamba2 as tm
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.convert import params_from_numpy

# One intra-op thread: the suite runs in parallel workers beside tests
# that time the wall clock.
torch.set_num_threads(1)

ARCHS = ("mamba2-780m", "zamba2-2.7b")
F32 = dict(rtol=1e-4, atol=1e-4)
BF16_LEAF = dict(rtol=2.0 ** -7, atol=1e-5)
_MODELS = {}


def models(arch, **kw):
    """(jcfg, jparams, tcfg, tparams) of reduced ``arch``, float32."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        kw = {"compute_dtype": "float32", **kw}
        jcfg = jax_config(arch).reduced().with_(**kw)
        tcfg = torch_config(arch).reduced().with_(**kw)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jparams = jzoo.init_state(jcfg, jax.random.PRNGKey(0)).params
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
        _MODELS[key] = (jcfg, jparams, tcfg, tparams)
    return _MODELS[key]


def _layer0(jparams, tparams, cfg):
    if cfg.family == "ssm":
        return (jax.tree.map(lambda a: a[0], jparams["layers"]),
                tparams["layers"][0])
    return (jax.tree.map(lambda a: a[0, 0], jparams["mamba"]),
            tparams["mamba"][0][0])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(x):
    """A JAX array rounded to bf16 and back, as numpy."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


# ----------------------------------------------------------------- block
def test_param_dtypes_follow_the_reference():
    """A_log and dt_bias stay float32 in a bf16 model (the reference
    upcasts them at use); D and the conv weights take the compute dtype,
    as the reference's per-use cast does."""
    cfg = torch_config("mamba2-780m").reduced()
    for params in (tzoo.init_serving_params(cfg, device="cpu"),
                   models("mamba2-780m", compute_dtype="bfloat16")[3]):
        lp = params["layers"][0]
        assert lp["A_log"].dtype == lp["dt_bias"].dtype == torch.float32
        assert lp["norm"].dtype == lp["ssm_norm"].dtype == torch.float32
        for key in ("in_proj", "conv_w", "conv_b", "D", "out_proj"):
            assert lp[key].dtype == torch.bfloat16, key


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_block_prefill_matches_jax(arch):
    jcfg, jparams, tcfg, tparams = models(arch)
    jlp, tlp = _layer0(jparams, tparams, tcfg)
    x = np.random.default_rng(0).standard_normal((2, 32, 64)).astype(
        np.float32)
    jout, (jst, jconv) = jm.mamba2_block(jlp, jnp.asarray(x), jcfg)
    tout, (tst, tconv) = tm.mamba2_block(tlp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(tout), _np(jout), **F32)
    np.testing.assert_allclose(_np(tst), _np(jst), **F32)
    np.testing.assert_allclose(_np(tconv), _np(jconv), **F32)
    # state-continued: the second half from the first half's states
    _, (jst1, jconv1) = jm.mamba2_block(jlp, jnp.asarray(x[:, :16]), jcfg)
    jout2, (jst2, jconv2) = jm.mamba2_block(
        jlp, jnp.asarray(x[:, 16:]), jcfg, init_ssm=jst1, init_conv=jconv1)
    _, (tst1, tconv1) = tm.mamba2_block(tlp, torch.from_numpy(x[:, :16]),
                                        tcfg)
    tout2, (tst2, tconv2) = tm.mamba2_block(
        tlp, torch.from_numpy(x[:, 16:]), tcfg, init_ssm=tst1,
        init_conv=tconv1)
    np.testing.assert_allclose(_np(tout2), _np(jout2), **F32)
    np.testing.assert_allclose(_np(tst2), _np(jst2), **F32)
    np.testing.assert_allclose(_np(tconv2), _np(jconv2), **F32)
    # ... which is the whole sequence
    np.testing.assert_allclose(_np(tout2), _np(tout)[:, 16:], **F32)
    np.testing.assert_allclose(_np(tst2), _np(tst), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_block_decode_matches_jax(arch):
    """One decode token with states drawn at random and lane 1 inactive:
    the inactive lane keeps its states exactly."""
    jcfg, jparams, tcfg, tparams = models(arch)
    jlp, tlp = _layer0(jparams, tparams, tcfg)
    _, h, conv_dim, _ = tm.mamba2_dims(tcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    ssm = rng.standard_normal((3, h, tcfg.ssm_head_dim,
                               tcfg.ssm_state)).astype(np.float32)
    conv = _bf16(rng.standard_normal((3, tcfg.conv_width - 1, conv_dim)))
    active = np.array([True, False, True])
    jout, (jst, jconv) = jm.mamba2_block(
        jlp, jnp.asarray(x), jcfg, ssm_state=jnp.asarray(ssm),
        conv_state=jnp.asarray(conv).astype(jnp.bfloat16),
        active=jnp.asarray(active))
    tconv0 = torch.from_numpy(conv).bfloat16()
    tout, (tst, tconv) = tm.mamba2_block(
        tlp, torch.from_numpy(x), tcfg, ssm_state=torch.from_numpy(ssm),
        conv_state=tconv0, active=torch.from_numpy(active))
    np.testing.assert_allclose(_np(tout), _np(jout), **F32)
    np.testing.assert_allclose(_np(tst), _np(jst), **F32)
    np.testing.assert_allclose(_np(tconv), _np(jconv), **F32)
    assert np.array_equal(_np(tst)[1], ssm[1])
    assert np.array_equal(_np(tconv)[1], conv[1])


# ----------------------------------------------------------------- model
def _compare_cache(tcache, jcache, nb=None):
    assert set(tcache) == set(jcache)
    for key, jleaf in jcache.items():
        tleaf = tcache[key]
        if key in ("k", "v") and nb is not None:
            tleaf = tleaf[:, :nb]
        assert tuple(tleaf.shape) == tuple(jleaf.shape), key
        if key == "ssm" or key == "conv" and jleaf.dtype == jnp.float32:
            assert tleaf.dtype == torch.float32
            np.testing.assert_allclose(_np(tleaf), _np(jleaf), **F32)
        elif key == "conv":  # a prefill's tail, rounded to bf16 both sides
            assert tleaf.dtype == torch.float32
            np.testing.assert_allclose(_np(tleaf), _bf16(jleaf),
                                       **BF16_LEAF)
        else:          # bf16 leaves: k, v
            assert tleaf.dtype == torch.bfloat16, key
            np.testing.assert_allclose(_np(tleaf), _bf16(jleaf),
                                       **BF16_LEAF)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_prefill_matches_jax_f32(arch):
    jcfg, jparams, tcfg, tparams = models(arch)
    B, S = 2, 32                       # two SSD chunks of 16
    toks = np.random.default_rng(3).integers(0, 250, (B, S)).astype(np.int32)
    jlogits, jstate = jzoo.make_prefill(jcfg, JShape("p", S, B, "prefill"))(
        jparams, {"tokens": jnp.asarray(toks)})
    tlogits, tstate = tzoo.make_prefill(tcfg, TShape("p", S, B, "prefill"))(
        tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32)
    _compare_cache(tstate.cache, jstate.cache)
    assert tstate.cache_len.tolist() == np.asarray(jstate.cache_len).tolist()


def _random_state(cfg, B, S, paged, nb=None, bs=None, seed=5):
    """The same random decode state for both packages (numpy), with
    cache lengths per lane and, paged, permuted block tables."""
    rng = np.random.default_rng(seed)
    ab = (jzoo.abstract_paged_decode_state(cfg, JShape("s", S, B, "decode"),
                                           bs, nb) if paged else
          jzoo.abstract_decode_state(cfg, JShape("s", S, B, "decode")))
    cache = {}
    for key, sds in ab.cache.items():
        a = rng.standard_normal(sds.shape).astype(np.float32)
        cache[key] = a if key == "ssm" else _bf16(a)
    clen = rng.integers(1, S - 1, B).astype(np.int32)
    tables = None
    if paged:
        tables = rng.permutation(nb)[:B * (S // bs)].reshape(
            B, S // bs).astype(np.int32)
    return cache, clen, tables


def _jax_state(cache, clen, tables):
    jc = {k: jnp.asarray(v) if k == "ssm"
          else jnp.asarray(v).astype(jnp.bfloat16) for k, v in cache.items()}
    if tables is None:
        return jzoo.DecodeState(jc, jnp.asarray(clen))
    return jzoo.PagedDecodeState(jc, jnp.asarray(clen), jnp.asarray(tables))


def _torch_state(cfg, shape, cache, clen, tables, nb=None, bs=None):
    if tables is None:
        state = tzoo.init_decode_state(cfg, shape, device="cpu")
    else:
        state = tzoo.init_paged_decode_state(cfg, shape, bs, nb, "cpu")
        state.block_tables.copy_(torch.from_numpy(tables))
    for key, a in cache.items():
        leaf = state.cache[key]
        if key in ("k", "v") and tables is not None:
            leaf = leaf[:, :nb]
        leaf.copy_(torch.from_numpy(a))
    state.cache_len.copy_(torch.from_numpy(clen))
    return state


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_jax_f32(arch, paged):
    jcfg, jparams, tcfg, tparams = models(arch)
    B, S, bs, nb = 3, 32, 8, 16
    cache, clen, tables = _random_state(jcfg, B, S, paged, nb, bs)
    toks = np.array([[7], [100], [31]], np.int32)
    active = np.array([1, 0, 1], np.int32)
    jshape, tshape = JShape("s", S, B, "decode"), TShape("s", S, B, "decode")
    if paged:
        jstep = jzoo.make_paged_serve_step(jcfg, jshape, bs, nb)
        tstep = tzoo.make_paged_serve_step(tcfg, tshape, bs, nb)
    else:
        jstep = jzoo.make_serve_step(jcfg, jshape)
        tstep = tzoo.make_serve_step(tcfg, tshape)
    jlogits, jstate = jstep(jparams, _jax_state(cache, clen, tables),
                            {"tokens": jnp.asarray(toks),
                             "active": jnp.asarray(active)})
    tstate = _torch_state(tcfg, tshape, cache, clen, tables, nb, bs)
    tlogits, tstate = tstep(tparams, tstate, torch.from_numpy(toks),
                            torch.from_numpy(active))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32)
    _compare_cache(tstate.cache, jstate.cache, nb if paged else None)
    assert tstate.cache_len.tolist() == np.asarray(jstate.cache_len).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_two_chunk_paged_bulk_prefill_matches_jax_f32(arch):
    """Chunk 1 at off 0 (``first_chunk``), chunk 2 at off 16 continuing
    slot 1's carried states, over a random state whose other lanes and
    blocks must come out as JAX leaves them."""
    jcfg, jparams, tcfg, tparams = models(arch)
    B, S, bs, nb = 3, 48, 8, 18
    cache, clen, tables = _random_state(jcfg, B, S, True, nb, bs, seed=9)
    toks = np.random.default_rng(4).integers(0, 250, (2, 16)).astype(
        np.int32)
    jshape, tshape = JShape("s", S, B, "decode"), TShape("s", S, B, "decode")
    jstate = _jax_state(cache, clen, tables)
    tstate = _torch_state(tcfg, tshape, cache, clen, tables, nb, bs)
    for i, (off, first) in enumerate(((0, True), (16, False))):
        jfn = jzoo.make_paged_bulk_prefill(jcfg, jshape, 16, bs, nb,
                                           first_chunk=first)
        tfn = tzoo.make_paged_bulk_prefill(tcfg, tshape, 16, bs, nb,
                                           first_chunk=first)
        jstate = jfn(jparams, jstate, jnp.asarray(toks[i:i + 1]), 1, off, 16)
        tstate = tfn(tparams, tstate, torch.from_numpy(toks[i:i + 1]), 1,
                     off, 16)
        _compare_cache(tstate.cache, jstate.cache, nb)
        assert tstate.cache_len.tolist() == \
            np.asarray(jstate.cache_len).tolist()


# ------------------------------------------------------------ chained steps
CHAIN_BOUND = {"mamba2-780m": 1e-5, "zamba2-2.7b": 5e-4}


def _rel(got, want):
    """max |got - want| over the largest |want|."""
    want = _np(want)
    return float(np.abs(_np(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chained_serve_steps_match_jax_f32(arch, paged):
    """Ten serve steps chained in float32, from an empty dense state or
    (paged) after an 8-token bulk prefill into each lane: every step's
    logits and the final ``ssm`` and ``conv`` leaves within
    ``CHAIN_BOUND`` of the reference's chain, each relative to its
    largest element.  The port's conv leaf carries float32 between steps,
    as the reference's float32 step does."""
    jcfg, jparams, tcfg, tparams = models(arch)
    B, S, bs, nb, P, steps = 2, 32, 8, 8, 8, 10
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, 250, (B, P)).astype(np.int32)
    toks = rng.integers(0, 250, (steps, B, 1)).astype(np.int32)
    jshape, tshape = JShape("s", S, B, "decode"), TShape("s", S, B, "decode")
    if paged:
        jstate = jzoo.init_paged_decode_state(jcfg, jshape, bs, nb)
        tstate = tzoo.init_paged_decode_state(tcfg, tshape, bs, nb, "cpu")
        tables = np.arange(nb, dtype=np.int32).reshape(B, S // bs)
        jstate = jzoo.PagedDecodeState(jstate.cache, jstate.cache_len,
                                       jnp.asarray(tables))
        tstate.block_tables.copy_(torch.from_numpy(tables))
        jpre = jzoo.make_paged_bulk_prefill(jcfg, jshape, P, bs, nb,
                                            first_chunk=True)
        tpre = tzoo.make_paged_bulk_prefill(tcfg, tshape, P, bs, nb,
                                            first_chunk=True)
        for b in range(B):
            jstate = jpre(jparams, jstate, jnp.asarray(prompts[b:b + 1]), b,
                          0, P)
            tstate = tpre(tparams, tstate, torch.from_numpy(
                prompts[b:b + 1]), b, 0, P)
        jstep = jax.jit(jzoo.make_paged_serve_step(jcfg, jshape, bs, nb))
        tstep = tzoo.make_paged_serve_step(tcfg, tshape, bs, nb)
    else:
        jstate = jzoo.init_decode_state(jcfg, jshape, fill_len=0)
        tstate = tzoo.init_decode_state(tcfg, tshape, fill_len=0,
                                        device="cpu")
        jstep = jax.jit(jzoo.make_serve_step(jcfg, jshape))
        tstep = tzoo.make_serve_step(tcfg, tshape)
    assert tstate.cache["conv"].dtype == torch.float32
    active = np.ones(B, np.int32)
    worst = 0.0
    for t in toks:
        jlogits, jstate = jstep(jparams, jstate,
                                {"tokens": jnp.asarray(t),
                                 "active": jnp.asarray(active)})
        tlogits, tstate = tstep(tparams, tstate, torch.from_numpy(t),
                                torch.from_numpy(active))
        worst = max(worst, _rel(tlogits, jlogits))
    assert jstate.cache["conv"].dtype == jnp.float32
    bound = CHAIN_BOUND[arch]
    assert worst < bound, (arch, worst)
    for key in ("ssm", "conv"):
        assert _rel(tstate.cache[key], jstate.cache[key]) < bound, key
    assert tstate.cache_len.tolist() == np.asarray(jstate.cache_len).tolist()
