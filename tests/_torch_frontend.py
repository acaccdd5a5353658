"""What the enc_dec and vlm tests share: the reduced model in both
packages, its batches, the dense engines, units across packages.

``seamless-m4t-medium`` (enc_dec) takes ``frames`` (B, S, d) into its
encoder; ``internvl2-26b`` (vlm) takes ``patch_embeds`` (B, frontend_seq,
d) in front of its tokens.  Both frontends are the reference's stubs, so
the tests draw those arrays from a numpy seed.  The JAX parameters cross
through ``params_from_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShape
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtransformer
from repro.models.schema import init_params as jinit_params
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config as torch_config
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

ENC_DEC, VLM = "seamless-m4t-medium", "internvl2-26b"
# one bf16 ulp of each |x| (2^-7 relative; atol for values near zero)
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-5)
F32 = dict(rtol=1e-5, atol=1e-5)
# the dense engine: 8 requests through 4 lanes, every prompt token a
# decode step (neither family has a bulk prefill)
ENGINE = dict(batch_size=4, max_seq=64, decode_block=4)
PROMPTS = (5, 20, 11, 3, 17, 8, 30, 12)
MAX_NEW = (6, 4, 5, 7, 3, 8, 4, 6)

_MODELS = {}


def configs(arch, **kw):
    jcfg = jax_config(arch).reduced().with_(**kw)
    tcfg = torch_config(arch).reduced().with_(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def models(arch, **kw):
    """(jcfg, jparams, tcfg, tparams) of reduced ``arch``: JAX's params,
    and the same carried to the port on the CPU."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg, tcfg = configs(arch, **kw)
        # one jitted draw: JAX's eager per-leaf init takes seconds
        schema = jtransformer.model_schema(jcfg)
        jparams = jax.jit(lambda key: jinit_params(
            schema, key, jcfg.param_dtype))(jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
        _MODELS[key] = jcfg, jparams, tcfg, tparams
    return _MODELS[key]


def prefill_batch(cfg, B, S, seed=3):
    """A prefill batch of ``S`` positions as numpy float32 / int32: tokens
    and ``frames`` (enc_dec), or ``S - frontend_seq`` tokens after
    ``patch_embeds`` (vlm)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        st = S - cfg.frontend_seq
        return {"tokens": rng.integers(0, 250, (B, st)).astype(np.int32),
                "patch_embeds": rng.standard_normal(
                    (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, 250, (B, S)).astype(np.int32),
            "frames": rng.standard_normal((B, S, cfg.d_model)).astype(
                np.float32)}


def both(batch):
    """A numpy batch as (jnp arrays, torch tensors)."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def column_bits(col) -> np.ndarray:
    """A cache column of either package as comparable numpy: bf16 (a torch
    tensor or ``ml_dtypes``) as its int16 bits, anything else as it is."""
    if isinstance(col, torch.Tensor):
        return (col.view(torch.int16) if col.dtype == torch.bfloat16
                else col).numpy()
    col = np.asarray(col)
    return col.view(np.int16) if col.dtype == ml_dtypes.bfloat16 else col


def schema_shapes(schema, prefix=""):
    """``{"/path/to/leaf": shape}`` of either package's schema."""
    if hasattr(schema, "shape"):
        return {prefix: tuple(schema.shape)}
    out = {}
    for k in sorted(schema):
        out.update(schema_shapes(schema[k], f"{prefix}/{k}"))
    return out


def prefills(jcfg, jparams, tcfg, tparams, B, S):
    """Both packages' ``make_prefill`` of one ``prefill_batch``."""
    jb, tb = both(prefill_batch(tcfg, B, S))
    jout = jzoo.make_prefill(jcfg, JShape("p", S, B, "prefill"))(jparams, jb)
    tout = tzoo.make_prefill(tcfg, TShape("p", S, B, "prefill"))(tparams, tb)
    return jout, tout


def assert_prefill_close(jout, tout, keys):
    """Float32 last-position logits within 1e-5; every bf16 cache leaf
    (``keys``) of the reference's shape and within one bf16 ulp; the same
    ``cache_len``."""
    (jlogits, jstate), (tlogits, tstate) = jout, tout
    np.testing.assert_allclose(f32(tlogits), f32(jlogits), **F32)
    assert set(tstate.cache) == set(jstate.cache) == set(keys)
    for key, jleaf in jstate.cache.items():
        tleaf = tstate.cache[key]
        assert tleaf.dtype == torch.bfloat16
        assert tuple(tleaf.shape) == tuple(jleaf.shape), key
        np.testing.assert_allclose(f32(tleaf), f32(jleaf), **BF16_ULP)
    assert tstate.cache_len.tolist() == np.asarray(jstate.cache_len).tolist()


def serve_steps_agree(arch, P, S=32, B=2, steps=4):
    """A ``P``-position prefill written into an ``S``-position decode state
    (the same bf16 bits in both packages), then ``steps`` serve steps:
    float32 logits within 1e-5 at each step, the caches within one bf16
    ulp after them."""
    jcfg, jparams, tcfg, tparams = models(arch, compute_dtype="float32")
    _, (_, pre) = prefills(jcfg, jparams, tcfg, tparams, B=B, S=P)
    tstate = tzoo.init_decode_state(tcfg, TShape("s", S, B, "decode"),
                                    fill_len=P, device="cpu")
    for key, leaf in tstate.cache.items():
        leaf[:, :, :P] = pre.cache[key]
    jstate = jzoo.init_decode_state(jcfg, JShape("s", S, B, "decode"),
                                    fill_len=P)
    jstate = jstate._replace(cache={
        k: jnp.asarray(column_bits(v).view(ml_dtypes.bfloat16))
        for k, v in tstate.cache.items()})
    jstep = jax.jit(jzoo.make_serve_step(jcfg, JShape("s", S, B, "decode")))
    tstep = tzoo.make_serve_step(tcfg, TShape("s", S, B, "decode"))
    rng = np.random.default_rng(7)
    for _ in range(steps):
        tok = rng.integers(0, 250, (B, 1)).astype(np.int32)
        jlogits, jstate = jstep(jparams, jstate, {"tokens": jnp.asarray(tok)})
        tlogits, tstate = tstep(tparams, tstate, torch.from_numpy(tok))
        np.testing.assert_allclose(f32(tlogits), f32(jlogits), **F32)
    for key, leaf in tstate.cache.items():
        np.testing.assert_allclose(f32(leaf), f32(jstate.cache[key]),
                                   **BF16_ULP)
    assert tstate.cache_len.tolist() == [P + steps] * B


def assert_bf16_logits_close(out, ref, vocab):
    """The port's bf16 logit tolerance: 8 bf16 ulps (8 * 2^-8) of the
    largest logit, absolute, and the same greedy token wherever the
    reference's top-2 gap exceeds twice that (a difference within the
    tolerance cannot flip the token there; random logits have near ties,
    down to exact bf16 ties).  JAX's bf16 ``silu`` rounds after each op
    and torch's once, so an MLP output may differ by one ulp, and that
    compounds over the layers."""
    out, ref = out[..., :vocab], ref[..., :vocab]
    atol = 8 * 2.0 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * atol
    assert clear.any()
    assert (out.argmax(-1) == ref.argmax(-1))[clear].all()


def serve(engine, request_cls, seed=11):
    """8 requests through ``engine``: (streams by rid, counters)."""
    rng = np.random.default_rng(seed)
    reqs = [request_cls(rid=i, prompt=rng.integers(1, 250, n).astype(
        np.int32), max_new_tokens=m)
        for i, (n, m) in enumerate(zip(PROMPTS, MAX_NEW))]
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    assert all(r.done for r in reqs)
    assert [len(r.out_tokens) for r in reqs] == list(MAX_NEW)
    counters = {"host_syncs": engine.host_syncs,
                "chunk_prefills": engine.chunk_prefills,
                "peak_slots": engine._peak_slots,
                "processed": engine.processed_tokens}
    return {r.rid: list(r.out_tokens) for r in reqs}, counters


def engines_agree(arch):
    """The float32 dense engines of both packages give the same streams
    and counters; neither runs a chunk prefill."""
    jcfg, jparams, tcfg, tparams = models(arch, compute_dtype="float32")
    jstreams, jcount = serve(JEngine(jcfg, jparams, cache_mode="dense",
                                     **ENGINE), JRequest)
    tstreams, tcount = serve(TEngine(tcfg, tparams, cache_mode="dense",
                                     device="cpu", **ENGINE), TRequest)
    assert tstreams == jstreams
    assert tcount == jcount
    assert tcount["chunk_prefills"] == 0


def packed_mid_decode(engine, request_cls):
    rng = np.random.default_rng(23)
    reqs = [request_cls(rid=i, prompt=rng.integers(1, 250, n)
                        .astype(np.int32), max_new_tokens=8)
            for i, n in enumerate((3, 4, 6))]
    for r in reqs:
        engine.submit(r)
    engine.step_many(2)
    return engine.pack()


def jax_columns(cols):
    """The port's columns as the JAX engine reads them: numpy, bf16 as
    ``ml_dtypes.bfloat16``."""
    return {k: (column_bits(t).view(ml_dtypes.bfloat16)
                if t.dtype == torch.bfloat16 else t.numpy())
            for k, t in cols.items()}


def units_cross(arch, direction):
    """Units packed mid-decode by one package unpack into the other's
    dense engine and pack back with every column bit for bit (k, v and,
    for enc_dec, the cross cache xk, xv), and the unpacked requests run
    to their token counts.  Every bf16 column is first filled with random
    values (an enc_dec lane's cross cache is zero in a served engine), so
    that a crossing that moved nothing could not pass."""
    jcfg, jparams, tcfg, tparams = models(arch, compute_dtype="float32")
    geometry = dict(batch_size=3, max_seq=32, cache_mode="dense")
    if direction == "port_to_jax":
        units = packed_mid_decode(
            TEngine(tcfg, tparams, device="cpu", **geometry), TRequest)
        for u in units:
            u.snapshot.cache = jax_columns(u.snapshot.cache)
        dst = JEngine(jcfg, jparams, **geometry)
    else:
        units = packed_mid_decode(JEngine(jcfg, jparams, **geometry),
                                  JRequest)
        dst = TEngine(tcfg, tparams, device="cpu", **geometry)
    rng = np.random.default_rng(5)
    for u in units:
        u.snapshot.cache = {
            k: (rng.standard_normal(v.shape).astype(ml_dtypes.bfloat16)
                if v.dtype == ml_dtypes.bfloat16 else v)
            for k, v in u.snapshot.cache.items()}
    want = {u.rid: {k: column_bits(v) for k, v in u.snapshot.cache.items()}
            for u in units}
    keys = {"k", "v", "xk", "xv"} if arch == ENC_DEC else {"k", "v"}
    assert set(units[0].snapshot.cache) == keys
    dst.unpack(units)
    dst._admit()
    back = dst.pack()
    assert sorted(u.rid for u in back) == sorted(want)
    for u in back:
        for k, col in u.snapshot.cache.items():
            assert np.array_equal(column_bits(col), want[u.rid][k]), (u.rid,
                                                                       k)
    dst.unpack(back)
    dst.run_until_idle()
    done = dst.pop_completed()
    assert len(done) == len(back)
    assert all(r.done and len(r.out_tokens) == 8 for r in done)
