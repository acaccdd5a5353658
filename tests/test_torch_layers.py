"""Each ported layer function held against its JAX counterpart.

Inputs are drawn with numpy from a seed and handed to both packages.
Float32 compute is held to rtol=atol=1e-5.  In bf16 both sides round to
bf16 after every op that returns bf16, but XLA may fuse an elementwise
chain and round once where torch rounds per op, so an output element may
differ by one or two bf16 ulps (2^-8 relative each): bf16 cases are held
to rtol=atol=2e-2 on values of magnitude ~1.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config as torch_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy

# One intra-op thread: the suite runs in parallel workers beside tests
# that time the wall clock.
torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype):
    jcfg = jax_config("granite-8b").reduced().with_(compute_dtype=dtype)
    tcfg = torch_config("granite-8b").reduced().with_(compute_dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _params(cfg, seed=0):
    """A numpy param tree for the reduced dense model (stacked layers)."""
    rng = np.random.default_rng(seed)
    H, KV, D, d, f = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.d_model, cfg.d_ff)
    n = cfg.num_layers

    def w(fan_in, *shape):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def norm(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return {
        "embed": (0.5 * rng.standard_normal(
            (cfg.padded_vocab, d))).astype(np.float32),
        "final_norm": norm(d),
        "lm_head": w(d, d, cfg.padded_vocab),
        "layers": {
            "attn": {"norm": norm(n, d), "wq": w(d, n, d, H, D),
                     "wk": w(d, n, d, KV, D), "wv": w(d, n, d, KV, D),
                     "wo": w(H * D, n, H, D, d)},
            "mlp": {"norm": norm(n, d), "w_gate": w(d, n, d, f),
                    "w_up": w(d, n, d, f), "w_down": w(f, n, f, d)},
        },
    }


def _layer(tree, i=0):
    return {k: {n: v[i] for n, v in sub.items()}
            for k, sub in tree["layers"].items()}


def _both(arr, dtype):
    jdt, tdt = DT[dtype]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(
        np.asarray(arr)).to(tdt)


def _close(t, j, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)), **tol)


def _jp(tree_np, sub):
    return {k: jnp.asarray(v) for k, v in _layer(tree_np)[sub].items()}


def _tp(tree_np, cfg, sub):
    return params_from_numpy(tree_np, cfg, device="cpu")["layers"][0][sub]


DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = _both(x, dtype)
    _close(TL.rms_norm(tx, torch.from_numpy(w), 1e-5),
           JL.rms_norm(jx, jnp.asarray(w), 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rotary(dtype):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 900, (3, 4)).astype(np.int32)
    jc, js = JL.rotary_embedding(jnp.asarray(pos), 16, 10_000.0)
    tc, ts = TL.rotary_embedding(torch.from_numpy(pos), 16, 10_000.0)
    # cos/sin of angles up to ~900 rad: float32 argument rounding of
    # pos * freq differs by an ulp of the angle (~6e-5 at 900)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-4)
    x = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    jx, tx = _both(x, dtype)
    cos, sin = np.asarray(jc), np.asarray(js)
    _close(TL.apply_rotary(tx, torch.from_numpy(cos), torch.from_numpy(sin)),
           JL.apply_rotary(jx, jnp.asarray(cos), jnp.asarray(sin)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,q_offset,kv_len", [
    (True, 0, None), (True, 3, None), (False, 0, (2, 9))])
def test_full_attention(dtype, causal, q_offset, kv_len):
    rng = np.random.default_rng(3)
    b, sq, sk = 2, (4 if q_offset else 9), 9
    q = rng.standard_normal((b, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((b, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((b, sk, 2, 16)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    jl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    _close(TL.full_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                             kv_len=tl),
           JL.full_attention(jq, jk, jv, causal=causal, q_offset=q_offset,
                             kv_len=jl), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_block_prefill(dtype):
    jcfg, tcfg = _cfgs(dtype)
    tree = _params(jcfg)
    x = np.random.default_rng(4).standard_normal((2, 7, 64)).astype(
        np.float32)
    jx, tx = _both(x, dtype)
    jout, (jk, jv) = JL.attention_block(_jp(tree, "attn"), jx, jcfg)
    tout, (tk, tv) = TL.attention_block(_tp(tree, tcfg, "attn"), tx, tcfg)
    for t, j in ((tout, jout), (tk, jk), (tv, jv)):
        _close(t, j, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_block(dtype):
    jcfg, tcfg = _cfgs(dtype)
    tree = _params(jcfg)
    x = np.random.default_rng(5).standard_normal((2, 3, 64)).astype(
        np.float32)
    jx, tx = _both(x, dtype)
    _close(TL.swiglu_block(_tp(tree, tcfg, "mlp"), tx, tcfg),
           JL.swiglu_block(_jp(tree, "mlp"), jx, jcfg), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_and_logits(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jcfg = jcfg.with_(vocab_size=250)          # padded vocab masked
    tcfg = tcfg.with_(vocab_size=250)
    tree = _params(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in tree.items() if k != "layers"}
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    toks = np.random.default_rng(6).integers(0, 250, (2, 5)).astype(
        np.int32)
    _close(TT.embed_tokens(tparams, torch.from_numpy(toks), tcfg),
           JT.embed_tokens(jparams, jnp.asarray(toks), jcfg), dtype)
    h = np.random.default_rng(7).standard_normal((2, 5, 64)).astype(
        np.float32)
    jh, th = _both(h, dtype)
    tl = TT.lm_logits(tparams, th, tcfg)
    jl = JT.lm_logits(jparams, jh, jcfg)
    assert tl.dtype == torch.float32
    assert (tl[..., 250:] == -1e30).all()
    _close(tl, jl, dtype)


# ------------------------------------------------------------ cached decode
def _cache(b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, 2, 16)).astype(np.float32)


def _bf16_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention(dtype):
    """Lanes: active mid-cache, inactive (old value kept), and a lane at
    cache_len == S_max (JAX clamps the read and drops the write)."""
    jcfg, tcfg = _cfgs(dtype)
    tree = _params(jcfg)
    b, S = 3, 12
    ck, cv = _bf16_np(_cache(b, S, 8)), _bf16_np(_cache(b, S, 9))
    x = np.random.default_rng(10).standard_normal((b, 1, 64)).astype(
        np.float32)
    clen = np.array([4, 7, S], np.int32)
    act = np.array([True, False, True])
    jx, tx = _both(x, dtype)
    jout, (jk, jv) = JL.decode_attention(
        _jp(tree, "attn"), jx, jcfg,
        cache_k=jnp.asarray(ck).astype(jnp.bfloat16),
        cache_v=jnp.asarray(cv).astype(jnp.bfloat16),
        cache_len=jnp.asarray(clen), active=jnp.asarray(act))
    tk = torch.from_numpy(ck).to(torch.bfloat16)
    tv = torch.from_numpy(cv).to(torch.bfloat16)
    tout, (tk, tv) = TL.decode_attention(
        _tp(tree, tcfg, "attn"), tx, tcfg, cache_k=tk, cache_v=tv,
        cache_len=torch.from_numpy(clen), active=torch.from_numpy(act))
    _close(tout, jout, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j.astype(jnp.float32)), **tol)


def _paged_setup(b, nb, bs, mb, seed):
    rng = np.random.default_rng(seed)
    pool_k = _bf16_np(rng.standard_normal((nb, bs, 2, 16)))
    pool_v = _bf16_np(rng.standard_normal((nb, bs, 2, 16)))
    bt = np.full((b, mb), nb, np.int32)            # sentinel everywhere...
    perm = rng.permutation(nb)
    return pool_k, pool_v, bt, perm


def _torch_pool(arr):
    """The port's pool: the live rows plus a zero sink row."""
    t = torch.from_numpy(arr).to(torch.bfloat16)
    return torch.cat([t, torch.zeros_like(t[:1])])


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_attention(dtype):
    """Lanes: active mid-block; inactive (write dropped); at a block
    boundary (cache_len % bs == 0, first write into a fresh block); at
    cache_len // bs == max_blocks - 1; a lane whose write column is a
    sentinel entry (dropped).  Pools compared on the live rows."""
    jcfg, tcfg = _cfgs(dtype)
    tree = _params(jcfg)
    b, nb, bs, mb = 5, 20, 4, 5
    pool_k, pool_v, bt, perm = _paged_setup(b, nb, bs, mb, 11)
    clen = np.array([6, 9, 8, 18, 10], np.int32)
    act = np.array([True, False, True, True, True])
    used = [2, 3, 3, 5, 2]     # lane 4: column 10 // 4 = 2 is a sentinel
    k = 0
    for i, n in enumerate(used):
        bt[i, :n] = perm[k:k + n]
        k += n
    x = np.random.default_rng(12).standard_normal((b, 1, 64)).astype(
        np.float32)
    jx, tx = _both(x, dtype)
    jout, (jk, jv) = JL.paged_decode_attention(
        _jp(tree, "attn"), jx, jcfg,
        pool_k=jnp.asarray(pool_k).astype(jnp.bfloat16),
        pool_v=jnp.asarray(pool_v).astype(jnp.bfloat16),
        block_tables=jnp.asarray(bt), cache_len=jnp.asarray(clen),
        active=jnp.asarray(act), impl="ref")
    tk, tv = _torch_pool(pool_k), _torch_pool(pool_v)
    tout, _ = TL.paged_decode_attention(
        _tp(tree, tcfg, "attn"), tx, tcfg, pool_k=tk, pool_v=tv,
        block_tables=torch.from_numpy(bt), cache_len=torch.from_numpy(clen),
        active=torch.from_numpy(act))
    _close(tout, jout, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(t[:nb].float().numpy(),
                                   np.asarray(j.astype(jnp.float32)), **tol)
    # untouched live rows are bit-identical (no write aliased into them)
    written = {int(bt[i, clen[i] // bs]) for i in range(b)
               if act[i] and bt[i, clen[i] // bs] < nb}
    for row in set(range(nb)) - written:
        assert torch.equal(tk[row].float(),
                           torch.from_numpy(pool_k[row]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("history,off,c,n_used", [
    (False, 0, 16, 2),     # pad bucket: chunk 16 over 2 reserved blocks
    (False, 0, 8, 2),
    (True, 8, 16, 5),      # history + chunk, sentinel tail
    (True, 13, 4, 5),      # mid-block start
])
def test_paged_chunk_attention(dtype, history, off, c, n_used):
    jcfg, tcfg = _cfgs(dtype)
    tree = _params(jcfg)
    nb, bs, mb = 12, 4, 6
    pool_k, pool_v, _, perm = _paged_setup(1, nb, bs, mb, 13)
    bt_row = np.full(mb, nb, np.int32)
    bt_row[:n_used] = perm[:n_used]
    x = np.random.default_rng(14).standard_normal((1, c, 64)).astype(
        np.float32)
    jx, tx = _both(x, dtype)
    jout, jk, jv = JL.paged_chunk_attention(
        _jp(tree, "attn"), jx, jcfg,
        pool_k=jnp.asarray(pool_k).astype(jnp.bfloat16),
        pool_v=jnp.asarray(pool_v).astype(jnp.bfloat16),
        bt_row=jnp.asarray(bt_row), off=off, history=history)
    tk, tv = _torch_pool(pool_k), _torch_pool(pool_v)
    tout, tk, tv = TL.paged_chunk_attention(
        _tp(tree, tcfg, "attn"), tx, tcfg, pool_k=tk, pool_v=tv,
        bt_row=torch.from_numpy(bt_row), off=off, history=history)
    _close(tout, jout, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(t[:nb].float().numpy(),
                                   np.asarray(j.astype(jnp.float32)), **tol)
