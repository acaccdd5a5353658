"""The moe family served by the port, held against the JAX engine.

Reduced ``qwen2-moe-a2.7b`` (8 experts, top-2, one shared expert) and
``qwen3-moe-30b-a3b`` (8 experts, top-2, no shared expert); the JAX
parameters are carried across with ``params_from_numpy``.  In float32:
prefill logits and one dense and one paged serve step agree to 1e-5, and
the dense and paged engines, each with chunked and with streamed
prefill, emit the reference engine's greedy streams with equal sync,
chunk-prefill, peak-slot and processed-token counters.  In bf16 the
first decode step's logits agree within a stated tolerance.  A steady
window makes no host sync, and the router stays float32.

At these geometries no token is dropped: a prefill chunk of 16 or 64
tokens routes in 16 groups of 1 or 4 tokens and a decode step of 3
lanes in one group of 3, each with capacity 8 (``expert_capacity``'s
floor), so no lane's output depends on another's (ROADMAP §3).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtransformer
from repro.models.schema import init_params as jinit_params
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config as torch_config
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as moe_lib
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from test_torch_engine import (ENGINE, PAGED, MAX_NEW, PROMPTS,
                               _first_divergence, _first_step_logits_jax,
                               _first_step_logits_torch, _prompts, _serve)

torch.set_num_threads(1)

ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b")


def _models(arch, **kw):
    jcfg = jax_config(arch).reduced().with_(**kw)
    tcfg = torch_config(arch).reduced().with_(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    schema = jtransformer.model_schema(jcfg)
    jparams = jax.jit(lambda key: jinit_params(schema, key,
                                               jcfg.param_dtype))(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def f32_models():
    return {arch: _models(arch, compute_dtype="float32") for arch in ARCHS}


def test_no_drops_at_these_geometries():
    cfg = torch_config(ARCHS[0]).reduced()
    for tokens, groups in ((16, 16), (64, 16), (3, 1)):
        tg = tokens // groups
        assert moe_lib.expert_capacity(cfg, tg) >= tg


@pytest.mark.parametrize("arch", ARCHS)
def test_router_float32_after_convert_and_init(f32_models, arch):
    _, _, _, carried = f32_models[arch]
    cfg = torch_config(arch).reduced()                    # bf16 compute
    drawn = tzoo.init_serving_params(cfg, seed=0, device="cpu")
    for params in (carried, drawn):
        for lp in params["layers"]:
            assert lp["moe"]["router"].dtype == torch.float32
            assert lp["moe"]["norm"].dtype == torch.float32
    assert drawn["layers"][0]["moe"]["we_gate"].dtype == torch.bfloat16
    assert "mlp" not in drawn["layers"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_counts_routed_top_k(arch):
    cfg = torch_config(arch)
    per_expert = 3 * cfg.d_model * cfg.d_ff
    assert tzoo.num_params(cfg) - tzoo.active_params(cfg) == (
        cfg.num_layers * (cfg.num_experts - cfg.top_k) * per_expert)
    assert tzoo.active_params(cfg) == jzoo.active_params(jax_config(arch))
    assert tzoo.num_params(cfg) == jzoo.num_params(jax_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_make_prefill_matches_jax_f32(f32_models, arch):
    """Whole-prompt prefill: last-position logits to 1e-5 and the bf16
    KV cache to one bf16 ulp."""
    from repro.configs.base import ShapeConfig as JShape
    from repro_torch.configs.base import ShapeConfig as TShape
    jcfg, jparams, tcfg, tparams = f32_models[arch]
    B, S = 2, 16
    toks = np.random.default_rng(3).integers(0, 250, (B, S)).astype(np.int32)
    jlogits, jstate = jzoo.make_prefill(jcfg, JShape("serve", S, B, "decode"))(
        jparams, {"tokens": jax.numpy.asarray(toks)})
    tlogits, tstate = tzoo.make_prefill(tcfg, TShape("serve", S, B, "decode"))(
        tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tstate.cache[key].float().numpy(),
            np.asarray(jstate.cache[key].astype(np.float32)),
            rtol=2.0 ** -7, atol=1e-5)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_first_decode_logits_match_jax_f32(f32_models, arch, paged):
    """Three prompts chunk-prefilled, then one dense or paged serve
    step: logits to 1e-5."""
    jcfg, jparams, tcfg, tparams = f32_models[arch]
    prompts = [p[:n] for p, n in zip(_prompts(seed=5)[:3], (5, 12, 16))]
    ref = _first_step_logits_jax(jcfg, jparams, prompts, paged)
    out = _first_step_logits_torch(tcfg, tparams, prompts, paged)
    V = tcfg.vocab_size
    np.testing.assert_allclose(out[..., :V], ref[..., :V], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("prefill", ["chunked", "streamed"])
@pytest.mark.parametrize("mode", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_jax_engine_f32(f32_models, arch, mode,
                                             prefill):
    """Prompts within the 16 and 64 buckets and past the largest (two
    and three paged chunks), a pool smaller than lanes x max_seq."""
    jcfg, jparams, tcfg, tparams = f32_models[arch]
    kw = dict(ENGINE, prefill_mode=prefill,
              **(PAGED if mode == "paged" else {}))
    jstreams, jcount = _serve(JEngine(jcfg, jparams, **kw), JRequest)
    tstreams, tcount = _serve(TEngine(tcfg, tparams, device="cpu", **kw),
                              TRequest)
    assert tstreams == jstreams, _first_divergence(tstreams, jstreams)
    assert tcount == jcount
    if prefill == "chunked" and mode == "paged":
        assert tcount["chunk_prefills"] > len(PROMPTS)   # multi-chunk ran
    if prefill == "streamed":
        assert tcount["chunk_prefills"] == 0


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_first_decode_logits_bf16(arch, paged):
    """Default bf16 compute.  bf16 rounds in other places in the two
    frameworks (``silu`` in the experts, the expert matmuls), so an
    expert output may differ by a bf16 ulp, and that compounds over the
    layers.  Held to 8 bf16 ulps (8 * 2^-8) of the largest logit,
    absolute, and to the same greedy token."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    prompts = [p[:n] for p, n in zip(_prompts(seed=5)[:3], (5, 12, 16))]
    V = tcfg.vocab_size
    ref = _first_step_logits_jax(jcfg, jparams, prompts, paged)[..., :V]
    out = _first_step_logits_torch(tcfg, tparams, prompts, paged)[..., :V]
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=8 * 2.0 ** -8 * np.abs(ref).max())
    assert (out.argmax(-1) == ref.argmax(-1)).all()


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_steady_window_makes_no_host_sync(mode):
    """bf16 qwen2-moe, 3 lanes decoding: an 8-step window after the
    admission makes no host sync, and a second run of the same requests
    gives the same streams."""
    cfg = torch_config(ARCHS[0]).reduced()
    params = tzoo.init_serving_params(cfg, seed=0, device="cpu")
    streams = []
    for _ in range(2):
        eng = TEngine(cfg, params, device="cpu", decode_block=8,
                      **ENGINE, **(PAGED if mode == "paged" else {}))
        reqs = [TRequest(rid=i, prompt=p[:12].copy(), max_new_tokens=24)
                for i, p in enumerate(_prompts()[:3])]
        for r in reqs:
            eng.submit(r)
        eng.step_many(8)                         # admit + first window
        syncs = eng.host_syncs
        assert eng.step_many(8)["steps"] == 8
        assert eng.host_syncs == syncs
        eng.run_until_idle()
        streams.append([list(r.out_tokens) for r in reqs])
        assert all(len(s) == 24 for s in streams[-1])
    assert streams[0] == streams[1]
