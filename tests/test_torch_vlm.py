"""The vlm family (internvl2-26b) held against the reference.

Reduced internvl2-26b (2 layers, d_model 64, 4 heads over 2 kv heads, 8
patch positions) with the JAX parameters carried across: the schema and
parameter count, ``decoder_forward`` with ``patch_embeds`` in float32
(1e-5) and bf16 (the port's bf16 logit tolerance), ``make_prefill`` with
patch embeddings (logits 1e-5, k and v within one bf16 ulp), the blockwise
route at a GQA group of 2, serve steps, ``lm_loss`` on the text positions
only, the dense engine's float32 streams, the refused paged cache, work
units across packages, the synthetic data and the launcher.  Training
parity is in ``test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_frontend import (F32, VLM, assert_bf16_logits_close,
                             assert_prefill_close, both, configs,
                             engines_agree, f32, models, prefill_batch,
                             prefills, schema_shapes, serve_steps_agree,
                             units_cross)
from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JSHAPES
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model_zoo as jzoo
from repro.models import transformer as JT
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import ServingEngine as TEngine

torch.set_num_threads(1)

ARCH = VLM


def test_schema_matches_reference():
    jcfg, tcfg = configs(ARCH)
    got = schema_shapes(TT.model_schema(tcfg))
    assert got == schema_shapes(JT.model_schema(jcfg))
    assert "/lm_head" in got and "/layers/mlp/w_gate" in got


def test_num_params_of_the_full_config():
    full = ARCHS[ARCH]
    assert tzoo.num_params(full) == jzoo.num_params(jax_config(ARCH)) \
        == 19_862_722_560
    assert (full.num_layers, full.num_heads, full.num_kv_heads,
            full.head_dim, full.frontend_seq) == (48, 48, 8, 128, 256)


def _forward(jcfg, jparams, tcfg, tparams, S=20):
    jb, tb = both(prefill_batch(tcfg, 2, S))
    jh, _ = JT.decoder_forward(jparams, jb["tokens"], jcfg,
                               patch_embeds=jb["patch_embeds"])
    th, _ = TT.decoder_forward(tparams, tb["tokens"], tcfg,
                               patch_embeds=tb["patch_embeds"])
    assert th.shape == (2, S, tcfg.d_model)
    return (jh, JT.lm_logits(jparams, jh, jcfg), th,
            TT.lm_logits(tparams, th, tcfg))


def test_decoder_forward_with_patches_matches_reference_f32():
    jh, jl, th, tl = _forward(*models(ARCH, compute_dtype="float32"))
    np.testing.assert_allclose(f32(th), f32(jh), **F32)
    np.testing.assert_allclose(f32(tl), f32(jl), **F32)


def test_decoder_forward_with_patches_matches_reference_bf16():
    jcfg, jparams, tcfg, tparams = models(ARCH)
    _, jl, th, tl = _forward(jcfg, jparams, tcfg, tparams)
    assert th.dtype == torch.bfloat16
    assert_bf16_logits_close(f32(tl), f32(jl), tcfg.vocab_size)


def test_decoder_forward_needs_patches():
    _, tcfg = configs(ARCH)
    with pytest.raises(ValueError, match="patch_embeds"):
        TT.decoder_forward(tzoo.init_serving_params(tcfg, device="cpu"),
                           torch.zeros((1, 4), dtype=torch.int32), tcfg)


def test_make_prefill_with_patches_matches_reference_f32():
    """8 patch positions then 12 tokens: last-position logits within 1e-5,
    k and v (over all 20 positions) within one bf16 ulp, cache_len 20."""
    jout, tout = prefills(*models(ARCH, compute_dtype="float32"), B=2, S=20)
    assert_prefill_close(jout, tout, ("k", "v"))
    assert tout[1].cache["k"].shape == (2, 2, 20, 2, 16)
    assert tout[1].cache_len.tolist() == [20, 20]


BLOCKWISE = dict(compute_dtype="float32", attn_impl="blockwise",
                 flash_block_q=16, flash_block_kv=16)


@pytest.mark.parametrize("S", [32, 64])
def test_blockwise_route_matches_reference_f32(S, monkeypatch):
    """``attn_impl="blockwise"`` at blocks of 16: the reference's jnp
    ``blockwise_attention`` against ``flash_attention_ref``, causal over
    patches and tokens, 4 heads over 2 kv heads (a GQA group of 2)."""
    seen = []
    blockwise = TL.blockwise_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], q.shape[2] // k.shape[2], kw["causal"]))
        return blockwise(q, k, v, **kw)

    monkeypatch.setattr(TL, "blockwise_attention", spy)
    jout, tout = prefills(*models(ARCH, **BLOCKWISE), B=2, S=S)
    assert seen == [(S, 2, True)] * 2
    assert_prefill_close(jout, tout, ("k", "v"))


def test_serve_steps_after_a_patch_prefill_f32():
    """A 20-position prefill (8 patches, 12 tokens) written into a
    32-position decode state, then 4 serve steps: float32 logits within
    1e-5 at each step."""
    serve_steps_agree(ARCH, P=20)


def test_lm_loss_on_text_positions_matches_reference_f32():
    jcfg, tcfg = configs(ARCH, compute_dtype="float32")
    shape = SHAPES["train_4k"].reduced()
    state = tzoo.init_state(tcfg, 0, device="cpu")
    host = SyntheticLM(tcfg, shape, seed=1).batch_at(0)
    assert host["labels"].shape == (shape.global_batch,
                                    shape.seq_len - tcfg.frontend_seq)
    jbatch = JSyntheticLM(jcfg, JSHAPES["train_4k"].reduced(),
                          seed=1).batch_at(0)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state.params)
    jloss, _ = jzoo.lm_loss(jparams, jax.tree.map(jnp.asarray, jbatch), jcfg)
    tloss, _ = tzoo.lm_loss(state.params,
                            {k: torch.as_tensor(v) for k, v in host.items()},
                            tcfg)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)


def test_dense_engine_streams_match_reference_f32():
    """8 requests through 4 lanes, text only (no patches), every prompt
    token a decode step: streams and counters equal the reference's."""
    engines_agree(ARCH)


def test_paged_cache_raises_as_the_reference_does():
    jcfg, jparams, tcfg, tparams = models(ARCH)
    from repro.serving.engine import ServingEngine as JEngine
    with pytest.raises(ValueError, match="paged cache unsupported for vlm"):
        JEngine(jcfg, jparams, batch_size=2, max_seq=32, cache_mode="paged")
    with pytest.raises(ValueError, match="paged cache unsupported for vlm"):
        TEngine(tcfg, tparams, batch_size=2, max_seq=32, cache_mode="paged",
                device="cpu")
    with pytest.raises(ValueError):
        tzoo.make_paged_serve_step(tcfg, TShape("s", 32, 2, "decode"), 8, 8)
    with pytest.raises(ValueError):
        tzoo.make_bulk_prefill(tcfg, TShape("s", 32, 2, "decode"), 16)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_work_units_cross_packages_bitwise(direction):
    units_cross(ARCH, direction)


def test_synthetic_lm_patches_equal_reference_bit_for_bit():
    shape, jshape = SHAPES["train_4k"].reduced(), JSHAPES["train_4k"].reduced()
    ours = SyntheticLM(ARCHS[ARCH].reduced(), shape, seed=5)
    ref = JSyntheticLM(jax_config(ARCH).reduced(), jshape, seed=5)
    for step in (0, 3):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "patch_embeds", "tokens"]
        assert a["patch_embeds"].dtype == torch.bfloat16
        assert np.array_equal(a["patch_embeds"].view(torch.int16).numpy(),
                              b["patch_embeds"].view(np.int16))
        for k in ("labels", "tokens"):
            assert np.array_equal(a[k], b[k])


def test_serve_launcher_dense_and_refused_paged(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                "--max-new", "3", "--cache-mode", "dense"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} cache=dense" in out and "served 3/3" in out, out
    with pytest.raises(ValueError, match="paged cache unsupported"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                    "--cache-mode", "paged"])


def test_train_launcher(capsys):
    from repro_torch.launch import train
    train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps",
                "2"])
    assert "done:" in capsys.readouterr().out
