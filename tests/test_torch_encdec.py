"""The enc_dec family (seamless-m4t-medium) held against the reference.

Reduced seamless-m4t-medium (2 encoder + 2 decoder layers, d_model 64)
with the JAX parameters carried across: the schema and parameter count,
``encoder_forward`` / ``enc_dec_forward`` in float32 (1e-5) and bf16 (the
port's bf16 logit tolerance), ``make_prefill`` with frames (logits 1e-5,
the bf16 caches ``k``, ``v``, ``xk``, ``xv`` within one bf16 ulp), the
blockwise routes (encoder non-causal, decoder causal), serve steps over a
prefilled cross cache, ``lm_loss``, the dense engine's float32 streams,
the refused paged cache, work units across packages, the synthetic data
and both launchers.  Training parity is in ``test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_frontend import (ENC_DEC, F32, assert_bf16_logits_close,
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

ARCH = ENC_DEC


@pytest.mark.parametrize("tie", [False, True])
def test_schema_matches_reference(tie):
    """Leaf names and shapes; ``lm_head`` stays whatever
    ``tie_embeddings`` says."""
    jcfg, tcfg = configs(ARCH, tie_embeddings=tie)
    got = schema_shapes(TT.model_schema(tcfg))
    assert got == schema_shapes(JT.model_schema(jcfg))
    assert "/lm_head" in got and "/enc_layers/attn/wq" in got


def test_num_params_of_the_full_config():
    full = ARCHS[ARCH]
    assert tzoo.num_params(full) == jzoo.num_params(jax_config(ARCH)) \
        == 977_860_608
    assert (full.enc_layers, full.dec_layers, full.d_model,
            full.padded_vocab) == (12, 12, 1024, 256_256)


def test_encoder_forward_matches_reference_f32():
    jcfg, jparams, tcfg, tparams = models(ARCH, compute_dtype="float32")
    jb, tb = both(prefill_batch(tcfg, 2, 12))
    want = JT.encoder_forward(jparams, jb["frames"], jcfg)
    got = TT.encoder_forward(tparams, tb["frames"], tcfg)
    np.testing.assert_allclose(f32(got), f32(want), **F32)


def _forward(jcfg, jparams, tcfg, tparams, S=12):
    jb, tb = both(prefill_batch(tcfg, 2, S))
    jh = JT.enc_dec_forward(jparams, jb["frames"], jb["tokens"], jcfg)
    th = TT.enc_dec_forward(tparams, tb["frames"], tb["tokens"], tcfg)
    return (jh, JT.lm_logits(jparams, jh, jcfg), th,
            TT.lm_logits(tparams, th, tcfg))


def test_enc_dec_forward_matches_reference_f32():
    jh, jl, th, tl = _forward(*models(ARCH, compute_dtype="float32"))
    np.testing.assert_allclose(f32(th), f32(jh), **F32)
    np.testing.assert_allclose(f32(tl), f32(jl), **F32)


def test_enc_dec_forward_matches_reference_bf16():
    jcfg, jparams, tcfg, tparams = models(ARCH)
    _, jl, th, tl = _forward(jcfg, jparams, tcfg, tparams)
    assert th.dtype == torch.bfloat16
    assert_bf16_logits_close(f32(tl), f32(jl), tcfg.vocab_size)


def test_make_prefill_with_frames_matches_reference_f32():
    """Last-position logits within 1e-5; the bf16 caches (self attention's
    k, v and cross attention's xk, xv) within one bf16 ulp; cache_len is
    the shape's seq_len."""
    jout, tout = prefills(*models(ARCH, compute_dtype="float32"), B=2, S=12)
    assert_prefill_close(jout, tout, ("k", "v", "xk", "xv"))
    assert tout[1].cache["xk"].shape == (2, 2, 12, 2, 16)
    assert tout[1].cache_len.tolist() == [12, 12]


BLOCKWISE = dict(compute_dtype="float32", attn_impl="blockwise",
                 flash_block_q=16, flash_block_kv=16)


@pytest.mark.parametrize("S", [32, 64])
def test_blockwise_routes_match_reference_f32(S, monkeypatch):
    """``attn_impl="blockwise"`` at blocks of 16: the reference takes its
    jnp ``blockwise_attention``, the port ``flash_attention_ref`` (the
    flash kernel's plain version), non-causal in each encoder layer and
    causal in each decoder layer's self attention; cross attention stays
    ``full_attention``."""
    seen = []
    blockwise = TL.blockwise_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], kw["causal"]))
        return blockwise(q, k, v, **kw)

    monkeypatch.setattr(TL, "blockwise_attention", spy)
    jout, tout = prefills(*models(ARCH, **BLOCKWISE), B=2, S=S)
    assert seen == [(S, False)] * 2 + [(S, True)] * 2
    assert_prefill_close(jout, tout, ("k", "v", "xk", "xv"))


def test_serve_steps_over_a_prefilled_cross_cache_f32():
    """A 12-position prefill (frames and tokens) written into a 32-position
    decode state, then 4 serve steps: float32 logits within 1e-5 at each
    step, and the same cache after them."""
    serve_steps_agree(ARCH, P=12)


def test_lm_loss_matches_reference_f32():
    jcfg, tcfg = configs(ARCH, compute_dtype="float32")
    shape = SHAPES["train_4k"].reduced()
    state = tzoo.init_state(tcfg, 0, device="cpu")
    host = SyntheticLM(tcfg, shape, seed=1).batch_at(0)
    jbatch = JSyntheticLM(jcfg, JSHAPES["train_4k"].reduced(),
                          seed=1).batch_at(0)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state.params)
    jloss, jm = jzoo.lm_loss(jparams, jax.tree.map(jnp.asarray, jbatch),
                             jcfg)
    tloss, tm = tzoo.lm_loss(state.params,
                             {k: torch.as_tensor(v) for k, v in host.items()},
                             tcfg)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0


def test_dense_engine_streams_match_reference_f32():
    """8 requests through 4 lanes, every prompt token a decode step:
    greedy streams, host syncs, chunk prefills (0) and tokens served
    equal the reference engine's."""
    engines_agree(ARCH)


def test_paged_cache_raises_as_the_reference_does():
    jcfg, jparams, tcfg, tparams = models(ARCH)
    from repro.serving.engine import ServingEngine as JEngine
    with pytest.raises(ValueError, match="paged cache unsupported for "
                                         "enc_dec"):
        JEngine(jcfg, jparams, batch_size=2, max_seq=32, cache_mode="paged")
    with pytest.raises(ValueError, match="paged cache unsupported for "
                                         "enc_dec"):
        TEngine(tcfg, tparams, batch_size=2, max_seq=32, cache_mode="paged",
                device="cpu")
    with pytest.raises(ValueError):
        tzoo.paged_kv_keys(tcfg)
    with pytest.raises(ValueError):
        tzoo.make_bulk_prefill(tcfg, TShape("s", 32, 2, "decode"), 16)
    assert tcfg.family not in tzoo.BULK_PREFILL_FAMILIES
    assert tzoo.BULK_PREFILL_FAMILIES == jzoo.BULK_PREFILL_FAMILIES
    assert tzoo.PAD_SAFE_FAMILIES == jzoo.PAD_SAFE_FAMILIES


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_work_units_cross_packages_bitwise(direction):
    units_cross(ARCH, direction)


def test_synthetic_lm_frames_equal_reference_bit_for_bit():
    shape, jshape = SHAPES["train_4k"].reduced(), JSHAPES["train_4k"].reduced()
    ours = SyntheticLM(ARCHS[ARCH].reduced(), shape, seed=5)
    ref = JSyntheticLM(jax_config(ARCH).reduced(), jshape, seed=5)
    for step in (0, 3):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b) == ["frames", "labels", "tokens"]
        assert a["frames"].dtype == torch.bfloat16
        assert b["frames"].dtype == ml_dtypes.bfloat16
        assert np.array_equal(a["frames"].view(torch.int16).numpy(),
                              b["frames"].view(np.int16))
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
