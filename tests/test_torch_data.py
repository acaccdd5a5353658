"""The port's data pipeline and batch specs, held against the reference.

``SyntheticLM.batch_at`` is numpy on both sides and must give the same
arrays bit for bit (the elastic tests rest on it); the mirrors of
``tests/test_runtime.py``'s data tests run on the port, and the
prefetcher's device copies on the CPU.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JSHAPES
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model_zoo as jzoo
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, to_device
from repro_torch.models import model_zoo as tzoo

torch.set_num_threads(1)

PORTED = sorted(ARCHS)


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", PORTED)
def test_batch_spec_matches_reference(arch, shape_name):
    cfg = get_config(arch).reduced()
    shape = SHAPES[shape_name].reduced()
    want = jzoo.batch_spec(jax_config(arch).reduced(),
                           JSHAPES[shape_name].reduced())
    got = tzoo.batch_spec(cfg, shape)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape
        # the port names its dtypes in torch (numpy has no bf16 without
        # ml_dtypes): torch.int32 for int32, torch.bfloat16 for bfloat16
        assert got[k].dtype == getattr(torch, np.dtype(v.dtype).name)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-780m",
                                  "qwen2-moe-a2.7b", "zamba2-2.7b"])
def test_synthetic_lm_equals_reference_bit_for_bit(arch, shape_name):
    ours = SyntheticLM(get_config(arch).reduced(),
                       SHAPES[shape_name].reduced(), seed=5)
    ref = JSyntheticLM(jax_config(arch).reduced(),
                       JSHAPES[shape_name].reduced(), seed=5)
    for step in (0, 1, 7):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert np.array_equal(a[k], b[k]), (k, step)


def test_synthetic_lm_at_full_train_shape_equals_reference():
    """mamba2-780m at train_4k with the global batch cut to 8."""
    shape = SHAPES["train_4k"]
    cut = type(shape)(shape.name, shape.seq_len, 8, shape.kind)
    jcut = type(JSHAPES["train_4k"])(shape.name, shape.seq_len, 8,
                                     shape.kind)
    a = SyntheticLM(get_config("mamba2-780m"), cut).batch_at(3)
    b = JSyntheticLM(jax_config("mamba2-780m"), jcut).batch_at(3)
    for k in b:
        assert np.array_equal(a[k], b[k])
    assert a["tokens"].shape == (8, 4096)


def test_synthetic_data_deterministic_and_step_addressable():
    cfg = ARCHS["granite-8b"].reduced()
    shape = SHAPES["train_4k"].reduced()
    d1 = SyntheticLM(cfg, shape, seed=7)
    d2 = SyntheticLM(cfg, shape, seed=7)
    b5a, b5b = d1.batch_at(5), d2.batch_at(5)
    for k in b5a:
        assert np.array_equal(b5a[k], b5b[k])
    # different steps differ
    assert not np.array_equal(d1.batch_at(5)["tokens"],
                              d1.batch_at(6)["tokens"])
    # restart-resume: iterating from 3 gives batch_at(3)
    it = d1.iterate(start_step=3)
    assert np.array_equal(next(it)["tokens"], d1.batch_at(3)["tokens"])


def test_prefetcher_orders_batches():
    cfg = ARCHS["granite-8b"].reduced()
    shape = SHAPES["train_4k"].reduced()
    src = SyntheticLM(cfg, shape, seed=1)
    pf = Prefetcher(src, start_step=2)
    try:
        s0, b0 = pf.next()
        s1, b1 = pf.next()
        assert (s0, s1) == (2, 3)
        assert np.array_equal(np.asarray(b0["tokens"]),
                              src.batch_at(2)["tokens"])
    finally:
        pf.stop()
    assert not pf._thread.is_alive()


def test_prefetcher_copies_on_the_callers_thread():
    """With a device, ``next`` returns tensors there, in step order,
    equal to the host batches."""
    cfg = ARCHS["mamba2-780m"].reduced()
    shape = SHAPES["train_4k"].reduced()
    src = SyntheticLM(cfg, shape, seed=2)
    pf = Prefetcher(src, start_step=0, device="cpu", depth=3)
    try:
        for want in range(4):
            step, batch = pf.next()
            assert step == want
            for k, v in src.batch_at(want).items():
                assert isinstance(batch[k], torch.Tensor)
                assert batch[k].dtype == torch.int32
                assert np.array_equal(batch[k].numpy(), v)
    finally:
        pf.stop()
    assert not pf._thread.is_alive()


def test_to_device_and_make_batch():
    cfg = ARCHS["zamba2-2.7b"].reduced()
    shape = SHAPES["train_4k"].reduced()
    host = SyntheticLM(cfg, shape).batch_at(0)
    dev = to_device(host, "cpu")
    assert all(np.array_equal(dev[k].numpy(), host[k]) for k in host)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        s = SHAPES[name].reduced()
        b = tzoo.make_batch(cfg, s, seed=3, device="cpu")
        spec = tzoo.batch_spec(cfg, s)
        assert sorted(b) == sorted(spec)
        for k, v in spec.items():
            assert tuple(b[k].shape) == v.shape
            assert b[k].dtype == torch.int32
        assert int(b["tokens"].max()) < cfg.vocab_size
        if "active" in b:
            assert bool((b["active"] == 1).all())
    again = tzoo.make_batch(cfg, shape, seed=3, device="cpu")
    first = tzoo.make_batch(cfg, shape, seed=3, device="cpu")
    assert all(torch.equal(again[k], first[k]) for k in first)
