"""The port's checkpoint stores against the reference's.

Every store restores exactly what it saved (bf16, float32 and int32
leaves, in dicts, lists, tuples and the engine's dataclass states), as
an independent copy; ``nbytes`` of the memory and device stores equals
the reference's for the same tree; a restore runs where the caller says,
and without a card the default (``"cuda"``) raises.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import checkpointing as jckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import checkpointing as ckpt
from repro_torch.models import model_zoo as zoo

KINDS = ("memory", "device", "filesystem")


def _arrays(seed=0):
    """The same values as numpy (bf16 as ml_dtypes) for both packages."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((3, 5)).astype(np.float32),
        "kv": rng.standard_normal((2, 4, 6)).astype(ml_dtypes.bfloat16),
        "len": rng.integers(0, 9, 4).astype(np.int32),
        "nested": [rng.standard_normal(7).astype(np.float32),
                   (rng.integers(0, 5, (2, 2)).astype(np.int32),)],
    }


def _torch_tree(arrays):
    def conv(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    return {"w": conv(arrays["w"]), "kv": conv(arrays["kv"]),
            "len": conv(arrays["len"]),
            "nested": [conv(arrays["nested"][0]),
                       (conv(arrays["nested"][1][0]),)]}


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _assert_same(a, b):
    la, lb = ckpt.tree_leaves(a), ckpt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(_bits(x), _bits(y))


def _store(kind, tmp_path):
    return ckpt.make_store(kind, tmp_path / "ckpt")


@pytest.mark.parametrize("kind", KINDS)
def test_save_restore_exact_and_independent(kind, tmp_path):
    store = _store(kind, tmp_path)
    tree = _torch_tree(_arrays())
    want = ckpt.tree_map(torch.clone, tree)
    assert store.save("s", tree) >= 0.0
    assert store.exists("s") and not store.exists("other")
    for leaf in ckpt.tree_leaves(tree):       # the live state moves on
        leaf.zero_()
    out = store.restore("s", device="cpu")
    assert isinstance(out["nested"], list)
    assert isinstance(out["nested"][1], tuple)
    _assert_same(out, want)
    for leaf in ckpt.tree_leaves(out):        # so does the restored one
        leaf.zero_()
    _assert_same(store.restore("s", device="cpu"), want)
    assert set(store.timer.stages) == {"checkpoint", "restore"}
    store.drop("s")
    assert not store.exists("s")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("paged", [False, True])
def test_engine_decode_state_roundtrips(kind, paged, tmp_path):
    """The engine's own state (a dataclass holding a dict of leaves):
    what the card phase saves and restores at full width."""
    cfg = get_config("zamba2-2.7b").reduced()
    shape = ShapeConfig("serve", 32, 2, "decode")
    state = (zoo.init_paged_decode_state(cfg, shape, 8, 8, device="cpu")
             if paged else zoo.init_decode_state(cfg, shape, fill_len=0,
                                                 device="cpu"))
    gen = torch.Generator().manual_seed(0)
    for leaf in ckpt.tree_leaves(state):
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    store = _store(kind, tmp_path)
    store.save("state", state)
    out = store.restore("state", device="cpu")
    assert type(out) is type(state) and set(out.cache) == set(state.cache)
    _assert_same(out, state)


@pytest.mark.parametrize("kind", ["memory", "device"])
def test_nbytes_matches_reference(kind):
    arrays = _arrays(seed=3)
    jstore = jckpt.make_store(kind)
    jstore.save("s", {"w": jnp.asarray(arrays["w"]),
                      "kv": jnp.asarray(arrays["kv"]),
                      "len": jnp.asarray(arrays["len"]),
                      "nested": [jnp.asarray(arrays["nested"][0]),
                                 (jnp.asarray(arrays["nested"][1][0]),)]})
    store = ckpt.make_store(kind)
    store.save("s", _torch_tree(arrays))
    assert store.nbytes("s") == jstore.nbytes("s") == 216


@pytest.mark.parametrize("kind", KINDS)
def test_restore_defaults_to_the_card(kind, tmp_path):
    """``device`` defaults to ``"cuda"``: without a card that raises
    (no silent CPU fallback); with one the leaves land there."""
    store = _store(kind, tmp_path)
    store.save("s", _torch_tree(_arrays()))
    if torch.cuda.is_available():
        out = store.restore("s")
        assert all(t.is_cuda for t in ckpt.tree_leaves(out))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            store.restore("s")


def test_make_store_kinds(tmp_path):
    assert isinstance(ckpt.make_store("memory"), ckpt.InMemoryStore)
    assert isinstance(ckpt.make_store("device"), ckpt.DeviceStore)
    fs = ckpt.make_store("filesystem", tmp_path / "fs")
    assert isinstance(fs, ckpt.FilesystemStore)
    assert fs.root == tmp_path / "fs" and fs.root.is_dir()
    fs.save("a", {"x": torch.arange(10)})
    assert fs.nbytes("a") == (fs.root / "a.ckpt").stat().st_size > 0
    with pytest.raises(ValueError):
        ckpt.make_store("tape")


def test_stage_timer_accumulates():
    timer = ckpt.StageTimer()
    for _ in range(2):
        with timer.time("x"):
            pass
    assert list(timer.stages) == ["x"] and timer.stages["x"] >= 0.0
