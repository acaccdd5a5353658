"""The port's MoE block: the reference's dispatch invariants and
cross-implementation checks (``tests/test_moe.py``,
``tests/test_moe_impls.py``) on ``repro_torch.models.moe``, then the port
held against ``repro.models.moe`` on the same inputs and weights.

The JAX weights are carried across with ``convert`` (the router stays
float32, the experts are cast to the compute dtype).  Tolerances:

* routing: ``tok_of_slot`` equal exactly, drops included;
  ``w_of_slot`` to 4e-6 relative (the router's float32 matmul sums in
  another order, ~1e-7 of a logit, and XLA's ``exp`` and torch's differ
  in the last bit now and then: 1.1e-6 seen); on constructed ties the
  same expert indices, the lower index first, and the weights to one
  float32 ulp;
* float32 outputs: 1e-5 absolute (another order of summation in the
  matmuls, outputs of size ~1-4), aux exactly;
* bf16 outputs: the same routing tables, outputs within 4 bf16 ulps of
  the largest (4 * 2^-8 * max |out|; silu and the expert matmuls round
  to bf16 in other places in the two frameworks).

The reference's ``test_grouped_gradients_finite`` is mirrored in
``tests/test_torch_train.py`` (``test_grouped_gradients_finite``), and
the moe block over data and model ranks in
``tests/test_torch_multirank.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro.configs import get_config as jax_config
from repro.models import moe as jmoe
from repro.models.schema import init_params as jinit_params
from repro_torch.configs import get_config
from repro_torch.models import moe as moe_lib
from repro_torch.models.convert import _convert
from repro_torch.models.layers import rms_norm
from repro_torch.models.schema import init_params

torch.set_num_threads(1)

CPU = torch.device("cpu")


def small_cfg(**kw):
    return get_config("qwen3-moe-30b-a3b").reduced().with_(**kw)


def moe_params(cfg, seed=0):
    """Port weights from a torch generator, laid out as ``convert``
    lays them out (experts in compute dtype, router and norm float32)."""
    tree = init_params(moe_lib.moe_schema(cfg),
                       torch.Generator().manual_seed(seed), "cpu")
    return _convert(tree, cfg, CPU)


def randn(*shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


# ---------------------------------------------- the reference's invariants
@given(e=st.integers(2, 16), k=st.integers(1, 4), t=st.integers(4, 64))
@settings(max_examples=40, deadline=None)
def test_route_topk_valid(e, k, t):
    k = min(k, e)
    cfg = small_cfg(num_experts=e, top_k=k)
    logits = randn(t, e, seed=t)
    idx, w, aux = moe_lib.route(logits, cfg)
    assert idx.shape == (t, k) and w.shape == (t, k)
    assert int(idx.min()) >= 0 and int(idx.max()) < e
    # weights normalized over the k choices
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    # top-1 has the highest weight
    assert bool((w[:, 0] >= w[:, -1] - 1e-6).all())
    assert float(aux) >= 0.0


def test_capacity_bounds_tokens_per_expert():
    cfg = small_cfg(num_experts=4, top_k=2, capacity_factor=1.0)
    T = 32
    C = moe_lib.expert_capacity(cfg, T)
    assert C == max(8, T * 2 // 4)


def test_moe_block_no_drop_equals_dense_computation():
    """With huge capacity, the dispatch/combine path equals an explicit
    per-token expert sum (no tokens dropped, weights respected)."""
    cfg = small_cfg(num_experts=4, top_k=2, capacity_factor=1e3,
                    num_shared_experts=0)
    p = moe_params(cfg)
    x = randn(2, 8, cfg.d_model)
    out, _ = moe_lib.moe_block(p, x, cfg)

    h = rms_norm(x, p["norm"], cfg.norm_eps).to(torch.bfloat16)
    ht = h.reshape(-1, cfg.d_model)
    idx, w, _ = moe_lib.route(ht.float() @ p["router"], cfg)
    y = torch.zeros_like(ht)
    for t in range(ht.shape[0]):
        acc = torch.zeros(cfg.d_model, dtype=torch.bfloat16)
        for j in range(cfg.top_k):
            e = int(idx[t, j])
            g = torch.nn.functional.silu(ht[t] @ p["we_gate"][e])
            u = ht[t] @ p["we_up"][e]
            acc = acc + w[t, j].to(torch.bfloat16) * (
                (g * u) @ p["we_down"][e])
        y[t] = acc
    ref = x + y.reshape(x.shape).to(x.dtype)
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    assert err < 5e-2, err   # bf16 accumulation-order tolerance


def test_moe_capacity_drops_tokens():
    """With capacity_factor -> tiny, most tokens are dropped and the
    output approaches the residual input."""
    # moe_groups=1: the per-group capacity floor (8) would otherwise keep
    # most tokens with 16 groups x 16 tokens each
    cfg = small_cfg(num_experts=8, top_k=2, capacity_factor=1e-6,
                    num_shared_experts=0, moe_groups=1)
    p = moe_params(cfg)
    x = randn(4, 64, cfg.d_model)
    out, _ = moe_lib.moe_block(p, x, cfg)
    # capacity=8 (floor) x 8 experts = 64 routed slots for 512 tokens
    delta = float((out - x).abs().mean())
    out_full, _ = moe_lib.moe_block(p, x, cfg.with_(capacity_factor=100.0))
    delta_full = float((out_full - x).abs().mean())
    assert delta < 0.6 * delta_full


def test_shared_experts_applied():
    cfg = small_cfg(num_experts=4, top_k=1, num_shared_experts=2)
    p = moe_params(cfg)
    assert "ws_gate" in p
    x = randn(1, 4, cfg.d_model)
    out, _ = moe_lib.moe_block(p, x, cfg)
    p2 = dict(p, ws_down=torch.zeros_like(p["ws_down"]))
    out2, _ = moe_lib.moe_block(p2, x, cfg)
    assert float((out - out2).abs().max()) > 0


def _impls_setup(cf=100.0, groups=4):
    cfg = small_cfg(num_experts=8, top_k=2, capacity_factor=cf,
                    num_shared_experts=0, moe_groups=groups)
    return cfg, moe_params(cfg), randn(4, 32, cfg.d_model)


def test_grouped_matches_onehot_no_drop():
    cfg, p, x = _impls_setup()
    o1, a1 = moe_lib._moe_grouped(p, x, cfg)
    o2, a2 = moe_lib.moe_block_onehot(p, x, cfg)
    assert float((o1 - o2).abs().max()) < 1e-3
    assert abs(float(a1) - float(a2)) < 1e-6


def test_grouped_matches_onehot_with_drops_single_group():
    # one group == global capacity semantics -> exact drop agreement
    cfg, p, x = _impls_setup(cf=0.8, groups=1)
    o1, _ = moe_lib._moe_grouped(p, x, cfg)
    o2, _ = moe_lib.moe_block_onehot(p, x, cfg)
    assert float((o1 - o2).abs().max()) < 1e-3


def test_moe_impl_knob():
    cfg, p, x = _impls_setup()
    o_auto, _ = moe_lib.moe_block(p, x, cfg)              # no mesh: grouped
    o_grp, _ = moe_lib.moe_block(p, x, cfg.with_(moe_impl="grouped"))
    o_hot, _ = moe_lib.moe_block(p, x, cfg.with_(moe_impl="onehot"))
    assert torch.equal(o_auto, o_grp)
    assert float((o_auto - o_hot).abs().max()) < 1e-3


# ---------------------------------------------------- against the reference
def _configs(**kw):
    jcfg = jax_config("qwen2-moe-a2.7b").reduced().with_(**kw)
    tcfg = get_config("qwen2-moe-a2.7b").reduced().with_(**kw)
    return jcfg, tcfg


def _carried(jcfg, tcfg, seed=0):
    """The reference's float32 weights and the port's copy of them."""
    jp = jinit_params(jmoe.moe_schema(jcfg), jax.random.PRNGKey(seed))
    return jp, _convert(jax.tree.map(np.asarray, jp), tcfg, CPU)


def test_convert_keeps_router_float32():
    jcfg, tcfg = _configs()           # bf16 compute
    jp, tp = _carried(jcfg, tcfg)
    assert tp["router"].dtype == torch.float32
    assert np.array_equal(tp["router"].numpy(), np.asarray(jp["router"]))
    assert tp["norm"].dtype == torch.float32
    for k in ("we_gate", "we_up", "we_down", "ws_gate", "ws_up", "ws_down"):
        assert tp[k].dtype == torch.bfloat16, k


def test_route_ties_match_reference():
    """Equal probabilities: ``lax.top_k`` puts the lower index first, and
    so does the port.  Rows: all equal, a tie for first, a tie across
    the k-th place, two tied pairs."""
    E = 8
    cfg = small_cfg(num_experts=E, top_k=3)
    rows = np.zeros((4, E), np.float32)
    rows[1, [5, 2]] = 1.0
    rows[2, [6]] = 2.0
    rows[2, [1, 4, 7]] = 1.0
    rows[3, [3, 0]] = 0.5
    rows[3, [2, 6]] = 0.25
    jidx, jw, jaux = jmoe.route(jnp.asarray(rows), cfg)
    tidx, tw, taux = moe_lib.route(torch.from_numpy(rows), cfg)
    assert tidx.tolist() == np.asarray(jidx).tolist()
    assert tidx.tolist() == [[0, 1, 2], [2, 5, 0], [6, 1, 4], [0, 3, 2]]
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2.0 ** -23)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("cf", [0.8, 100.0])
@pytest.mark.parametrize("groups", [1, 4])
def test_routing_tables_match_reference(groups, cf):
    """slot -> token equal exactly, drops included (capacity 0.8 drops
    tokens; 100 keeps all), slot -> weight to 4e-6 relative."""
    jcfg, tcfg = _configs(compute_dtype="float32", moe_groups=groups,
                          capacity_factor=cf)
    jp, tp = _carried(jcfg, tcfg)
    T = 128
    ht = np.random.default_rng(2).standard_normal(
        (groups, T // groups, jcfg.d_model)).astype(np.float32)
    jt, jw, jaux, jC = jmoe._routing_tables(jp, jnp.asarray(ht), jcfg,
                                            groups, T // groups)
    tt, tw, taux, tC = moe_lib._routing_tables(tp, torch.from_numpy(ht),
                                               tcfg, groups, T // groups)
    assert tC == jC
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    if cf < 1:
        assert (tt.numpy() == T // groups).any()      # empty slots exist
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=4e-6,
                               atol=0)
    assert float(taux) == float(jaux)


@pytest.mark.parametrize("impl", ["grouped", "onehot"])
@pytest.mark.parametrize("cf", [0.8, 100.0])
def test_block_matches_reference_f32(impl, cf):
    jcfg, tcfg = _configs(compute_dtype="float32", capacity_factor=cf,
                          moe_groups=4)
    jp, tp = _carried(jcfg, tcfg)
    x = np.random.default_rng(1).standard_normal(
        (4, 32, jcfg.d_model)).astype(np.float32)
    jfn = jmoe._moe_grouped if impl == "grouped" else jmoe.moe_block_onehot
    tfn = (moe_lib._moe_grouped if impl == "grouped"
           else moe_lib.moe_block_onehot)
    jo, jaux = jfn(jp, jnp.asarray(x), jcfg)
    to, taux = tfn(tp, torch.from_numpy(x), tcfg)
    assert to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    assert float(taux) == float(jaux)


@pytest.mark.parametrize("impl", ["grouped", "onehot"])
def test_block_matches_reference_bf16(impl):
    """bf16 compute on the same bf16 input, as a decoder layer feeds it:
    the same routing tables, outputs within 4 bf16 ulps of the largest."""
    jcfg, tcfg = _configs(moe_groups=4, capacity_factor=0.8)
    jp, tp = _carried(jcfg, tcfg)
    x = np.random.default_rng(1).standard_normal(
        (4, 32, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(np.asarray(jx.astype(jnp.float32)),
                          tx.float().numpy())
    jh = jax.jit(lambda v: jmoe.L.rms_norm(v, jp["norm"], jcfg.norm_eps))(jx)
    th = rms_norm(tx, tp["norm"], tcfg.norm_eps)
    ht = th.reshape(4, 32, -1)
    jt, _, _, _ = jmoe._routing_tables(jp, jh.reshape(4, 32, -1), jcfg, 4, 32)
    tt, _, _, _ = moe_lib._routing_tables(tp, ht, tcfg, 4, 32)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    jfn = jmoe._moe_grouped if impl == "grouped" else jmoe.moe_block_onehot
    tfn = (moe_lib._moe_grouped if impl == "grouped"
           else moe_lib.moe_block_onehot)
    jo, jaux = jfn(jp, jx, jcfg)
    to, taux = tfn(tp, tx, tcfg)
    assert to.dtype == torch.bfloat16
    ref = np.asarray(jo.astype(jnp.float32))
    np.testing.assert_allclose(to.float().numpy(), ref, rtol=0,
                               atol=4 * 2.0 ** -8 * np.abs(ref).max())
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


# ------------------------------------- capacity positions over rank blocks
def _choice_major_positions(idx, Tg: int, E: int):
    """The single device's positions, straight from the definition: in
    each group of ``Tg`` tokens, entry (token, choice j) counts the
    entries before it with its expert in choice-major order (every
    token's choice 0, then choice 1, ...).  (k, T)."""
    T, k = idx.shape
    pos = np.empty((k, T), np.int64)
    for g0 in range(0, T, Tg):
        seen = np.zeros(E, np.int64)
        for j in range(k):
            for t in range(g0, g0 + Tg):
                pos[j, t] = seen[idx[t, j]]
                seen[idx[t, j]] += 1
    return pos


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("groups", [1, 2, 16])
@pytest.mark.parametrize("blocks", [(160,), (80, 80), (37, 123),
                                    (50, 13, 61, 36)])
def test_capacity_positions_over_blocks_match_one_device(blocks, groups,
                                                         onehot):
    """Random top-2 choices of 160 tokens over 8 experts, routed in 1, 2
    or 16 groups, split into 1-4 contiguous blocks (the data ranks'
    rows; equal and unequal, cutting groups or not): given every block's
    count table, each block's positions (sort-based ranks, or the
    one-hot cumulative sum) plus ``pool_offsets`` are the single
    device's choice-major positions over the whole group, so the keep
    mask at the group's capacity (factor 0.5: 1 and 2 groups drop
    tokens) is too; one
    block with no tables is the single device itself."""
    E, k, T = 8, 2, sum(blocks)
    cfg = small_cfg(num_experts=E, top_k=k, capacity_factor=0.5)
    Tg = T // groups
    C = moe_lib.expert_capacity(cfg, Tg)
    rng = np.random.default_rng(len(blocks) * 100 + groups)
    idx = np.argsort(rng.random((T, E)), axis=1)[:, :k]
    want = _choice_major_positions(idx, Tg, E)
    # groups of 10 tokens keep all (capacity's floor of 8); larger drop
    assert (want >= C).any() == (Tg > 10)
    offs = np.cumsum((0,) + blocks[:-1])
    tidx = torch.from_numpy(idx)
    if len(blocks) == 1:
        pos, key, Gt = moe_lib.capacity_positions(tidx, 0, 0, Tg, groups, E,
                                                  onehot=onehot)
        assert torch.equal(pos, torch.from_numpy(want.reshape(-1)))
        assert Gt == groups
        return
    tables = []

    def keep(table):
        tables.append(table)
        return table.new_zeros((len(blocks),) + table.shape)
    for q, (off, n) in enumerate(zip(offs, blocks)):
        moe_lib.capacity_positions(tidx[off:off + n], int(off), q, Tg,
                                   groups, E, gather=keep, onehot=onehot)
    gathered = torch.stack(tables)
    assert gathered.shape == (len(blocks), groups, k, E)
    assert int(gathered.sum()) == k * T
    for q, (off, n) in enumerate(zip(offs, blocks)):
        pos, key, Gt = moe_lib.capacity_positions(
            tidx[off:off + n], int(off), q, Tg, groups, E,
            gather=lambda t: gathered, onehot=onehot)
        mine = want[:, off:off + n].reshape(-1)
        assert torch.equal(pos, torch.from_numpy(mine)), q
        assert torch.equal(pos < C, torch.from_numpy(mine < C)), q
        g0 = off // Tg
        assert Gt == (off + n - 1) // Tg - g0 + 1
        groups_of = (off + np.arange(n)) // Tg - g0
        assert torch.equal(key, torch.from_numpy(
            (np.tile(groups_of, k) * E + idx[off:off + n].T.reshape(-1))))
