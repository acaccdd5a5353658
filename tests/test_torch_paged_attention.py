"""The port's paged-attention kernel module.

* The plain version (``ref.py``) matches JAX's ``paged_attention_ref``
  and JAX's Pallas kernel run in interpret mode, on the shapes of
  ``tests/test_paged.py`` plus permuted pools and sentinel entries, at
  rtol=atol=2e-5 in float32.
* The plain version equals the port's dense decode attention bit for bit.
* A CPU tensor goes through the plain version and launches nothing; the
  kernel wrapper itself refuses CPU tensors and arguments it does not
  take.
* Kernel vs plain version needs the card: ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_ref as jax_ref
from repro.kernels.paged_attention.kernel import paged_attention as \
    pallas_kernel
from repro_torch.kernels.paged_attention import (gather_pages,
                                                 paged_attention,
                                                 paged_attention_ref)
from repro_torch.kernels.paged_attention import kernel
from repro_torch.models.layers import full_attention

from tests.test_torch_cuda import paged_inputs

# One intra-op thread: the suite runs in parallel workers beside tests
# that time the wall clock.
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
SHAPES = [(4, 4, 3), (8, 2, 4)]     # (heads, kv_heads, blocks_used)


def _inputs(heads, kv_heads, blocks_used, seed=0, permute=True):
    return paged_inputs(3, heads, kv_heads, 16, 8, 12, 4, blocks_used,
                        seed=seed, permute=permute)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("permute", [True, False])
@pytest.mark.parametrize("heads,kv_heads,blocks_used", SHAPES)
def test_plain_matches_jax_ref_and_pallas(heads, kv_heads, blocks_used,
                                          permute):
    arrays = _inputs(heads, kv_heads, blocks_used, permute=permute)
    out = paged_attention_ref(*_torch(*arrays)).numpy()
    q, k_pool, v_pool, bt, kv_len = (jnp.asarray(a) for a in arrays)
    ref = jax_ref(q, k_pool, v_pool, bt, kv_len)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    nb = k_pool.shape[0]
    pallas = pallas_kernel(q, k_pool, v_pool, jnp.clip(bt, 0, nb - 1),
                           kv_len, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)


def test_plain_bit_identical_to_dense_attention():
    """Gather-through-the-table + full_attention == dense decode
    attention, bit for bit — with sentinel table entries and garbage in
    unreferenced pool blocks."""
    b, h, d, bs, nb, mb = 2, 4, 16, 8, 10, 3
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(
        np.float32))
    dense_k = torch.from_numpy(rng.standard_normal((b, mb * bs, h, d))
                               .astype(np.float32))
    dense_v = torch.from_numpy(rng.standard_normal((b, mb * bs, h, d))
                               .astype(np.float32))
    kv_len = torch.tensor([5, 17], dtype=torch.int32)
    pool_k = torch.from_numpy(50 * rng.standard_normal((nb, bs, h, d))
                              .astype(np.float32))
    pool_v = pool_k + 1.0
    bt = np.full((b, mb), nb, np.int32)
    rows = rng.permutation(nb)[:b * mb].reshape(b, mb)
    for i in range(b):
        for j in range(-(-int(kv_len[i]) // bs)):
            bt[i, j] = rows[i, j]
            pool_k[rows[i, j]] = dense_k[i, j * bs:(j + 1) * bs]
            pool_v[rows[i, j]] = dense_v[i, j * bs:(j + 1) * bs]
    ref = full_attention(q, dense_k, dense_v, causal=False,
                         kv_len=kv_len)[:, 0]
    out = paged_attention_ref(q[:, 0], pool_k, pool_v,
                              torch.from_numpy(bt), kv_len)
    assert torch.equal(out, ref)


def test_gather_pages_clamps_sentinels():
    pool = torch.arange(4 * 2 * 1 * 2, dtype=torch.float32).reshape(
        4, 2, 1, 2)
    rows = gather_pages(pool, torch.tensor([[1, 4, 4]], dtype=torch.int32))
    assert rows.shape == (1, 6, 1, 2)
    assert torch.equal(rows[0, :2], pool[1])


def test_cpu_tensor_takes_plain_version_without_launch():
    args = _torch(*_inputs(8, 2, 4))
    before = kernel.launches
    out = paged_attention(*args)
    assert kernel.launches == before
    assert torch.equal(out, paged_attention_ref(*args))


@pytest.mark.parametrize("bad", ["cpu", "dtype", "head_dim", "group",
                                 "table_dtype"])
def test_kernel_wrapper_refuses(bad):
    q, k, v, bt, kl = _torch(*_inputs(8, 2, 4))
    if bad == "dtype":
        q = q.double()
    elif bad == "head_dim":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif bad == "group":
        q = torch.cat([q, q, q], 1)[:, :18]          # 18 heads over 2
    elif bad == "table_dtype":
        bt = bt.long()
    before = kernel.launches
    with pytest.raises(ValueError):
        kernel.paged_attention(q, k, v, bt, kl)
    assert kernel.launches == before
