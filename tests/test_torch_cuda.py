"""Tests of the port that need an NVIDIA GPU (marked ``cuda``).

They skip without a card: the CUDA kernels have no CPU mode.  This file
imports torch and the port only (no jax), so it runs on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import kernel, paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)    # 2 bf16 ulps at |x| ~ 1-2


def paged_inputs(b, heads, kv_heads, d, bs, nb, mb, blocks_used, seed=0,
                 permute=True):
    """Decode inputs with permuted pool rows and a sentinel table tail."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    k_pool = rng.standard_normal((nb, bs, kv_heads, d)).astype(np.float32)
    v_pool = rng.standard_normal((nb, bs, kv_heads, d)).astype(np.float32)
    bt = np.full((b, mb), nb, np.int32)
    kv_len = np.zeros(b, np.int32)
    for i in range(b):
        used = rng.permutation(nb) if permute else np.arange(nb)
        bt[i, :blocks_used] = used[:blocks_used]
        kv_len[i] = rng.integers(1, blocks_used * bs + 1)
    return q, k_pool, v_pool, bt, kv_len


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,kv_heads,d,bs,nb,mb,used", [
    (3, 4, 4, 16, 8, 12, 4, 3),          # tests/test_paged.py shapes
    (3, 8, 2, 16, 8, 12, 4, 4),
    (8, 32, 8, 128, 16, 200, 20, 20),    # granite-8b heads, 320 positions
    (2, 8, 8, 64, 4, 40, 10, 7),         # G = 1
])
def test_kernel_matches_plain_on_card(cuda_device, b, heads, kv_heads, d,
                                      bs, nb, mb, used, dtype):
    arrays = paged_inputs(b, heads, kv_heads, d, bs, nb, mb, used)
    q, k, v, bt, kl = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = kernel.launches
    out = paged_attention(q, k, v, bt, kl)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = paged_attention_ref(q, k, v, bt, kl)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)
