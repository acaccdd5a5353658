"""Tests of the port that need an NVIDIA GPU (marked ``cuda``).

They skip without a card: the CUDA kernels have no CPU mode.  This file
imports torch and the port only (no jax), so it runs on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import jacobi, ssd
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
    (4, 32, 32, 80, 16, 64, 16, 16),     # zamba2-2.7b heads, D = 80
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


def ssd_inputs(b, nc, l, h, p, n, seed=0):
    """SSD intra-chunk inputs as ``tests/test_kernels.py`` draws them:
    x, B, C standard normal, dt = softplus(normal), dA = -|normal| / 10."""
    rng = np.random.default_rng(seed)
    xr = rng.standard_normal((b, nc, l, h, p)).astype(np.float32)
    dtr = np.log1p(np.exp(rng.standard_normal((b, nc, l, h)))).astype(
        np.float32)
    dA = -np.abs(rng.standard_normal((b, nc, l, h))).astype(np.float32) * 0.1
    dA_cs = np.cumsum(dA, axis=2, dtype=np.float32)
    Br = rng.standard_normal((b, nc, l, n)).astype(np.float32)
    Cr = rng.standard_normal((b, nc, l, n)).astype(np.float32)
    return xr, dtr, dA_cs, Br, Cr


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,l,h,p,n", [
    (1, 2, 16, 2, 8, 16),                # tests/test_kernels.py shapes
    (2, 1, 32, 4, 16, 8),
    (1, 3, 8, 1, 4, 4),
    (1, 1, 64, 2, 32, 16),
    (1, 4, 16, 8, 16, 16),               # reduced mamba2-780m, 64 tokens
    (2, 1, 100, 3, 128, 256),            # ragged l, p and n at their limits
])
def test_ssd_kernel_matches_plain_on_card(cuda_device, b, nc, l, h, p, n):
    """The reference's tolerance, 1e-4 absolute (float32, sums in another
    order)."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in ssd_inputs(b, nc, l, h, p, n)]
    before = ssd.kernel.launches
    y, st = ssd.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert ssd.kernel.launches == before + 1
    y_ref, st_ref = ssd.ssd_intra_chunk_ref(*args)
    atol = 1e-4 if max(l, n) <= 64 else 1e-5 * float(y_ref.abs().max())
    np.testing.assert_allclose(y.cpu().numpy(), y_ref.cpu().numpy(),
                               rtol=1e-4, atol=atol)
    np.testing.assert_allclose(st.cpu().numpy(), st_ref.cpu().numpy(),
                               rtol=1e-4, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [16, 64, 256])
@pytest.mark.parametrize("h,p,n", [(48, 64, 128), (80, 64, 64)],
                         ids=["mamba2-780m", "zamba2-2.7b"])
def test_ssd_kernel_full_shapes_on_card(cuda_device, l, h, p, n):
    """Full-width prefill chunks (b = nc = 1).  Sums of up to l * n
    float32 products taken in another order: held to 1e-5 of the largest
    output, and 1e-4 relative."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in ssd_inputs(1, 1, l, h, p, n, seed=l)]
    y, st = ssd.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    y_ref, st_ref = ssd.ssd_intra_chunk_ref(*args)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    for out, ref in ((y, y_ref), (st, st_ref)):
        np.testing.assert_allclose(
            out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4,
            atol=1e-5 * float(ref.abs().max()))


# ----------------------------------------------------------------- jacobi
@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(64, 64), (128, 64), (64, 128), (256, 32),
                                 (32, 32)])               # test_kernels.py
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jacobi_kernel_matches_plain_on_card(cuda_device, H, W, dtype):
    """Bit for bit: both round after every op, in the same order."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (H, W)).astype(np.float32)).to(cuda_device, dtype)
    before = jacobi.kernel.launches
    out = jacobi.jacobi(g)
    torch.cuda.synchronize()
    assert jacobi.kernel.launches == before + 1
    ref = jacobi.jacobi(g, impl="ref")
    assert out.dtype == dtype and torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_runtime_on_card_after_migration(cuda_device, dtype):
    """The card's runtime (one kernel launch per PE per step) equals the
    CPU's plain version bit for bit, across a load-balancer migration and
    an assignment changed by hand; launches = PEs holding tiles per step."""
    from repro_torch.core.overdecomp import HostTileRuntime, TileGrid
    from repro_torch.core.rates import RateMonitor
    grid = TileGrid(96, 160, 3, 4)
    card = HostTileRuntime(grid, 4, odf=3, dtype=dtype, device=cuda_device)
    host = HostTileRuntime(grid, 4, odf=3, dtype=dtype, device="cpu")
    before = jacobi.kernel.launches
    expected = 0
    for i in range(9):
        if i == 3:
            for rt in (card, host):       # PE 2 measured 4x slower
                rt.monitor = RateMonitor(4)
                rt.monitor.record_step([3.0] * 4, [1.0, 1.0, 4.0, 1.0])
                assert rt.load_balance("greedy_refine").migrations > 0
        if i == 6:
            moved = np.random.default_rng(1).integers(0, 3, 12)
            card.assignment, host.assignment = moved, moved.copy()
        card.step()
        host.step()
        expected += int((np.bincount(card.assignment, minlength=4) > 0)
                        .sum())
    torch.cuda.synchronize()
    assert card.host_syncs == 9
    assert jacobi.kernel.launches - before == expected
    assert torch.equal(card.tiles.cpu(), host.tiles)
