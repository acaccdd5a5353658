"""Tests of the port that need an NVIDIA GPU (marked ``cuda``).

They skip without a card: the CUDA kernels have no CPU mode.  This file
imports torch and the port only (no jax), so it runs on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, jacobi, ssd
from repro_torch.kernels.paged_attention import kernel, paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_ULP_TOL = dict(rtol=2.0 ** -7, atol=1e-5)  # one bf16 ulp of each |x|
# The paged kernel keeps the softmax weights float32 where its plain
# version rounds them to bf16, so a bf16 output differs by a share of its
# (lane, head) row's size: held to one ulp of itself plus 2^-7 of the
# row's RMS (at most 6.4e-3 of it at these shapes, seeds 0-2, on an H100:
# benchmarks/paged_bf16_readings.py), the whole to 4e-3 relative L2
# (readings 1.2e-3 to 2.8e-3).  An absolute 1.6e-2 was ~20% of an output
# at 320 positions.
PAGED_BF16_RTOL = PAGED_BF16_ROW_ATOL = 2.0 ** -7
PAGED_BF16_REL_L2 = 4e-3


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
    if dtype == torch.float32:
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   **F32_TOL)
        return
    a, r = out.float(), ref.float()
    row_rms = r.pow(2).mean(-1, keepdim=True).sqrt()
    excess = (a - r).abs() - PAGED_BF16_RTOL * r.abs()
    assert float((excess / row_rms).max()) <= PAGED_BF16_ROW_ATOL
    assert float((a - r).norm() / r.norm()) <= PAGED_BF16_REL_L2


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
    (1, 64, 256, 80, 64, 64),            # zamba2-2.7b's long prefill: b*nc 64
    (2, 1, 1, 4, 16, 16),                # l off the buckets: 1, 32, 100, 200
    (1, 2, 32, 3, 16, 16),               # h = 3
    (1, 1, 100, 5, 100, 64),             # h = 5, p = 100
    (1, 1, 200, 50, 64, 128),            # h = 50
    (1, 2, 64, 5, 128, 16),              # p = 128, n = 16
    (1, 2, 16, 3, 16, 256),              # n = 256
    (1, 2, 48, 3, 30, 18),               # rows of x, B, C not 16-byte sized
    # grids large enough for heads to share C.B^T (on a 132-SM card):
    (1, 64, 192, 5, 32, 16),             # 2 heads a CTA, a group of 1
    (1, 80, 128, 3, 100, 32),            # large grid, p > 64: 1 head a CTA
    (1, 300, 32, 6, 64, 16),             # one-tile chunks, 2 heads a CTA
])
def test_ssd_kernel_matches_plain_on_card(cuda_device, b, nc, l, h, p, n):
    """The reference's tolerance, 1e-4 absolute (float32, sums in another
    order)."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in ssd_inputs(b, nc, l, h, p, n)]
    before = ssd.kernel.launches
    before_l = ssd.kernel.launches_by_len.get(l, 0)
    y, st = ssd.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert ssd.kernel.launches == before + 1
    assert ssd.kernel.launches_by_len[l] == before_l + 1
    y_ref, st_ref = ssd.ssd_intra_chunk_ref(*args)
    atol = 1e-4 if max(l, n) <= 64 else 1e-5 * float(y_ref.abs().max())
    np.testing.assert_allclose(y.cpu().numpy(), y_ref.cpu().numpy(),
                               rtol=1e-4, atol=atol)
    np.testing.assert_allclose(st.cpu().numpy(), st_ref.cpu().numpy(),
                               rtol=1e-4, atol=atol)


@pytest.mark.cuda
def test_ssd_kernel_reads_unaligned_rows_on_card(cuda_device):
    """Tensors that start 4 bytes past a 16-byte boundary (views into a
    larger buffer): the kernel copies single floats there, with the same
    result as from aligned tensors."""
    arrays = ssd_inputs(1, 2, 64, 3, 16, 32)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    shifted = []
    for a in args:
        buf = torch.empty(a.numel() + 1, device=cuda_device)
        view = buf[1:].view(a.shape)
        view.copy_(a)
        assert view.data_ptr() % 16 == 4 and view.is_contiguous()
        shifted.append(view)
    y, st = ssd.ssd_intra_chunk(*shifted)
    torch.cuda.synchronize()
    y_ref, st_ref = ssd.ssd_intra_chunk_ref(*args)
    for out, ref in ((y, y_ref), (st, st_ref)):
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


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


@pytest.mark.cuda
@pytest.mark.parametrize("nc,l,h,p,n", [
    (1, 256, 48, 64, 128),               # mamba2-780m's chunk prefill
    (1, 64, 48, 64, 128),
    (64, 256, 80, 64, 64),               # zamba2-2.7b's long prefill
])
def test_ssd_kernel_at_model_decays_on_card(cuda_device, nc, l, h, p, n):
    """Decays as large as the models' chunks have them: dA = dt * A with
    A = -exp(uniform(log 0.01, log 16)) per head (the models draw A in
    [1, 16]; slower heads keep long spans of the decay above underflow)
    and dt = softplus(2 * normal), so steps reach ~-100 and dA_cs spans
    thousands.  Held to the full-shape limits: 1e-4 relative, 1e-5 of
    the largest output."""
    xr, _, _, Br, Cr = ssd_inputs(1, nc, l, h, p, n, seed=l + nc)
    rng = np.random.default_rng(l + nc + 1)
    A = -np.exp(rng.uniform(np.log(0.01), np.log(16.0), h))
    dtr = np.log1p(np.exp(2 * rng.standard_normal((1, nc, l, h))))
    dA_cs = np.cumsum((dtr * A).astype(np.float32), axis=2, dtype=np.float32)
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(cuda_device)
            for a in (xr, dtr, dA_cs, Br, Cr)]
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


# ------------------------------------------------------------------ flash
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kv,s,d,bq,bkv", [
    (1, 4, 2, 128, 32, 32, 32),          # tests/test_kernels.py shapes
    (2, 8, 8, 64, 16, 32, 16),
    (1, 4, 4, 128, 64, 64, 64),
    (1, 6, 3, 96, 32, 32, 32),
    (1, 2, 1, 64, 16, 16, 32),
    (1, 32, 8, 320, 128, 64, 64),        # granite-8b heads
    (2, 4, 4, 200, 80, 512, 512),        # D = 80, a ragged last tile
    (1, 4, 1, 48, 48, 48, 16),           # one partial tile, G = 4
    (1, 4, 2, 128, 96, 64, 64),          # D = 96
    (2, 2, 1, 80, 112, 16, 16),          # D = 112, a ragged last tile
])
def test_flash_kernel_matches_plain_on_card(cuda_device, b, h, kv, s, d,
                                            bq, bkv, causal, dtype):
    """``ops.attention`` on (B, S, H, D) tensors: one launch that reads and
    writes that layout through strides, against the plain version
    (``impl="ref"``).  float32: sums in another order; bf16: both keep
    ``p`` in float32 and round the output once, so an output near a
    rounding boundary may land on the other neighbour: one bf16 ulp, at
    most 2^-7 of its size (atol 1e-5 for outputs that cancel to near
    zero)."""
    rng = np.random.default_rng(s + d)
    q, k, v = [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, dtype)
        for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]
    before = flash_attention.kernel.launches
    out = flash_attention.attention(q, k, v, causal=causal, block_q=bq,
                                    block_kv=bkv)
    torch.cuda.synchronize()
    assert flash_attention.kernel.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    ref = flash_attention.attention(q, k, v, causal=causal, block_q=bq,
                                    block_kv=bkv, impl="ref")
    tol = F32_TOL if dtype == torch.float32 else BF16_ULP_TOL
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", [
    (1, 4, 2, 300, 300, 128, True),      # ragged against 128-row tiles
    (1, 4, 2, 1000, 1000, 80, True),
    (1, 2, 1, 1000, 1000, 128, False),
    (1, 4, 2, 200, 333, 64, False),      # Sq != Sk
    (2, 4, 4, 384, 130, 128, False),
    (1, 8, 2, 256, 256, 128, True),      # G = 4 at D = 128
    (1, 4, 4, 256, 256, 128, True),      # G = 1 at D = 128
    (1, 4, 1, 4096, 4096, 128, True),    # the key-tile ring wraps many times
    (1, 4, 4, 4096, 4096, 80, True),
    *[(1, 4, 2, 192, 192, d, True) for d in flash_attention.kernel.HEAD_DIMS],
])
def test_flash_kernel_bf16_tiles_on_card(cuda_device, b, h, kv, sq, sk, d,
                                         causal):
    """The bf16 tensor-core kernel at shapes that cut its tiles: ragged
    query and key tiles, Sq != Sk, GQA groups of 1 and 4, long rings, and
    every head_dim; held to one bf16 ulp of the plain version (blocks as
    large as the lengths allow, so the plain version takes any length)."""
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
        for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]
    bq, bkv = (512 if sq % 512 == 0 else sq), (512 if sk % 512 == 0 else sk)
    before = flash_attention.kernel.launches
    out = flash_attention.attention(q, k, v, causal=causal, block_q=bq,
                                    block_kv=bkv)
    torch.cuda.synchronize()
    assert flash_attention.kernel.launches == before + 1
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    ref = flash_attention.attention(q, k, v, causal=causal, block_q=bq,
                                    block_kv=bkv, impl="ref")
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **BF16_ULP_TOL)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    """``check_args`` raises ``ValueError``, and nothing is launched."""
    fk = flash_attention.kernel

    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=cuda_device)

    q, k = t(1, 4, 64, 32), t(1, 2, 64, 32)
    flat = torch.zeros(4 * 64 * 32 + 1, device=cuda_device)
    bad = {
        "head_dim 24": (t(1, 4, 64, 24), t(1, 2, 64, 24), t(1, 2, 64, 24)),
        "head_dim 144": (t(1, 4, 8, 144), t(1, 2, 8, 144), t(1, 2, 8, 144)),
        "3 heads on 2": (t(1, 3, 64, 32), k, k),
        "k and v differ": (q, k, t(1, 2, 32, 32)),
        "batch differs": (q, t(2, 2, 64, 32), t(2, 2, 64, 32)),
        "empty": (t(1, 4, 0, 32), t(1, 2, 0, 32), t(1, 2, 0, 32)),
        "mixed dtypes": (q, k, t(1, 2, 64, 32, dtype=torch.bfloat16)),
        "float16": (q.half(), k.half(), k.half()),
        "a CPU tensor": (q, k.cpu(), k),
        "head_dim strided": (t(1, 4, 32, 64).transpose(2, 3), k, k),
        "misaligned": (flat[1:].view(1, 4, 64, 32), k, k),
        "rank 3": (q[0], k[0], k[0]),
    }
    before = fk.launches
    for what, args in bad.items():
        with pytest.raises(ValueError):
            fk.flash_attention(*args)
            pytest.fail(what)
    assert fk.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b"])
def test_blockwise_bulk_prefill_kernel_matches_plain_on_card(cuda_device,
                                                             arch, dtype):
    """A 256-token dense bulk prefill of reduced granite-8b, and of reduced
    zamba2-2.7b (``_ssm_prefill``'s shared attention), with
    ``attn_impl="blockwise"`` (blocks of 64): one flash launch per
    attention layer, and the same cache as ``impl="ref"`` (the plain
    ``blockwise_attention`` form, and the plain SSD).  The k/v and conv
    leaves are bf16: float32 values that differ in the order of summation
    may straddle a rounding boundary, one bf16 ulp (2^-7 relative); the
    float32 SSD states differ in that order only (1e-4).  In bf16 compute
    the plain form also rounds ``p`` to bf16, about one bf16 ulp (2^-9
    relative) on each attention output, which reaches the next layers
    through the residual stream: held to 2% relative L2 over each leaf."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model_zoo as zoo
    cfg = get_config(arch).reduced().with_(
        compute_dtype=dtype, attn_impl="blockwise", flash_block_q=64,
        flash_block_kv=64)
    params = zoo.init_serving_params(cfg, seed=0, device=cuda_device)
    shape = ShapeConfig("serve", 320, 2, "decode")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, 256)).astype(np.int32)).to(cuda_device)
    caches = {}
    for impl in ("kernel", "ref"):
        state = zoo.init_decode_state(cfg, shape, fill_len=0,
                                      device=cuda_device)
        before = flash_attention.kernel.launches
        state = zoo.make_bulk_prefill(cfg, shape, 256, impl=impl)(
            params, state, toks, 1, 250)
        torch.cuda.synchronize()
        launched = flash_attention.kernel.launches - before
        assert launched == (zoo._attn_layers(cfg) if impl == "kernel"
                            else 0)
        assert state.cache_len.tolist() == [0, 250]
        caches[impl] = state.cache
    assert set(caches["kernel"]) == set(caches["ref"])
    for key in caches["ref"]:
        a, b = caches["kernel"][key].float(), caches["ref"][key].float()
        if dtype == "float32":
            tol = (dict(rtol=1e-4, atol=1e-4) if key == "ssm"
                   else dict(rtol=2.0 ** -7, atol=1e-5))
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       **tol)
        else:
            assert float((a - b).norm() / b.norm()) < 2e-2, key
