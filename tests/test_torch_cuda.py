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
# The paged kernel keeps the softmax weights to 2^-16 where its plain
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
    (8, 16, 16, 128, 16, 200, 20, 20),   # qwen2-moe-a2.7b heads: G = 1
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
    hold_paged(out, paged_attention_ref(q, k, v, bt, kl))


def hold_paged(out, ref):
    """The kernel's output against the plain version's: float32 to
    ``F32_TOL``; bf16 each element to one ulp of itself plus
    ``PAGED_BF16_ROW_ATOL`` of its row's RMS, the whole to
    ``PAGED_BF16_REL_L2``."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if out.dtype == torch.float32:
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   **F32_TOL)
        return
    a, r = out.float(), ref.float()
    row_rms = r.pow(2).mean(-1, keepdim=True).sqrt()
    excess = (a - r).abs() - PAGED_BF16_RTOL * r.abs()
    assert float((excess / row_rms).max()) <= PAGED_BF16_ROW_ATOL
    assert float((a - r).norm() / r.norm()) <= PAGED_BF16_REL_L2


def lane_inputs(kv_lens, heads, kv_heads, d, dtype, device, bs=16, mb=None,
                seed=0):
    """Decode inputs with one lane per entry of ``kv_lens``: each lane's
    blocks on rows of a shuffled pool, the table's tail sentinels, and
    the pool's unreferenced rows garbage (1e4)."""
    rng = np.random.default_rng(seed)
    blocks = [-(-n // bs) for n in kv_lens]
    mb = mb or max(max(blocks), 1)
    nb = sum(blocks) + 2
    rows = rng.permutation(nb)
    k_pool = np.full((nb, bs, kv_heads, d), 1e4, np.float32)
    v_pool = np.full((nb, bs, kv_heads, d), 1e4, np.float32)
    bt = np.full((len(kv_lens), mb), nb, np.int32)
    used = 0
    for i, n in enumerate(blocks):
        bt[i, :n] = rows[used:used + n]
        used += n
    for r in rows[:used]:
        k_pool[r] = rng.standard_normal((bs, kv_heads, d))
        v_pool[r] = rng.standard_normal((bs, kv_heads, d))
    q = rng.standard_normal((len(kv_lens), heads, d)).astype(np.float32)
    kl = np.asarray(kv_lens, np.int32)
    return [torch.from_numpy(x).to(device, dtype) for x in (q, k_pool, v_pool)] \
        + [torch.from_numpy(x).to(device) for x in (bt, kl)]


PAGED_LANE_CASES = {
    # lanes of 1 and 1000 positions in one batch, sentinel tails
    "short_and_long": dict(kv_lens=[1, 1000, 1, 1000], heads=32, kv_heads=8,
                           d=128, mb=64),
    # one lane of 1024 positions
    "one_lane_1024": dict(kv_lens=[1024], heads=32, kv_heads=8, d=128),
    # 64 lanes at G = 4: 512 (lane, kv head) pairs, many CTAs
    "b64_g4": dict(kv_lens=list(range(7, 7 + 64 * 15, 15)), heads=16,
                   kv_heads=4, d=64),
    # zamba2-2.7b's shared attention, G = 1, D = 80
    "d80_g1": dict(kv_lens=[5, 300, 129, 700], heads=32, kv_heads=32, d=80),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED_LANE_CASES))
def test_kernel_lane_mixes_on_card(cuda_device, case, dtype):
    args = lane_inputs(dtype=dtype, device=cuda_device,
                       **PAGED_LANE_CASES[case])
    out = paged_attention(*args)
    torch.cuda.synchronize()
    hold_paged(out, paged_attention_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_chunk_boundaries_on_card(cuda_device, dtype):
    """kv_len one below, at and one above a multiple of the positions a
    CTA covers (the source's kChunk; 64, 128 and 256 were read), and at
    block sizes that do not divide it."""
    lens = [63, 64, 65, 127, 128, 129, 255, 256, 257]
    for bs in (16, 8, 48):
        args = lane_inputs(lens, 8, 2, 32, dtype, cuda_device, bs=bs,
                           seed=bs)
        hold_paged(paged_attention(*args), paged_attention_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_empty_lane_writes_zeros_on_card(cuda_device, dtype):
    """A lane with kv_len 0 writes zeros (acc / max(l, 1e-30)); the other
    lanes of the batch are unaffected."""
    args = lane_inputs([0, 200, 0, 1000, 1], 8, 2, 64, dtype, cuda_device)
    out = paged_attention(*args)
    ref = paged_attention_ref(*args)
    assert torch.equal(out[[0, 2]], torch.zeros_like(out[[0, 2]]))
    hold_paged(out[[1, 3, 4]], ref[[1, 3, 4]])


@pytest.mark.cuda
def test_kernel_back_to_back_calls_on_card(cuda_device):
    """Calls that change geometry and lengths, launched one after another
    on the stream with no sync between: the per-(lane, kv head) counters
    come back to zero after each and their buffer grows (zeroed) for more
    lanes x kv heads; each output matches the plain version."""
    cases = [([1000, 3, 517], 8, 2, 128), ([129] * 40, 32, 8, 64),
             ([1, 1000], 4, 4, 80), ([300] * 70, 16, 8, 32),
             ([0, 640, 1024], 32, 8, 128)]
    calls = [lane_inputs(lens, h, kv, d, torch.bfloat16, cuda_device,
                         mb=64, seed=i)
             for i, (lens, h, kv, d) in enumerate(cases)]
    before = kernel.launches
    outs = [paged_attention(*a) for a in calls]
    torch.cuda.synchronize()
    assert kernel.launches == before + len(cases)
    counters = kernel._counters[cuda_device.index or 0]
    assert counters.numel() >= 70 * 8
    assert int(counters.abs().sum()) == 0
    for a, out in zip(calls, outs):
        lanes = a[4] > 0
        hold_paged(out[lanes], paged_attention_ref(*a)[lanes])
    assert torch.equal(outs[-1][0], torch.zeros_like(outs[-1][0]))


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


def _migration_engine(cfg, params, dev, **kw):
    from repro_torch.serving.engine import ServingEngine
    kw = dict(dict(batch_size=3, max_seq=96, prefill_buckets=(16, 64),
                   cache_mode="paged", block_size=8), **kw)
    return ServingEngine(cfg, params, device=dev, **kw)


def _migration_requests(cfg):
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(11)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(((5, 9), (20, 7), (70, 8)))]


def _migration_params(arch, dtype, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo
    cfg = get_config(arch).reduced().with_(compute_dtype=dtype)
    return cfg, zoo.init_serving_params(cfg, seed=0, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b",
                                  "qwen2-moe-a2.7b"])
def test_pack_unpack_on_card_continues_stream(cuda_device, arch, dtype):
    """Slots packed mid-decode on the card (columns gathered on the
    device, one counted fetch) unpack into a second engine on the card,
    and every stream equals the unmigrated run's; the window after the
    unpack makes no host sync."""
    cfg, params = _migration_params(arch, dtype, cuda_device)
    ref_reqs = _migration_requests(cfg)
    ref = _migration_engine(cfg, params, cuda_device)
    for r in ref_reqs:
        ref.submit(r)
    ref.run_until_idle()
    reqs = _migration_requests(cfg)
    src = _migration_engine(cfg, params, cuda_device)
    for r in reqs:
        src.submit(r)
    src.step_many(3)
    syncs = src.host_syncs
    units = src.pack()
    assert src.host_syncs == syncs + 2 and len(units) == 3
    for u in units:
        assert all(t.device.type == "cpu" for t in u.snapshot.cache.values())
    dst = _migration_engine(cfg, params, cuda_device)
    dst.unpack(units)
    syncs = dst.host_syncs
    torch.cuda.set_sync_debug_mode("error")
    try:
        dst.step_many(2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dst.host_syncs == syncs
    dst.run_until_idle()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decode_window_on_card(cuda_device, dtype):
    """Reduced qwen2-moe on the card, paged: an 8-step decode window
    makes no host sync under ``set_sync_debug_mode("error")`` (routing,
    dispatch and combine included), a second run gives the same streams
    bit for bit (the combine adds in a fixed order, no float atomics),
    and in float32 the dense engine gives the paged one's streams."""
    from repro_torch.serving.engine import Request
    cfg, params = _migration_params("qwen2-moe-a2.7b", dtype, cuda_device)
    streams = []
    for mode in ("paged", "paged", "dense"):
        eng = _migration_engine(cfg, params, cuda_device, cache_mode=mode,
                                decode_block=8)
        rng = np.random.default_rng(11)
        reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n)
                        .astype(np.int32), max_new_tokens=40)
                for i, n in enumerate((5, 20, 40))]
        for r in reqs:
            eng.submit(r)
        eng.step_many(8)                        # admit + first window
        syncs = eng.host_syncs
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step_many(8)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert eng.host_syncs == syncs
        eng.run_until_idle()
        streams.append([list(r.out_tokens) for r in reqs])
    assert streams[0] == streams[1]
    if dtype == "float32":
        assert streams[2] == streams[0]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b"])
def test_resize_on_card_repacks_bitwise(cuda_device, arch):
    """A resize on the card (3 -> 1 lanes, back to 3, then a larger
    pool) packs through the device gather and re-installs what it keeps:
    every unit's columns come back bit for bit, and the float32 streams
    finish as an unmoved run's."""
    cfg, params = _migration_params(arch, "float32", cuda_device)
    ref_reqs = _migration_requests(cfg)
    ref = _migration_engine(cfg, params, cuda_device)
    for r in ref_reqs:
        ref.submit(r)
    ref.run_until_idle()
    reqs = _migration_requests(cfg)
    eng = _migration_engine(cfg, params, cuda_device)
    for r in reqs:
        eng.submit(r)
    eng.step_many(3)
    packed = eng.pack()
    cols = {u.rid: u.snapshot.cache for u in packed}

    def same(units):
        for u in units:
            for k, t in u.snapshot.cache.items():
                assert torch.equal(t.view(torch.uint8),
                                   cols[u.rid][k].view(torch.uint8)), k

    eng.unpack(packed)
    eng.step_many(0)                          # install, no decode step
    evicted = eng.resize(batch_size=1)
    assert len(evicted) == 2 and eng.n_active == 1
    same(evicted)
    kept = eng.pack()
    same(kept)
    assert eng.resize(batch_size=3) == []
    eng.unpack(kept)
    eng.resume(evicted)
    eng.step_many(0)
    assert eng.resize(kv_pool_blocks=eng.pool_blocks + 5) == []
    assert eng.state.cache["k"].shape[1] == eng.pool_blocks + 1
    again = eng.pack()
    same(again)
    eng.unpack(again)
    eng.run_until_idle()
    eng._alloc.check_invariants()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]


@pytest.mark.cuda
def test_device_store_holds_host_leaves_on_card(cuda_device):
    """A ``DeviceStore`` built for the card keeps its copy there, host
    leaves included (pinned or not), and restores them bit for bit; one
    built with no device keeps each copy on its leaf's device."""
    from repro_torch.core.checkpointing import DeviceStore
    host = torch.randn(4, 33).to(torch.bfloat16)
    tree = {"pageable": host, "pinned": host.pin_memory(),
            "card": host.to(cuda_device)}
    store = DeviceStore(device=cuda_device)
    store.save("x", tree)
    assert all(t.device.type == "cuda" for t in store._data["x"].values())
    assert store._data["x"]["card"].data_ptr() != tree["card"].data_ptr()
    out = store.restore("x", device=cuda_device)
    for k, t in out.items():
        assert t.device.type == "cuda"
        assert torch.equal(t.cpu().view(torch.int16), host.view(torch.int16))
    plain = DeviceStore()
    plain.save("x", tree)
    assert plain._data["x"]["pageable"].device.type == "cpu"
    assert plain._data["x"]["card"].device.type == "cuda"


def _cluster_model(dev):
    return _migration_params("granite-8b", "bfloat16", dev)


@pytest.mark.cuda
def test_device_endpoint_roundtrip_lands_on_card(cuda_device):
    """A unit staged through a ``DeviceEndpoint`` comes back with its
    columns on the card, bit for bit, stamped ``residency == "device"``;
    the target engine's install is a device-to-device copy, the window
    after it makes no host sync, and the stream continues exactly."""
    from repro_torch.cluster import DeviceEndpoint
    cfg, params = _cluster_model(cuda_device)
    ref_reqs = _migration_requests(cfg)
    ref = _migration_engine(cfg, params, cuda_device)
    for r in ref_reqs:
        ref.submit(r)
    ref.run_until_idle()
    reqs = _migration_requests(cfg)
    src = _migration_engine(cfg, params, cuda_device)
    for r in reqs:
        src.submit(r)
    src.step_many(3)
    units = src.pack()
    want = {u.rid: {k: t.clone() for k, t in u.snapshot.cache.items()}
            for u in units}
    ep = DeviceEndpoint(device=cuda_device)
    ckpt_s, restore_s = ep.roundtrip(units, "drain_r0")
    assert ckpt_s > 0 and restore_s > 0
    for u in units:
        assert u.residency == "device"
        for k, t in u.snapshot.cache.items():
            assert t.device.type == "cuda", k
            assert torch.equal(t.cpu().view(torch.uint8),
                               want[u.rid][k].view(torch.uint8)), k
    dst = _migration_engine(cfg, params, cuda_device)
    dst.unpack(units)
    syncs = dst.host_syncs
    torch.cuda.set_sync_debug_mode("error")
    try:
        dst.step_many(2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dst.host_syncs == syncs
    dst.run_until_idle()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]


@pytest.mark.cuda
def test_small_paged_cluster_on_card_matches_lone_engine(cuda_device):
    """Paged replicas on the card, drained through a device and a host
    endpoint: every bf16 greedy stream equals a lone paged engine's of
    the same geometry, and the paged kernel ran on every replica."""
    import functools
    from repro_torch.cluster import InstanceType, ServingCluster
    from repro_torch.runtime import FaultTrace
    from repro_torch.serving.engine import ServingEngine
    cfg, params = _cluster_model(cuda_device)
    geometry = dict(batch_size=3, max_seq=96, decode_block=4)
    engine = functools.partial(ServingEngine, cache_mode="paged",
                               block_size=8, prefill_buckets=(16, 64))

    def requests():
        from repro_torch.serving.workload import synthetic_requests
        return synthetic_requests(10, cfg.vocab_size, seed=3,
                                  prompt_len=(3, 60), max_new=24)

    lone_reqs = requests()
    lone = engine(cfg, params, device=cuda_device, **geometry)
    for r in lone_reqs:
        lone.submit(r)
    lone.run_until_idle()
    trace = FaultTrace(rebalance_lead=2.0, notice_deadline=2.0)
    trace.inject(1.0, 0)
    trace.inject(2.0, 1)
    fleet = [InstanceType("gpu.2x", 2.0, accelerator=True),
             InstanceType("spot.2x", 2.0), InstanceType("spot.0.7x", 0.7)]
    cl = ServingCluster(cfg, params, fleet, engine=engine, trace=trace,
                        dt=1.0, device=cuda_device, **geometry)
    reqs = requests()
    for r in reqs:
        cl.submit(r, at=0.0)
    launches = kernel.launches
    out = cl.run()
    assert out["completed"] == 10 and out["drains"] == 2
    assert out["migrated_slots"] > 0
    assert kernel.launches > launches
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in lone_reqs]
