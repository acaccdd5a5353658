"""Wrapper of the hand-written CUDA paged-attention kernel.

The kernel (``csrc/paged_attention.cu``, sm_90a) replaces the Pallas TPU
kernel ``repro/kernels/paged_attention/kernel.py:33,73``.  It is built
with ``nvcc`` on first use (``kernels.build``) and called through ctypes
on the current CUDA stream.  This wrapper takes CUDA tensors only: it
checks device, dtype, shape, contiguity and alignment, allocates the
output (and, where the table spans several chunks of positions, the
workspace of their softmax states) with ``torch.empty``, launches, and
raises if the launch failed.  The kernel counts the chunks of each
(lane, kv head) that have finished in an int32 buffer kept here per
device: zeroed once, grown (zeroed) when a call has more lanes x kv heads
than it holds, and left zero by every launch, so a call reads nothing on
the host and allocates nothing that depends on ``kv_len``.  Calls on one
device share it and must not overlap (one stream).  ``launches`` counts
successful launches and nothing else; each launch is also reported to
the cost counter in force (``kernels.report``, ``cost``).
``empty_launch`` launches an empty kernel through the same C path (the
floor under a call's time).

A call that autograd would record (grad mode on, an input that
requires grad) raises ``RuntimeError`` (``kernels.refuse_grad``): the
output would be cut off from the graph.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_grad, report

HEAD_DIMS = (16, 32, 64, 80, 128)   # 80: zamba2-2.7b's shared attention
MAX_GROUP = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_fns = None
_workspace_floats = {}   # geometry -> floats of chunk-softmax workspace
_counters = {}           # device index -> int32 zeros, one per (lane, kv)
_empty = None


def _lib():
    """The two C entries, their signatures declared once: every pointer
    and the stream as ``c_void_p`` (a bare Python int would be cut to 32
    bits)."""
    global _fns
    if _fns is None:
        lib = build.load("paged_attention")
        launch = lib.paged_attention_launch
        launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                           + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p])
        launch.restype = ctypes.c_int
        workspace = lib.paged_attention_workspace
        workspace.argtypes = [ctypes.c_int] * 6
        workspace.restype = ctypes.c_longlong
        _fns = launch, workspace
    return _fns


def cost(q, k_pool, v_pool, block_tables, kv_len, lens=None):
    """``(flops, bytes)`` of one call: the K and V rows below each lane's
    length, q and the output, the table entries those rows need and
    kv_len, each read or written once; q.k and p.v at 2 operations a
    multiply-add.  ``lens`` gives the lanes' lengths (``kv_len`` read on
    the host by the caller); without it (a cost trace, whose ``kv_len``
    holds no values, and a counted launch, which reads nothing on the
    host) every lane counts the full width of its table."""
    B, H, D = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    if lens is None:
        lens = [block_tables.shape[1] * bs] * B
    tokens, e = sum(lens), q.element_size()
    nbytes = (tokens * KV * D * e * 2                 # k and v rows
              + 2 * B * H * D * e                     # q in, out
              + sum(-(-n // bs) for n in lens) * 4 + B * 4)
    return 4 * tokens * H * D, nbytes


def check_args(q, k_pool, v_pool, block_tables, kv_len,
               device: str = "cuda"):
    """Raise ``ValueError`` for arguments the kernel does not take;
    ``device`` is the device type they must be on (``"meta"``: a call
    that ``ops`` answers without launching)."""
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"want q (B,H,D) and pools (NB,bs,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    b, h, d = q.shape
    nb, bs, kv, dk = k_pool.shape
    if dk != d or d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} (pool {dk}); supported {HEAD_DIMS}")
    if h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"{h} q heads over {kv} kv heads: the GQA group "
                         f"must divide and be at most {MAX_GROUP}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_pool.dtype}/{v_pool.dtype}: "
                         f"want one of float32, bfloat16 for all three")
    if block_tables.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise ValueError("block_tables and kv_len must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(kv_len.shape) != (b,):
        raise ValueError(f"want block_tables ({b}, max_blocks) and kv_len "
                         f"({b},); got {tuple(block_tables.shape)}, "
                         f"{tuple(kv_len.shape)}")
    if nb == 0 or block_tables.shape[1] == 0:
        raise ValueError("empty pool or block table")
    tensors = (q, k_pool, v_pool, block_tables, kv_len)
    for t in tensors:
        if t.device != q.device or t.device.type != device:
            raise ValueError(f"the CUDA kernel's tensors must be on one "
                             f"{device} device; got "
                             f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("tensors must be contiguous and 16-byte "
                             "aligned")


def paged_attention(q, k_pool, v_pool, block_tables, kv_len):
    """q: (B, H, D); pools: (num_blocks, bs, KV, D) of q's dtype;
    block_tables: (B, max_blocks) int32 (sentinel entries allowed: the
    kernel clamps them into the pool); kv_len: (B,) int32.
    Returns (B, H, D)."""
    global launches
    refuse_grad("paged_attention (a decode kernel, no backward)", q,
                k_pool, v_pool)
    check_args(q, k_pool, v_pool, block_tables, kv_len)
    b, h, d = q.shape
    nb, bs, kv, _ = k_pool.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    launch, workspace = _lib()
    geom = (b, h, kv, d, bs, block_tables.shape[1])
    if geom not in _workspace_floats:
        _workspace_floats[geom] = workspace(*geom)
    n = _workspace_floats[geom]
    if n < 0:
        raise ValueError(f"paged_attention: bad geometry {geom}")
    ws = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    counters = _counters.get(q.device.index)
    if counters is None or counters.numel() < b * kv:
        counters = torch.zeros(b * kv, dtype=torch.int32, device=q.device)
        _counters[q.device.index] = counters
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(_DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                    v_pool.data_ptr(), block_tables.data_ptr(),
                    kv_len.data_ptr(), out.data_ptr(),
                    None if ws is None else ws.data_ptr(),
                    counters.data_ptr(), b, h, kv, d, nb, bs,
                    block_tables.shape[1], d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed (code {rc})")
    launches += 1
    report("paged_attention", cost, q, k_pool, v_pool, block_tables, kv_len)
    return out


def empty_launch(device=None) -> None:
    """One empty kernel on the current stream of ``device`` (a card),
    launched through the same ctypes path as the paged kernel."""
    global _empty
    if _empty is None:
        fn = build.load("paged_attention").paged_attention_empty_launch
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _empty = fn
    rc = _empty(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed (code {rc})")
