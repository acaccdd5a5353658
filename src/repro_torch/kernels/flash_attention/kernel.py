"""Wrapper of the hand-written CUDA flash-attention kernel.

The kernel (``csrc/flash_attention.cu``, sm_90a) replaces the Pallas TPU
kernel ``repro/kernels/flash_attention/kernel.py:25,69``: bf16 on the
tensor cores (wgmma, K and V by TMA; the checks below also make every
stride and base fit a TMA descriptor), float32 by FFMA.  It is built
with ``nvcc`` on first use (``kernels.build``) and called through ctypes
on the current CUDA stream.  This wrapper takes CUDA tensors only: it
checks device, dtype, shape, strides and alignment, allocates the output
with ``torch.empty_like(q)`` (q's strides, so a heads-major view of a
(B, S, H, D) tensor gets a (B, S, H, D) output), launches, and raises if
the launch failed.  ``launches`` counts successful launches and nothing
else; each launch is also reported to the cost counter in force
(``kernels.report``, ``cost``).

A call that autograd would record (grad mode on, an input that
requires grad) raises ``RuntimeError`` (``kernels.refuse_grad``): the
output would be cut off from the graph.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_grad, report

HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)   # multiples of 16 to 128
MAX_GRID_YZ = 65535                               # heads, batch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_fn = None


def _lib():
    """The C entry, its signature declared once: every pointer and the
    stream as ``c_void_p`` and the strides as ``c_longlong`` (bare Python
    ints would be cut to 32 bits)."""
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def cost(q, k, v, causal=True):
    """``(flops, bytes)`` of one call on q (B, H, Sq, D) and k, v (B, KV,
    Sk, D): q.k and p.v over the attended pairs of each head (query row
    i attends keys 0..i when causal, all Sk otherwise), 2 operations a
    multiply-add; q, k and v read once and the output written once."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if causal:
        full = max(sq - sk, 0)                  # rows that see every key
        m = sq - full
        pairs = m * (m + 1) // 2 + full * sk
    else:
        pairs = sq * sk
    flops = 4 * b * h * d * pairs
    nbytes = q.element_size() * b * d * (2 * h * sq + 2 * kv * sk)
    return flops, nbytes


def check_args(q, k, v, device: str = "cuda"):
    """Raise ``ValueError`` for arguments the kernel does not take;
    ``device`` is the device type they must be on (``"meta"``: a call
    that ``ops`` answers without launching)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,Sq,D) and k, v (B,KV,Sk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    bk, kv, sk, dk = k.shape
    if bk != b or dk != d or d not in HEAD_DIMS:
        raise ValueError(f"batch {b}/{bk}, head_dim {d}/{dk}; supported "
                         f"head_dim {HEAD_DIMS}")
    if min(b, h, kv, sq, sk) <= 0 or h % kv:
        raise ValueError(f"empty dimension, or {h} q heads not a multiple "
                         f"of {kv} kv heads")
    if b > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"batch {b} and heads {h} must be at most "
                         f"{MAX_GRID_YZ}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: want one "
                         f"of float32, bfloat16 for all three")
    # rows are read as 16-byte vectors: D contiguous, every other stride a
    # whole number of 16-byte chunks, every base 16-byte aligned
    chunk = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.device.type != device:
            raise ValueError(f"the CUDA kernel's tensors must be on one "
                             f"{device} device; got "
                             f"{[str(x.device) for x in (q, k, v)]}")
        if t.stride(3) != 1 or any(s % chunk for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: head_dim must be contiguous, other "
                             f"strides multiples of {chunk} elements and "
                             f"the data 16-byte aligned; strides "
                             f"{t.stride()}")


def flash_attention(q, k, v, *, causal=True):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) of q's dtype, on one card,
    in any layout whose head_dim is contiguous.  Returns (B, H, Sq, D)
    with q's strides."""
    global launches
    refuse_grad("flash_attention (no backward kernel: blockwise training "
                "past 8192 tokens is ROADMAP work)", q, k, v)
    check_args(q, k, v)
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    # q's strides where q is dense (they passed the checks), else
    # contiguous: either way head_dim is contiguous and rows 16-byte whole
    out = torch.empty_like(q)
    strides = [s for t in (q, k, v, out)
               for s in (t.stride(0), t.stride(2), t.stride(1))]
    launch = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), b, h, kv, sq, sk, d,
                    *strides, int(causal), d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {rc})")
    launches += 1
    report("flash_attention", cost, q, k, v, causal)
    return out
