"""Wrapper of the hand-written CUDA SSD intra-chunk kernel.

The kernel (``csrc/ssd.cu``, sm_90a) replaces the Pallas TPU kernel
``repro/kernels/ssd/kernel.py:25,54``.  Its three products run on the
tensor cores in 3xTF32 (each float32 operand split into two TF32 terms,
three TF32 products per float32 one), which keeps float32 accuracy.  It
is built with ``nvcc`` on first use (``kernels.build``) and called
through ctypes on the current CUDA stream.  This wrapper takes CUDA
tensors only: it checks device, dtype, shape, contiguity and alignment,
allocates both outputs with ``torch.empty``, launches, and raises if the
launch failed.  ``launches`` counts successful launches and nothing
else; ``launches_by_len`` counts them by chunk length l.  Each launch
is also reported to the cost counter in force (``kernels.report``,
``cost``).
``empty_launch`` launches an empty kernel through the same C path (the
floor of a timing harness) and counts nothing.

A call that autograd would record raises ``RuntimeError``
(``kernels.refuse_grad``); ``ops.ssd_intra_chunk`` sends such calls
through ``ops.SSDIntraChunk``, which calls this wrapper with grad
mode off.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_grad, report

MAX_HEAD_DIM = 128   # p: one or two 64-column groups
MAX_STATE = 256      # n: the C and B tiles, 64 rows of n (rounded up to
                     # 32) + 4 floats each, must fit shared memory beside
                     # the x and score tiles
MAX_CHUNKS = 65535   # b * nc: the grid's z dimension

launches = 0
launches_by_len: dict = {}
_fn = None
_empty = None


def _lib():
    """The C entry, its signature declared once: every pointer and the
    stream as ``c_void_p`` (a bare Python int would be cut to 32 bits)."""
    global _fn
    if _fn is None:
        fn = build.load("ssd").ssd_intra_chunk_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def cost(xr, dtr, dA_cs, Br, Cr):
    """``(flops, bytes)`` of one call (shapes only are read): over the
    b * nc chunks, per chunk the causal half of C.B^T once (B and C are
    shared by the heads), per head the causal half of att @ xdt and the
    (p, n) state product, 2 operations a multiply-add; each input read
    and each output written once in float32."""
    b, nc, l, h, p = xr.shape
    n, bc = Br.shape[-1], b * nc
    tri = l * (l + 1) // 2
    flops = 2 * bc * (tri * n + h * tri * p + h * l * p * n)
    nbytes = 4 * bc * (2 * l * h * p + 2 * l * h + 2 * l * n + h * p * n)
    return flops, nbytes


def check_args(xr, dtr, dA_cs, Br, Cr, device: str = "cuda"):
    """Raise ``ValueError`` for arguments the kernel does not take;
    ``device`` is the device type they must be on (``"meta"``: a call
    that ``ops`` answers without launching)."""
    if xr.dim() != 5:
        raise ValueError(f"want xr (b,nc,l,h,p); got {tuple(xr.shape)}")
    b, nc, l, h, p = xr.shape
    n = Br.shape[-1] if Br.dim() == 4 else -1
    want = {"dtr": (dtr, (b, nc, l, h)), "dA_cs": (dA_cs, (b, nc, l, h)),
            "Br": (Br, (b, nc, l, n)), "Cr": (Cr, (b, nc, l, n))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {shape}, got {tuple(t.shape)}")
    if min(b, nc, l, h, p, n) <= 0:
        raise ValueError(f"empty dimension in {(b, nc, l, h, p, n)}")
    if p > MAX_HEAD_DIM or n > MAX_STATE or b * nc > MAX_CHUNKS:
        raise ValueError(f"head_dim {p} (max {MAX_HEAD_DIM}), state {n} "
                         f"(max {MAX_STATE}), b*nc {b * nc} "
                         f"(max {MAX_CHUNKS})")
    tensors = (xr, dtr, dA_cs, Br, Cr)
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"all inputs must be float32; got "
                             f"{[str(x.dtype) for x in tensors]}")
        if t.device != xr.device or t.device.type != device:
            raise ValueError(f"the CUDA kernel's tensors must be on one "
                             f"{device} device; got "
                             f"{[str(x.device) for x in tensors]}")
        # the kernel copies 16-byte pieces of rows that are 16-byte
        # aligned and single floats otherwise: 4 bytes is all it needs
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError("tensors must be contiguous and 4-byte aligned")


def ssd_intra_chunk(xr, dtr, dA_cs, Br, Cr):
    """xr: (b,nc,l,h,p); dtr, dA_cs: (b,nc,l,h); Br, Cr: (b,nc,l,n), all
    float32 on one card.  Returns y_diag (b,nc,l,h,p) and states
    (b,nc,h,p,n), float32."""
    global launches
    refuse_grad("ssd_intra_chunk's kernel (a gradient goes through "
                "kernels.ssd.ops.SSDIntraChunk)", xr, dtr, dA_cs, Br, Cr)
    check_args(xr, dtr, dA_cs, Br, Cr)
    b, nc, l, h, p = xr.shape
    n = Br.shape[-1]
    y = torch.empty_like(xr)
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32,
                         device=xr.device)
    launch = _lib()
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        rc = launch(xr.data_ptr(), dtr.data_ptr(), dA_cs.data_ptr(),
                    Br.data_ptr(), Cr.data_ptr(), y.data_ptr(),
                    states.data_ptr(), b * nc, l, h, p, n, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed (code {rc})")
    launches += 1
    launches_by_len[l] = launches_by_len.get(l, 0) + 1
    report("ssd_intra_chunk", cost, xr, dtr, dA_cs, Br, Cr)
    return y, states


def empty_launch(device=None) -> None:
    """One empty kernel on the current stream of ``device`` (a card),
    launched through the same ctypes path as the SSD kernel."""
    global _empty
    if _empty is None:
        fn = build.load("ssd").ssd_empty_launch
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _empty = fn
    rc = _empty(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed (code {rc})")
