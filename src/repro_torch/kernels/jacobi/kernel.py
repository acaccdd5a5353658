"""Wrapper of the hand-written CUDA Jacobi stencil kernel.

The kernel (``csrc/jacobi.cu``, sm_90a) replaces the Pallas TPU kernel
``repro/kernels/jacobi/kernel.py:22,42``.  It is built with ``nvcc`` on
first use (``kernels.build``) and called through ctypes on the current
CUDA stream.  This wrapper takes CUDA tensors on the current device
only: it checks device, dtype, shape, contiguity, alignment and that the
output does not overlap the input, launches, and raises if the launch
failed.  The values of ``ids`` and ``nbr`` are not read on the host
(that would synchronise): ids must lie in ``[0, T)`` and neighbours in
``[-1, T)``, as the tile runtime builds them.  ``launches`` counts
successful launches and nothing else; each launch is also reported to
the cost counter in force (``kernels.report``, ``cost``).

A call that autograd would record (grad mode on, an input that
requires grad) raises ``RuntimeError`` (``kernels.refuse_grad``): the
output would be cut off from the graph.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_grad, report

ROWS_PER_CTA = 16       # kRows in csrc/jacobi.cu
MAX_GRID_YZ = 65535     # tiles per launch, and row strips per tile

launches = 0
_fn = None


def _lib():
    """The C entry, its signature declared once: every pointer and the
    stream as ``c_void_p`` (a bare Python int would be cut to 32 bits).
    The kernel is loaded onto the card here, not at its first launch."""
    global _fn
    if _fn is None:
        lib = build.load("jacobi")
        rc = lib.jacobi_tiles_load()
        if rc != 0:
            raise RuntimeError(f"loading the jacobi kernel failed (code {rc})")
        fn = lib.jacobi_tiles_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def cost(points: int, dtype) -> tuple:
    """``(flops, bytes)`` of one sweep over ``points`` grid points of
    ``dtype``: 3 adds and a multiply a point; each point read once and
    written once (the halos are other points' reads)."""
    return 4 * points, 2 * points * dtype.itemsize


def _check_grid(*tensors, device: str = "cuda"):
    refuse_grad("jacobi (no backward)", *tensors)
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"want float32 or bfloat16; got {dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise ValueError(
                f"dtypes differ: {[str(x.dtype) for x in tensors]}")
        if t.device.type != device or t.device != tensors[0].device:
            raise ValueError(f"the CUDA kernel's tensors must be on one "
                             f"{device} device; got "
                             f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous() or t.data_ptr() % t.element_size():
            raise ValueError("tensors must be contiguous and aligned")


def _overlap(a, b) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def check_tiles(src, ids, nbr, out, device: str = "cuda"):
    """Raise ``ValueError`` for arguments the tile launch does not take;
    ``device`` is the device type they must be on (``"meta"``: a call
    that ``ops`` answers without launching, where ``out``'s overlap with
    the tiles cannot be read)."""
    if src.dim() != 3 or min(src.shape) <= 0:
        raise ValueError(f"want tiles (T, h, w); got {tuple(src.shape)}")
    if tuple(out.shape) != tuple(src.shape):
        raise ValueError(f"out {tuple(out.shape)} != tiles "
                         f"{tuple(src.shape)}")
    if device != "meta" and _overlap(src, out):
        raise ValueError("out overlaps the tiles it is computed from")
    T, h, _ = src.shape
    if ids.dim() != 1 or not 1 <= ids.numel() <= MAX_GRID_YZ:
        raise ValueError(f"want 1 to {MAX_GRID_YZ} ids; got "
                         f"{tuple(ids.shape)}")
    if tuple(nbr.shape) != (T, 4):
        raise ValueError(f"want nbr ({T}, 4); got {tuple(nbr.shape)}")
    for name, t in (("ids", ids), ("nbr", nbr)):
        if t.dtype != torch.int32 or t.device != src.device or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on "
                             f"{src.device}; got {t.dtype} on {t.device}")
    if -(-h // ROWS_PER_CTA) > MAX_GRID_YZ:
        raise ValueError(f"tile height {h} too large")
    _check_grid(src, out, device=device)


def check_grid(grid, device: str = "cuda"):
    """Raise ``ValueError`` for a grid the global sweep does not take."""
    if grid.dim() != 2 or min(grid.shape) <= 0:
        raise ValueError(f"want a grid (H, W); got {tuple(grid.shape)}")
    _check_grid(grid, device=device)
    if -(-grid.shape[0] // ROWS_PER_CTA) > MAX_GRID_YZ:
        raise ValueError(f"grid height {grid.shape[0]} too large")


def _launcher(src, out, ids, nbr, n, h, w):
    """The launch as a function of no arguments.  The host's work (the
    library, the stream, the arguments as ctypes values) is done here,
    before it is called, so that events recorded around the call time
    the kernel, not the host's preparation of it."""
    if src.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {src.device}, but the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    fn = _lib()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (src.data_ptr(), out.data_ptr(),
            None if ids is None else ids.data_ptr(),
            None if nbr is None else nbr.data_ptr())
    args = (*map(ctypes.c_void_p, ptrs),
            *map(ctypes.c_int, (n, h, w, int(src.dtype == torch.bfloat16))),
            ctypes.c_void_p(stream))

    def launch(_alive=(src, ids, nbr)):   # the pointers' tensors
        global launches
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"jacobi kernel launch failed (code {rc})")
        launches += 1
        report("jacobi", cost, n * h * w, src.dtype)
        return out
    return launch


def prepare_tiles(src, ids, nbr, out):
    """One sweep of the tiles ``ids`` (int32, n) of ``src (T, h, w)``
    into the same tiles of ``out``, halos from the neighbour table
    ``nbr (T, 4)`` of ``src``: checked here, and returned as a function
    of no arguments (see ``_launcher``) that launches once and returns
    ``out``."""
    check_tiles(src, ids, nbr, out)
    _, h, w = src.shape
    return _launcher(src, out, ids, nbr, ids.numel(), h, w)


def jacobi_step(grid):
    """One sweep of the grid ``(H, W)``: top halo 1.0, others 0.0."""
    check_grid(grid)
    H, W = grid.shape
    return _launcher(grid, torch.empty_like(grid), None, None, 1, H, W)()
