"""SSD intra-chunk entry point (``models.mamba2.ssd_chunked`` calls it).

Dispatch follows the tensor, never a fallback:

* a CUDA tensor launches the hand-written kernel (``kernel.py``), which
  raises on arguments it does not take;
* a CPU tensor runs the plain version (``ref.py``), which autograd
  differentiates as it is;
* a meta tensor (a cost trace, ``launch.hlo_analysis``) gets outputs of
  the kernel's shapes and dtypes: the arguments are checked as the
  kernel checks them and the call is reported to the cost counter in
  force with ``kernel.cost``, and nothing is launched, built or run.

``impl="ref"`` asks for the plain version explicitly, wherever the
tensors are: only tests and ``chip_smoke.py`` use it, to hold the kernel
against its plain version on the card.

**The gradient.**  A CUDA or meta call made while autograd records (grad
mode on and an input that requires grad) goes through ``SSDIntraChunk``,
a ``torch.autograd.Function``: its forward launches the kernel (on meta:
the meta outputs), as every call does, and saves the five inputs; its
backward is the vector-Jacobian product of the plain version
(``ssd_intra_chunk_ref`` recomputed under ``enable_grad`` and
differentiated with ``torch.autograd.grad`` against the incoming
cotangents), which launches no kernel.  That is the reference's own
backward: the JAX package has no backward kernel (no ``custom_vjp``),
and its model trains through the jnp form (``mamba2_block(impl="jnp")``),
so XLA's gradient of that formula is what it runs.  A hand-written
backward kernel is later work (ROADMAP).  Calls under ``no_grad``, or on
tensors that need no gradient (every serving path), launch the kernel
directly, as before.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import report
from repro_torch.kernels.ssd import kernel
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref


def _kernel_call(xr, dtr, dA_cs, Br, Cr):
    """The kernel on a card; on meta tensors its outputs, reported."""
    if xr.device.type != "meta":
        return kernel.ssd_intra_chunk(xr, dtr, dA_cs, Br, Cr)
    kernel.check_args(xr, dtr, dA_cs, Br, Cr, device="meta")
    b, nc, _, h, p = xr.shape
    report("ssd_intra_chunk", kernel.cost, xr, dtr, dA_cs, Br, Cr)
    return (torch.empty_like(xr),
            torch.empty((b, nc, h, p, Br.shape[-1]), dtype=torch.float32,
                        device=xr.device))


class SSDIntraChunk(torch.autograd.Function):
    """The kernel forward, the plain version's vector-Jacobian product
    backward."""

    @staticmethod
    def forward(ctx, xr, dtr, dA_cs, Br, Cr):
        ctx.save_for_backward(xr, dtr, dA_cs, Br, Cr)
        return _kernel_call(xr, dtr, dA_cs, Br, Cr)

    @staticmethod
    def backward(ctx, g_y, g_states):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ssd_intra_chunk_ref(*inputs)
        return torch.autograd.grad(outs, inputs, (g_y, g_states))


def ssd_intra_chunk(xr, dtr, dA_cs, Br, Cr, *, impl: str = "kernel"):
    """xr: (b,nc,l,h,p) f32; dtr/dA_cs: (b,nc,l,h); Br/Cr: (b,nc,l,n).
    Returns y_diag (b,nc,l,h,p), states (b,nc,h,p,n)."""
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "ref" or xr.device.type == "cpu":
        return ssd_intra_chunk_ref(xr, dtr, dA_cs, Br, Cr)
    args = (xr, dtr, dA_cs, Br, Cr)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SSDIntraChunk.apply(*args)
    return _kernel_call(*args)
