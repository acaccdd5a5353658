"""SSD intra-chunk entry point (``models.mamba2.ssd_chunked`` calls it).

Dispatch follows the tensor, never a fallback:

* a CUDA tensor launches the hand-written kernel (``kernel.py``), which
  raises on arguments it does not take;
* a CPU tensor runs the plain version (``ref.py``).

``impl="ref"`` asks for the plain version explicitly, wherever the
tensors are: only tests and ``chip_smoke.py`` use it, to hold the kernel
against its plain version on the card.
"""
from __future__ import annotations

from repro_torch.kernels.ssd import kernel
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref


def ssd_intra_chunk(xr, dtr, dA_cs, Br, Cr, *, impl: str = "kernel"):
    """xr: (b,nc,l,h,p) f32; dtr/dA_cs: (b,nc,l,h); Br/Cr: (b,nc,l,n).
    Returns y_diag (b,nc,l,h,p), states (b,nc,h,p,n)."""
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "ref" or xr.device.type == "cpu":
        return ssd_intra_chunk_ref(xr, dtr, dA_cs, Br, Cr)
    return kernel.ssd_intra_chunk(xr, dtr, dA_cs, Br, Cr)
