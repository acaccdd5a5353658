"""Hand-written CUDA kernels of the port, each beside its plain version.

Each ctypes wrapper allocates its outputs with ``torch.empty``: a tensor
made so has no place in the autograd graph.  So a wrapper refuses a call
that autograd would record (``refuse_grad``) instead of returning an
output that silently drops the gradient; only the SSD kernel has a
backward (``kernels.ssd.ops.SSDIntraChunk``), and its entry point routes
such calls through it.
"""

import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``RuntimeError`` if grad mode is on and one of ``tensors``
    requires grad: ``kernel`` has no backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, but this kernel has no "
            f"backward, and its output would drop the gradient; call it "
            f"under torch.no_grad(), or on CPU tensors (the plain version, "
            f"which autograd differentiates)")
