"""Hand-written CUDA kernels of the port, each beside its plain version.

Each ctypes wrapper allocates its outputs with ``torch.empty``: a tensor
made so has no place in the autograd graph.  So a wrapper refuses a call
that autograd would record (``refuse_grad``) instead of returning an
output that silently drops the gradient; only the SSD kernel has a
backward (``kernels.ssd.ops.SSDIntraChunk``), and its entry point routes
such calls through it.

Every kernel call, a launch on a card or a call on meta tensors (which
launches nothing), is told to the cost counter in force, if any
(``report``; ``launch.hlo_analysis.CostCounter``), with the FLOPs and
bytes of its ``kernel.cost``.
"""

import torch

# The cost counters in force (``launch.hlo_analysis.CostCounter``),
# innermost last.
counters: list = []


def report(name: str, cost, *args) -> None:
    """Tell the innermost cost counter in force, if any, of one call of
    kernel ``name`` on ``args``: ``cost(*args)`` gives its ``(flops,
    bytes)``.  With no counter in force this is one check."""
    if counters:
        counters[-1].kernel_call(name, *cost(*args))


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
