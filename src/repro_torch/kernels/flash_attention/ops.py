"""Flash-attention entry point (model layout: (B, S, H, D)).

Dispatch follows the tensor, never a fallback:

* a CUDA tensor launches the hand-written kernel (``kernel.py``), which
  raises on arguments it does not take;
* a CPU tensor runs the plain version ``flash_attention_ref``;
* a meta tensor (a cost trace, ``launch.hlo_analysis``) gets an output
  of the kernel's shape, dtype and strides: the arguments are checked as
  the kernel checks them and the call is reported to the cost counter in
  force with ``kernel.cost``, and nothing is launched, built or run.

``impl="ref"`` asks for the plain version explicitly, wherever the
tensors are: only tests and ``chip_smoke.py`` use it, to hold the kernel
against its plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad, report
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.layers import attention_blocks


def attention(q, k, v, *, causal=True, block_q=512, block_kv=512,
              impl: str = "kernel"):
    """q: (B, S, H, D); k/v: (B, S, KV, D) -> (B, S, H, D).

    The reference's contract holds on both routes: after ``min(block,
    S)``, ``Sq % block_q == 0`` and ``Sk % block_kv == 0``, else
    ``ValueError``.  The plain version computes block by block with these
    sizes; the CUDA kernel tiles with its own (bf16: 128 query rows by
    128 key rows on the tensor cores; float32: 64 by 64) and reads the
    (B, S, H, D) layout through strides, without a transpose.  Its result
    depends on the block sizes only through the order of rounding."""
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    bq, bkv = attention_blocks(q.shape[1], k.shape[1], block_q, block_kv)
    qm, km, vm = (t.transpose(1, 2) for t in (q, k, v))
    if impl == "ref" or q.device.type == "cpu":
        out = flash_attention_ref(qm, km, vm, causal=causal, block_q=bq,
                                  block_kv=bkv)
    elif q.device.type == "meta":
        refuse_grad("flash_attention (no backward kernel)", qm, km, vm)
        kernel.check_args(qm, km, vm, device="meta")
        report("flash_attention", kernel.cost, qm, km, vm, causal)
        out = torch.empty_like(qm)
    else:
        out = kernel.flash_attention(qm, km, vm, causal=causal)
    return out.transpose(1, 2)
