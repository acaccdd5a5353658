"""Paged-attention entry point (decode layout: one token per lane).

Dispatch follows the tensor, never a fallback:

* a CUDA tensor launches the hand-written kernel (``kernel.py``), which
  raises on arguments it does not take;
* a CPU tensor runs the plain version (``ref.py``), which is bit-identical
  to the dense decode path;
* a meta tensor (a cost trace, ``launch.hlo_analysis``) gets an output
  of the kernel's shape and dtype: the arguments are checked as the
  kernel checks them and the call is reported to the cost counter in
  force with ``kernel.cost`` (every lane at its table's full width: a
  meta ``kv_len`` holds no lengths), and nothing is launched, built or
  run.

``impl="ref"`` asks for the plain version explicitly, wherever the
tensors are: only tests and ``chip_smoke.py`` use it, to hold the kernel
against its plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad, report
from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q, k_pool, v_pool, block_tables, kv_len, *,
                    impl: str = "kernel"):
    """q: (B, H, D); pools: (num_blocks, bs, KV, D); block_tables:
    (B, max_blocks) int32 (sentinel entries allowed — clamped);
    kv_len: (B,) int32.  Returns (B, H, D)."""
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "ref" or q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables, kv_len)
    if q.device.type == "meta":
        refuse_grad("paged_attention (a decode kernel, no backward)", q,
                    k_pool, v_pool)
        kernel.check_args(q, k_pool, v_pool, block_tables, kv_len,
                          device="meta")
        report("paged_attention", kernel.cost, q, k_pool, v_pool,
               block_tables, kv_len)
        return torch.empty_like(q)
    return kernel.paged_attention(q, k_pool, v_pool, block_tables, kv_len)
