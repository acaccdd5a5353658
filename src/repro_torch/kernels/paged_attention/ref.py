"""Plain version of the paged-attention kernel: gather + the model's math.

Gathers each lane's blocks (through its block table) into the contiguous
``(B, S, KV, D)`` layout the dense cache uses and runs the exact
``full_attention`` call of ``layers.decode_attention``.  Positions at or
beyond ``kv_len`` get an exact-zero softmax weight, so the gathered
garbage in unallocated / sentinel blocks contributes nothing and the
result equals the dense decode path bit for bit.
"""
from __future__ import annotations

from repro_torch.models.layers import full_attention


def gather_pages(pool, block_tables):
    """(num_blocks, bs, ...) + (B, max_blocks) -> (B, max_blocks*bs, ...).

    Sentinel / out-of-range table entries are clamped into the pool (the
    caller masks those positions via ``kv_len``), so a partially filled
    table is safe to gather.
    """
    nb = pool.shape[0]
    rows = pool[block_tables.clamp(0, nb - 1).long()]  # (B, mb, bs, ...)
    b, mb, bs = rows.shape[:3]
    return rows.reshape(b, mb * bs, *rows.shape[3:])


def paged_attention_ref(q, k_pool, v_pool, block_tables, kv_len):
    """q: (B, H, D) one decode token per lane; pools: (num_blocks, bs,
    KV, D); block_tables: (B, max_blocks) int32; kv_len: (B,) valid
    positions per lane.  Returns (B, H, D)."""
    k = gather_pages(k_pool, block_tables)
    v = gather_pages(v_pool, block_tables)
    out = full_attention(q[:, None], k, v, causal=False, kv_len=kv_len)
    return out[:, 0]

