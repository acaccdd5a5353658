"""Plain versions of the flash-attention kernel, in torch ops.

Port of ``repro/kernels/flash_attention/ref.py`` (``flash_ref``, the
model's ``full_attention`` in the heads-major layout) plus
``flash_attention_ref``: the arithmetic of the Pallas kernel
``_flash_kernel`` (``repro/kernels/flash_attention/kernel.py:25``) in
plain ops, block for block.  The CPU path of ``ops.attention`` runs
``flash_attention_ref``; on the card only tests and ``chip_smoke.py``
do, to hold the kernel against it.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import NEG_INF, attention_blocks, full_attention


def flash_ref(q, k, v, *, causal=True):
    """q: (B, H, S, D) heads-major -> (B, H, S, D), via full_attention."""
    out = full_attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def flash_attention_ref(q, k, v, *, causal=True, block_q=512, block_kv=512):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) heads-major -> (B, H, Sq, D)
    in q's dtype.

    ``_flash_kernel`` line for line: q, k and v upcast to float32; for
    each q block an online softmax over the kv blocks with a ``-1e30``
    initial max and ``-1e30`` on masked scores; causal kv blocks past
    the diagonal (``ik * bkv > iq * bq + bq - 1``) skipped; ``p`` kept in
    float32 for ``p @ v``; output ``acc / max(l, 1e-30)``.  The grid's
    (batch, head) dimensions are batch dimensions of one product, the
    GQA group broadcast over its kv head."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    bq, bkv = attention_blocks(sq, sk, block_q, block_kv)
    scale = d ** -0.5
    qf = q.float().reshape(b, kv, g, sq, d)
    kf = k.float()[:, :, None]                      # (B, KV, 1, Sk, D)
    vf = v.float()[:, :, None]
    out = torch.empty((b, kv, g, sq, d), dtype=q.dtype, device=q.device)
    for iq in range(sq // bq):
        qi = qf[..., iq * bq:(iq + 1) * bq, :]
        acc = torch.zeros((b, kv, g, bq, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, kv, g, bq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        qpos = iq * bq + torch.arange(bq, device=q.device)
        for ik in range(sk // bkv):
            if causal and ik * bkv > iq * bq + bq - 1:
                continue
            ki = kf[..., ik * bkv:(ik + 1) * bkv, :]
            vi = vf[..., ik * bkv:(ik + 1) * bkv, :]
            s = torch.matmul(qi, ki.transpose(-1, -2)) * scale
            if causal:
                kpos = ik * bkv + torch.arange(bkv, device=q.device)
                s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vi)
            m = m_new
        out[..., iq * bq:(iq + 1) * bq, :] = (
            acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.reshape(b, h, sq, d)
