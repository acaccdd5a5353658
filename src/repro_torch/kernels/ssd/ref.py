"""Plain version of the SSD intra-chunk kernel, in torch einsums.

Port of ``repro.models.mamba2.ssd_intra_chunk_ref`` (``mamba2.py:108``),
the oracle of the Pallas kernel.  The CPU path runs it; on the card
tests and ``chip_smoke.py`` run it to hold the kernel against it, and
the kernel's backward (``ops.SSDIntraChunk``) is its vector-Jacobian
product.
"""
from __future__ import annotations

import torch


def ssd_intra_chunk_ref(xr, dtr, dA_cs, Br, Cr):
    """xr: (b,nc,l,h,p) f32; dtr: (b,nc,l,h); dA_cs: (b,nc,l,h) cumsum of
    dt*A; Br, Cr: (b,nc,l,n).  Returns y_diag (b,nc,l,h,p) and the
    per-chunk state contributions (b,nc,h,p,n)."""
    # decay from position j to i (i >= j): exp(dA_cs[i] - dA_cs[j]).
    # Above the diagonal seg > 0 may overflow exp; it is masked to -inf
    # *before* the exp (exp(-inf) = 0), which gives the reference's
    # values bit for bit, and a gradient: a select after the exp would
    # send 0 * exp(seg) = 0 * inf = nan back into dA_cs
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]  # (b,nc,i,j,h)
    l = xr.shape[2]
    mask = torch.tril(torch.ones(l, l, dtype=torch.bool, device=xr.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], seg,
                                  -torch.inf))
    cb = torch.einsum("bcin,bcjn->bcij", Cr, Br)               # (b,nc,i,j)
    att = cb[..., None] * decay                                # (b,nc,i,j,h)
    xdt = xr * dtr[..., None]                                  # (b,nc,l,h,p)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", att, xdt)
    # state contribution of this chunk: sum_j exp(dA_cs[-1]-dA_cs[j]) B_j x_j
    w = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)                 # (b,nc,l,h)
    states = torch.einsum("bcln,bclhp->bchpn", Br, xdt * w[..., None])
    return y_diag, states
