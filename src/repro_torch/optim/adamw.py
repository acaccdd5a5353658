"""AdamW with cosine schedule, warmup and global-norm clipping.

Port of ``repro.optim.adamw``: plain functions on trees of tensors
(nested dicts, leaves in sorted-key order as ``jax.tree.leaves`` gives
them), not ``torch.optim.AdamW``, which orders the same arithmetic
differently.  Every step of the reference's formula is kept in its
order, in float32: clip by the global norm, warmup then cosine, bias
correction, ``delta = mh / (sqrt(vh) + eps) + wd * p``, and ``p - lr *
delta`` computed in float32 and cast back to p's dtype.  m and v are
float32.  ``step`` is a 0-d integer tensor, as the reference's is, and
the schedule is computed from it on its device, so a step needs no host
read.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch


class HParams(NamedTuple):
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    m: Any
    v: Any


def flatten(tree) -> Tuple[List[torch.Tensor], Callable]:
    """The leaves of a tree of nested dicts in ``jax.tree.leaves`` order
    (sorted keys), and a function that builds the same tree from a list
    of new leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
        leaves = [leaf for ls, _ in parts for leaf in ls]

        def rebuild(new):
            out, i = {}, 0
            for k, (ls, sub) in zip(keys, parts):
                out[k] = sub(new[i:i + len(ls)])
                i += len(ls)
            return out
        return leaves, rebuild
    return [tree], lambda new: new[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    leaves, rebuild = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return rebuild([fn(*xs) for xs in zip(leaves, *others)])


def init(params) -> AdamWState:
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(tree_map(z, params), tree_map(z, params))


def global_norm(tree) -> torch.Tensor:
    leaves, _ = flatten(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def schedule(step: torch.Tensor, hp: HParams) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor), float32: linear
    warmup from 0, then a cosine to 0 at ``total_steps``."""
    step = step.float()
    warm = hp.lr * step / max(hp.warmup_steps, 1)
    frac = torch.clamp((step - hp.warmup_steps)
                       / max(hp.total_steps - hp.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * hp.lr * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < hp.warmup_steps, warm, cos)


@torch.no_grad()
def update(params, grads, state: AdamWState, step: torch.Tensor,
           hp: HParams, gnorm: Optional[torch.Tensor] = None):
    """One AdamW step.  Returns ``(new_params, AdamWState(m, v))``, new
    trees; the arguments are not modified.  ``gnorm``: the gradient's
    global norm when ``grads`` holds only this rank's ZeRO-1 blocks of
    it (``model_zoo.DataParallel.norm``); by default ``global_norm(
    grads)``.  The update is elementwise, so on blocks of the params, m
    and v it computes those blocks of the whole update."""
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp(hp.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(step, hp)
    t = (step + 1).float()
    bc1 = 1.0 - hp.b1 ** t
    bc2 = 1.0 - hp.b2 ** t

    def upd(p, g, m, v):
        g = g.float() * scale
        m = hp.b1 * m + (1 - hp.b1) * g
        v = hp.b2 * v + (1 - hp.b2) * torch.square(g)
        del g
        p32 = p.float()
        # delta = mh / (sqrt(vh) + eps) + wd * p, in place on temporaries
        # of its own: the reference's arithmetic, in its order
        denom = (v / bc2).sqrt_().add_(hp.eps)
        delta = (m / bc1).div_(denom)
        del denom
        delta.add_(hp.weight_decay * p32)
        return (p32 - lr * delta).to(p.dtype), m, v

    flat_p, rebuild = flatten(params)
    flat_g = flatten(grads)[0]
    flat_m = flatten(state.m)[0]
    flat_v = flatten(state.v)[0]
    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = rebuild([o[0] for o in out])
    new_m = rebuild([o[1] for o in out])
    new_v = rebuild([o[2] for o in out])
    return new_p, AdamWState(new_m, new_v)
