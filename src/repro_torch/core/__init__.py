"""The paper's runtime, ported: the stencil half (C1, C2), the stores and
the CloudManager.

- overdecomp:    chare-style tile runtime on the card (C1)
- rates:         measured per-PE rate EWMA
- loadbalance:   Greedy / GreedyRefine, rate-aware (C2)
- checkpointing: memory / device / filesystem stores (C3, C5)
- cloud:         CloudManager, the spot-fleet simulation of the
                 filesystem / reactive / proactive modes (C4, C5)
- spmd_stencil:  the single-grid oracle (the multi-device path is ROADMAP
                 item 13a, third step)
- elastic:       shrink / expand over devices or torch.distributed ranks
"""
