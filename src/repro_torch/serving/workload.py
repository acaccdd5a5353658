"""Synthetic serving workloads for tests and CLIs.

Port of the request generators of ``repro.serving.workload``: the same
numpy streams, so both packages draw the same requests from one seed.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np

from repro_torch.serving.engine import Request


def synthetic_requests(n: int, vocab_size: int, *, seed: int = 0,
                       prompt_len: Tuple[int, int] = (3, 9),
                       max_new: Union[int, Tuple[int, int]] = (4, 10),
                       start_rid: int = 0) -> List[Request]:
    """``n`` random-token requests; lengths drawn from half-open ranges."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(start_rid, start_rid + n):
        plen = int(rng.integers(*prompt_len))
        new = max_new if isinstance(max_new, int) \
            else int(rng.integers(*max_new))
        reqs.append(Request(rid=rid,
                            prompt=rng.integers(0, vocab_size, plen,
                                                dtype=np.int32),
                            max_new_tokens=new))
    return reqs


def prefill_heavy_requests(n: int, vocab_size: int, *, prompt_len: int = 64,
                           max_new: int = 8, seed: int = 0,
                           start_rid: int = 0) -> List[Request]:
    """Fixed-length long-prompt requests: the prefill-dominated workload.
    All prompts share one length so timing isolates the prefill strategy,
    not workload variance."""
    rng = np.random.default_rng(seed)
    return [Request(rid=rid,
                    prompt=rng.integers(0, vocab_size, prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=max_new)
            for rid in range(start_rid, start_rid + n)]
