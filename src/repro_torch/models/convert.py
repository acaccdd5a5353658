"""Parameter trees into the port's layout.

The JAX package keeps its parameters as one pytree whose per-layer
leaves are stacked on a leading ``layers`` axis, in ``param_dtype``
(float32), and casts each matmul and embedding weight to
``compute_dtype`` at every use (``.astype(dt)`` in ``layers.py`` and
``transformer.py``).  The port stores the tree once, already in the form
its eager loops read:

* the ``layers`` axis is unstacked into a list of per-layer dicts (the
  Python loop over layers replaces ``lax.scan``); the hybrid family's
  ``mamba`` tree, stacked ``(periods, attn_every)``, becomes a list of
  ``periods`` lists of ``attn_every`` dicts, and its ``shared`` block
  stays as it is;
* matmul and embedding weights, and Mamba2's ``D``, ``conv_w`` and
  ``conv_b``, are cast to ``compute_dtype`` once, here;
* norm weights, Mamba2's ``A_log`` and ``dt_bias`` and the MoE
  ``router`` stay float32: the reference upcasts them at use, and
  rounding ``A_log`` or ``dt_bias`` to bf16 would change ``A`` and
  ``dt``, and rounding ``router`` would change the routing.

Casting once at load gives the same values as the reference's per-use
``.astype(dt)``, value for value: both round the same float32 numbers
to ``compute_dtype`` with round-to-nearest-even.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of, resolve_device


FLOAT32_KEYS = ("A_log", "dt_bias", "router")


def _keeps_float32(key: str) -> bool:
    return key == "norm" or key.endswith("_norm") or key in FLOAT32_KEYS


def _leaf(x, key: str, cfg: ModelConfig, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x
    dt = (torch.float32 if _keeps_float32(key)
          else dtype_of(cfg.compute_dtype))
    return t.to(device=device, dtype=dt)


def _convert(tree, cfg: ModelConfig, device):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _convert(val, cfg, device)
        else:
            out[key] = _leaf(val, key, cfg, device)
    return out


def _unstack(tree, i: int):
    return {k: _unstack(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """A dense, moe, ssm or hybrid parameter tree -> the port's params.

    ``tree`` is the JAX parameter tree handed over as nested dicts of
    numpy arrays (``jax.tree.map(np.asarray, params)``), or the same tree
    of tensors as ``model_zoo.init_serving_params`` draws it.  ``layers``
    (dense, moe, ssm) becomes a list of ``cfg.num_layers`` per-layer dicts;
    ``mamba`` (hybrid) a list of ``periods`` lists of ``attn_every``
    dicts.  The dicts hold views of the stacked tensors."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: enc_dec and vlm are "
            f"ROADMAP item 11")
    dev = resolve_device(device)
    params = _convert(tree, cfg, dev)
    if cfg.family == "hybrid":
        stacked = params.pop("mamba")
        periods = cfg.num_layers // cfg.attn_every
        params["mamba"] = [
            [_unstack(_unstack(stacked, i), j) for j in range(cfg.attn_every)]
            for i in range(periods)]
    else:
        stacked = params.pop("layers")
        params["layers"] = [_unstack(stacked, i)
                            for i in range(cfg.num_layers)]
    return params
