"""Parameter trees into the port's layout.

The JAX package keeps its parameters as one pytree whose per-layer
leaves are stacked on a leading ``layers`` axis, in ``param_dtype``
(float32), and casts each matmul and embedding weight to
``compute_dtype`` at every use (``.astype(dt)`` in ``layers.py`` and
``transformer.py``).  The port stores the tree once, already in the form
its eager loops read:

* the ``layers`` axis is unstacked into a list of per-layer dicts (the
  Python loop over layers replaces ``lax.scan``);
* matmul and embedding weights are cast to ``compute_dtype`` once, here;
* norm weights stay float32 (``rms_norm`` upcasts them at use).

Casting once at load gives the same values as the reference's per-use
``.astype(dt)``, value for value: both round the same float32 numbers
to ``compute_dtype`` with round-to-nearest-even.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of, resolve_device


def _is_norm(key: str) -> bool:
    return key == "norm" or key.endswith("_norm")


def _leaf(x, key: str, cfg: ModelConfig, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x
    dt = torch.float32 if _is_norm(key) else dtype_of(cfg.compute_dtype)
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
    """A dense-family parameter tree with a stacked ``layers`` axis -> the
    port's params.

    ``tree`` is the JAX parameter tree handed over as nested dicts of
    numpy arrays (``jax.tree.map(np.asarray, params)``), or the same tree
    of tensors as ``model_zoo.init_serving_params`` draws it.  ``layers``
    becomes a list of ``cfg.num_layers`` per-layer dicts (views of the
    stacked tensors)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1)")
    dev = resolve_device(device)
    params = _convert(tree, cfg, dev)
    stacked = params.pop("layers")
    params["layers"] = [_unstack(stacked, i) for i in range(cfg.num_layers)]
    return params
