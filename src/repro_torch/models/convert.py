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
  stays as it is; the enc_dec family's ``enc_layers`` and
  ``dec_layers`` become two such lists;
* matmul and embedding weights, and Mamba2's ``D``, ``conv_w`` and
  ``conv_b``, are cast to ``compute_dtype`` once, here;
* norm weights, Mamba2's ``A_log`` and ``dt_bias`` and the MoE
  ``router`` stay float32: the reference upcasts them at use, and
  rounding ``A_log`` or ``dt_bias`` to bf16 would change ``A`` and
  ``dt``, and rounding ``router`` would change the routing.

Casting once at load gives the same values as the reference's per-use
``.astype(dt)``, value for value: both round the same float32 numbers
to ``compute_dtype`` with round-to-nearest-even.

Training keeps the reference's own layout instead (``model_zoo.
TrainState``: stacked, float32 masters, leaf for leaf the JAX tree) and
reaches this one through ``compute_view``, a differentiable cast and
unstack made once per micro-batch.
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
    """``x`` cast by the rule above, on ``device`` (None: where it is)."""
    t = torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x
    dt = (torch.float32 if _keeps_float32(key)
          else dtype_of(cfg.compute_dtype))
    return t.to(device=device or t.device, dtype=dt)


def _convert(tree, cfg: ModelConfig, device):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _convert(val, cfg, device)
        else:
            out[key] = _leaf(val, key, cfg, device)
    return out


def _unbind(tree, n: int):
    """A tree stacked on a leading axis of ``n`` -> ``n`` trees of views.

    Each leaf is unbound once (``Tensor.unbind``), so that a gradient
    into the views goes back to the stacked leaf in one stack (an index
    per layer would scatter a zero-filled copy of the whole leaf per
    layer)."""
    split = {k: _unbind(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _layout(params, cfg: ModelConfig):
    """The stacked tree -> the eager layout (see ``params_from_numpy``)."""
    params = dict(params)
    if cfg.family == "hybrid":
        periods = cfg.num_layers // cfg.attn_every
        params["mamba"] = [_unbind(p, cfg.attn_every)
                           for p in _unbind(params.pop("mamba"), periods)]
    elif cfg.family == "enc_dec":
        params["enc_layers"] = _unbind(params.pop("enc_layers"),
                                       cfg.enc_layers)
        params["dec_layers"] = _unbind(params.pop("dec_layers"),
                                       cfg.dec_layers)
    else:
        params["layers"] = _unbind(params.pop("layers"), cfg.num_layers)
    return params


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """A parameter tree of any family -> the port's params.

    ``tree`` is the JAX parameter tree handed over as nested dicts of
    numpy arrays (``jax.tree.map(np.asarray, params)``), or the same tree
    of tensors as ``model_zoo.init_serving_params`` draws it.  ``layers``
    (dense, vlm, moe, ssm) becomes a list of ``cfg.num_layers`` per-layer
    dicts; ``mamba`` (hybrid) a list of ``periods`` lists of
    ``attn_every`` dicts; ``enc_layers`` and ``dec_layers`` (enc_dec)
    lists of ``cfg.enc_layers`` dicts (``attn``, ``mlp``) and
    ``cfg.dec_layers`` dicts (``self_attn``, ``cross_attn``, ``mlp``).
    The dicts hold views of the stacked tensors.  ``device=None`` keeps
    each tensor where it is (meta tensors stay meta)."""
    dev = None if device is None else resolve_device(device)
    return _layout(_convert(tree, cfg, dev), cfg)


def compute_view(params, cfg: ModelConfig):
    """The training layout -> the layout every layer function reads.

    ``params`` is a ``TrainState``'s tree: the reference's stacked tree,
    leaf for leaf and in ``param_dtype`` (float32 masters).  Returns
    ``params_from_numpy``'s layout on the same device, through
    differentiable ops only (a cast per leaf by this module's rule, then
    views), so a loss over it sends each gradient back to its float32
    master through the cast, as the reference's per-use ``.astype(dt)``
    does.  A tied embedding is used twice in the reference, each use
    with its own cast, and JAX sums the two float32 cotangents; so here
    the output projection gets a cast of its own (``lm_head``, a
    transposed view), and the two cotangents meet in float32 at the
    master, not in the compute dtype.  An enc_dec model has an
    ``lm_head`` of its own whatever ``tie_embeddings`` says, and keeps
    it.  Called once per micro-batch."""
    view = _convert(params, cfg, None)
    if cfg.tie_embeddings and "lm_head" not in view:
        view["lm_head"] = _leaf(params["embed"], "embed", cfg, None).t()
    return _layout(view, cfg)
