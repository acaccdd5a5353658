"""input_specs(): abstract stand-ins + shardings per (arch x shape).

Port of ``repro.launch.specs``.  The abstract args are meta tensors
where the reference has ``ShapeDtypeStruct``s: the train state
(``model_zoo.abstract_state``), the batch (``batch_spec``'s shapes and
dtypes), and for prefill and decode the parameters in the serving layout
that ``cell_fn``'s functions read (``abstract_serving_params``) and the
decode state (``abstract_decode_state``), so that ``cell_fn(cfg,
shape)(*input_specs(cfg, shape, rules)["args"])`` runs on them.  The
shardings are ``launch.sharding.NamedSharding``s, whose specs are the
reference's ``PartitionSpec``s entry for entry (the parameters' in the
reference's stacked layout).  No device allocation happens here.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.sharding import (NamedSharding, ShardingRules,
                                         param_shardings, zero1_extend,
                                         zero1_shardings)
from repro_torch.models import model_zoo as zoo
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWState


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig,
                    rules: ShardingRules):
    spec = zoo.batch_spec(cfg, shape)
    return {
        k: rules.sharding(("batch",) + (None,) * (len(v.shape) - 1), v.shape)
        for k, v in spec.items()
    }


def params_shardings(cfg: ModelConfig, rules: ShardingRules):
    return param_shardings(rules, T.model_schema(cfg))


_zero1_extend = zero1_extend  # re-export (tests import from here)


def state_shardings(cfg: ModelConfig, rules: ShardingRules):
    psh = params_shardings(cfg, rules)
    if cfg.zero1:
        opt_one = zero1_shardings(rules, T.model_schema(cfg))
    else:
        opt_one = psh
    return zoo.TrainState(
        step=NamedSharding(rules.mesh, ()),
        params=psh,
        opt=AdamWState(m=opt_one, v=opt_one),
    )


decode_state_shardings = zoo.decode_state_shardings


def metrics_shardings(rules: ShardingRules):
    rep = NamedSharding(rules.mesh, ())
    return {k: rep for k in ("loss", "nll", "aux", "grad_norm")}


def abstract_batch(cfg: ModelConfig, shape: ShapeConfig):
    """``batch_spec``'s inputs as meta tensors."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in zoo.batch_spec(cfg, shape).items()}


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                rules: ShardingRules) -> Dict[str, Any]:
    """Everything a launcher needs to run a cell at scale.

    Returns dict with: kind, abstract args, in_shardings, out_shardings.
    """
    rep = NamedSharding(rules.mesh, ())
    if shape.kind == "train":
        args = (zoo.abstract_state(cfg), abstract_batch(cfg, shape))
        in_sh = (state_shardings(cfg, rules),
                 batch_shardings(cfg, shape, rules))
        out_sh = (state_shardings(cfg, rules), metrics_shardings(rules))
        return dict(kind="train", args=args, in_shardings=in_sh,
                    out_shardings=out_sh)
    params = zoo.abstract_serving_params(cfg)
    if shape.kind == "prefill":
        args = (params, abstract_batch(cfg, shape))
        in_sh = (params_shardings(cfg, rules),
                 batch_shardings(cfg, shape, rules))
        out_sh = (rep, decode_state_shardings(cfg, shape, rules))
        return dict(kind="prefill", args=args, in_shardings=in_sh,
                    out_shardings=out_sh)
    if shape.kind == "decode":
        args = (params, zoo.abstract_decode_state(cfg, shape),
                abstract_batch(cfg, shape))
        dsh = decode_state_shardings(cfg, shape, rules)
        in_sh = (params_shardings(cfg, rules), dsh,
                 batch_shardings(cfg, shape, rules))
        out_sh = (rep, dsh)
        return dict(kind="decode", args=args, in_shardings=in_sh,
                    out_shardings=out_sh)
    raise ValueError(shape.kind)


def cell_fn(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """The function a cell runs, with the reference's signature:
    ``train_step(state, batch)``, ``prefill(params, batch)`` or
    ``serve_step(params, state, batch)`` with ``batch = {"tokens",
    "active"}``.  (The reference's ``unroll`` flag straightens its scans
    for XLA's cost analysis; the port's layers and micro-batches are
    Python loops already.)  ``mesh``: this rank's program over a
    ``("data", "model")`` ``DeviceMesh``, which every rank of it runs:
    it takes the rank's blocks of the state or parameters and decode
    state (``DataParallel.place``, ``model_zoo.serving_params``,
    ``ServingMesh.place_state``) and the global batch."""
    if shape.kind == "train":
        return zoo.make_train_step(cfg, mesh=mesh)
    if shape.kind == "prefill":
        return zoo.make_prefill(cfg, shape, mesh=mesh)
    if shape.kind == "decode":
        step = zoo.make_serve_step(cfg, shape, mesh=mesh)

        def serve_step(params, state, batch):
            return step(params, state, batch["tokens"], batch.get("active"))
        return serve_step
    raise ValueError(shape.kind)
