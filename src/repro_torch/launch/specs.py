"""input_specs(): abstract stand-ins + shardings per (arch x shape).

Port of ``repro.launch.specs``.  The abstract args are meta tensors
(``model_zoo.abstract_state``, ``abstract_decode_state``) and the
batch's ``ArraySpec``s, where the reference has ``ShapeDtypeStruct``s;
the shardings are ``launch.sharding.NamedSharding``s, whose specs are the
reference's ``PartitionSpec``s entry for entry.  No device allocation
happens here.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.sharding import (NamedSharding, ShardingRules,
                                         param_shardings, zero1_extend,
                                         zero1_shardings)
from repro_torch.models import model_zoo as zoo
from repro_torch.models import transformer as T
from repro_torch.models.schema import abstract_params
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


def decode_state_shardings(cfg: ModelConfig, shape: ShapeConfig,
                           rules: ShardingRules):
    ab = zoo.abstract_decode_state(cfg, shape)
    ax = zoo.decode_state_logical_axes(cfg)
    cache_sh = {k: rules.sharding(ax.cache[k], v.shape)
                for k, v in ab.cache.items()}
    return zoo.DecodeState(cache_sh,
                           rules.sharding(ax.cache_len,
                                          (shape.global_batch,)))


def metrics_shardings(rules: ShardingRules):
    rep = NamedSharding(rules.mesh, ())
    return {k: rep for k in ("loss", "nll", "aux", "grad_norm")}


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                rules: ShardingRules) -> Dict[str, Any]:
    """Everything a launcher needs to run a cell at scale.

    Returns dict with: kind, abstract args, in_shardings, out_shardings.
    """
    rep = NamedSharding(rules.mesh, ())
    if shape.kind == "train":
        args = (zoo.abstract_state(cfg), zoo.batch_spec(cfg, shape))
        in_sh = (state_shardings(cfg, rules),
                 batch_shardings(cfg, shape, rules))
        out_sh = (state_shardings(cfg, rules), metrics_shardings(rules))
        return dict(kind="train", args=args, in_shardings=in_sh,
                    out_shardings=out_sh)
    params = abstract_params(T.model_schema(cfg), cfg.param_dtype)
    if shape.kind == "prefill":
        args = (params, zoo.batch_spec(cfg, shape))
        in_sh = (params_shardings(cfg, rules),
                 batch_shardings(cfg, shape, rules))
        out_sh = (rep, decode_state_shardings(cfg, shape, rules))
        return dict(kind="prefill", args=args, in_shardings=in_sh,
                    out_shardings=out_sh)
    if shape.kind == "decode":
        args = (params, zoo.abstract_decode_state(cfg, shape),
                zoo.batch_spec(cfg, shape))
        dsh = decode_state_shardings(cfg, shape, rules)
        in_sh = (params_shardings(cfg, rules), dsh,
                 batch_shardings(cfg, shape, rules))
        out_sh = (rep, dsh)
        return dict(kind="decode", args=args, in_shardings=in_sh,
                    out_shardings=out_sh)
    raise ValueError(shape.kind)


def cell_fn(cfg: ModelConfig, shape: ShapeConfig):
    """The function a cell runs.  (The reference's ``unroll`` flag
    straightens its scans for XLA's cost analysis; the port's layers and
    micro-batches are Python loops already.)"""
    if shape.kind == "train":
        return zoo.make_train_step(cfg)
    if shape.kind == "prefill":
        return zoo.make_prefill(cfg, shape)
    if shape.kind == "decode":
        return zoo.make_serve_step(cfg, shape)
    raise ValueError(shape.kind)
