"""Declarative parameter schemas.

A schema is a nested dict mapping param name -> ``Spec(shape, axes, init)``:

* ``shape``  — global shape
* ``axes``   — logical axis name per dim (``'layers'`` marks the stacked
               layer axis); ``None`` = a plain axis
* ``init``   — 'normal' (1/sqrt(fan_in)), 'embed', 'zeros', 'ones',
               'ssm_a', 'ssm_dt'

The same trees as ``repro.models.schema``; ``init_params`` follows the
same rules but draws from a ``torch.Generator``, so its values differ
from JAX's stream (tests carry JAX's params across with
``models.convert.params_from_numpy`` instead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import dtype_of, resolve_device


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"
    dtype: Optional[str] = None  # override param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def _leaves(schema):
    """Specs of a schema in a fixed (sorted-key) order."""
    if is_spec(schema):
        yield schema
        return
    for k in sorted(schema):
        yield from _leaves(schema[k])


def map_specs(fn, schema):
    """``fn`` over every spec of ``schema``: the schema's nested dict with
    its results in place of the specs (sorted-key order)."""
    if is_spec(schema):
        return fn(schema)
    return {k: map_specs(fn, schema[k]) for k in sorted(schema)}


def _fan_in(spec: Spec) -> int:
    # Last dim is fan-out by convention; everything else but stacking dims
    # ('layers', 'periods', 'stack') contributes to fan-in.
    fan = 1
    for dim, ax in zip(spec.shape[:-1], spec.axes[:-1]):
        if ax not in ("layers", "periods", "stack"):
            fan *= dim
    return max(fan, 1)


def init_one(spec: Spec, generator: torch.Generator, device,
             dtype) -> torch.Tensor:
    dt = dtype_of(spec.dtype or dtype)
    f32 = torch.float32

    def normal():
        return torch.randn(spec.shape, generator=generator, device=device,
                           dtype=f32)

    def uniform(lo, hi):
        u = torch.rand(spec.shape, generator=generator, device=device,
                       dtype=f32)
        return lo + (hi - lo) * u

    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "embed":
        return normal().mul_(0.02).to(dt)
    if spec.init == "ssm_a":  # A_log: log of A in [1, 16]
        return torch.log(uniform(1.0, 16.0)).to(dt)
    if spec.init == "ssm_dt":  # dt_bias: softplus^-1 of dt in [1e-3, 1e-1]
        dtv = torch.exp(uniform(math.log(1e-3), math.log(1e-1)))
        return (dtv + torch.log(-torch.expm1(-dtv))).to(dt)
    scale = 1.0 / math.sqrt(_fan_in(spec))
    return normal().mul_(scale).to(dt)


def init_params(schema, generator: torch.Generator, device="cuda",
                dtype="float32"):
    """Draw every leaf of ``schema`` on ``device`` (sorted-key order).

    ``generator`` must live on ``device`` (``torch.Generator(device)``).
    Returns the schema's nested dict with tensors in place of specs.
    """
    dev = resolve_device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    return map_specs(lambda s: init_one(s, generator, dev, dtype), schema)


def abstract_params(schema, dtype="float32"):
    """The params ``init_params`` would draw, as meta tensors (shape and
    dtype, no storage): the counterpart of the reference's
    ``ShapeDtypeStruct`` tree."""
    return map_specs(lambda s: torch.empty(
        s.shape, dtype=dtype_of(s.dtype or dtype), device="meta"), schema)


def count_params(schema) -> int:
    return int(sum(np.prod(s.shape) for s in _leaves(schema)))
