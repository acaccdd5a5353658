"""Roofline terms counted from one traced run of a function.

Port of ``repro.launch.hlo_analysis``.  The reference reads XLA's
``cost_analysis()`` (FLOPs, bytes) and parses the collectives out of the
compiled HLO text.  The port has no HLO: it runs eagerly, one aten op
after another, so ``CostCounter`` (a ``TorchDispatchMode``) counts what
one run of a function dispatches.  ``launch.dryrun`` runs it on meta
tensors (shapes and dtypes, no storage, nothing computed); on the card
the same run counts the same ops.  Per aten op:

* **FLOPs.**  Products (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions) by ``torch.utils.flop_counter``'s formulas, 2 a
  multiply-add, as XLA counts a dot.  The rest as XLA's cost analysis
  counts it (``HloCostAnalysis``): 1 an output element for elementwise
  arithmetic, comparisons, selects and casts (a ``convert`` counts 1),
  1 an input element for reductions, 0 for the transcendental functions
  (``exp``, ``log``, ``rsqrt``, the trigonometric ones; XLA counts those
  apart as ``transcendentals``), and 0 for copies, views, index ops and
  allocations.  A kernel reached on the way (``kernels.report``) adds
  its ``kernel.cost`` FLOPs and bytes, and its call is counted by name.
* **Bytes accessed.**  Every input and output tensor of an op, read or
  written once (its distinct elements times their size: a broadcast
  dimension once); a view (an op whose outputs alias its inputs and
  write nothing, and ``_unsafe_view``), an allocation (``empty``; the
  0-d constant a Python scalar becomes) and a collective (wire traffic,
  below) count 0.
  The port runs eagerly, so this is its real, unfused traffic: XLA's
  count is of its fused program, and is smaller.
* **Collectives.**  Each ``c10d`` op, as the reference's kind
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), with its result bytes (the all-gather's
  gathered output, the reduce-scatter's scattered block, as the
  reference's partitioned HLO prints them) and its group's size, read
  from its process-group argument.
* **Memory.**  The bytes of every live storage, tracked as storages are
  made (an op's outputs) and freed (a weak reference's callback), from
  the arguments' storages on: the peak is the largest sum.

The constants are the H100 SXM's (NVIDIA's data sheet, dense, at 700 W):
``PEAK_FLOPS`` bf16 on the tensor cores, ``HBM_BW`` and ``LINK_BW``
(NVLink 4: 900 GB/s both ways a card, 450 GB/s each way).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import kernels

# H100 SXM constants (NVIDIA data sheet, dense, 700 W)
PEAK_FLOPS = 989e12        # bf16 FLOP/s a card, tensor cores
HBM_BW = 3.35e12           # bytes/s a card
LINK_BW = 450e9            # bytes/s a card each way (NVLink 4)

_aten = torch.ops.aten
# pointwise ops XLA counts as transcendentals, not FLOPs
_TRANSCENDENTAL = {
    _aten.exp, _aten.exp_, _aten.expm1, _aten.log, _aten.log_, _aten.log1p,
    _aten.log2, _aten.rsqrt, _aten.rsqrt_, _aten.sqrt, _aten.sqrt_,
    _aten.sin, _aten.cos, _aten.tan, _aten.tanh, _aten.erf, _aten.sigmoid}
# a pointwise-tagged op that copies and computes nothing
_COPY = _aten.clone
# allocations, and the 0-d constant a scalar operand becomes
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                _aten.new_empty, _aten.new_empty_strided,
                _aten.scalar_tensor}
# c10d op -> the reference's collective kind
_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute"}


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements ``t`` refers to: a broadcast
    (stride 0) dimension reads its elements once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _is_view(func) -> bool:
    """Every output aliases an input and nothing is written (and
    ``_unsafe_view``, a view whose schema does not say so)."""
    if func.overloadpacket is _aten._unsafe_view:
        return True
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


def _group_size(args) -> int:
    for a in tree_leaves(args):
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith(".ProcessGroup"):
            return torch.distributed.ProcessGroup.unbox(a).size()
    return 1


@dataclasses.dataclass
class Collective:
    kind: str
    result_bytes: int
    group_size: int


def wire_bytes_per_device(c: Collective) -> float:
    """Ring-algorithm bytes each device puts on its links.

    ``result_bytes`` is the per-device result: the gathered output of an
    all-gather, the scattered block of a reduce-scatter."""
    g = c.group_size
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if c.kind == "all-gather":
        # per-device output is g x input; each device sends input*(g-1)
        return c.result_bytes * frac
    if c.kind == "reduce-scatter":
        return c.result_bytes * (g - 1)
    if c.kind == "all-reduce":
        return 2.0 * c.result_bytes * frac
    if c.kind == "all-to-all":
        return c.result_bytes * frac
    if c.kind == "collective-permute":
        return float(c.result_bytes)
    return 0.0


def collective_summary(colls: List[Collective]
                       ) -> Dict[str, Dict[str, float]]:
    """Count, result bytes and wire bytes by kind (the reference's, from
    a counted list where it parses HLO text)."""
    summary: Dict[str, Dict[str, float]] = {}
    for c in colls:
        s = summary.setdefault(c.kind, {"count": 0, "result_bytes": 0,
                                        "wire_bytes": 0.0})
        s["count"] += 1
        s["result_bytes"] += c.result_bytes
        s["wire_bytes"] += wire_bytes_per_device(c)
    return summary


def total_wire_bytes(summary: Dict[str, Dict[str, float]]) -> float:
    return sum(s["wire_bytes"] for s in summary.values())


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_device / LINK_BW

    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant(),
        }


class CostCounter(TorchDispatchMode):
    """FLOPs, bytes, collectives, kernel calls and live memory of what
    runs while it is in force (see the module's docstring).

    ``run(fn, *args)`` is the whole use: it enters the counter, takes
    ``args``' storages as the arguments, calls ``fn`` and takes its
    result's storages as the outputs.  Totals: ``flops``, ``bytes``,
    ``flops_by_op`` (by aten op name, products and the rest apart),
    ``collectives`` (a list of ``Collective``), ``kernels`` (name ->
    calls, flops, bytes) and the memory fields ``memory_stats`` reads."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.flops_by_op: Dict[str, int] = {}
        self.collectives: List[Collective] = []
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.live = self.peak = 0
        self.argument_bytes = self.output_bytes = self.alias_bytes = 0
        self._storages: Dict[int, tuple] = {}
        self._arguments: set = set()

    # ---------------------------------------------------------- memory
    def _free(self, key, _ref):
        entry = self._storages.pop(key, None)
        if entry is not None:
            self.live -= entry[1]

    def _track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = (weakref.ref(
                st, lambda r, k=key: self._free(k, r)), n)
            self.live += n
        self.peak = max(self.peak, self.live)

    # ---------------------------------------------------------- use
    def run(self, fn, *args):
        """``fn(*args)`` under the counter; returns its result."""
        with self:
            ts = _tensors(args)
            self._track(ts)
            self._arguments = {id(t.untyped_storage()) for t in ts}
            self.argument_bytes = sum(
                self._storages[k][1] for k in self._arguments)
            out = fn(*args)
            outs = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                    for t in _tensors(out)}
            self.output_bytes = sum(outs.values())
            self.alias_bytes = sum(n for k, n in outs.items()
                                   if k in self._arguments)
        return out

    def __enter__(self):
        kernels.counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.counters.remove(self)
        return super().__exit__(*exc)

    def kernel_call(self, name: str, flops: int, nbytes: int) -> None:
        """One call of a hand-written kernel (``kernels.report``)."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    # ---------------------------------------------------------- ops
    def _op_flops(self, func, args, kwargs, out) -> int:
        packet = func.overloadpacket
        count = flop_counter.flop_registry.get(packet)
        if count is not None:
            return int(count(*args, **kwargs, out_val=out))
        if packet in _TRANSCENDENTAL or packet is _COPY:
            return 0
        if torch.Tag.pointwise in func.tags:
            return sum(t.numel() for t in _tensors(out))
        if torch.Tag.reduction in func.tags or packet is _aten.cumsum:
            return _tensors(args)[0].numel()
        if packet is _aten._to_copy and "dtype" in kwargs and \
                kwargs["dtype"] != args[0].dtype:
            return args[0].numel()                  # XLA's convert
        return 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._track(outs)
        if func.namespace == "c10d":
            kind = _KINDS.get(func.overloadpacket.__name__)
            if kind is not None:        # args[0]: the result's tensors
                self.collectives.append(Collective(
                    kind, sum(_nbytes(t) for t in _tensors(args[0])),
                    _group_size(args)))
            return out
        if _is_view(func) or func.overloadpacket in _ALLOCATIONS:
            return out
        flops = self._op_flops(func, args, kwargs, out)
        if flops:
            name = str(func.overloadpacket)
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + flops
            self.flops += flops
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in outs)
        return out


def extract_terms(counter: CostCounter) -> Dict[str, object]:
    """The reference's raw terms of one traced run, and the kernels'
    calls by name (with their FLOPs and bytes)."""
    summ = collective_summary(counter.collectives)
    return {
        "flops": float(counter.flops),
        "bytes_accessed": float(counter.bytes),
        "collectives": summ,
        "wire_bytes": total_wire_bytes(summ),
        "kernels": {k: dict(v) for k, v in counter.kernels.items()},
    }


def memory_stats(counter: CostCounter) -> Dict[str, float]:
    """The reference's five keys, as the port measures them: argument
    bytes are the arguments' storages, output bytes the result's, alias
    bytes the result's storages that are also arguments', temp bytes the
    peak of live storage less the arguments, and ``peak_hbm_estimate``
    that peak."""
    return {
        "argument_bytes": counter.argument_bytes,
        "output_bytes": counter.output_bytes,
        "temp_bytes": counter.peak - counter.argument_bytes,
        "alias_bytes": counter.alias_bytes,
        "peak_hbm_estimate": counter.peak,
    }
