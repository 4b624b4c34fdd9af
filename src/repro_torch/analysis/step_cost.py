"""Per-rank cost of one step, traced on fake tensors: the counterpart of
``repro.analysis.hlo_cost``.

The reference walks XLA's compiled, partitioned HLO of a step. The port
has no HLO: :func:`trace_step` runs the step eagerly under a
``TorchDispatchMode`` that sees every aten operation (forward, backward
and rematerialised recompute alike, so no trip counts are needed) and
counts the matmul FLOPs with ``FlopCounterMode``'s own formulas (its
``flop_registry``, applied in the same mode: a second Python mode would
double the trace's cost per operation), with the hand kernels' calls on
fake tensors
recorded by their wrappers (:func:`repro_torch.kernels._build.record`)
and the collectives counted where the port makes them
(:data:`repro_torch.distributed.collectives.WIRE`). Per rank, as the
reference's numbers are per device:

* ``dot_flops`` — ``FlopCounterMode``'s FLOPs (its registry: mm, addmm,
  bmm, baddbmm, convolution and attention operations, 2·M·N·K each) plus
  the hand kernels' own (the work each kernel does over the blocks it
  visits, from the cost function beside it);
* ``flops`` — ``dot_flops`` plus one per output element of every other
  operation that is not a view or an ``empty`` (elementwise, reductions,
  data movement; transcendentals count one), as ``hlo_cost`` counts them;
* ``hbm_bytes`` — the operand plus result bytes at every aten operation
  and kernel boundary. These are eager PyTorch's boundaries, not XLA's
  fusions (an XLA fusion keeps its intermediates on chip), so this
  figure is not comparable with the reference's and is not compared;
* ``collectives`` — the five names of the reference's table, filled from
  the ``torch.distributed`` calls the port makes (``all-gather``,
  ``all-to-all``; its psum is one of each, and it makes no
  ``all-reduce``, ``reduce-scatter`` or ``collective-permute`` call),
  with operand and result bytes and their totals;
* ``kernels`` — the hand kernels' calls, FLOPs and bytes, by kernel.

:attr:`StepCost.memory` has the reference's memory-summary keys.
``argument_size_in_bytes`` is the bytes of the storages the arguments
hold, ``output_size_in_bytes`` those of the outputs' storages,
``alias_size_in_bytes`` the outputs' bytes whose storage is an
argument's (the state updated in place, the cache written in place),
``temp_size_in_bytes`` the peak of the bytes of the storages made during
the step that are live at once, the outputs' left out (each storage is
tracked from the operation that makes it until ``weakref.finalize``
sees it freed), and ``per_device_hbm_bytes`` the reference's ``argument
+ output + temp − alias``. ``peak_bytes`` adds the arguments to the
peak of every storage made during the step, the outputs' included: what
a caching allocator's high-water mark over the step would read.
"""
from __future__ import annotations

import copy
import dataclasses
import weakref
from typing import Any, Dict, Iterator, List, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import collectives as C
from repro_torch.kernels import _build

__all__ = ["COLLECTIVES", "StepCost", "tensors_of", "trace_step"]

#: The reference's collective names (``hlo_cost._COLLECTIVES``), and the
#: ``WIRE`` entry each is read from (None: the port makes no such call).
COLLECTIVES = {"all-gather": "all-gather", "all-reduce": "all-reduce",
               "reduce-scatter": None, "all-to-all": "all-to-all",
               "collective-permute": None}

#: Operations that allocate without writing (views are told apart by
#: ``OpOverload.is_view``), and a tensor's device query.
_EMPTY = {torch.ops.aten.empty.memory_format,
          torch.ops.aten.empty_like.default,
          torch.ops.aten.empty_strided.default,
          torch.ops.aten.new_empty.default,
          torch.ops.aten.new_empty_strided.default}
_DEVICE = torch.ops.prim.device.default


@dataclasses.dataclass
class StepCost:
    flops: float = 0.0
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    #: the ``torch.distributed`` calls (``WIRE``) and the port's own
    #: operations (``COUNTS``: all_gather, psum_scatter, psum)
    wire: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    by_op: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    memory: Dict[str, int] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        """``hlo_cost.HloCost.as_dict()``'s keys, and the kernel table."""
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "hbm_bytes": self.hbm_bytes,
                "collectives": copy.deepcopy(self.collectives),
                "kernels": copy.deepcopy(self.kernels)}


def tensors_of(obj) -> Iterator[torch.Tensor]:
    """Every tensor in ``obj``: tensors, modules' parameters and buffers
    (not their ``.grad``: a step's gradients are its temporaries), dicts,
    lists, tuples, named tuples and dataclasses (a cache)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors_of(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors_of(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors_of(getattr(obj, f.name))


def _storages(obj) -> Dict[int, Tuple[Any, int]]:
    """``{id: (storage, bytes)}`` of the distinct storages ``obj`` holds."""
    out = {}
    for t in tensors_of(obj):
        s = t.untyped_storage()
        out.setdefault(id(s), (s, s.nbytes()))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(xs) -> Iterator[torch.Tensor]:
    """The tensors of an operation's arguments or outputs (tensors, and
    lists and tuples of them)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _flat(x)


class _Tracer(TorchDispatchMode):
    """Counts the dot FLOPs, the other operations' FLOPs and the boundary
    bytes of every operation and follows the storages made during the step
    (a serial number each, and a timeline of their births and frees)."""

    def __init__(self, arg_ids):
        super().__init__()
        self.arg_ids = set(arg_ids)
        self.dot_flops = 0.0
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.serial: Dict[int, Tuple[int, int]] = {}   # id → (serial, bytes)
        self.events: List[Tuple[int, int]] = []        # (serial, ±bytes)
        self._next = 0

    def _free(self, key: int) -> None:
        serial, n = self.serial.pop(key)
        self.events.append((serial, -n))

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self.arg_ids or key in self.serial:
            return
        n = s.nbytes()
        self.serial[key] = (self._next, n)
        self.events.append((self._next, n))
        self._next += 1
        weakref.finalize(s, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _DEVICE:
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = list(_flat((out,)))
        for t in outs:
            self._track(t)
        if func in _EMPTY or func.is_view:
            return out
        ins = _flat((args, tuple(kwargs.values())))
        self.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.dot_flops += count(*args, **kwargs, out_val=out)
        elif func.namespace != "c10d":
            self.flops += sum(t.numel() for t in outs)
        return out

    def output_serials(self, out) -> set:
        return {self.serial[id(s)][0] for s, _ in _storages(out).values()
                if id(s) in self.serial}

    def peak(self, leave_out=frozenset()) -> int:
        live = top = 0
        for serial, n in self.events:
            if serial not in leave_out:
                live += n
                top = max(top, live)
        return top


def _diff(after: dict, before: dict) -> dict:
    return {op: {k: v - before[op][k] for k, v in c.items()}
            for op, c in after.items()}


def trace_step(fn, *args):
    """Run ``fn(*args)`` on fake tensors (in the caller's
    ``FakeTensorMode``) and return ``(StepCost, output)``: its per-rank
    FLOPs, bytes, collectives, kernel calls and memory (module
    docstring)."""
    arg_storages = _storages(args)
    kernels: Dict[str, Dict[str, float]] = {}

    def on_kernel(name: str, cost: _build.KernelCost) -> None:
        k = kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                      "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += cost.flops
        k["bytes"] += cost.bytes

    wire0, ops0 = copy.deepcopy(C.WIRE), copy.deepcopy(C.COUNTS)
    tracer = _Tracer(arg_storages)
    with _build.recording(on_kernel), tracer:
        out = fn(*args)
    wire, by_op = _diff(C.WIRE, wire0), _diff(C.COUNTS, ops0)

    kernel_flops = sum(k["flops"] for k in kernels.values())
    cost = StepCost(
        dot_flops=tracer.dot_flops + kernel_flops,
        hbm_bytes=tracer.hbm_bytes + sum(k["bytes"]
                                         for k in kernels.values()),
        kernels=kernels, wire=wire, by_op=by_op)
    cost.flops = cost.dot_flops + tracer.flops
    colls = {}
    for name, src in COLLECTIVES.items():
        w = wire.get(src) if src else None
        colls[name] = {"count": w["calls"] if w else 0,
                       "operand_bytes": w["operand_bytes"] if w else 0,
                       "result_bytes": w["result_bytes"] if w else 0}
    cost.collectives = {
        **colls,
        "total_operand_bytes": sum(v["operand_bytes"]
                                   for v in colls.values()),
        "total_result_bytes": sum(v["result_bytes"]
                                  for v in colls.values())}

    outs = _storages(out)
    args_b = sum(n for _, n in arg_storages.values())
    out_b = sum(n for _, n in outs.values())
    alias_b = sum(n for key, (_, n) in outs.items() if key in arg_storages)
    temp_b = tracer.peak(tracer.output_serials(out))
    cost.memory = {
        "argument_size_in_bytes": args_b,
        "output_size_in_bytes": out_b,
        "temp_size_in_bytes": temp_b,
        "alias_size_in_bytes": alias_b,
        "per_device_hbm_bytes": args_b + out_b + temp_b - alias_b,
        "peak_bytes": args_b + tracer.peak(),
    }
    return cost, out
