"""The collectives and ops of one step, counted on this rank (the port of
``repro.analysis.hlo`` and of ``repro.analysis.hlo_counter``'s collective
census).

The reference parses a compiled module's HLO text, which is one device's
partitioned program, and sums every ``all-gather`` / ``all-reduce`` /
``reduce-scatter`` / ``all-to-all`` / ``collective-permute``.  The port runs
the step, so :class:`Census` is a ``TorchDispatchMode`` that sees every
``c10d`` and ``_c10d_functional`` op the rank issues, whether the port
calls ``torch.distributed`` itself (``distributed/local.py``, the trainer's
row exchange) or DTensor issues it (``redistribute``, ``full_tensor``).  A
DTensor op is not counted as such: the mode steps aside (returns
``NotImplemented``), DTensor runs it, and the census sees the local ops
and collectives it runs on this rank's shards.  So every count is one
rank's, as the reference's are one device's.

Bytes are each collective's RESULT bytes, as ``hlo.py`` counts them:

  all-reduce          the reduced tensor (equal to its operand)
  all-gather          the gathered tensor: the group size times the operand
  reduce-scatter      this rank's shard: the operand over the group size
  all-to-all          what the rank receives (equal to what it sends when
                      the splits are even)
  collective-permute  a ``recv`` counts the tensor received, a ``send``
                      nothing (its bytes are its peer's ``recv``); a
                      broadcast counts the tensor on every rank, root too

DTensor derives each op's output shape by running the op on fake tensors
of the global shapes (its sharding propagation, cached per op and
layout).  That is no work of this rank, so while a census is entered the
propagation runs with every dispatch mode off: no counter sees it,
whether or not its cache already held the op.  That wraps a private
method of DTensor's (``ShardingPropagator._propagate_tensor_meta_non_cached``,
PyTorch 2.11 and 2.13); importing this module fails where it is missing.

``operand_bytes`` keeps what each collective takes in; the two differ for
all-gather, reduce-scatter and uneven all-to-alls.  ``bytes`` sums every
op's tensor operands and results but views (the roofline's byte count,
``analysis/roofline.count_step``), collectives included, as
``hlo_counter`` adds collective bytes to its byte count; ops that move no
data are left out: metadata queries (``prim::device``, which a fake
tensor dispatches and a real one does not) and a collective's wait.

``hlo_counter``'s ``unknown_trip_counts`` has no counterpart: it counts
while loops whose trip count the compiler did not record, which it then
counts once; eager runs every iteration of every loop, so every iteration
is counted.  Records that carry the field keep it at 0.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# op name -> (kind, where its result is: "out" for the op's return value,
# an argument index for the buffers a c10d op fills in place, None for no
# result; where its operand is)
_OPS = {
    "c10d::allreduce_": ("all-reduce", 0, 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0, 0),
    "c10d::allgather_": ("all-gather", 0, 1),
    "c10d::allgather_coalesced_": ("all-gather", 0, 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 0, 1),
    "c10d::_allgather_base_": ("all-gather", 0, 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 0, 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 0, 1),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 1),
    "c10d::alltoall_": ("all-to-all", 0, 1),
    "c10d::alltoall_base_": ("all-to-all", 0, 1),
    "c10d::broadcast_": ("collective-permute", 0, 0),
    "c10d::recv_": ("collective-permute", 0, 0),
    "c10d::send": ("collective-permute", None, 0),
    "_c10d_functional::all_reduce": ("all-reduce", "out", 0),
    "_c10d_functional::all_reduce_": ("all-reduce", "out", 0),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", "out", 0),
    "_c10d_functional::all_reduce_coalesced_": ("all-reduce", "out", 0),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", "out", 0),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", "out", 0),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", "out", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", "out", 0),
    "_c10d_functional::reduce_scatter_tensor_out": ("reduce-scatter", "out", 0),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter", "out", 0),
    "_c10d_functional::all_to_all_single": ("all-to-all", "out", 0),
    "_c10d_functional::broadcast": ("collective-permute", "out", 0),
    "_c10d_functional::broadcast_": ("collective-permute", "out", 0),
    "_c10d_functional::irecv": ("collective-permute", "out", None),
    "_c10d_functional::isend": ("collective-permute", None, 0),
    # DTensor's Shard(i) -> Shard(j) on the card (on the CPU it gathers)
    "_dtensor::shard_dim_alltoall": ("all-to-all", "out", 0),
}
# hlo_counter's transcendental opcodes, as aten ops
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "rsqrt", "sqrt",
                   "pow", "sigmoid", "sin", "cos", "erf"}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
# ops in those namespaces that move no data: counted nowhere
_UNCOUNTED = ("c10d::barrier", "c10d::monitored_barrier_", "c10d::check_for_nan",
              "_c10d_functional::wait_tensor", "_c10d_functional::_wrap_tensor_autograd")


@dataclasses.dataclass(frozen=True)
class Collective:
    kind: str            # the reference's kind, or the op's name for one not listed
    op: str              # e.g. "c10d::allreduce_"
    bytes: int           # result bytes (see the module's docstring)
    operand_bytes: int


def tensor_bytes(x) -> int:
    """The bytes of every tensor in ``x`` (nested lists, tuples, dicts)."""
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _is_dtensor_op(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


class Census(TorchDispatchMode):
    """Counts, on this rank, every collective (:attr:`collectives`), every
    aten op by name (:attr:`ops`), the bytes of every op but views
    (:attr:`bytes`) and the elements transcendental ops write
    (:attr:`transcendentals`, ``hlo_counter``'s count) while it is
    entered."""

    def __init__(self):
        super().__init__()
        self.collectives: List[Collective] = []
        self.ops: collections.Counter = collections.Counter()
        self.bytes = 0
        self.transcendentals = 0

    def __enter__(self):
        self._quiet = _quiet_propagation()
        self._quiet.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._quiet.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.name().split(".")[0]
        ns = name.split("::")[0]
        if ns == "prim" or name in _UNCOUNTED:
            # metadata (a fake tensor's ``device`` dispatches) and waits
            return out
        if ns in _COLLECTIVE_NAMESPACES or name in _OPS:
            self._collective(name, args, out)
        elif ns == "aten":
            op = func._overloadpacket.__name__
            self.ops[op] += 1
            if op in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in _tensors(out))
        if not func.is_view:
            self.bytes += tensor_bytes(args) + tensor_bytes(kwargs) + tensor_bytes(out)
        return out

    def _collective(self, name, args, out):
        kind, res, opnd = _OPS.get(name, (name, "out", 0))
        result = 0 if res is None else tensor_bytes(out if res == "out" else args[res])
        operand = 0 if opnd is None else tensor_bytes(args[opnd])
        self.collectives.append(Collective(kind, name, result, operand))


# DTensor's private hook for the propagation's fake run, as PyTorch 2.11
# and 2.13 name it; checked here, so that a release that renames it fails
# at import instead of the census counting the propagation again
_PROPAGATE = "_propagate_tensor_meta_non_cached"


def _propagator():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    if not hasattr(ShardingPropagator, _PROPAGATE):
        raise ImportError(f"torch {torch.__version__}: ShardingPropagator has no {_PROPAGATE}; "
                          "the census cannot keep DTensor's sharding propagation out")
    return ShardingPropagator


_propagator()


@contextlib.contextmanager
def _quiet_propagation():
    """DTensor's sharding propagation run with every dispatch mode off
    (its ``_propagate_tensor_meta_non_cached`` wrapped while entered)."""
    from torch.utils._python_dispatch import _disable_current_modes

    prop = _propagator()
    orig = getattr(prop, _PROPAGATE)

    def quiet(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    setattr(prop, _PROPAGATE, quiet)
    try:
        yield
    finally:
        setattr(prop, _PROPAGATE, orig)


def collective_stats(census: Census) -> Dict[str, Dict[str, float]]:
    """``{kind: {"count", "bytes"}}`` over the census, result bytes, the
    reference's ``collective_stats`` of one device's program."""
    stats: Dict[str, Dict[str, float]] = {}
    for c in census.collectives:
        s = stats.setdefault(c.kind, {"count": 0, "bytes": 0})
        s["count"] += 1
        s["bytes"] += c.bytes
    return stats


def total_collective_bytes(census: Census) -> int:
    return int(sum(c.bytes for c in census.collectives))


def op_census(census: Census, ops: Optional[Iterable[str]] = None) -> Dict[str, int]:
    """How many times each aten op (by name, ``"mm"``, ``"exp"``) ran: those
    in ``ops``, or every one that ran."""
    if ops is None:
        return dict(census.ops)
    return {op: census.ops.get(op, 0) for op in ops}
