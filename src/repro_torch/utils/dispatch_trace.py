"""What a region of PyTorch code dispatches: its ops, host reads and
collectives.

Counterpart of ``repro.utils.hlo_analysis``, which parses the compiled HLO
text of a jitted function.  Eager PyTorch compiles nothing, so the port
records what runs instead: :class:`Trace` is a context manager that puts a
``TorchDispatchMode`` (every ATen op below autograd) and a
``TorchFunctionMode`` (the Python-level calls that read a tensor's values
into the host) around a region, and keeps

* ``ops`` -- one :class:`OpRecord` a dispatched op: its name, its outputs'
  dtypes, shapes and devices, and the bytes of its tensor inputs plus
  outputs (each op's own traffic: eager ops do not fuse, so the sum is an
  upper bound on what the region moves through memory);
* ``syncs`` -- one :class:`SyncRecord` a call that makes a CUDA host wait
  on the device: ``aten._local_scalar_dense`` (``.item()``, ``float()``,
  ``bool()`` of a tensor), ``aten.nonzero``, ``aten.is_nonzero``,
  ``aten.equal``, ``aten.masked_select``, ``aten.unique*``, a copy
  between the CPU and another device (either way: an upload from
  pageable memory waits too), a tensor made from host data
  (``aten.lift_fresh``: on a card, such an upload), and the Python reads
  that never reach the dispatcher on a CPU tensor (``tolist``,
  ``numpy``).  A Python read is recorded once, not again as the op it
  dispatches;
* ``collectives`` -- one :class:`CollectiveRecord` a ``c10d`` op.  On
  torch 2.13 the dispatcher sees every ``c10d`` collective of a gloo or
  NCCL group (``c10d.allreduce_`` and the rest) with its tensors, but the
  reduce op is an opaque script object there; the kind (``add`` /
  ``max``) is read from the enclosing ``torch.distributed.all_reduce``
  call, which the function mode sees.

The region runs for real: a trace is a record of one execution, not of a
compiled program, so a data-dependent region shows the path its data took.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ATen ops whose CUDA kernels read a value back to the host
SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.nonzero", "aten.is_nonzero",
    "aten.equal", "aten.masked_select", "aten.unique",
    "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive", "aten.unique_dim_consecutive",
})
# a tensor made from host data (``torch.tensor``, ``torch.as_tensor`` of a
# list or an array): on a card, an upload from pageable memory that the
# host waits for (the copy itself, ``aten._to_copy`` to the card, is
# recorded too where the dispatcher shows it)
UPLOAD_OPS = frozenset({"aten.lift_fresh"})
COPY_OPS = frozenset({"aten._to_copy", "aten.copy_", "aten._copy_from",
                      "aten._copy_from_and_resize"})

# Python-level reads of a tensor's values; on a CUDA tensor each waits for
# the device (``__bool__`` and the scalar casts also dispatch
# ``_local_scalar_dense``, recorded once, here)
HOST_READS = frozenset({"tolist", "numpy", "item", "__bool__", "__float__",
                        "__int__", "__index__", "__complex__"})

_KINDS = {dist.ReduceOp.SUM: "add", dist.ReduceOp.MAX: "max",
          dist.ReduceOp.MIN: "min", dist.ReduceOp.PRODUCT: "mul"}
_COLLECTIVE_NAMES = {"allreduce_": "all-reduce", "allgather_": "all-gather",
                     "_allgather_base_": "all-gather",
                     "reduce_scatter_": "reduce-scatter",
                     "_reduce_scatter_base_": "reduce-scatter",
                     "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
                     "broadcast_": "broadcast", "send": "send",
                     "recv_": "recv", "barrier": "barrier",
                     "gather_": "gather", "scatter_": "scatter",
                     "reduce_": "reduce"}


class OpRecord(NamedTuple):
    name: str                  # "aten.mm", "c10d.allreduce_", ...
    dtypes: tuple              # outputs' dtypes
    shapes: tuple              # outputs' shapes
    devices: tuple             # outputs' device types
    nbytes: int                # tensor inputs + outputs


class SyncRecord(NamedTuple):
    name: str                  # the ATen op or the Tensor method
    device: str                # device type of the tensor read


class CollectiveRecord(NamedTuple):
    op: str                    # "all-reduce", "broadcast", ...
    kind: str                  # "add" / "max" / ... ("" where none)
    elements: int              # elements of the tensors it carries
    nbytes: int


class CollectiveStats(NamedTuple):
    """Counts and bytes by collective op (``hlo_analysis.CollectiveStats``
    in the JAX package)."""
    count_by_op: dict
    bytes_by_op: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _op_name(func) -> str:
    return f"{func.namespace}.{func._schema.name.split('::')[-1]}"


def _reduce_kind(args, kwargs) -> str:
    op = kwargs.get("op", args[1] if len(args) > 1 else dist.ReduceOp.SUM)
    return _KINDS.get(op, str(op))


class _Dispatch(TorchDispatchMode):
    def __init__(self, trace: "Trace"):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.trace._record(func, args, kwargs, out)
        return out


class _Function(TorchFunctionMode):
    def __init__(self, trace: "Trace"):
        super().__init__()
        self.trace = trace

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        tr = self.trace
        if name in HOST_READS and args and isinstance(args[0],
                                                      torch.Tensor):
            if not tr._quiet:
                tr.syncs.append(SyncRecord(name, args[0].device.type))
            tr._quiet += 1
            try:
                return func(*args, **kwargs)
            finally:
                tr._quiet -= 1
        if func is dist.all_reduce:
            tr._kind = _reduce_kind(args, kwargs)
            try:
                return func(*args, **kwargs)
            finally:
                tr._kind = ""
        return func(*args, **kwargs)


class Trace:
    """Record the ops, host reads and collectives of a region::

        with Trace() as tr:
            fn(...)
        tr.ops, tr.syncs, tr.collectives

    Traces nest with other modes (``FlopCounterMode``, a profiler)."""

    def __init__(self):
        self.ops: list[OpRecord] = []
        self.syncs: list[SyncRecord] = []
        self.collectives: list[CollectiveRecord] = []
        self._quiet = 0
        self._kind = ""
        self._modes = (_Function(self), _Dispatch(self))

    def __enter__(self) -> "Trace":
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False

    def _record(self, func, args, kwargs, out) -> None:
        name = _op_name(func)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func.namespace == "c10d":
            base = func._schema.name.split("::")[-1]
            self.collectives.append(CollectiveRecord(
                _COLLECTIVE_NAMES.get(base, base),
                self._kind if base == "allreduce_" else "",
                sum(t.numel() for t in ins), _nbytes(ins)))
        self.ops.append(OpRecord(
            name, tuple(t.dtype for t in outs),
            tuple(tuple(t.shape) for t in outs),
            tuple(t.device.type for t in outs), _nbytes(ins) + _nbytes(outs)))
        if self._quiet:
            return
        if name in SYNC_OPS:
            dev = ins[0].device.type if ins else "cpu"
            self.syncs.append(SyncRecord(name, dev))
        elif name in UPLOAD_OPS:
            self.syncs.append(SyncRecord(name, "host"))
        elif name in COPY_OPS and len(ins) + len(outs) >= 2:
            if name == "aten.copy_":                    # copy_(dst, src)
                src, dst = ins[1], ins[0]
            elif name == "aten._to_copy":
                src, dst = ins[0], outs[0]
            else:                                       # _copy_from(src, dst)
                src, dst = ins[0], ins[1]
            if (dst.device.type == "cpu") != (src.device.type == "cpu"):
                self.syncs.append(SyncRecord(name, src.device.type))

    # ------------------------------------------------------------ views
    @property
    def nbytes(self) -> int:
        """Bytes of every op's tensor inputs and outputs."""
        return sum(r.nbytes for r in self.ops)

    def collective_multiset(self) -> collections.Counter:
        """Collectives as ``CommModel.collective_multiset`` keys them:
        (op, kind, elements)."""
        return collections.Counter((c.op, c.kind, c.elements)
                                   for c in self.collectives)

    def collective_stats(self) -> CollectiveStats:
        count, nbytes = collections.Counter(), collections.Counter()
        for c in self.collectives:
            count[c.op] += 1
            nbytes[c.op] += c.nbytes
        return CollectiveStats(dict(count), dict(nbytes))

    def wide_dtypes(self) -> list[OpRecord]:
        """Ops with a float64 or complex128 output."""
        return [r for r in self.ops
                if any(d in (torch.float64, torch.complex128)
                       for d in r.dtypes)]
