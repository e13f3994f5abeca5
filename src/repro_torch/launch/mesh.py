"""Client groups: Algorithm 4's clients as ``torch.distributed`` processes.

Counterpart of ``repro.launch.mesh``.  The JAX package runs its clients
as the devices of one ``jax.sharding.Mesh`` under ``shard_map`` (a single
controller); here each client is a process, one rank of a process group,
and the cross-client reductions are real ``all_reduce`` calls on that
group (``engine.group_hooks``).  A :class:`ClientGroup` is what the
solver's ``mesh=`` arguments take.

Backends: NCCL across cards, gloo on the CPU or over CUDA tensors.  NCCL
refuses two ranks on one card ("Duplicate GPU detected"), so ranks that
share a card talk through gloo, which copies each CUDA tensor to the
host and back.  The backend is always the caller's choice: nothing here
falls back from one to the other.

:func:`spawn_clients` runs a function on k fresh processes (``spawn``
start method, ``file://`` rendezvous in a temporary directory, so no
port is needed) and returns what each rank returned.  The function is
pickled by its import path, so it must live in a module the children
can import, not in a ``__main__`` they cannot see or inside a test.
:func:`run_in_child` runs a function in ONE fresh process, whose default
process group is then its own to make (the launch dry-run's fake groups).

The JAX package's production meshes (``make_production_mesh``: 16x16
``(data, model)`` and 2x16x16 ``(pod, data, model)``) are rank layouts
here (:class:`Layout`, :data:`PRODUCTION_LAYOUTS`): rank r sits at the
row-major coordinates of r, the last axis fastest, as ``jax.make_mesh``
lays out devices.  :func:`init_fake_group` makes the default group torch's
fake backend of k ranks, where one process stands in for one rank of a
k = 256 or 512 group: every collective returns at once, so the values it
reduces mean nothing, but the collectives issued and their shapes are
this rank's own.

The SPMD fit service (``serve.solver_service.SolverService(mesh=)``) moves
its own traffic with three helpers: :func:`broadcast_object` (rank 0's
plan to every rank), :func:`send_objects` / :func:`recv_object` (rank 0's
admission data to the ranks that hold the lane) and
:func:`gather_objects` (every rank's harvest rows to rank 0).  Each
pickles its object into a byte tensor (on the card for NCCL, on the host
for gloo), waits at most the group's ``timeout_s`` for every backend call
it makes, and tallies each call in :data:`traffic_counts` under the name
the profiler gives it ("broadcast", "send", "recv"), apart from the
solver's all-reduces (``engine.collective_counts``).
"""

from __future__ import annotations

import collections
import datetime
import math
import multiprocessing
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

BACKENDS = ("gloo", "nccl")

# The service helpers' backend calls by op (one count a call, on the rank
# that makes it), as the profiler names them ("gloo:broadcast", ...).
traffic_counts: collections.Counter = collections.Counter()


class ClientGroup(NamedTuple):
    """One rank's view of a client group: the torch ``ProcessGroup``, this
    process's rank in it, its size, and the device its tensors live on.
    ``recorder``, when set (``group._replace(recorder=...)``), is called
    by the group's hooks after each all-reduce they issue, with its kind,
    its elements, their bytes and its seconds (``engine.group_hooks``);
    ``utils.comm_audit.Recorder`` is one.  ``timeout_s`` bounds each call
    of the service helpers below (None: the backend's own timeout)."""
    group: Any
    rank: int
    size: int
    device: torch.device
    recorder: Callable | None = None
    timeout_s: float | None = None


def _client_device(device, rank: int) -> torch.device:
    """``cuda:(rank % device_count)`` unless the CPU is asked for."""
    dev = resolve_device(device)          # raises for cuda without a card
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def init_client_group(*, backend: str, init_method: str, rank: int,
                      world_size: int, device=None,
                      timeout_s: float | None = None) -> ClientGroup:
    """Join the default process group as client ``rank`` of
    ``world_size`` and return its :class:`ClientGroup`.

    ``backend`` is ``"gloo"`` or ``"nccl"``; a backend this build lacks,
    or NCCL on the CPU, raises.  ``device`` is ``"cuda"`` (the default:
    ``cuda:(rank % device_count)``, raising without a card) or ``"cpu"``.
    ``timeout_s`` bounds every collective of the group (gloo honours it;
    a rank that waits longer raises)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = _client_device(device, rank)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL backend")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **_timeout_kw(timeout_s))
    return ClientGroup(group=dist.group.WORLD, rank=rank, size=world_size,
                       device=dev, timeout_s=timeout_s)


def _timeout_kw(timeout_s: float | None) -> dict:
    return {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}


def sub_group(parent: ClientGroup, ranks) -> ClientGroup | None:
    """The client group of ``ranks`` (ranks of ``parent``, which must be
    the default group, whose backend and timeout it takes), or None on a
    rank outside it.  Every rank of the default group must call this, in
    the same order, for every subgroup (``torch.distributed.new_group``'s
    rule)."""
    ranks = sorted(ranks)
    pg = dist.new_group(ranks, **_timeout_kw(parent.timeout_s))
    if parent.rank not in ranks:
        return None
    return ClientGroup(group=pg, rank=ranks.index(parent.rank),
                       size=len(ranks), device=parent.device,
                       timeout_s=parent.timeout_s)


# ------------------------------------------------------------------------
# The production layouts and the fake group of the launch dry-run.
# ------------------------------------------------------------------------

class Layout(NamedTuple):
    """A mesh of ranks: its name (``"16x16"``), axis names and extents.
    Rank r sits at the row-major coordinates of r (the last axis
    fastest), as ``jax.make_mesh`` lays out its devices."""
    name: str
    axis_names: tuple
    shape: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def coords(self, rank: int) -> dict:
        """Rank ``rank``'s coordinate on every axis."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not in the {self.name} layout")
        return {a: int(c) for a, c in
                zip(self.axis_names, np.unravel_index(rank, self.shape))}

    def column_ranks(self, column: int) -> list[int]:
        """The ranks whose ``model`` coordinate is ``column``, in rank
        order: one model column's data ranks (``pod x data`` on the
        multi-pod layout)."""
        ranks = np.arange(self.size).reshape(self.shape)
        return np.take(ranks, column, axis=self.axis_names.index("model")
                       ).reshape(-1).tolist()


PRODUCTION_LAYOUTS = {
    "16x16": Layout("16x16", ("data", "model"), (16, 16)),
    "2x16x16": Layout("2x16x16", ("pod", "data", "model"), (2, 16, 16)),
}


def production_layout(multi_pod: bool = False) -> Layout:
    """Single pod: 16x16 (data, model), k = 256.  Multi-pod: 2x16x16
    (pod, data, model), k = 512."""
    return PRODUCTION_LAYOUTS["2x16x16" if multi_pod else "16x16"]


def layout_for(k: int) -> Layout:
    """The JAX package's ``make_test_mesh`` rule for k devices: ``(k //
    model, model)`` over ``("data", "model")``, model the first of 4, 2, 1
    that divides k."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    model = next(m for m in (4, 2, 1) if k % m == 0)
    return Layout(f"{k // model}x{model}", ("data", "model"),
                  (k // model, model))


def make_test_mesh(world: ClientGroup, ranks=None, layout=None):
    """The counterpart of ``repro.launch.mesh.make_test_mesh``: a
    ``models.sharding.Mesh`` over ``ranks`` (ranks of the default group
    ``world``; default: all of them) laid out by :func:`layout_for` (or
    ``layout``, of as many ranks), its groups on ``world``'s device.

    Collective over ``world``: every rank of the default group calls it
    with the same ranks, and it makes (``sub_group``, in this order) the
    mesh's whole group, each ``data`` column's and each ``model`` row's; a
    rank outside ``ranks`` gets None.  Mesh position r is ``ranks[r]``,
    row-major as ``jax.make_mesh`` lays out devices.  The mesh carries the
    ``DeviceMesh`` over the same groups (``DeviceMesh.from_group``)."""
    from repro_torch.models.sharding import Mesh

    ranks = list(range(world.size) if ranks is None else ranks)
    layout = layout_for(len(ranks)) if layout is None else layout
    if layout.size != len(ranks):
        raise ValueError(f"{len(ranks)} ranks do not fill {layout.name}")
    grid = np.asarray(ranks).reshape(layout.shape)
    whole = sub_group(world, ranks)
    lines = {}
    for i, axis in enumerate(layout.axis_names):
        moved = np.moveaxis(grid, i, -1).reshape(-1, layout.shape[i])
        for line in moved.tolist():
            group = sub_group(world, line)
            if group is not None:
                lines[axis] = group
    if whole is None:
        return None
    return Mesh(layout=layout, rank=whole.rank, world=whole, groups=lines,
                device=world.device,
                device_mesh=_device_mesh(world, lines, grid, layout))


def _device_mesh(world: ClientGroup, lines: dict, grid, layout):
    """The ``DeviceMesh`` of a mesh's groups (their global ranks as the
    mesh tensor), or None where this torch cannot make one over them."""
    from torch.distributed.device_mesh import DeviceMesh

    global_ranks = [dist.get_global_rank(world.group, int(r))
                    for r in grid.reshape(-1)]
    try:
        return DeviceMesh.from_group(
            [lines[a].group for a in layout.axis_names],
            world.device.type,
            mesh=torch.tensor(global_ranks).reshape(layout.shape),
            mesh_dim_names=tuple(layout.axis_names))
    except (RuntimeError, ValueError, NotImplementedError):
        return None


def init_fake_group(k: int, device=None, rank: int = 0) -> ClientGroup:
    """Make the default process group torch's fake backend of ``k`` ranks,
    with this process as rank ``rank``, and return its
    :class:`ClientGroup` on ``device`` (the card unless the CPU is
    asked for).  Its collectives move nothing: each returns at once,
    leaving this rank's data as it was.  The caller destroys the group
    (``torch.distributed.destroy_process_group()``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dev = _client_device(device, rank)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=k)
    return ClientGroup(group=dist.group.WORLD, rank=rank, size=k, device=dev)


def column_groups(world: ClientGroup, layout: Layout) -> list:
    """Every model column's :func:`sub_group` of the default group
    ``world`` laid out as ``layout``, made in column order (every rank
    must make every one: ``new_group``'s rule); None for each column that
    does not hold this rank."""
    if world.size != layout.size:
        raise ValueError(f"a group of {world.size} ranks is not the "
                         f"{layout.name} layout ({layout.size} ranks)")
    return [sub_group(world, layout.column_ranks(c))
            for c in range(layout.axis_sizes["model"])]


# ------------------------------------------------------------------------
# The SPMD service's own traffic: picklable objects between rank 0 and the
# other ranks of a group.  A group of one rank moves nothing.
# ------------------------------------------------------------------------

def _wait(work, group: ClientGroup, op: str) -> None:
    traffic_counts[op] += 1
    if group.timeout_s is None:
        work.wait()
    else:
        work.wait(timeout=datetime.timedelta(seconds=group.timeout_s))


def _byte_device(group: ClientGroup) -> torch.device:
    """Where a group's byte tensors live: the card for NCCL, else the
    host (gloo would copy a CUDA tensor to the host and back)."""
    if dist.get_backend(group.group) == "nccl":
        return group.device
    return torch.device("cpu")


def _to_bytes(obj, device) -> torch.Tensor:
    buf = np.frombuffer(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL),
                        dtype=np.uint8)
    return torch.from_numpy(buf.copy()).to(device)


def _from_bytes(data: torch.Tensor):
    return pickle.loads(data.cpu().numpy().tobytes())


def _send(group: ClientGroup, obj, dst: int) -> int:
    dev = _byte_device(group)
    data = _to_bytes(obj, dev)
    size = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
    peer = dist.get_global_rank(group.group, dst)
    _wait(dist.isend(size, peer, group=group.group), group, "send")
    _wait(dist.isend(data, peer, group=group.group), group, "send")
    return data.numel()


def _recv(group: ClientGroup, src: int) -> tuple[Any, int]:
    dev = _byte_device(group)
    size = torch.zeros(1, dtype=torch.int64, device=dev)
    peer = dist.get_global_rank(group.group, src)
    _wait(dist.irecv(size, peer, group=group.group), group, "recv")
    data = torch.empty(int(size.item()), dtype=torch.uint8, device=dev)
    _wait(dist.irecv(data, peer, group=group.group), group, "recv")
    return _from_bytes(data), data.numel()


def broadcast_object(group: ClientGroup, obj=None) -> tuple[Any, int]:
    """Rank 0's ``obj`` on every rank of ``group`` (other ranks pass
    nothing): its pickle's length, then its bytes, two broadcasts.
    Returns (the object, its pickle's bytes)."""
    if group.size == 1:
        return obj, 0
    dev = _byte_device(group)
    root = dist.get_global_rank(group.group, 0)
    if group.rank == 0:
        data = _to_bytes(obj, dev)
        size = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    _wait(dist.broadcast(size, root, group=group.group, async_op=True),
          group, "broadcast")
    if group.rank != 0:
        data = torch.empty(int(size.item()), dtype=torch.uint8, device=dev)
    _wait(dist.broadcast(data, root, group=group.group, async_op=True),
          group, "broadcast")
    return (obj if group.rank == 0 else _from_bytes(data)), data.numel()


def send_objects(group: ClientGroup, objs: dict) -> int:
    """From rank 0: ``objs[r]`` to each rank r of ``objs`` (r != 0), which
    must call :func:`recv_object`.  Returns the bytes sent."""
    if group.rank != 0:
        raise RuntimeError("send_objects is called on rank 0")
    return sum(_send(group, obj, dst) for dst, obj in sorted(objs.items()))


def recv_object(group: ClientGroup) -> tuple[Any, int]:
    """The object rank 0 sent this rank with :func:`send_objects`, and
    its pickle's bytes."""
    return _recv(group, 0)


def gather_objects(group: ClientGroup, obj) -> tuple[list | None, int]:
    """Every rank's ``obj`` on rank 0, in rank order (None elsewhere):
    each other rank sends its pickle to rank 0.  Returns (the list or
    None, the bytes this rank sent or received)."""
    if group.size == 1:
        return [obj], 0
    if group.rank != 0:
        return None, _send(group, obj, 0)
    got = [_recv(group, src) for src in range(1, group.size)]
    return [obj] + [o for o, _ in got], sum(n for _, n in got)


def _client_main(fn, rank, k, backend, device, init_method, timeout_s,
                 args, results) -> None:
    """A spawned client: join the group, run ``fn``, report the result or
    the traceback on ``results``."""
    try:
        group = init_client_group(backend=backend, init_method=init_method,
                                  rank=rank, world_size=k, device=device,
                                  timeout_s=timeout_s)
        try:
            out = fn(group, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                 # reported, then the child exits
        results.put((rank, False, traceback.format_exc()))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=30)


def _collect(procs, results, deadline: float, who: str) -> dict:
    """Every process's result by rank from ``results`` (``(rank, ok,
    payload)`` tuples), waiting until ``deadline``: a process that failed
    has its traceback raised as a RuntimeError, one that exited without a
    result raises too, and a timeout raises TimeoutError.  The caller
    stops the processes."""
    n, out = len(procs), {}
    while len(out) < n:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"{who}: {n - len(out)} of {n} processes "
                               "gave no result in time; all were killed")
        try:
            rank, ok, payload = results.get(timeout=min(left, 0.5))
        except queue.Empty:
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if r not in out and p.exitcode is not None]
            if not dead:
                continue
            try:                          # what an exited one sent, if any
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                raise RuntimeError(f"{who}: process {dead[0][0]} exited "
                                   f"with code {dead[0][1]} without a "
                                   "result") from None
        if not ok:
            raise RuntimeError(f"{who}: process {rank} of {n} failed:\n"
                               f"{payload}")
        out[rank] = payload
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    return out


def _child_main(fn, args, results) -> None:
    try:
        results.put((0, True, fn(*args)))
    except BaseException:                 # reported, then the child exits
        results.put((0, False, traceback.format_exc()))


def run_in_child(fn: Callable, *args, timeout_s: float):
    """``fn(*args)`` in one spawned process, and its result here.

    The child's default process group is its own to make (a fake group of
    k ranks, say).  As with :func:`spawn_clients`, ``fn`` must be
    importable by the child, the arguments and the result travel pickled
    (numpy, not tensors), the child's traceback is re-raised here as a
    RuntimeError, and when ``timeout_s`` (start-up included) runs out the
    child is killed and TimeoutError raised.  The child does not outlive
    this call."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child_main, args=(fn, args, results),
                         daemon=True)]
    deadline = time.monotonic() + timeout_s
    try:
        procs[0].start()
        return _collect(procs, results, deadline, "run_in_child")[0]
    finally:
        _stop(procs)
        results.close()


def spawn_clients(fn: Callable, k: int, *, backend: str, device,
                  timeout_s: float, args: tuple = ()) -> list:
    """Run ``fn(group, *args)`` on k spawned processes, one rank each, and
    return the k results in rank order.

    Results and ``args`` are pickled: return numpy arrays, not tensors
    (torch shares a tensor through a file descriptor of its process, which
    may have exited by the time the parent reads it).
    The first child that raises has its traceback re-raised here as a
    RuntimeError; a child that dies without a result raises too.  When
    ``timeout_s`` (start-up included) runs out, every child is killed and
    TimeoutError is raised.  No child outlives this call."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    ctx = multiprocessing.get_context("spawn")
    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_clients_"))
    init_method = f"file://{tmp / 'rendezvous'}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_client_main,
                         args=(fn, r, k, backend, device, init_method,
                               timeout_s, args, results), daemon=True)
             for r in range(k)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        out = _collect(procs, results, deadline, "spawn_clients")
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(k)]
