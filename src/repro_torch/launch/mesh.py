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
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

BACKENDS = ("gloo", "nccl")


class ClientGroup(NamedTuple):
    """One rank's view of a client group: the torch ``ProcessGroup``, this
    process's rank in it, its size, and the device its tensors live on.
    ``recorder``, when set (``group._replace(recorder=...)``), is called
    by the group's hooks after each all-reduce they issue, with its kind,
    its elements, their bytes and its seconds (``engine.group_hooks``);
    ``utils.comm_audit.Recorder`` is one."""
    group: Any
    rank: int
    size: int
    device: torch.device
    recorder: Callable | None = None


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
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return ClientGroup(group=dist.group.WORLD, rank=rank, size=world_size,
                       device=dev)


def sub_group(parent: ClientGroup, ranks) -> ClientGroup | None:
    """The client group of ``ranks`` (ranks of ``parent``, which must be
    the default group, whose backend it takes), or None on a rank outside
    it.  Every rank of the default group must call this, in the same
    order, for every subgroup (``torch.distributed.new_group``'s rule)."""
    ranks = sorted(ranks)
    pg = dist.new_group(ranks)
    if parent.rank not in ranks:
        return None
    return ClientGroup(group=pg, rank=ranks.index(parent.rank),
                       size=len(ranks), device=parent.device)


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
    out: dict = {}
    try:
        for p in procs:
            p.start()
        while len(out) < k:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn_clients: {k - len(out)} of {k} clients gave no "
                    f"result within {timeout_s} s; all were killed")
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn_clients: client {dead[0][0]} "
                                       f"exited with code {dead[0][1]} "
                                       "without a result")
                continue
            if not ok:
                raise RuntimeError(
                    f"spawn_clients: client {rank} of {k} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(k)]
