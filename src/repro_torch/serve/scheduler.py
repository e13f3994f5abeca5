"""Workload-agnostic continuous-batching scheduler core.

A copy of ``repro.serve.scheduler`` (standard library only), kept in the
port so that the port imports nothing of the JAX package.

Both serving surfaces -- the SVM fit endpoint
(:mod:`repro_torch.serve.solver_service`) and the LM decode loop
(:mod:`repro_torch.serve.lm_service`) -- face the same scheduling problem:
requests of varying shapes arrive over time, each chunk set-up
serves exactly one shape GROUP (a solver bucket, one decode batch), a
group owns a fixed table of reusable slot LANES, and the host must
decide, between device chunks, (a) which group runs its next chunk and
(b) which queued requests are admitted into the group's freed lanes.
This module is that decision core, with no knowledge of what a lane's
device state looks like -- workloads attach their per-group device
buffers as ``Group.payload`` and their per-lane bookkeeping as
``Ticket.note``.

Tickets and urgency
-------------------

Every request is wrapped in a :class:`Ticket` carrying its arrival
sequence number (a global monotonic counter), wall-clock submit time
(for queue-to-result latency accounting), an integer ``priority``
(higher first) and an optional ``deadline`` (any orderable float;
earlier first).  Tickets order by the URGENCY key

    (deadline is None, deadline, -priority, arrival)

so deadline-tagged requests always precede slack ones, higher priority
precedes lower within each of those classes, and arrival order (FIFO)
breaks the remaining ties.  The same key drives both decisions:
admission pops a group's queue in urgency order, and the default
policy runs the group holding the globally most urgent live ticket.

Policies
--------

``oldest``       :class:`OldestFirstPolicy` (default): run the group
                 whose most urgent ticket (queued or running) is
                 globally most urgent -- with pure FIFO traffic that is
                 oldest-request-first across buckets.  Bucket-fill-rate
                 aware: among equally urgent groups the FULLER one runs
                 first, so a chunk's fixed cost is amortized over more
                 tenants.  Starvation-free WITHIN an urgency class
                 under sustained backlog: a waiting ticket's urgency is
                 fixed while same-class tickets elsewhere complete and
                 are replaced by later-arrival (less urgent) ones, so
                 its group's turn always comes.  Deadline tags and
                 priorities are deliberately STRICT classes -- a
                 sustained stream of higher-class traffic CAN starve
                 lower classes (that is what "deadline-tagged never
                 scheduled after slack" means); callers wanting
                 fairness across classes should simply not tag
                 bulk traffic.
``round_robin``  :class:`RoundRobinPolicy`: the solver service's
                 original ``_pick_batch`` cursor, retained bit-for-bit
                 for compatibility tests
                 -- the cursor advances past the chosen group and no
                 group with work is skipped twice.

Policies only pick among groups WITH WORK; they never admit or evict.
Admission into freed lanes (:meth:`Scheduler.admit`) and idle-group
eviction (:meth:`Scheduler.evict_idle`) are explicit scheduler calls
the workload's step loop makes around its chunk dispatch.

Compile-cache accounting
------------------------

:class:`CompileStats` wraps every chunk dispatch
(``with sched.stats.chunk(key, trace_counter): ...``) and attributes
trace-count deltas to THIS scheduler's calls only -- other services or
solo solves sharing an executable key are never misattributed.  After
warm-up every dispatch must be a cache hit; the serve benchmarks
assert exactly that.

Request lifecycle (status contract)
-----------------------------------

Every ticket carries a :class:`Status`::

    PENDING -----------------> RUNNING ----------------> DONE
       |  \\                      |  \\
       |   `-> CANCELLED          |   `-> CANCELLED   (cancel(rid))
       |-----> DEADLINE_EXCEEDED  |-----> FAILED      (quarantine)
       |        (shed_expired)    |   \\
       `-----> SUPERSEDED         |    `-> PENDING    (resubmit, bounded
                                  |                    retry budget)
                                  `-----> SUPERSEDED  (streaming update)

``submit`` creates PENDING tickets; ``admit`` marks them RUNNING;
``release`` stamps the terminal status (DONE / FAILED / CANCELLED) and
the queue-to-result latency.  ``shed_expired`` sweeps queued tickets
whose deadline has passed (opt-in: services only shed when constructed
with a ``clock``), ``cancel_queued`` removes a queued ticket eagerly,
and ``resubmit`` re-enqueues a quarantined ticket with a FRESH arrival
counter -- the retry queues behind everything already waiting, which
is the backoff ordering.  SUPERSEDED is the streaming-update outcome:
a newer revision of the same tenant's problem arrived, so the stale
fit's answer is no longer wanted -- the solver service cancels the old
request (queued or running) with this status when it accepts an
``UpdateRequest`` for the tenant.  Terminal statuses never transition
again.
"""

from __future__ import annotations

import collections
import contextlib
import enum
import heapq
import itertools
import time
from typing import Any, Callable, Iterator, NamedTuple


class Status(enum.Enum):
    """Request lifecycle states carried on the scheduler ticket.

    Values are the wire strings services expose from ``status(rid)``.
    """

    PENDING = "PENDING"                      # queued, not yet in a lane
    RUNNING = "RUNNING"                      # occupying a device lane
    DONE = "DONE"                            # finished, result available
    FAILED = "FAILED"                        # quarantined / rejected
    CANCELLED = "CANCELLED"                  # cancel(rid) honored
    DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"  # shed before admission
    SUPERSEDED = "SUPERSEDED"                # replaced by a newer
                                             # revision of its tenant's
                                             # streaming problem

    @property
    def terminal(self) -> bool:
        return self not in (Status.PENDING, Status.RUNNING)


class RequestFailure(NamedTuple):
    """Structured terminal record for a request that did NOT produce a
    normal result: quarantined (FAILED), cancelled, or shed past its
    deadline.  Services store these in their results map so callers get
    a typed object from ``result(rid)`` instead of an exception."""

    request_id: int
    status: Status
    reason: str
    attempts: int = 0   # device admissions consumed (0 = never ran:
                        # shed or cancelled while still queued)


class ResultNotReady(KeyError):
    """``result(rid)`` on a KNOWN request that has not reached a
    terminal status yet.  Subclasses ``KeyError`` so pre-status-API
    callers that caught the bare ``KeyError`` keep working; unknown
    rids still raise the plain ``KeyError``."""


class Ticket:
    """One scheduled request: identity + urgency + latency stamps.

    ``payload`` is the workload's request object (opaque here);
    ``note`` is free per-lane bookkeeping the workload attaches at
    admission (solver: harvest metadata; LM: the token accumulator).
    """

    __slots__ = ("rid", "payload", "priority", "deadline", "arrival",
                 "submitted", "note", "status", "attempts")

    def __init__(self, rid: int, payload: Any, priority: int,
                 deadline: float | None, arrival: int, submitted: float):
        self.rid = rid
        self.payload = payload
        self.priority = priority
        self.deadline = deadline
        self.arrival = arrival
        self.submitted = submitted
        self.note: Any = None
        self.status: Status = Status.PENDING
        self.attempts: int = 0   # admissions so far (retry accounting)

    @property
    def urgency(self) -> tuple:
        """Total order: deadline-tagged first (earliest deadline), then
        priority (higher first), then FIFO.  Unique per ticket (the
        arrival counter is global and monotonic)."""
        return (self.deadline is None,
                self.deadline if self.deadline is not None else 0.0,
                -self.priority, self.arrival)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Ticket(rid={self.rid}, prio={self.priority}, "
                f"deadline={self.deadline}, arrival={self.arrival})")


class Group:
    """One executable's slot table: a sorted request queue plus the
    lane -> ticket map of currently running requests.  ``payload``
    holds the workload's per-group device buffers (opaque)."""

    def __init__(self, key: Any, num_slots: int, payload: Any = None):
        self.key = key
        self.num_slots = num_slots
        self.payload = payload
        self._heap: list[tuple[tuple, Ticket]] = []
        self.slots: dict[int, Ticket] = {}

    # ----------------------------------------------------------- queue
    def enqueue(self, ticket: Ticket) -> None:
        heapq.heappush(self._heap, (ticket.urgency, ticket))

    def pop_most_urgent(self) -> Ticket:
        return heapq.heappop(self._heap)[1]

    def remove_queued(self, rid: int) -> Ticket | None:
        """Eagerly remove one queued ticket by rid (O(queue) rebuild);
        None if the rid is not queued here."""
        hit = None
        kept = []
        for entry in self._heap:
            if hit is None and entry[1].rid == rid:
                hit = entry[1]
            else:
                kept.append(entry)
        if hit is not None:
            self._heap = kept
            heapq.heapify(self._heap)
        return hit

    def drain_expired(self, now: float) -> list[Ticket]:
        """Remove every queued ticket whose deadline is <= ``now``
        (deadline-less tickets never expire).  Returns the shed
        tickets; the survivors keep their heap order."""
        shed = [t for _, t in self._heap
                if t.deadline is not None and t.deadline <= now]
        if shed:
            self._heap = [e for e in self._heap
                          if not (e[1].deadline is not None
                                  and e[1].deadline <= now)]
            heapq.heapify(self._heap)
        return shed

    @property
    def queued(self) -> int:
        return len(self._heap)

    # ----------------------------------------------------------- lanes
    def free_lanes(self) -> list[int]:
        return [i for i in range(self.num_slots) if i not in self.slots]

    @property
    def fill(self) -> int:
        return len(self.slots)

    def has_work(self) -> bool:
        return bool(self.slots or self._heap)

    def most_urgent(self) -> tuple | None:
        """Min urgency over queued AND running tickets (None if the
        group is drained) -- the group's claim on the next chunk."""
        best = self._heap[0][0] if self._heap else None
        for t in self.slots.values():
            if best is None or t.urgency < best:
                best = t.urgency
        return best


class OldestFirstPolicy:
    """Latency-aware default: the group holding the globally most
    urgent live ticket runs next; ties (possible only between equal
    urgency keys, i.e. never for distinct tickets) break toward the
    fuller group, then insertion order.  Starvation-free within an
    urgency class; deadline/priority classes are strict (see the
    module docstring)."""

    def select(self, groups: list[Group]) -> Group | None:
        best, best_key = None, None
        for i, g in enumerate(groups):
            u = g.most_urgent()
            if u is None:
                continue
            key = (u, g.num_slots - g.fill, i)
            if best_key is None or key < best_key:
                best, best_key = g, key
        return best


class RoundRobinPolicy:
    """The solver service's original ``_pick_batch``: a cursor over the
    insertion-ordered group list, advanced past the chosen group so a
    continuously-fed group cannot starve the others.  Retained as a
    policy so the bit-compat tests keep a reference scheduler."""

    def __init__(self) -> None:
        self._rr = 0

    def select(self, groups: list[Group]) -> Group | None:
        for i in range(len(groups)):
            j = (self._rr + i) % len(groups)
            if groups[j].has_work():
                self._rr = j + 1
                return groups[j]
        return None


POLICIES: dict[str, Callable[[], Any]] = {
    "oldest": OldestFirstPolicy,
    "round_robin": RoundRobinPolicy,
}


class CompileStats:
    """Per-scheduler compile-cache accounting: ``chunk`` wraps one
    dispatch and records the trace-count delta it caused, so traces by
    other services / solo solves sharing an executable key are never
    attributed here."""

    def __init__(self) -> None:
        self.chunk_calls: collections.Counter = collections.Counter()
        self.compiles = 0

    @contextlib.contextmanager
    def chunk(self, key: Any, trace_counter: collections.Counter
              ) -> Iterator[None]:
        self.chunk_calls[key] += 1
        before = trace_counter.get(key, 0)
        try:
            yield
        finally:
            self.compiles += trace_counter.get(key, 0) - before

    def as_dict(self) -> dict:
        calls = sum(self.chunk_calls.values())
        return {"chunk_calls": calls, "compiles": self.compiles,
                "cache_hits": calls - self.compiles}


class Scheduler:
    """The latency-aware admission core shared by both services.

    Workload step loop shape::

        group = sched.next_group()             # policy pick
        for lane, ticket in sched.admit(group):
            ...write the request into device lane state...
        ...dispatch one chunk under sched.stats.chunk(key, counter)...
        for finished lane: sched.release(group, lane)
        sched.evict_idle(group)

    The scheduler owns everything host-side and O(requests): queues,
    lane occupancy, urgency ordering, queue-to-result latency stamps,
    compile-cache stats.  Device state stays with the workload.
    """

    def __init__(self, num_slots: int, policy: str | Any = "oldest",
                 latency_window: int = 4096):
        self.num_slots = num_slots
        self.policy = (POLICIES[policy]() if isinstance(policy, str)
                       else policy)
        self._groups: dict[Any, Group] = {}     # insertion-ordered
        self._arrival = itertools.count()
        self.stats = CompileStats()
        # (rid, queue-to-result seconds), appended at release; a
        # BOUNDED sliding window so a long-running service stays
        # O(active slots + window), never O(requests served)
        self.latencies: collections.deque[tuple[int, float]] = \
            collections.deque(maxlen=latency_window)

    # ---------------------------------------------------------- groups
    @property
    def groups(self) -> list[Group]:
        return list(self._groups.values())

    def group(self, key: Any,
              payload_factory: Callable[[], Any] | None = None,
              num_slots: int | None = None) -> Group:
        """Get-or-create the slot group for ``key`` (insertion order is
        the round-robin policy's rotation order).

        ``key`` is opaque to the scheduler; the workload picks it so
        that requests sharing a key share one compiled executable.  The
        solver service keys by (bucket, shard-placement): the bucket
        tuple -- padded shapes plus the step statics -- PLUS, on a
        device mesh, the slot's placement kind (lane-parallel unsharded
        slots vs point-sharded large-n slots).  Two fits with identical
        buckets but different placements lower to different
        ``shard_map`` programs with different collective budgets, so
        they must never share a lane table; everything the scheduler
        does (queueing, admission, eviction, stats) is per-key and
        therefore placement-local for free.

        ``num_slots`` overrides the scheduler-wide lane count for THIS
        group at creation (point-sharded groups run few large-n lanes
        where lane-parallel groups run many); ignored if the group
        already exists.
        """
        g = self._groups.get(key)
        if g is None:
            payload = payload_factory() if payload_factory else None
            g = self._groups[key] = Group(
                key, num_slots or self.num_slots, payload)
        return g

    def has_work(self) -> bool:
        return any(g.has_work() for g in self._groups.values())

    # ---------------------------------------------------------- intake
    def submit(self, key: Any, rid: int, payload: Any = None, *,
               priority: int = 0, deadline: float | None = None,
               payload_factory: Callable[[], Any] | None = None,
               num_slots: int | None = None) -> Ticket:
        """Enqueue a request on its group's queue; stamps arrival order
        and wall-clock submit time (queue-to-result latency starts
        here).  ``num_slots`` sizes the group if this submit creates
        it (see :meth:`group`)."""
        g = self.group(key, payload_factory, num_slots)
        t = Ticket(rid, payload, priority, deadline,
                   next(self._arrival), time.perf_counter())
        g.enqueue(t)
        return t

    # -------------------------------------------------------- schedule
    def next_group(self) -> Group | None:
        """Policy pick among groups with work (queued or running)."""
        return self.policy.select(self.groups)

    def admit(self, group: Group) -> list[tuple[int, Ticket]]:
        """Fill the group's free lanes from its queue in urgency order;
        returns the (lane, ticket) assignments for the workload to
        realize in device state.  Between chunks only -- admission
        never interrupts a running chunk."""
        out = []
        for lane in group.free_lanes():
            if not group.queued:
                break
            t = group.pop_most_urgent()
            t.status = Status.RUNNING
            t.attempts += 1
            group.slots[lane] = t
            out.append((lane, t))
        return out

    def release(self, group: Group, lane: int,
                status: Status = Status.DONE) -> Ticket:
        """Free a finished lane, stamp the terminal ``status`` and the
        ticket's queue-to-result latency.  The lane is immediately
        admissible again."""
        t = group.slots.pop(lane)
        t.status = status
        self.latencies.append((t.rid, time.perf_counter() - t.submitted))
        return t

    # ------------------------------------------------ faults/deadlines
    def shed_expired(self, now: float) -> list[tuple[Group, Ticket]]:
        """Sweep every group's queue for tickets whose deadline is
        already past (``deadline <= now``) and shed them with status
        DEADLINE_EXCEEDED -- a hopeless request never occupies a lane.
        Only QUEUED tickets are shed; running ones finish their budget
        (cancel them explicitly if needed).  Returns (group, ticket)
        pairs so the workload can record structured failures."""
        shed = []
        for g in self.groups:
            for t in g.drain_expired(now):
                t.status = Status.DEADLINE_EXCEEDED
                shed.append((g, t))
        return shed

    def cancel_queued(self, rid: int,
                      status: Status = Status.CANCELLED
                      ) -> tuple[Group, Ticket] | None:
        """Remove a still-queued ticket from whichever group holds it,
        stamping ``status`` (CANCELLED by default; the solver service
        passes SUPERSEDED when a streaming update replaces a queued
        fit).  None if no group has it queued (it may be running -- the
        workload cancels those between chunks via :meth:`release`)."""
        for g in self.groups:
            t = g.remove_queued(rid)
            if t is not None:
                t.status = status
                return g, t
        return None

    def resubmit(self, group: Group, lane: int, ticket: Ticket) -> Ticket:
        """Retry path: free the quarantined lane WITHOUT a terminal
        status and re-enqueue the same ticket with a fresh arrival
        counter.  The fresh counter is the backoff ordering -- the
        retry queues behind every ticket already waiting in its
        urgency class, so one flaky tenant cannot hog a lane.  No
        latency stamp (the request is still in flight)."""
        assert group.slots.get(lane) is ticket
        del group.slots[lane]
        ticket.arrival = next(self._arrival)
        ticket.status = Status.PENDING
        ticket.note = None
        group.enqueue(ticket)
        return ticket

    def evict_idle(self, group: Group) -> bool:
        """Drop a drained group so workload device buffers held by its
        payload can be freed -- a chunk configuration's set-up is
        counted once per process (``engine.trace_counts``), so
        re-creating the group later costs one allocation, not a new
        set-up.  Returns True if evicted."""
        if group.has_work():
            return False
        if self._groups.get(group.key) is group:
            del self._groups[group.key]
        return True

    # ----------------------------------------------------------- stats
    def latency_percentiles(self, *pcts: float) -> dict[float, float]:
        """Queue-to-result latency percentiles (seconds) over the
        sliding window of released tickets; empty dict if nothing
        completed yet."""
        if not self.latencies:
            return {}
        import numpy as np
        lats = np.asarray([s for _, s in self.latencies])
        return {p: float(np.percentile(lats, p)) for p in pcts}
