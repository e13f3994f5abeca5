"""Multi-tenant SVM fit serving: continuous batching over the
slot-batched saddle engine, in PyTorch.

The port of ``repro.serve.solver_service`` without its mesh placements.
The paper's per-iteration work is tiny -- O(B + n) after preprocessing
(Theorem 6) -- so a single fit request cannot fill the card.  At serving
scale the unit of work is therefore MANY independent small problems: this
service packs S concurrent fit requests into ONE slot-batched step
(:func:`repro_torch.core.engine.run_chunk_slots`, the slot axis written
out as the leading dimension of every tensor, two packed kernel launches a
step for all S lanes) and keeps it busy by admitting queued requests into
lanes as they free up mid-run.

Scheduling is delegated to the latency-aware core
(:class:`repro_torch.serve.scheduler.Scheduler`): the service is a thin
WORKLOAD ADAPTER that owns only the device side -- per-bucket slot
buffers (:class:`_Batch`), engine chunk dispatch, and harvest through
the svm.py recovery path.  Queue ordering (arrival / priority /
deadline urgency), cross-bucket policy (``oldest`` default,
``round_robin``), admission into freed slots, idle-batch eviction,
queue-to-result latency stamps and set-up accounting all live in the
scheduler.

Every entry point runs on ``device``: ``cuda`` (the default: the
hand-written kernels) or ``cpu`` (their plain PyTorch versions).  A
``mesh`` (lane-parallel or point-sharded groups over several processes)
is not ported yet: the chunk it would run is
(``engine.run_chunk_slots_sharded``), the service that drives one a rank
is not (see ROADMAP.md), and asking for it raises.

Streaming updates (warm starts)
-------------------------------

A fit submitted with ``stream=True`` declares a LIVE TENANT whose data
keeps changing.  :meth:`SolverService.submit_update` takes an
:class:`UpdateRequest` -- append points, replace the set, or pure
re-fit -- applies the tenant's FIXED preprocessing transform to the
new points (``preprocess.transform_like``), supersedes the tenant's
in-flight request (``Status.SUPERSEDED``), and enqueues a re-fit that
WARM-STARTS from the tenant's last completed saddle state instead of
the uniform init: ``w`` and the dual momentum carry over, carried
points keep their dual mass re-placed at the new class offsets, new
points are seeded at the uniform level and the next MWU normalizer
round renormalizes each class (``preprocess.repack_warm_duals``), and
``u`` is recomputed from the carried w on the device
(``engine.warm_packed_state``).  When the updated point count still
fits the tenant's pow-2 rung, the update re-packs in place and reuses
the same bucket's chunk set-up; an overflow jumps one rung (one new
bucket, set up once).

Shape buckets
-------------

One slot batch serves exactly one (n_bucket, d_bucket) shape, on the
POW-2 BUCKET LADDER of :func:`repro_torch.core.preprocess.bucket_shape`:
``LANE * 2^k`` points (at most 2x padding, each rung lane-aligned for the
packed kernels) and ``2^k`` coordinates (already the WD transform's d).
Padding points carry sign 0 / log-weight NEG_INF (inert in every
reduction).  Because the solver samples coordinate blocks over the full
bucket axis, a bucketed request is reproducible against
``saddle.solve(..., n_pad, d_pad, record_every=chunk_steps)`` at the same
seed -- the service's parity contract.  A slot's trajectory depends only
on its own seed, budget and bucket, and every chunk is a FULL chunk, so
scheduling policy changes WHEN a request runs, never WHAT it computes.

Slot lifecycle (see also :class:`repro_torch.core.engine.SlotState`)
--------------------------------------------------------------------

  queue -> ADMIT -> RUNNING -> FINISHED -> harvest -> (lane FREE)

  * ADMIT (between chunks only): the scheduler assigns urgency-ordered
    tickets to free lanes; :func:`engine.admit_into_slot` then
    overwrites EVERY per-slot field in place -- state, sampler, budget,
    active flag -- so a reused lane cannot leak its previous occupant's
    duals; the request's packed operand is copied into its lane of the
    batch buffers (in place, no reallocation).  Each lane's sampler is a
    ``torch.Generator`` on the device seeded with the request's seed, as
    the solo ``saddle.solve`` seeds its own.
  * RUNNING: the slot steps while ``t < max_t`` and (if the request
    set ``gap_tol``) its relative duality gap is above threshold.
    The per-slot active mask freezes finished slots WITHOUT halting
    the batch.
  * FINISHED -> harvest: the host reads the (S,) active / t / objective /
    health vectors after each chunk in ONE transfer, extracts finished
    slots, and recovers each request's input-space (w, b) via the
    ``svm.py`` path (:func:`repro_torch.core.svm.recover_hyperplane`).

Set-up discipline
-----------------

A chunk configuration is keyed by (S, bucket shape, block size,
chunk_steps, project, check_gap) (``engine.slot_trace_key``); eager
PyTorch compiles nothing, so ``engine.trace_counts`` records each key
once, when it is first set up.  After a bucket's first chunk, no chunk,
admission, fault or update adds a key (``SolverService.stats``).

Status contract & fault handling
--------------------------------

Every request walks the scheduler's :class:`~repro_torch.serve.scheduler.
Status` lifecycle (PENDING -> RUNNING -> DONE / FAILED / CANCELLED /
DEADLINE_EXCEEDED / SUPERSEDED), readable any time via ``status(rid)``:

  * INTAKE: ``submit`` fails fast with ``ValueError`` on non-finite
    ``x``/``y``, shape mismatches, single-class ``y``, infeasible
    ``nu`` and over-ladder shapes -- a malformed request never reaches
    a device lane.
  * QUARANTINE: the chunk returns a per-slot finite-health flag
    (:func:`repro_torch.core.engine.run_chunk_slots`); a slot whose
    state diverged to NaN/Inf is quarantined at the chunk boundary --
    lane freed for re-admission, batch-mates bit-for-bit unaffected
    (every op of the step is per lane) -- and either retried
    (``FitRequest.max_retries``, re-enqueued BEHIND waiting tickets:
    backoff ordering) or failed with a structured
    :class:`~repro_torch.serve.scheduler.RequestFailure`.
  * DEADLINES: constructed with a ``clock``, the service sheds every
    queued ticket whose deadline has passed at the top of each step
    (DEADLINE_EXCEEDED).  Without a clock, deadlines only order.
  * CANCEL: ``cancel(rid)`` removes a queued ticket eagerly or frees a
    running lane between chunks (the device slot is deactivated; the
    batch shape never changes).

``result(rid)`` returns the ``FitResult`` OR the ``RequestFailure``;
on a known-but-unfinished rid it raises
:class:`~repro_torch.serve.scheduler.ResultNotReady` (a ``KeyError``
subclass -- unknown rids raise a bare ``KeyError``).

Every device write of the service (admission, poison, cancel) and every
chunk runs on the current CUDA stream: the packed kernels share one
workspace of ticket counters per device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import preprocess as pp
from repro_torch.core import saddle
from repro_torch.core import svm as svm_mod
from repro_torch.device import resolve_device
from repro_torch.serve import faults as faults_mod
from repro_torch.serve.scheduler import (RequestFailure, ResultNotReady,
                                         Scheduler, Status)


@dataclass
class FitRequest:
    """One SVM fit: raw (x, y) plus the solver configuration a
    ``SaddleSVC``/``SaddleNuSVC`` would take.  ``nu=0`` is hard margin.
    ``gap_tol > 0`` enables the per-slot duality-gap early stop (the
    request may then finish before ``num_iters``).  ``max_retries``
    bounds how many times a quarantined (non-finite) run is re-admitted
    before the request fails for good.  ``stream=True`` declares a LIVE
    TENANT: the service retains the request's preprocessing transform
    and, at harvest, its final saddle state, so later
    :class:`UpdateRequest`\\ s can edit the data and warm-start the
    re-fit (see ``submit_update``).

    ``signs`` (the transform's +-1 diagonal, d_pad values) and
    ``idx_schedule`` (the solver's (steps, block_size) coordinate
    blocks) replace the seeded draws, as ``SaddleSVC.fit`` takes them,
    to replay another run exactly."""
    x: np.ndarray
    y: np.ndarray
    eps: float = 1e-3
    beta: float = 0.1
    nu: float = 0.0
    num_iters: int | None = None
    block_size: int = 1
    seed: int = 0
    gap_tol: float = 0.0
    max_retries: int = 0
    stream: bool = False
    signs: np.ndarray | None = None
    idx_schedule: np.ndarray | None = None


@dataclass
class UpdateRequest:
    """One STREAMING UPDATE of a live tenant's problem: edit the data
    (append new labelled points, replace the whole set, or neither for
    a pure re-fit) and re-solve -- warm-started from the tenant's last
    completed saddle state unless ``warm=False`` (the cold reference).

    ``tenant`` is the rid of the original ``stream=True`` fit.  ``x``/
    ``y`` are new raw points in the tenant's ORIGINAL input space (the
    tenant's fixed WD transform+scale is applied at intake,
    ``preprocess.transform_like``); ``mode="append"`` may carry a
    single class (the tenant already has both), ``mode="replace"``
    must carry both.  ``nu``/``num_iters``/``gap_tol``/``max_retries``
    default to the tenant's original configuration when None.

    An accepted update SUPERSEDES the tenant's in-flight request, if
    any (its ticket terminates with ``Status.SUPERSEDED``); already
    completed results stay claimable.  The dataset edit is applied at
    intake and survives even if this update's solve later fails."""
    tenant: int
    x: np.ndarray | None = None
    y: np.ndarray | None = None
    mode: str = "append"
    warm: bool = True
    nu: float | None = None
    num_iters: int | None = None
    gap_tol: float | None = None
    max_retries: int | None = None


class FitResult(NamedTuple):
    """Input-space hyperplane (the ``svm.py`` recovery path) plus the
    serving metadata of the request's ride through the batch."""
    request_id: int
    w: np.ndarray
    b: float
    objective: float
    margin: float
    iterations: int          # iterations actually run (gap stop <= budget)
    bucket: tuple            # (n_bucket, d_bucket) the request shared
    history: list            # [(iteration, objective)] at chunk marks


class _WarmState(NamedTuple):
    """A tenant's last COMPLETED saddle state, host-retained at harvest
    (idle-group eviction frees the device lane, so warm state cannot
    stay slot-resident).  ``log_lam``/``log_lam_prev`` are in the
    packed layout of the bucket the state was harvested at; only the
    first ``n1 + n2`` entries are meaningful
    (``preprocess.repack_warm_duals`` re-places them at admission)."""
    w: np.ndarray            # (d_bucket,) transformed-space direction
    log_lam: np.ndarray      # (n_pad_old,) packed log duals
    log_lam_prev: np.ndarray
    n1: int                  # class sizes the state was fit at
    n2: int


class _Tenant:
    """Host-side record of one live streaming tenant: the FIXED
    preprocessing transform, the CURRENT transformed class matrices
    (updates edit these at intake), the original request as the config
    template for derived update fits, and the warm-start state."""

    __slots__ = ("pre", "xp_t", "xm_t", "req", "warm", "live_rid",
                 "version")

    def __init__(self, pre: pp.Preprocessed, xp_t: torch.Tensor,
                 xm_t: torch.Tensor, req: FitRequest):
        self.pre = pre
        self.xp_t = xp_t
        self.xm_t = xm_t
        self.req = req
        self.warm: _WarmState | None = None
        self.live_rid: int | None = None   # in-flight fit/update rid
        self.version = 0                   # bumped per accepted update


class _Admission(NamedTuple):
    """Everything the admission path needs to (re-)stage one request
    into a device lane: the transform, the class matrices, the warm
    state to start from (None = cold uniform init), the owning
    streaming tenant (None = plain fit) and an injected coordinate
    schedule (None = the lane's own sampler).  Stored per queued rid; a
    quarantine retry re-stashes the SAME record, so the retry re-enters
    from the last good warm state."""
    pre: pp.Preprocessed
    xp_t: torch.Tensor
    xm_t: torch.Tensor
    warm: _WarmState | None
    tenant: int | None
    schedule: torch.Tensor | None


class _Slot(NamedTuple):
    """Host-side bookkeeping for one RUNNING lane (attached to the
    scheduler ticket as ``ticket.note``)."""
    request_id: int
    req: FitRequest
    adm: _Admission          # how the lane was staged (retry re-stages it)
    history: list


def _write_slot_data(batch: "_Batch", slot: int, x_t: torch.Tensor,
                     sign: torch.Tensor) -> None:
    """Copy one request's packed operand into lane ``slot`` of the batch
    buffers, in place."""
    batch.x_t[slot].copy_(x_t)
    batch.sign[slot].copy_(sign)


# a free lane's step scalars (its outputs are discarded by the mask)
_FREE_ROW = engine.SlotParams(*(np.float32(v) for v in (
    0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0)))


class _Batch:
    """One bucket's DEVICE buffers: slot-batched engine state, the
    (S, d, n) packed operands and the per-slot SlotParams rows (numpy
    float32, mirrored on the device by ``engine.stack_slot_params`` when
    an admission changed them).  The host-side queue and lane occupancy
    live in the scheduler's Group (this object is that group's
    ``payload``).

    ``project``/``check_gap`` are FIXED at batch creation (hard-margin
    and nu-SVM requests live in separate batches): a request's chunk
    configuration -- and therefore its numeric trajectory -- is fully
    determined by the request itself, never by which co-tenants happen
    to share its bucket at admission time."""

    def __init__(self, bucket: tuple[int, int], num_slots: int,
                 project: bool, check_gap: bool, device: torch.device):
        n_pad, d_pad = bucket
        self.bucket = bucket
        self.project = project
        self.check_gap = check_gap
        self.state = engine.init_slot_state(num_slots, n_pad, d_pad, device)
        self.x_t = torch.zeros((num_slots, d_pad, n_pad), dtype=torch.float32,
                               device=device)
        self.sign = torch.zeros((num_slots, n_pad), dtype=torch.float32,
                                device=device)
        self.sp = [_FREE_ROW] * num_slots
        self.sp_dev = None                      # device mirror of sp


class SolverService:
    """Continuous-batching fit endpoint over the slot-batched engine.

    ``submit`` enqueues a request (assigning it a ticket id); ``step``
    runs ONE chunk of one bucket's batch -- admitting queued requests
    into free lanes first, harvesting finished slots after -- and
    returns any completed :class:`FitResult`s; ``run`` drains
    everything.  ``fit`` is the one-shot convenience wrapper.

    ``policy`` selects the cross-bucket scheduler: ``"oldest"``
    (default, latency-aware oldest-request-first, fill-rate tie-break)
    or ``"round_robin"``.  Results are policy-invariant (see the module
    docstring); only queue latency changes.

    ``device`` is ``"cuda"`` (the default) or ``"cpu"``.  ``mesh`` and
    ``shard_points_above`` (the JAX package's multi-device placements)
    raise NotImplementedError.

    The service is host-driven between chunks (admission and harvest are
    O(S) scalar decisions); all per-iteration work stays inside the
    chunk.
    """

    def __init__(self, num_slots: int = 8, chunk_steps: int = 64,
                 policy: str = "oldest", clock=None, fault_injector=None,
                 max_points: int = 1 << 20, max_dim: int = 1 << 14,
                 mesh=None, shard_points_above: int | None = None,
                 device: str | torch.device | None = None):
        if mesh is not None or shard_points_above is not None:
            raise NotImplementedError(
                "mesh-sharded serving (mesh=, shard_points_above=) is not "
                "ported yet: the chunk is (engine.run_chunk_slots_sharded), "
                "the service over a process group is not; see ROADMAP.md")
        self.device = resolve_device(device)
        self.num_slots = num_slots
        self.chunk_steps = chunk_steps
        # Deadline semantics are OPT-IN: without a clock, deadlines are
        # pure urgency ordering; with ``clock`` (e.g. ``time.monotonic``)
        # queued tickets whose deadline is past clock() are shed each step.
        self._clock = clock
        self._injector = fault_injector     # faults.FaultInjector | None
        self.max_points = max_points        # over-ladder intake bounds:
        self.max_dim = max_dim              # largest admissible bucket
        self._sched = Scheduler(num_slots=num_slots, policy=policy)
        self._results: dict[int, FitResult | RequestFailure] = {}
        self._pre_cache: dict[int, _Admission] = {}
        self._tickets: dict[int, Any] = {}  # rid -> live (non-terminal)
        self._tenants: dict[int, _Tenant] = {}   # streaming tenants
        self._rid_tenant: dict[int, int] = {}    # live rid -> tenant id
        self._next_id = 0

    @property
    def _batches(self) -> dict:
        """Bucket key -> device-buffer payload (for tests and
        introspection; the scheduler owns the group table)."""
        return {g.key: g.payload for g in self._sched.groups}

    # ------------------------------------------------------------ intake
    def submit(self, req: FitRequest, *, priority: int = 0,
               deadline: float | None = None) -> int:
        """Validate, preprocess and enqueue a fit request; returns its
        ticket id.  The per-request work here (split, WD transform on the
        device, bucket choice) is Algorithm 1, run at intake, with the
        transform's signs drawn as ``SaddleSVC`` draws them from the
        request's seed.  ``priority``/``deadline`` feed the scheduler's
        urgency order (see :mod:`repro_torch.serve.scheduler`).

        Fails fast (``ValueError`` naming the offending field) on
        malformed requests -- non-finite ``x``/``y``, shape
        mismatches, single-class ``y``, infeasible ``nu``, over-ladder
        shapes -- so one bad tenant is rejected at intake instead of
        poisoning a device lane."""
        x = np.asarray(req.x)
        y = np.asarray(req.y)
        if x.ndim != 2:
            raise ValueError(
                f"FitRequest.x must be 2-D (n, d); got shape {x.shape}")
        if y.shape != (x.shape[0],):
            raise ValueError(
                f"FitRequest.y must be shape ({x.shape[0]},) to match "
                f"x; got {y.shape}")
        if not np.isfinite(x).all():
            raise ValueError(
                "FitRequest.x contains non-finite values (NaN/Inf)")
        if not np.isfinite(y.astype(np.float64, copy=False)).all():
            raise ValueError(
                "FitRequest.y contains non-finite values (NaN/Inf)")
        if x.shape[0] > self.max_points or x.shape[1] > self.max_dim:
            raise ValueError(
                f"FitRequest.x shape {x.shape} exceeds the service's "
                f"bucket ladder (max_points={self.max_points}, "
                f"max_dim={self.max_dim})")
        xp, xm = svm_mod.split_classes(x, y)      # raises on 1 class
        n1, n2 = len(xp), len(xm)
        saddle.validate_nu(req.nu, n1, n2)
        gen = torch.Generator().manual_seed(
            svm_mod._preprocess_seed(req.seed))
        pre = pp.preprocess(xp, xm, generator=gen, signs=req.signs,
                            device=self.device)
        schedule = None
        if req.idx_schedule is not None:
            d_pad = pre.xp.shape[1]
            steps = saddle.resolve_num_iters(req.num_iters, d_pad, req.eps,
                                             req.beta, n1 + n2,
                                             req.block_size)
            schedule = saddle._schedule(req.idx_schedule, steps, d_pad,
                                        req.block_size, self.device)[:, 0]
        rid = self._next_id
        self._next_id += 1
        self._enqueue(rid, req, n1, n2, pre.xp.shape[1],
                      priority=priority, deadline=deadline)
        self._pre_cache[rid] = _Admission(
            pre=pre, xp_t=pre.xp, xm_t=pre.xm, warm=None,
            tenant=rid if req.stream else None, schedule=schedule)
        if req.stream:
            self._tenants[rid] = _Tenant(pre, pre.xp, pre.xm, req)
            self._tenants[rid].live_rid = rid
            self._rid_tenant[rid] = rid
        return rid

    def _enqueue(self, rid: int, req: FitRequest, n1: int, n2: int,
                 d_pre: int, *, priority: int,
                 deadline: float | None):
        """Shared tail of ``submit``/``submit_update``: derive the
        bucket group key and enqueue the ticket.  ONE derivation for
        both intakes, so an update can never land beside a plain fit
        under a different key discipline."""
        bucket = pp.bucket_shape(n1 + n2, d_pre)
        # everything that keys the chunk configuration also keys the
        # batch: block_size (shape), project (nu>0) and check_gap
        # (gap_tol>0) -- so co-tenancy can never change a request's
        # trajectory and the warm-up set is exactly the batch set
        project = req.nu > 0.0
        check_gap = req.gap_tol > 0.0
        batch_key = bucket + (req.block_size, project, check_gap)
        ticket = self._sched.submit(
            batch_key, rid, req, priority=priority, deadline=deadline,
            payload_factory=lambda: _Batch(bucket, self.num_slots, project,
                                           check_gap, self.device),
            num_slots=self.num_slots)
        self._tickets[rid] = ticket
        return ticket

    # ---------------------------------------------------------- updates
    def submit_update(self, ureq: UpdateRequest, *, priority: int = 0,
                      deadline: float | None = None) -> int:
        """Edit a live tenant's problem and enqueue its re-fit;
        returns the new ticket id.

        Validation-first, then commit: shape/finiteness/label checks,
        nu RE-validation at the post-edit class sizes, and the bucket
        ladder bound (an update that would overflow ``max_points``
        fails fast HERE with a ValueError -- it never reaches a device
        lane).  Only once the update is accepted does it mutate the
        tenant: the dataset edit is applied (and survives even if the
        re-fit later fails), the tenant's in-flight request -- if any --
        is SUPERSEDED, and the re-fit is enqueued exactly like any
        admission.  When the new point count still fits the tenant's
        current pow-2 rung the update re-packs in place (same bucket);
        when it does not, the re-fit lands on the next rung.

        The re-fit WARM-STARTS from the tenant's last completed state
        (``warm=False`` forces the cold uniform init): append mode
        carries the old points' dual mass and seeds only the new points
        at the uniform level; replace mode carries ``w`` but resets all
        dual mass, since the old points no longer exist.  A tenant with
        no completed fit yet falls back to cold."""
        ten = self._tenants.get(ureq.tenant)
        if ten is None:
            raise KeyError(
                f"unknown streaming tenant {ureq.tenant} (submit the "
                f"original fit with stream=True)")
        if ureq.mode not in ("append", "replace"):
            raise ValueError(
                f"UpdateRequest.mode must be 'append' or 'replace'; "
                f"got {ureq.mode!r}")
        if (ureq.x is None) != (ureq.y is None):
            raise ValueError(
                "UpdateRequest.x and .y must be given together "
                "(both None = pure re-fit of the current data)")
        xp_t, xm_t = ten.xp_t, ten.xm_t
        if ureq.x is not None:
            x = np.asarray(ureq.x)
            y = np.asarray(ureq.y)
            if x.ndim != 2:
                raise ValueError(
                    f"UpdateRequest.x must be 2-D (m, d); got shape "
                    f"{x.shape}")
            if y.shape != (x.shape[0],):
                raise ValueError(
                    f"UpdateRequest.y must be shape ({x.shape[0]},) to "
                    f"match x; got {y.shape}")
            if not np.isfinite(x).all():
                raise ValueError(
                    "UpdateRequest.x contains non-finite values "
                    "(NaN/Inf)")
            if not np.isfinite(y.astype(np.float64, copy=False)).all():
                raise ValueError(
                    "UpdateRequest.y contains non-finite values "
                    "(NaN/Inf)")
            xp_new = x[y > 0]
            xm_new = x[y < 0]
            if len(xp_new) + len(xm_new) != len(x):
                raise ValueError(
                    "UpdateRequest.y must be +-1 labels; got "
                    f"{np.unique(y).tolist()}")
            # the tenant's FIXED transform (raises on a d mismatch)
            txp = (pp.transform_like(ten.pre, xp_new) if len(xp_new)
                   else ten.xp_t[:0])
            txm = (pp.transform_like(ten.pre, xm_new) if len(xm_new)
                   else ten.xm_t[:0])
            if ureq.mode == "append":
                xp_t = torch.cat([ten.xp_t, txp]) if len(xp_new) \
                    else ten.xp_t
                xm_t = torch.cat([ten.xm_t, txm]) if len(xm_new) \
                    else ten.xm_t
            else:
                xp_t, xm_t = txp, txm
        n1, n2 = int(xp_t.shape[0]), int(xm_t.shape[0])
        if n1 == 0 or n2 == 0:
            raise ValueError(
                "UpdateRequest(mode='replace') must carry both classes "
                f"(+1 and -1); got {n1} positive and {n2} negative "
                f"points")
        nu_eff = ten.req.nu if ureq.nu is None else ureq.nu
        saddle.validate_nu(nu_eff, n1, n2)   # nu RE-validation post-edit
        if n1 + n2 > self.max_points:
            raise ValueError(
                f"update for tenant {ureq.tenant} grows the problem to "
                f"{n1 + n2} points, exceeding the service's bucket "
                f"ladder (max_points={self.max_points})")

        # -- validated: commit the edit and enqueue the re-fit --------
        rid = self._next_id
        self._next_id += 1
        replaced = ureq.mode == "replace" and ureq.x is not None
        if ten.live_rid is not None:
            self._supersede(ten.live_rid, rid)
        ten.xp_t, ten.xm_t = xp_t, xm_t
        ten.version += 1
        if replaced and ten.warm is not None:
            # old points no longer exist: dual mass cannot transfer.
            # Keep w (same transformed space) but reset the dual
            # segments to uniform -- n1=n2=0 makes repack_warm_duals
            # ignore the stale arrays entirely.
            ten.warm = ten.warm._replace(n1=0, n2=0)
        req = dc_replace(
            ten.req,
            # raw x/y are never read for updates (the transformed
            # matrices above are authoritative); drop the stale arrays
            x=None, y=None, signs=None, idx_schedule=None,
            nu=nu_eff,
            num_iters=(ten.req.num_iters if ureq.num_iters is None
                       else ureq.num_iters),
            gap_tol=(ten.req.gap_tol if ureq.gap_tol is None
                     else ureq.gap_tol),
            max_retries=(ten.req.max_retries if ureq.max_retries is None
                         else ureq.max_retries),
            # deterministic per-revision schedule: warm and cold
            # re-fits of the same revision share it, revisions differ
            seed=ten.req.seed + 1000003 * ten.version,
            stream=True)
        self._enqueue(rid, req, n1, n2, int(xp_t.shape[1]),
                      priority=priority, deadline=deadline)
        warm = ten.warm if ureq.warm else None
        self._pre_cache[rid] = _Admission(
            pre=ten.pre, xp_t=xp_t, xm_t=xm_t, warm=warm,
            tenant=ureq.tenant, schedule=None)
        ten.live_rid = rid
        self._rid_tenant[rid] = ureq.tenant
        return rid

    def _supersede(self, rid_old: int, rid_new: int) -> None:
        """Terminate the tenant's stale in-flight request with
        SUPERSEDED: a queued ticket is removed eagerly, a running one
        has its lane deactivated and freed (between chunks -- the
        service is host-driven).  The stale outcome is a claimable
        :class:`RequestFailure` naming the superseding rid."""
        if rid_old in self._tickets:
            reason = f"superseded by update request {rid_new}"
            self._terminate(rid_old, Status.SUPERSEDED, reason, reason)

    def close_stream(self, tenant: int) -> bool:
        """Drop a streaming tenant's host-side record (transform,
        transformed matrices, warm state).  An in-flight re-fit keeps
        running and its result stays claimable; it just no longer
        updates warm state at harvest.  Returns False on unknown
        tenants."""
        return self._tenants.pop(tenant, None) is not None

    # --------------------------------------------------------- admission
    def _admit(self, group) -> None:
        """Realize the scheduler's urgency-ordered lane assignments in
        device state (between chunks), in place."""
        batch = group.payload
        n_pad, d_pad = batch.bucket
        for lane, ticket in self._sched.admit(group):
            req = ticket.payload
            adm = self._pre_cache.pop(ticket.rid)
            xp_t, xm_t = adm.xp_t, adm.xm_t
            # preprocess() already padded d to a power of two, so the
            # request's dimensionality IS the batch's d rung
            assert xp_t.shape[1] == d_pad, (xp_t.shape, batch.bucket)
            n1, n2 = xp_t.shape[0], xm_t.shape[0]
            pts = pp.pack_points(xp_t, xm_t, pad_to=n_pad)
            params = saddle.make_params(
                n1 + n2, d_pad, req.eps, req.beta, nu=req.nu,
                block_size=req.block_size)
            # the SAME budget derivation as saddle.solve (shared
            # helper), so a request's schedule equals its solo solve's
            num_iters = saddle.resolve_num_iters(
                req.num_iters, d_pad, req.eps, req.beta, n1 + n2,
                req.block_size)
            _write_slot_data(batch, lane, pts.x_t, pts.sign)
            if adm.warm is not None:
                # WARM admission: re-place the carried dual segments at
                # the new class offsets (appended points seeded at the
                # uniform level; the next MWU normalizer round
                # renormalizes each class), and recompute u from the
                # carried w on the device, as saddle.solve(warm_start=)
                # does.  Neither touches a chunk set-up key.
                lam = pp.repack_warm_duals(
                    adm.warm.log_lam, adm.warm.n1, adm.warm.n2,
                    n1, n2, n_pad)
                prev = pp.repack_warm_duals(
                    adm.warm.log_lam_prev, adm.warm.n1, adm.warm.n2,
                    n1, n2, n_pad)
                dev = self.device
                pstate = engine.warm_packed_state(
                    pts.x_t, torch.as_tensor(adm.warm.w, device=dev),
                    torch.as_tensor(lam, device=dev),
                    torch.as_tensor(prev, device=dev))
            else:
                pstate = engine.init_packed_state(pts.sign, n1, n2,
                                                  d_pad)
            gen = torch.Generator(device=self.device).manual_seed(req.seed)
            engine.admit_into_slot(batch.state, lane, pstate, gen,
                                   num_iters)
            batch.sp[lane] = engine.slot_params_row(params, req.gap_tol)
            batch.sp_dev = None                 # refresh device mirror
            ticket.note = _Slot(request_id=ticket.rid, req=req, adm=adm,
                                history=[])

    def _chunk_blocks(self, group) -> torch.Tensor | None:
        """The next chunk's (chunk_steps, S, b) coordinate blocks when a
        lane replays an injected schedule, else None (every lane draws
        from its own sampler inside the chunk).  A replaying lane takes
        the rows of its schedule from its chunk index on (rows past its
        budget are never applied); every other lane draws from its own
        generator exactly as the chunk would."""
        lanes = {lane: t.note for lane, t in group.slots.items()}
        if all(slot.adm.schedule is None for slot in lanes.values()):
            return None
        batch = group.payload
        d, c = batch.bucket[1], self.chunk_steps
        b = next(iter(lanes.values())).req.block_size
        cols = []
        for lane, gen in enumerate(batch.state.generators):
            slot = lanes.get(lane)
            if slot is None or slot.adm.schedule is None:
                cols.append(engine.sample_blocks([gen], d, b, c,
                                                 self.device)[:, 0])
                continue
            rows = slot.adm.schedule[len(slot.history) * c:][:c]
            pad = torch.arange(b, dtype=rows.dtype, device=rows.device)
            cols.append(torch.cat([rows, pad.expand(c - len(rows), b)]))
        return torch.stack(cols, dim=1)

    # ----------------------------------------------------------- failure
    def _record_failure(self, ticket, status: Status, reason: str) -> None:
        """Terminal non-result: structured record claimable via
        ``result(rid)``, live bookkeeping dropped.  A streaming
        tenant's failed/superseded re-fit clears the tenant's live-rid
        (the tenant itself, its dataset and its last good warm state
        all survive -- the next update retries from there)."""
        self._results[ticket.rid] = RequestFailure(
            request_id=ticket.rid, status=status, reason=reason,
            attempts=ticket.attempts)
        self._pre_cache.pop(ticket.rid, None)
        self._tickets.pop(ticket.rid, None)
        ten_id = self._rid_tenant.pop(ticket.rid, None)
        if ten_id is not None:
            ten = self._tenants.get(ten_id)
            if ten is not None and ten.live_rid == ticket.rid:
                ten.live_rid = None

    def _terminate(self, rid: int, status: Status, queued: str,
                   running: str) -> bool:
        """End a live request with ``status``: a queued ticket is removed
        eagerly (reason ``queued``), a running one has its lane
        deactivated on the device and freed (reason ``running``); the
        outcome is a claimable :class:`RequestFailure`.  Returns False
        when ``rid`` is neither queued nor running."""
        hit = self._sched.cancel_queued(rid, status)
        if hit is not None:
            g, t = hit
            self._record_failure(t, status, queued)
            self._sched.evict_idle(g)
            return True
        for g in self._sched.groups:
            for lane, t in list(g.slots.items()):
                if t.rid == rid:
                    engine.deactivate_slot(g.payload.state, lane)
                    self._record_failure(t, status, running)
                    self._sched.release(g, lane, status)
                    self._sched.evict_idle(g)
                    return True
        return False

    # ----------------------------------------------------------- harvest
    def _harvest(self, group, obj, healthy) -> list[FitResult]:
        """Record per-slot history, QUARANTINE unhealthy slots (retry
        or structured FAILED -- batch-mates are untouched), extract
        every FINISHED healthy slot through the svm.py recovery path,
        and free its lane."""
        batch = group.payload
        st = batch.state
        # ONE device-to-host transfer per chunk for all (S,)-sized
        # lifecycle vectors; the big per-slot state only moves for
        # finished slots
        active, t, obj, healthy = torch.stack([
            v.to(torch.float64) for v in (st.active, st.t, obj, healthy)
        ]).cpu().numpy()
        out = []
        for lane, ticket in list(group.slots.items()):
            slot = ticket.note
            if not healthy[lane]:
                # Quarantine: the engine already deactivated the lane
                # on the device; free it host-side.  Within the retry
                # budget the ticket re-queues BEHIND waiting tickets
                # (fresh arrival = backoff ordering); past it, the
                # request fails with a structured record.
                if ticket.attempts <= ticket.payload.max_retries:
                    # re-stash the FULL admission record: the retry
                    # re-enters from the same (last good) warm state
                    # the poisoned attempt started from, so a clean
                    # retry is bit-for-bit a clean first run
                    self._pre_cache[ticket.rid] = slot.adm
                    self._sched.resubmit(group, lane, ticket)
                else:
                    self._record_failure(
                        ticket, Status.FAILED,
                        f"non-finite solver state detected at "
                        f"iteration {int(t[lane])} (quarantined; "
                        f"attempts={ticket.attempts})")
                    self._sched.release(group, lane, Status.FAILED)
                continue
            slot.history.append((int(t[lane]), float(obj[lane])))
            if active[lane]:
                continue
            adm = slot.adm
            n1 = adm.xp_t.shape[0]
            n2 = adm.xm_t.shape[0]
            lam = st.log_lam[lane]
            if adm.tenant is not None:
                # STREAMING harvest: host-retain the final saddle state
                # (w + dual momentum) BEFORE the lane is freed --
                # idle-group eviction drops the device buffers, so warm
                # state cannot stay slot-resident.
                ten = self._tenants.get(adm.tenant)
                if ten is not None and ten.live_rid == slot.request_id:
                    ten.warm = _WarmState(
                        w=st.w[lane].cpu().numpy(),
                        log_lam=lam.cpu().numpy(),
                        log_lam_prev=st.log_lam_prev[lane].cpu().numpy(),
                        n1=n1, n2=n2)
                    ten.live_rid = None
                self._rid_tenant.pop(slot.request_id, None)
            eta = torch.exp(lam[:n1])
            xi = torch.exp(lam[n1:n1 + n2])
            w, b, objective, margin, _ = svm_mod.recover_hyperplane(
                adm.pre, eta, xi, adm.xp_t, adm.xm_t)
            res = FitResult(request_id=slot.request_id, w=w, b=b,
                            objective=objective, margin=margin,
                            iterations=int(t[lane]), bucket=batch.bucket,
                            history=slot.history)
            self._results[slot.request_id] = res
            self._tickets.pop(slot.request_id, None)
            out.append(res)
            self._sched.release(group, lane)
        return out

    # -------------------------------------------------------------- run
    def step(self) -> list[FitResult]:
        """One scheduling round: shed expired deadlines -> policy pick
        -> admit -> one chunk -> harvest (quarantining unhealthy
        slots) -> evict-if-drained.  Returns the requests that
        finished this round."""
        # Deadline shedding FIRST (opt-in via clock): expired queued
        # tickets must neither drive the policy pick nor occupy a lane.
        if self._clock is not None:
            for g, ticket in self._sched.shed_expired(self._clock()):
                self._record_failure(
                    ticket, Status.DEADLINE_EXCEEDED,
                    f"deadline {ticket.deadline} passed before "
                    f"admission")
                self._sched.evict_idle(g)
        group = self._sched.next_group()
        if group is None:
            return []
        self._admit(group)
        if not group.slots:
            return []
        batch = group.payload
        n_pad, d_pad = batch.bucket
        project, check_gap = batch.project, batch.check_gap
        block_size = next(iter(group.slots.values())).payload.block_size
        key = engine.slot_trace_key(group.num_slots, n_pad, d_pad,
                                    block_size, self.chunk_steps, project,
                                    check_gap)
        # Always run FULL chunks: a slot near its budget is frozen by
        # the per-slot mask at exactly max_t, which keeps every slot's
        # chunk/sampler schedule identical to a solo solve with
        # record_every == chunk_steps (the parity contract).
        if batch.sp_dev is None:
            batch.sp_dev = engine.stack_slot_params(batch.sp, self.device)
        # Deterministic fault injection (tests/bench only): poison a
        # targeted lane BEFORE its chunk, in place; it adds no set-up
        # key.  A request's chunk index is the length of its history.
        if self._injector is not None:
            for lane, ticket in group.slots.items():
                if self._injector.poison_due(ticket.rid,
                                             len(ticket.note.history)):
                    faults_mod.poison_slot_state(batch.state, lane)
        idx = self._chunk_blocks(group)
        with self._sched.stats.chunk(key, engine.trace_counts):
            batch.state, obj, healthy = engine.run_chunk_slots(
                batch.state, batch.x_t, batch.sign, batch.sp_dev,
                self.chunk_steps, chunk_steps=self.chunk_steps, d=d_pad,
                block_size=block_size, project=project,
                check_gap=check_gap, idx=idx)
        out = self._harvest(group, obj, healthy)
        # Idle-batch eviction: a drained batch's device buffers (slot
        # state + the (S, d, n) operand) are released, so varied request
        # shapes do not hold device memory.
        self._sched.evict_idle(group)
        return out

    def run(self) -> dict[int, FitResult]:
        """Drain every queue; returns (and RELEASES) every result
        completed since the last drain -- results are not retained
        service-side, so a long-running service stays O(active slots),
        not O(requests served)."""
        while self._sched.has_work():
            self.step()
        out, self._results = self._results, {}
        return out

    # ------------------------------------------------------------ status
    def status(self, rid: int) -> Status:
        """The request's lifecycle state: DONE/FAILED/CANCELLED/
        DEADLINE_EXCEEDED/SUPERSEDED once terminal (until its result is
        claimed), PENDING/RUNNING while live.  KeyError on unknown or
        claimed rids."""
        res = self._results.get(rid)
        if res is not None:
            return (res.status if isinstance(res, RequestFailure)
                    else Status.DONE)
        return self._tickets[rid].status

    def result(self, rid: int) -> FitResult | RequestFailure:
        """Pop one terminal outcome: the :class:`FitResult`, or the
        structured :class:`RequestFailure` (quarantined / cancelled /
        deadline-shed / superseded).  A KNOWN rid still in flight raises
        :class:`ResultNotReady`; an unknown (or already claimed) rid
        raises a bare ``KeyError``."""
        if rid in self._results:
            return self._results.pop(rid)
        if rid in self._tickets:
            raise ResultNotReady(
                f"request {rid} is {self._tickets[rid].status.value}")
        raise KeyError(rid)

    def cancel(self, rid: int) -> bool:
        """Cancel a live request: a QUEUED ticket is removed eagerly, a
        RUNNING one has its device lane deactivated and freed (the
        service is host-driven, so this is always between chunks).
        Returns True if cancelled; False for unknown/terminal rids.
        The outcome is a claimable CANCELLED :class:`RequestFailure`."""
        if rid not in self._tickets:
            return False
        return self._terminate(rid, Status.CANCELLED,
                               "cancelled while queued",
                               "cancelled while running")

    def fit(self, x, y, **kw) -> FitResult:
        """One-shot convenience: submit + drain (still the full slot
        path).  Other requests completed by the drain stay claimable via
        ``result()``.  Raises ``RuntimeError`` if the request was
        quarantined past its retry budget."""
        rid = self.submit(FitRequest(x=x, y=y, **kw))
        out = self.run()
        res = out.pop(rid)
        self._results.update(out)      # keep co-drained results claimable
        if isinstance(res, RequestFailure):
            raise RuntimeError(
                f"fit request {rid} failed: {res.status.value} "
                f"({res.reason})")
        return res

    # ------------------------------------------------------------- stats
    @property
    def stats(self) -> dict:
        """Set-up accounting (scheduler-tracked): ``compiles`` counts
        the chunk set-ups (new ``engine.trace_counts`` keys) observed
        during THIS service's chunk dispatches, ``cache_hits`` the chunk
        calls that set up nothing.  After warm-up every call is a hit."""
        return self._sched.stats.as_dict()

    @property
    def latencies(self):
        """(request_id, queue-to-result seconds) per completed request
        -- stamped by the scheduler at submit and release (bounded
        sliding window)."""
        return self._sched.latencies

    def latency_percentiles(self, *pcts: float) -> dict[float, float]:
        """Queue-to-result latency percentiles (seconds), e.g.
        ``svc.latency_percentiles(50.0, 95.0)``."""
        return self._sched.latency_percentiles(*pcts)
