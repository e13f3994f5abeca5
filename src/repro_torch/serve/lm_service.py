"""Continuous-batching LM generation service with mid-decode admission:
the counterpart of ``repro.serve.lm_service``, on the port's scheduler.

  * S decode LANES share one slot-granular decode chunk
    (:func:`repro_torch.serve.engine.decode_chunk_slots`): each lane has
    its own cache row, position, sampling chain, token budget and active
    flag, so sequences at different depths decode together, and a
    finished sequence freezes (active mask) without halting the batch.
  * Between decode chunks the host admits queued prompts into freed
    lanes: one bucketed prefill per request (``_prefill_bucketed`` at the
    service's ``max_len``) fills a fresh lane cache with the index rewound
    to the true prompt length, and ``admit_lane`` overwrites every
    per-lane field.
  * Queue order (arrival / priority / deadline), admission into freed
    slots, idle eviction, queue-to-result latency stamps and set-up
    accounting are the scheduler's, shared with the fit service.

Parity contract: a sequence admitted mid-decode into a freed lane
reproduces the solo ``engine.generate(..., seed=s, max_len=max_len,
rows=service.rows)`` TOKEN FOR TOKEN at the same seed and prompt bucket,
for any number of lanes (decode is batch-invariant at a given row count,
``models.transformer``).  Exact for full-attention caches (GQA and MLA)
only: window configs (ring buffers) take the FALLBACK path, where
requests still flow through the scheduler's queue but each runs a solo
``generate`` to completion.

Set-up discipline: one decode-chunk configuration per service (keyed by
(model, S, max_len, chunk_steps, temperature)) plus one prefill per pow-2
prompt bucket; once those are warm, no request sets up anything new.

Status contract and fault handling are the fit service's: requests walk
the scheduler's ``Status`` lifecycle; ``submit`` fails fast
(``ValueError`` naming the field) on malformed prompts, out-of-vocab ids,
non-positive step counts and over-capacity shapes; an unhealthy lane
(non-finite logits, the chunk's per-lane flag) is quarantined at the
boundary, its batch-mates token for token unaffected, and retried within
``GenRequest.max_retries`` or FAILED; with a ``clock`` expired queued
tickets are shed; ``cancel(rid)`` frees queued or running lanes between
chunks.  Harvest reads the device once a chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.transformer import decode_rows
from repro_torch.serve import engine
from repro_torch.serve import faults as faults_mod
from repro_torch.serve.scheduler import (RequestFailure, ResultNotReady,
                                         Scheduler, Status)

# All lanes share one decode configuration whatever the prompt bucket, so
# the LM side is a single scheduler group.
_GROUP = "decode"


@dataclass
class GenRequest:
    """One generation request: a 1-D prompt token array plus the
    sampling configuration a solo ``generate`` call would take
    (``temperature`` is service-level).  ``max_retries`` bounds
    re-admissions after a quarantine."""
    prompt: np.ndarray
    steps: int
    seed: int = 0
    max_retries: int = 0


class GenResult(NamedTuple):
    """Generated tokens plus the serving metadata of the request's ride
    through the decode batch."""
    request_id: int
    tokens: np.ndarray       # (steps,) generated token ids
    prompt_len: int
    bucket: int              # pow-2 prompt bucket the prefill used
    admitted_chunk: int      # service decode-chunk count at admission
                             # (> 0 == admitted mid-decode)


class _LaneLog:
    """Host-side token accumulator for one RUNNING lane (the scheduler
    ticket's ``note``)."""

    __slots__ = ("req", "tokens", "t_seen", "admitted_chunk")

    def __init__(self, req: GenRequest, admitted_chunk: int):
        self.req = req
        self.tokens: list[np.ndarray] = []
        self.t_seen = 0
        self.admitted_chunk = admitted_chunk


class LMService:
    """Continuous-batching generation endpoint over the slot-granular
    decode driver, on the device of ``model``.

    ``submit`` enqueues a prompt; ``step`` runs ONE decode chunk
    (admitting queued prompts into freed lanes first, harvesting finished
    sequences after) and returns the completed :class:`GenResult`s;
    ``run`` drains everything; ``generate`` is the one-shot wrapper.
    ``max_len`` is the per-lane cache capacity: every admitted request
    must satisfy ``prompt_bucket + steps <= max_len``.  ``rows`` is the
    padded row count of its decode steps (``decode_rows(num_slots)``)."""

    def __init__(self, model, *, num_slots: int = 4, chunk_steps: int = 8,
                 max_len: int = 128, temperature: float = 0.0,
                 policy: str = "oldest", cache_dtype=torch.bfloat16,
                 clock=None, fault_injector=None):
        self.model = model
        self.cfg = model.cfg
        self.num_slots = num_slots
        self.rows = decode_rows(num_slots)
        self.chunk_steps = chunk_steps
        self.max_len = max_len
        self.temperature = temperature
        self.cache_dtype = cache_dtype
        self._clock = clock                 # opt-in deadline shedding
        self._injector = fault_injector     # faults.FaultInjector | None
        # full-attention caches only; other families -> fallback path
        self.slot_mode = engine._can_bucket(self.cfg)
        self._sched = Scheduler(
            num_slots=num_slots if self.slot_mode else 1, policy=policy)
        self._state: engine.LMSlotState | None = None
        self._results: dict[int, GenResult | RequestFailure] = {}
        self._tickets: dict[int, object] = {}   # rid -> live ticket
        self._next_id = 0
        self._chunks = 0         # decode chunks dispatched (lifetime)

    # ------------------------------------------------------------ intake
    def submit(self, prompt, steps: int, *, seed: int = 0,
               priority: int = 0, deadline: float | None = None,
               max_retries: int = 0) -> int:
        """Enqueue one prompt; returns its ticket id.  Fails fast
        (``ValueError`` naming the offending field) on malformed prompts:
        wrong rank or dtype, out-of-vocab token ids, non-positive
        ``steps``, over-capacity shapes."""
        prompt = np.asarray(prompt)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got {prompt.shape}")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(
                f"prompt must hold integer token ids, got dtype "
                f"{prompt.dtype}")
        if prompt.size and (prompt.min() < 0
                            or prompt.max() >= self.cfg.vocab_size):
            raise ValueError(
                f"prompt token ids must lie in [0, "
                f"{self.cfg.vocab_size}); got range "
                f"[{prompt.min()}, {prompt.max()}]")
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        s_b = engine.prompt_bucket(len(prompt))
        if self.slot_mode and s_b + steps > self.max_len:
            raise ValueError(
                f"prompt bucket {s_b} + steps {steps} exceeds the "
                f"service cache capacity max_len={self.max_len}")
        rid = self._next_id
        self._next_id += 1
        ticket = self._sched.submit(
            _GROUP, rid,
            GenRequest(prompt=prompt, steps=steps, seed=seed,
                       max_retries=max_retries),
            priority=priority, deadline=deadline)
        self._tickets[rid] = ticket
        return rid

    # --------------------------------------------------------- admission
    def _admit(self, group) -> None:
        """Prefill queued prompts into freed lanes (between chunks): one
        bucketed prefill per request, then the lane write.  The lane
        table is made from the first prefill's shapes."""
        for lane, ticket in self._sched.admit(group):
            req = ticket.payload
            s = len(req.prompt)
            s_b = engine.prompt_bucket(s)
            toks = np.zeros((1, s_b), np.int64)
            toks[0, :s] = req.prompt
            pkey = (self.cfg.name, s_b, self.max_len)
            with self._sched.stats.chunk(pkey, engine.trace_counts):
                pre = engine._prefill_bucketed(
                    self.model, toks, s, max_len=self.max_len,
                    cache_dtype=self.cache_dtype)
            if self._state is None:
                self._state = engine.init_lm_slot_state(pre, self.num_slots)
            self._state = engine.admit_lane(self._state, lane, pre,
                                            req.seed, req.steps)
            ticket.note = _LaneLog(req, self._chunks)

    # ----------------------------------------------------------- failure
    def _record_failure(self, ticket, status: Status, reason: str) -> None:
        """Terminal non-result: structured record claimable via
        ``result(rid)``, live bookkeeping dropped."""
        self._results[ticket.rid] = RequestFailure(
            request_id=ticket.rid, status=status, reason=reason,
            attempts=ticket.attempts)
        self._tickets.pop(ticket.rid, None)

    # ----------------------------------------------------------- harvest
    def _harvest(self, group, toks, healthy) -> list[GenResult]:
        """QUARANTINE unhealthy lanes (retry or structured FAILED; their
        batch-mates are untouched), append each healthy running lane's
        new tokens (its prefix of the chunk's (S, chunk) block), finish
        lanes whose budget is spent, and free them."""
        st = self._state
        s = st.num_slots
        # ONE blocking transfer per chunk: lifecycle vectors + tokens
        host = torch.cat([st.active.long(), st.t.long(), healthy.long(),
                          toks.reshape(-1)]).cpu().numpy()
        active, t, healthy = (host[i * s:(i + 1) * s] for i in range(3))
        toks = host[3 * s:].reshape(s, -1)
        out = []
        for lane, ticket in list(group.slots.items()):
            log = ticket.note
            if not healthy[lane]:
                # the engine already deactivated the lane; free it here.
                # Retries re-queue behind waiting tickets.
                if ticket.attempts <= ticket.payload.max_retries:
                    self._sched.resubmit(group, lane, ticket)
                else:
                    self._record_failure(
                        ticket, Status.FAILED,
                        f"non-finite logits detected after "
                        f"{log.t_seen} tokens (quarantined; "
                        f"attempts={ticket.attempts})")
                    self._sched.release(group, lane, Status.FAILED)
                continue
            gen = int(t[lane]) - log.t_seen
            if gen:
                log.tokens.append(toks[lane, :gen])
                log.t_seen = int(t[lane])
            if active[lane]:
                continue
            tokens = (np.concatenate(log.tokens) if log.tokens
                      else np.zeros((0,), toks.dtype))
            res = GenResult(request_id=ticket.rid, tokens=tokens,
                            prompt_len=len(log.req.prompt),
                            bucket=engine.prompt_bucket(
                                len(log.req.prompt)),
                            admitted_chunk=log.admitted_chunk)
            self._results[ticket.rid] = res
            self._tickets.pop(ticket.rid, None)
            out.append(res)
            self._sched.release(group, lane)
        return out

    # -------------------------------------------------------------- run
    def step(self) -> list[GenResult]:
        """One scheduling round: shed expired deadlines -> policy pick ->
        admit into freed lanes -> one decode chunk -> harvest
        (quarantining unhealthy lanes) -> evict if drained.  Returns the
        requests that finished this round."""
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
        if not self.slot_mode:
            return self._step_fallback(group)
        self._admit(group)
        if not group.slots:
            return []
        # Deterministic fault injection (tests and smoke runs): poison a
        # targeted lane's logits BEFORE its chunk.  A request's chunk
        # index is how many decode chunks it has lived through.
        if self._injector is not None:
            for lane, ticket in group.slots.items():
                if self._injector.poison_due(
                        ticket.rid,
                        self._chunks - ticket.note.admitted_chunk):
                    self._state = faults_mod.poison_lane_logits(
                        self._state, lane)
        dkey = engine.lm_slot_trace_key(
            self.cfg.name, self.num_slots, self.max_len,
            self.chunk_steps, self.temperature)
        with self._sched.stats.chunk(dkey, engine.trace_counts):
            self._state, toks, healthy = engine.decode_chunk_slots(
                self.model, self._state, chunk_steps=self.chunk_steps,
                temperature=self.temperature, max_len=self.max_len)
        self._chunks += 1
        out = self._harvest(group, toks, healthy)
        # Idle eviction: a drained service drops its lane table (the
        # stacked caches are the big device allocation).
        if self._sched.evict_idle(group):
            self._state = None
        return out

    def _step_fallback(self, group) -> list[GenResult]:
        """Window (ring-buffer) configs: run each request solo via
        ``generate``, exact by construction, scheduler-ordered,
        occupancy 1."""
        out = []
        for lane, ticket in self._sched.admit(group):
            req = ticket.payload
            toks = engine.generate(
                self.model, np.asarray(req.prompt)[None],
                steps=req.steps, temperature=self.temperature,
                seed=req.seed)
            res = GenResult(request_id=ticket.rid,
                            tokens=toks[0].cpu().numpy(),
                            prompt_len=len(req.prompt),
                            bucket=engine.prompt_bucket(len(req.prompt)),
                            admitted_chunk=self._chunks)
            self._results[ticket.rid] = res
            self._tickets.pop(ticket.rid, None)
            out.append(res)
            self._sched.release(group, lane)
        self._sched.evict_idle(group)
        return out

    def run(self) -> dict[int, GenResult | RequestFailure]:
        """Drain every queue; returns (and RELEASES) every result
        completed since the last drain."""
        while self._sched.has_work():
            self.step()
        out, self._results = self._results, {}
        return out

    # ------------------------------------------------------------ status
    def status(self, rid: int) -> Status:
        """The request's lifecycle state.  KeyError on unknown or claimed
        rids."""
        res = self._results.get(rid)
        if res is not None:
            return (res.status if isinstance(res, RequestFailure)
                    else Status.DONE)
        return self._tickets[rid].status

    def result(self, rid: int) -> GenResult | RequestFailure:
        """Pop one terminal outcome: the :class:`GenResult` or the
        structured ``RequestFailure``.  A known rid still in flight raises
        ``ResultNotReady``; an unknown (or claimed) rid a bare KeyError."""
        if rid in self._results:
            return self._results.pop(rid)
        if rid in self._tickets:
            raise ResultNotReady(
                f"request {rid} is {self._tickets[rid].status.value}")
        raise KeyError(rid)

    def cancel(self, rid: int) -> bool:
        """Cancel a live request: a queued ticket is removed, a running
        lane is deactivated and freed (between chunks).  Returns True if
        cancelled; False for unknown or terminal rids."""
        ticket = self._tickets.get(rid)
        if ticket is None:
            return False
        hit = self._sched.cancel_queued(rid)
        if hit is not None:
            g, t = hit
            self._record_failure(t, Status.CANCELLED,
                                 "cancelled while queued")
            if self._sched.evict_idle(g):
                self._state = None
            return True
        for g in self._sched.groups:
            for lane, t in list(g.slots.items()):
                if t.rid == rid:
                    if self._state is not None:
                        self._state = engine.deactivate_lane(
                            self._state, lane)
                    self._record_failure(t, Status.CANCELLED,
                                         "cancelled while running")
                    self._sched.release(g, lane, Status.CANCELLED)
                    if self._sched.evict_idle(g):
                        self._state = None
                    return True
        return False

    def generate(self, prompt, steps: int, **kw) -> GenResult:
        """One-shot convenience: submit + drain (the full lane path at
        occupancy 1).  Other requests completed by the drain stay
        claimable via ``result()``.  Raises RuntimeError if the request
        was quarantined past its retry budget."""
        rid = self.submit(prompt, steps, **kw)
        out = self.run()
        res = out.pop(rid)
        self._results.update(out)
        if isinstance(res, RequestFailure):
            raise RuntimeError(
                f"generate request {rid} failed: {res.status.value} "
                f"({res.reason})")
        return res

    # ------------------------------------------------------------- stats
    @property
    def stats(self) -> dict:
        """Set-up accounting (scheduler-tracked) over both dispatch
        kinds: per-bucket prefills and the decode chunk."""
        return self._sched.stats.as_dict()

    @property
    def latencies(self):
        """(request_id, queue-to-result seconds) per completed request
        (bounded sliding window)."""
        return self._sched.latencies

    def latency_percentiles(self, *pcts: float) -> dict[float, float]:
        """Queue-to-result latency percentiles (seconds)."""
        return self._sched.latency_percentiles(*pcts)
