"""Deterministic fault injection for the port's serving stack.

The port of ``repro.serve.faults``: the same plans from the same seeds
(:meth:`FaultPlan.generate` draws with ``numpy.random.default_rng``), so
one seed gives the same faults in both packages.

* :class:`Fault` -- one injected event.  Kinds:

  ``poison``       overwrite a running request's device lane with NaN
                   at a given service chunk index (models a tenant
                   whose numerics diverge mid-run; exercises the
                   engine's finite-health flag and the service's
                   quarantine + re-admission path).
  ``delay``        hold a request back for N scheduler steps before
                   submitting it (models bursty arrival; applied by
                   the code that submits requests, not the service --
                   a service never sees a delayed request until it is
                   submitted).
  ``drop_client``  remove one client from the k-client simulation at a
                   given outer iteration (models a worker loss in the
                   distributed MWU solve; consumed by the JAX
                   package's ``core.distributed.solve_distributed``, not
                   by the port yet).

* :class:`FaultPlan` -- a seed-keyed, immutable set of faults.

* :class:`FaultInjector` -- the per-service adapter.  Each fault
  fires AT MOST ONCE (one-shot), so a retried request is NOT
  re-poisoned: the retry models a transient failure recovering, which
  is exactly what the bounded-retry path needs to exercise.

* :func:`poison_slot_state` / :func:`poison_lane_logits` -- write NaN
  into one solver lane / one LM decode lane, in place, on the current
  stream.  They touch no ``trace_counts`` key, so the
  no-new-set-up-after-warm-up invariant holds under chaos.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected event.  ``rid`` targets a request (poison/delay);
    ``client`` targets a simulated client (drop_client).  ``at_chunk``
    is the service chunk index (poison) or outer iteration
    (drop_client) at which the event fires; ``delay_steps`` is how
    many scheduler steps a delayed request is held back."""

    kind: str                     # "poison" | "delay" | "drop_client"
    rid: int | None = None
    at_chunk: int = 0
    delay_steps: int = 0
    client: int | None = None

    def __post_init__(self):
        if self.kind not in ("poison", "delay", "drop_client"):
            raise ValueError(f"unknown fault kind: {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, seed-keyed set of faults (see module docstring)."""

    seed: int
    faults: tuple[Fault, ...]

    @classmethod
    def generate(cls, seed: int, rids: list[int], *,
                 poison_frac: float = 0.25, delay_frac: float = 0.25,
                 max_chunk: int = 3, max_delay: int = 3) -> "FaultPlan":
        """Derive a plan from one seed: each rid is independently
        poisoned with probability ``poison_frac`` (at a uniform chunk
        in [0, max_chunk]) and delayed with probability ``delay_frac``
        (by a uniform 1..max_delay scheduler steps).  Poison and delay
        can coincide on one rid."""
        rng = np.random.default_rng(seed)
        faults: list[Fault] = []
        for rid in rids:
            if rng.random() < poison_frac:
                faults.append(Fault(
                    "poison", rid=rid,
                    at_chunk=int(rng.integers(0, max_chunk + 1))))
            if rng.random() < delay_frac:
                faults.append(Fault(
                    "delay", rid=rid,
                    delay_steps=int(rng.integers(1, max_delay + 1))))
        return cls(seed=seed, faults=tuple(faults))

    def poisoned_rids(self) -> set[int]:
        return {f.rid for f in self.faults if f.kind == "poison"}

    def delays(self) -> dict[int, int]:
        return {f.rid: f.delay_steps for f in self.faults
                if f.kind == "delay"}


class FaultInjector:
    """Per-service adapter over a :class:`FaultPlan`.

    The service consults :meth:`poison_due` between chunks for every
    occupied lane; a poison fault fires exactly once, the first time
    the request's chunk index reaches ``at_chunk``.  ``fired`` is the
    audit trail the chaos tests assert against."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired: list[Fault] = []
        self._pending: dict[int, Fault] = {
            f.rid: f for f in plan.faults if f.kind == "poison"}

    def poison_due(self, rid: int, chunk_idx: int) -> bool:
        """True exactly once: the first query at/after the fault's
        ``at_chunk`` for a rid with a pending poison fault."""
        f = self._pending.get(rid)
        if f is None or chunk_idx < f.at_chunk:
            return False
        del self._pending[rid]
        self.fired.append(f)
        return True


def poison_slot_state(state, slot: int):
    """Overwrite one solver lane's primal iterate (``w`` and ``u``) with
    NaN, in place; returns ``state``.  The next chunk boundary's
    finite-health flag trips on it."""
    state.w[slot] = float("nan")
    state.u[slot] = float("nan")
    return state


def poison_lane_logits(state, lane: int):
    """Overwrite one LM lane's next-token logits with NaN, in place;
    returns ``state``.  The decode chunk's finite-health flag trips on
    it before the lane's first sampled token is kept."""
    state.last_logits[lane] = float("nan")
    return state
