"""Layer 2: rule-based lint of the hot paths, at the dispatcher.

Counterpart of ``repro.analysis.hlo_lint``, which reads the compiled HLO
of each jitted entry point.  Eager PyTorch compiles nothing, so each lint
target RUNS its entry point at a small size and the rules read what it
dispatched (:class:`repro_torch.utils.dispatch_trace.Trace`), the wrapper
calls and launches it made, and what it left allocated:

SYNC-001   [HOST-001] no op that makes the host wait on the device runs
           between a chunk's entry and its exit.  A solve loop's documented
           read-backs are pinned by count (``run_solve_slots``: none
           without the gap check, one ``bool(live)`` a chunk with it, and
           the final ``tolist``).  On the CPU the trace's host reads
           decide; on a card each chunk also runs under
           ``torch.cuda.set_sync_debug_mode("error")``.
DTYPE-001  no float64 or complex128 output inside a target (the slot
           scalars are derived in float64 on the host, before the chunk)
COMM-001   the collectives of a step are a sub-multiset of ``CommModel``
           / ``ServeCommModel``; serial targets make none
STEP-001   [TRIP-001] no step's work depends on the data: the trace of a
           chunk of 2s steps equals that of s steps plus s copies of one
           step's ops, a step makes exactly the declared calls (2 packed
           kernel calls, launches on a card; 24 bisection rounds with the
           projection), and a decode chunk of c steps shows c equal steps
STATE-001  [DONATE-001] a chunk leaves no second copy of its state: on the
           CPU every tensor of the entry state dies once the caller drops
           it (unless the returned state is that very tensor); on a card
           ``torch.cuda.memory_allocated()`` after the chunk, with the
           entry state dropped, equals the level before it plus the new
           state's bytes less the old's

Findings can only be waived through :data:`SUPPRESSIONS`, each carrying a
non-empty justification; an unsuppressed finding fails the gate
(``python -m repro_torch.analysis.run``).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils.dispatch_trace import Trace

RULES = {
    "SYNC-001": "no host wait inside a chunk; read-backs pinned by count",
    "DTYPE-001": "no float64/complex128 outputs in a target",
    "COMM-001": "step collectives within the CommModel budget",
    "STEP-001": "every step dispatches the same work",
    "STATE-001": "a chunk leaves no second copy of its state",
}

PACKED = ("momentum_dot_packed", "mwu_update_packed")


class Finding(NamedTuple):
    rule: str
    target: str
    detail: str


class Suppression(NamedTuple):
    rule: str
    target: str
    justification: str


#: The ONLY way to waive a finding.  Every entry must carry a real
#: justification; an empty one is itself an error (enforced in
#: apply_suppressions), so waivers stay reviewable.
SUPPRESSIONS: tuple[Suppression, ...] = ()


def apply_suppressions(
        findings: list[Finding],
        suppressions: tuple[Suppression, ...] = SUPPRESSIONS,
) -> tuple[list[Finding], list[dict]]:
    """Split findings into (unsuppressed, suppressed-records)."""
    for s in suppressions:
        if not s.justification.strip():
            raise ValueError(
                f"suppression {s.rule}/{s.target} has no justification")
    live, waived = [], []
    for f in findings:
        match = next((s for s in suppressions
                      if s.rule == f.rule and s.target == f.target), None)
        if match is None:
            live.append(f)
        else:
            waived.append({**f._asdict(),
                           "justification": match.justification})
    return live, waived


class LintTarget(NamedTuple):
    """One hot path.  ``setup(device, group) -> ctx`` makes its fixed
    inputs; ``init(ctx)`` a fresh entry state (None: the target carries
    none); ``run(ctx, state, units)`` calls the entry point over
    ``units`` steps (or chunks) and returns its output, of which
    ``out_state`` is the returned state.  ``units`` is the s of STEP-001
    (None: no step loop); ``per_unit`` the calls or ops each unit must
    make (a wrapper name counts calls, ``aten.*`` ops); ``reads(units)``
    the documented host read-backs; ``comm`` "serial" or ``ctx ->
    per-step multiset`` of collectives; ``chunk`` the (module, name) of
    the chunk function that runs under the sync debug mode's "error" on a
    card where the solve loop reads back between chunks; ``group`` whether the
    target runs on a process group."""
    name: str
    setup: Callable
    init: Callable
    run: Callable
    out_state: Callable = lambda out: out[0]
    units: int | None = 2
    per_unit: dict = {}
    reads: Callable = lambda units: 0
    comm: object = "serial"
    chunk: tuple | None = None
    group: bool = False


# ------------------------------------------------------------ measuring

@contextlib.contextmanager
def _counting_calls(calls: collections.Counter, trace: Trace):
    """Count calls of the packed kernels' entry points (``kernels.ops``,
    as the engine calls them).  On CPU tensors a wrapper runs its plain
    version, which checks ``idx`` against d by two host reads (on a card
    the kernel skips a bad row instead, with no read): those reads belong
    to the plain version, not to the card's path, so the trace leaves
    them out."""
    from repro_torch.kernels import ops

    saved = {name: getattr(ops, name) for name in PACKED}

    def counted(name, fn):
        def call(x_t, *args, **kwargs):
            calls[name] += 1
            if x_t.device.type != "cpu":
                return fn(x_t, *args, **kwargs)
            trace._quiet += 1
            try:
                return fn(x_t, *args, **kwargs)
            finally:
                trace._quiet -= 1
        return call

    for name, fn in saved.items():
        setattr(ops, name, counted(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def _sync_error(device: torch.device, chunk):
    """On a card: make any synchronizing call an error, in the whole run
    or, with ``chunk`` = (module, name), inside each call of that chunk
    function only.  Nothing on the CPU."""
    if device.type != "cuda":
        yield
        return
    if chunk is None:
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return
    module, name = chunk
    fn = getattr(module, name)

    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    setattr(module, name, strict)
    try:
        yield
    finally:
        setattr(module, name, fn)


class _Run(NamedTuple):
    trace: Trace
    calls: collections.Counter      # wrapper calls (CPU) / launches (card)
    error: str                      # a sync the debug mode refused


def _measure(t: LintTarget, ctx, units, device) -> _Run:
    from repro_torch.kernels import ops

    state = t.init(ctx)
    calls: collections.Counter = collections.Counter()
    launches = collections.Counter(ops.launch_counts)
    error = ""
    tr = Trace()
    with tr, _counting_calls(calls, tr):
        try:
            with _sync_error(device, t.chunk if t.reads(units) else None):
                out = t.run(ctx, state, units)
        except RuntimeError as err:
            if "synchroniz" not in str(err):
                raise
            error, out = str(err).splitlines()[0], None
    del out, state
    if device.type == "cuda":
        launched = collections.Counter(ops.launch_counts) - launches
        calls = collections.Counter({k: launched[k] for k in PACKED
                                     if calls[k] or launched[k]})
    return _Run(tr, calls, error)


def _op_keys(tr: Trace) -> collections.Counter:
    return collections.Counter((r.name, r.dtypes) for r in tr.ops)


# ----------------------------------------------------------------- rules

def check_sync(t: LintTarget, run: _Run, units) -> list[Finding]:
    out = []
    if run.error:
        out.append(Finding("SYNC-001", t.name,
                           f"set_sync_debug_mode('error') refused a call "
                           f"inside the chunk: {run.error}"))
    want = t.reads(units)
    got = run.trace.syncs
    if len(got) != want:
        names = collections.Counter(s.name for s in got)
        out.append(Finding(
            "SYNC-001", t.name,
            f"{len(got)} host reads {dict(names)} in a run of {units} "
            f"units; {want} documented"))
    return out


def check_dtype(t: LintTarget, run: _Run) -> list[Finding]:
    wide = run.trace.wide_dtypes()
    if wide:
        return [Finding("DTYPE-001", t.name,
                        f"{len(wide)} ops with float64/complex128 "
                        f"outputs, first {wide[0].name} {wide[0].dtypes}")]
    return []


def check_comm(t: LintTarget, ctx, runs: dict, s) -> list[Finding]:
    if t.comm == "serial":
        for units, run in runs.items():
            if run.trace.collectives:
                ops = sorted({c.op for c in run.trace.collectives})
                return [Finding(
                    "COMM-001", t.name,
                    f"serial target issues {len(run.trace.collectives)} "
                    f"collectives ({', '.join(ops)}); expected none")]
        return []
    predicted = t.comm(ctx)
    per = (runs[s + 1].trace.collective_multiset()
           - runs[s].trace.collective_multiset())
    excess = {k: (v, predicted.get(k, 0)) for k, v in per.items()
              if v > predicted.get(k, 0)}
    if excess:
        return [Finding(
            "COMM-001", t.name,
            "per-step collectives exceed the CommModel budget: " + "; ".join(
                f"{k} measured {v} > budget {b}"
                for k, (v, b) in sorted(excess.items(), key=str)))]
    return []


def check_steps(t: LintTarget, runs: dict, s: int) -> list[Finding]:
    c1, c2, c4 = (_op_keys(runs[n].trace) for n in (s, s + 1, 2 * s))
    out = []
    step = c2 - c1
    if c1 - c2 or c4 != c1 + collections.Counter(
            {k: v * s for k, v in step.items()}):
        diff = (c4 - c1) - collections.Counter(
            {k: v * s for k, v in step.items()})
        diff |= collections.Counter(
            {k: v * s for k, v in step.items()}) - (c4 - c1)
        first = next(iter(diff), None)
        out.append(Finding(
            "STEP-001", t.name,
            f"the steps dispatch different work: {2 * s} steps are not "
            f"{s} steps plus {s} copies of one step "
            f"({sum(diff.values())} ops apart, e.g. {first})"))
    names = collections.Counter()
    for (name, _), v in step.items():
        names[name] += v
    calls = runs[s + 1].calls - runs[s].calls
    for key, want in t.per_unit.items():
        got = calls[key] if key in PACKED else names[key]
        if got != want:
            out.append(Finding(
                "STEP-001", t.name,
                f"a step makes {got} {key}, {want} declared"))
    return out


def _tensors(obj) -> list[torch.Tensor]:
    from torch.utils._pytree import tree_flatten

    return [x for x in tree_flatten(obj)[0] if isinstance(x, torch.Tensor)]


def _block_bytes(ts) -> int:
    """Bytes the CUDA caching allocator books for distinct storages."""
    seen, total = set(), 0
    for t in ts:
        st = t.untyped_storage()
        if st.data_ptr() in seen:
            continue
        seen.add(st.data_ptr())
        total += max(512, -(-st.nbytes() // 512) * 512)
    return total


def check_state(t: LintTarget, ctx, units, device) -> list[Finding]:
    """STATE-001 over one run whose entry state the caller drops."""
    state = t.init(ctx)
    if state is None:
        return []
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        entry_ids = {id(x) for x in _tensors(state)}
        before = torch.cuda.memory_allocated(device)
        old = [x for x in _tensors(state)]
        out_state = t.out_state(t.run(ctx, state, units))
        new = _tensors(out_state)
        new_ids = {id(x) for x in new}
        delta = (_block_bytes([x for x in new if id(x) not in entry_ids])
                 - _block_bytes([x for x in old if id(x) not in new_ids]))
        del state, old
        gc.collect()
        torch.cuda.synchronize(device)
        after = torch.cuda.memory_allocated(device)
        del out_state, new
        if after != before + delta:
            return [Finding(
                "STATE-001", t.name,
                f"memory_allocated {after} B after the chunk with its entry "
                f"state dropped; {before} B before it, the state "
                f"{delta:+d} B: {after - before - delta:+d} B held")]
        return []
    refs = [weakref.ref(x) for x in _tensors(state)]
    out_state = t.out_state(t.run(ctx, state, units))
    del state
    gc.collect()
    kept = {id(x) for x in _tensors(out_state)}
    held = [r() for r in refs if r() is not None and id(r()) not in kept]
    if held:
        return [Finding(
            "STATE-001", t.name,
            f"{len(held)} tensors of the entry state outlive it (first "
            f"{tuple(held[0].shape)} {held[0].dtype}): a second copy of the "
            "state")]
    return []


def lint_target(t: LintTarget, device="cpu", group=None
                ) -> tuple[dict, list[Finding]]:
    """Run one target and apply the five rules."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ctx = t.setup(device, group)
    s = t.units
    unit_list = (None,) if s is None else (s, s + 1, 2 * s)
    t.run(ctx, t.init(ctx), s)                      # set-up, first use
    runs = {n: _measure(t, ctx, n, device) for n in unit_list}
    findings = check_sync(t, runs[s], s) + check_dtype(t, runs[s])
    findings += check_comm(t, ctx, runs, s)
    if s is not None:
        findings += check_steps(t, runs, s)
    findings += check_state(t, ctx, s, device)
    base = runs[s]
    record = {
        "target": t.name, "device": device.type, "units": s,
        "ops": len(base.trace.ops), "host_reads": len(base.trace.syncs),
        "collectives": len(base.trace.collectives),
        "calls": dict(base.calls), "findings": len(findings),
    }
    if s is not None:
        step = _op_keys(runs[s + 1].trace) - _op_keys(runs[s].trace)
        record["ops_per_unit"] = sum(step.values())
        record["calls_per_unit"] = dict(runs[s + 1].calls - base.calls)
        record["collectives_per_unit"] = {
            "|".join(map(str, k)): v for k, v in (
                runs[s + 1].trace.collective_multiset()
                - base.trace.collective_multiset()).items()}
    return record, findings


# --------------------------------------------------------------- targets

def _rounds(nu: float) -> int:
    from repro_torch.core import projections

    return int(projections.BISECT_ROUNDS_SOLVER) if nu > 0 else 0


def _packed_step_calls(nu: float, steps: int = 1) -> dict:
    out = {name: steps for name in PACKED}
    out["aten.minimum"] = _rounds(nu) * steps
    return out


def _problem(n1: int, n2: int, d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n1, d)).astype(np.float32) / np.sqrt(d) + 0.1,
            rng.normal(size=(n2, d)).astype(np.float32) / np.sqrt(d) - 0.1)


def _chunk_packed_target() -> LintTarget:
    """``engine.run_chunk_packed`` (the JAX target's shapes: 500 + 460
    points in d = 256, B = 128, nu)."""
    from repro_torch.core import engine, saddle
    from repro_torch.core import preprocess as pp

    n1, n2, d, nu = 500, 460, 256, 1.0 / (0.8 * 500)

    def setup(device, group):
        xp, xm = _problem(n1, n2, d)
        pts = pp.pack_points(torch.as_tensor(xp, device=device),
                             torch.as_tensor(xm, device=device))
        params = saddle.make_params(n1 + n2, d, 1e-3, 0.1, nu=nu,
                                    block_size=128)
        gen = torch.Generator(device=device).manual_seed(0)
        idx = engine.draw_blocks(gen, d, 128, 8, device)
        return dict(x_t=pts.x_t[None], sign=pts.sign[None], params=params,
                    idx=idx)

    def init(ctx):
        return engine.init_packed_state(ctx["sign"], n1, n2, d)

    def run(ctx, state, steps):
        return engine.run_chunk_packed(state, ctx["x_t"], ctx["sign"], steps,
                                       params=ctx["params"],
                                       idx=ctx["idx"][:steps])

    return LintTarget("engine.run_chunk_packed", setup, init, run,
                      per_unit=_packed_step_calls(nu))


def _slot_ctx(device, s=2, n_pad=256, d=32, nu=1.0, budget=1 << 20):
    from repro_torch.core import engine, saddle
    from repro_torch.utils import comm_audit

    n1, n2 = 100, 90
    params = saddle.make_params(n1 + n2, d, 1e-3, 0.1, nu=1.0 / (0.8 * n1),
                                block_size=1)
    problems = [tuple(torch.as_tensor(a, device=device)
                      for a in _problem(n1, n2, d, lane))
                for lane in range(s)]
    rows = [engine.slot_params_row(params, gap_tol=1e-9)] * s
    return dict(problems=problems, rows=rows, n_pad=n_pad, d=d, s=s,
                budget=budget, device=device, fresh=comm_audit.fresh_slot_batch)


def _slot_init(ctx):
    state, x_t, sign, sp = ctx["fresh"](
        ctx["problems"], ctx["n_pad"], ctx["d"], ctx["rows"],
        list(range(ctx["s"])), ctx["budget"], ctx["device"])
    ctx.update(x_t=x_t, sign=sign, sp=sp)
    return state


def _chunk_slots_target() -> LintTarget:
    """``engine.chunk_body_slots`` with the gap check (the JAX target's
    ``run_chunk_slots``: 2 slots of 256 points in d = 32, B = 1, nu)."""
    from repro_torch.core import engine

    def run(ctx, state, steps):
        return engine.chunk_body_slots(
            state, ctx["x_t"], ctx["sign"], ctx["sp"], steps,
            chunk_steps=8, d=ctx["d"], block_size=1, project=True,
            check_gap=True)

    return LintTarget("engine.chunk_body_slots",
                      lambda device, group: _slot_ctx(device), _slot_init,
                      run, per_unit=_packed_step_calls(1.0))


def _solve_slots_target(check_gap: bool) -> LintTarget:
    """``engine.run_solve_slots``, a unit one chunk of 4 steps."""
    from repro_torch.core import engine

    chunk = 4

    def run(ctx, state, chunks):
        return engine.run_solve_slots(
            state, ctx["x_t"], ctx["sign"], ctx["sp"], chunk * chunks,
            chunk_steps=chunk, num_chunks=chunks, d=ctx["d"], block_size=1,
            project=True, check_gap=check_gap)

    per_unit = _packed_step_calls(1.0, chunk)
    if check_gap:       # the gap's water-filling: a minimum a class
        per_unit["aten.minimum"] += 2
    return LintTarget(
        f"engine.run_solve_slots[check_gap={check_gap}]",
        lambda device, group: _slot_ctx(device), _slot_init, run,
        per_unit=per_unit,
        # a bool(live) a chunk with the gap check, the final tolist
        reads=(lambda units: units + 1) if check_gap else (lambda units: 1),
        chunk=(engine, "chunk_body_slots"))


def _warm_packed_target() -> LintTarget:
    from repro_torch.core import engine

    n_pad, d = 256, 32

    def setup(device, group):
        g = torch.Generator(device=device).manual_seed(0)
        return dict(x_t=torch.randn((d, n_pad), generator=g, device=device),
                    device=device)

    def init(ctx):
        dev = ctx["device"]
        return (torch.full((d,), 0.1, device=dev),
                torch.full((n_pad,), -5.0, device=dev),
                torch.full((n_pad,), -5.0, device=dev))

    def run(ctx, state, _units):
        return engine.warm_packed_state(ctx["x_t"], *state)

    return LintTarget("engine.warm_packed_state", setup, init, run,
                      out_state=lambda out: out, units=None)


LM_ARCH = "gemma-7b"      # smallest bucketable (all-attention) config
LM_SLOTS = 2
LM_CHUNK = 4
LM_MAX_LEN = 32


def _lm_ctx(device, group):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine as serve_engine

    model = tf.init_lm(get_config(LM_ARCH).reduced(), seed=0, device=device)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, (1, 8)),
                           dtype=torch.long, device=device)
    pre = serve_engine._prefill_bucketed(model, toks, 5, max_len=LM_MAX_LEN)
    return dict(model=model, toks=toks, pre=pre)


def _prefill_target() -> LintTarget:
    from repro_torch.serve import engine as serve_engine

    def run(ctx, _state, _units):
        return serve_engine._prefill_bucketed(ctx["model"], ctx["toks"], 5,
                                              max_len=LM_MAX_LEN)

    return LintTarget(f"serve._prefill_bucketed[{LM_ARCH}]", _lm_ctx,
                      lambda ctx: None, run, units=None)


def _decode_target() -> LintTarget:
    from repro_torch.serve import engine as serve_engine

    def init(ctx):
        state = serve_engine.init_lm_slot_state(ctx["pre"], LM_SLOTS)
        for lane in range(LM_SLOTS):
            state = serve_engine.admit_lane(state, lane, ctx["pre"],
                                            seed=lane, max_t=1 << 20)
        return state

    def run(ctx, state, steps):
        return serve_engine.decode_chunk_slots(
            ctx["model"], state, chunk_steps=steps, temperature=0.0,
            max_len=LM_MAX_LEN)

    return LintTarget(f"serve.decode_chunk_slots[{LM_ARCH}]", _lm_ctx, init,
                      run, units=LM_CHUNK // 2)


def serial_targets() -> list[LintTarget]:
    """The targets that need no process group (the ones ``chip_smoke.py``
    lints on the card)."""
    return [_chunk_packed_target(), _chunk_slots_target(),
            _solve_slots_target(False), _solve_slots_target(True),
            _warm_packed_target(), _prefill_target(), _decode_target()]


# ------------------------------------------------- targets over a group

DIST_K = 8


def _sharded_runner_target() -> LintTarget:
    """``distributed.sharded_run_fn`` at k = 8 (1000 + 900 points in
    d = 128, B = 128, nu; the JAX target's)."""
    from repro_torch.core import distributed, engine, saddle

    n1, n2, d, b, nu = 1000, 900, 128, 128, 1.0 / (0.8 * 1000)

    def setup(device, group):
        params = saddle.make_params(n1 + n2, d, 1e-3, 0.1, nu=nu,
                                    block_size=b)
        xp, xm = _problem(n1, n2, d)
        xp_sh, mask_p = distributed.shard_points(xp, group.size)
        xm_sh, mask_m = distributed.shard_points(xm, group.size)
        x_t, sign = distributed.pack_shards(xp_sh, mask_p, xm_sh, mask_m)
        rows = slice(group.rank, group.rank + 1)
        gen = torch.Generator(device=device).manual_seed(0)
        return dict(
            x_t=torch.as_tensor(x_t[rows], device=device),
            sign=torch.as_tensor(sign[rows], device=device),
            idx=engine.draw_blocks(gen, d, b, 8, device),
            runner=distributed.sharded_run_fn(group, params=params,
                                              chunk_steps=8),
            model=distributed.CommModel(k=group.size,
                                        nu_rounds_per_iter=_rounds(nu)))

    def init(ctx):
        return engine.init_packed_state(ctx["sign"], n1, n2, d)

    def run(ctx, state, steps):
        return ctx["runner"](state, ctx["x_t"], ctx["sign"],
                             ctx["idx"][:steps])

    return LintTarget(
        f"distributed.sharded_run_fn[k={DIST_K}]", setup, init, run,
        per_unit=_packed_step_calls(nu),
        comm=lambda ctx: ctx["model"].collective_multiset(b), group=True)


def _sharded_serve_target(placement: str) -> LintTarget:
    """``engine.run_chunk_slots_sharded`` at k = 8: lanes (8 lanes, one a
    rank, no collective) or points (2 lanes over every rank,
    ``ServeCommModel``), 100 + 90 / 300 + 280 points in d = 32, B = 1,
    nu (the JAX targets')."""
    from repro_torch.core import distributed, engine, saddle
    from repro_torch.core import preprocess as pp
    from repro_torch.utils import comm_audit

    points = placement == "points"
    n1, n2 = (300, 280) if points else (100, 90)
    s, d, nu = (2 if points else DIST_K), 32, 1.0

    def setup(device, group):
        k = group.size
        n_pad = (k * pp.bucket_length(-(-(n1 + n2) // k)) if points
                 else pp.bucket_length(n1 + n2))
        params = saddle.make_params(n1 + n2, d, 1e-3, 0.1,
                                    nu=1.0 / (0.8 * n1), block_size=1)
        problems = [tuple(torch.as_tensor(a, device=device)
                          for a in _problem(n1, n2, d, lane))
                    for lane in range(s)]
        return dict(group=group, n_pad=n_pad, problems=problems,
                    rows=[engine.slot_params_row(params)] * s, device=device,
                    model=distributed.ServeCommModel(
                        k=k, num_slots=s, nu_rounds_per_iter=_rounds(nu)))

    def init(ctx):
        batch = comm_audit.fresh_slot_batch(
            ctx["problems"], ctx["n_pad"], d, ctx["rows"], list(range(s)),
            1 << 20, ctx["device"])
        state, *ctx["local"] = engine.shard_slot_batch(
            ctx["group"], placement, *batch)
        return state

    def run(ctx, state, steps):
        return engine.run_chunk_slots_sharded(
            state, *ctx["local"], steps, mesh=ctx["group"],
            placement=placement, chunk_steps=8, d=d, block_size=1,
            project=True)

    return LintTarget(
        f"engine.run_chunk_slots_sharded[{placement},k={DIST_K}]", setup,
        init, run, per_unit=_packed_step_calls(nu),
        comm=((lambda ctx: ctx["model"].collective_multiset(1)) if points
              else "serial"), group=True)


def group_targets() -> list[LintTarget]:
    """The k = 8 targets: run by :func:`lint_all` over one spawn of
    ``DIST_K`` gloo ranks (``launch.mesh.spawn_clients``).  The launch
    dry-run's mesh targets join when ``launch/specs.py`` is ported."""
    return [_sharded_runner_target(), _sharded_serve_target("lanes"),
            _sharded_serve_target("points")]


def default_targets() -> list[LintTarget]:
    """Every hot path linted by the gate (the JAX ``default_targets``)."""
    return serial_targets() + group_targets()


def _rank_lint(group, names: list[str]) -> tuple[list[dict], list]:
    """A spawned rank: lint the named group targets on its group.
    Returns plain data (records, findings as tuples)."""
    by_name = {t.name: t for t in group_targets()}
    records, findings = [], []
    for name in names:
        rec, fs = lint_target(by_name[name], group.device, group)
        records.append(dict(rec, rank=group.rank))
        findings += [tuple(f) for f in fs]
    return records, findings


def lint_all(targets: list[LintTarget] | None = None, device="cpu",
             *, timeout_s: float = 240.0
             ) -> tuple[list[dict], list[Finding]]:
    """Lint every target: the serial ones in this process on ``device``,
    the group ones over one spawn of ``DIST_K`` gloo ranks on the CPU
    (each rank's findings, deduplicated)."""
    if targets is None:
        targets = default_targets()
    records, findings = [], []
    for t in targets:
        if t.group:
            continue
        rec, fs = lint_target(t, device)
        records.append(rec)
        findings.extend(fs)
    grouped = [t.name for t in targets if t.group]
    if grouped:
        from repro_torch.launch import mesh

        ranks = mesh.spawn_clients(_rank_lint, DIST_K, backend="gloo",
                                   device="cpu", timeout_s=timeout_s,
                                   args=(grouped,))
        seen = set()
        for recs, fs in ranks:
            records += recs
            for f in fs:
                if f not in seen:
                    seen.add(f)
                    findings.append(Finding(*f))
    return records, findings
