"""Packed saddle-point engine and slot driver, in PyTorch.

Counterpart of the packed path of ``repro.core.engine``.  Both classes live
in ONE lane-padded point set with a +-1 ``sign`` vector (0 marks padding,
which also carries log weight NEG_INF so it adds exactly 0 to every sum),
and the column-major mirror ``x_t`` (d, n_pad) makes a sampled block of
coordinates b contiguous rows.  Each iteration
(:func:`_step_packed_core`) makes two kernel calls:

  pass 1  ``momentum_dot_packed``: the signed momentum dot
          delta = sum_i sign_i mom_i x_t[idx, i]
  pass 2  ``mwu_update_packed``: the MWU update, the incremental u and
          both per-class logsumexp partials in the same sweep

then the w update, and for nu > 0 the sort-free capped-simplex bisection.
On CUDA tensors the calls launch the hand-written kernels; on CPU tensors
they run the plain versions.

The slot axis S of the JAX package's ``vmap`` is written out here as a
leading dimension of every state field and operand: ``x_t`` (S, d, n_pad),
``sign`` and point vectors (S, n_pad), per-slot step scalars (S,).  A
serial solve is the S = 1 batch.

The client axis of Algorithm 4 (the JAX package's ``vmap`` over
``axis_name="clients"`` with ``psum`` / ``pmax``) is that same leading
axis: k clients are S = k slots of one problem, the server's coordinate
block is one draw expanded to (k, b), and every cross-client reduction is
a hook (:func:`_all_sum` / :func:`_all_max`, an explicit sum or max over
the client dimension) that the serial step replaces by the identity.
Each client hook call is tallied in :data:`collective_counts`, keyed as
``repro.core.distributed.CommModel.collective_multiset`` keys its
all-reduces, so the collectives of a run can be counted.

The unpacked reference step (:func:`step`, two kernel calls per class,
four launches per step) is kept beside the packed one as the oracle the
packed path is held against, serially and across clients.

Randomness: each slot draws its b coordinates per step, distinct and
uniform, from its own ``torch.Generator`` on the slot's device
(:func:`sample_blocks`), a chunk's worth at a time.  The bits differ from
``jax.random``'s, so every driver entry takes an injected index schedule
for parity with the JAX package.

State updates: where the JAX package donates state buffers, the slot
functions here (:func:`admit_into_slot`, :func:`deactivate_slot`) write
into the slot table in place; the step itself returns new tensors.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import projections
from repro_torch.kernels import ops

NEG_INF = -1e30     # log weight of padding points (exp() == 0 exactly)

# Chunk set-ups by static configuration (the key of :func:`slot_trace_key`).
# The JAX package counts compilations here; eager PyTorch compiles nothing,
# so a configuration is set up once, the first time it runs, and each key
# reads 1.  Serving warm-up checks read it the same way in both packages.
trace_counts: collections.Counter = collections.Counter()

# Client reductions by (op, reduce kind, elements per client): one count
# per call of _all_sum / _all_max on a client axis.
collective_counts: collections.Counter = collections.Counter()

# Rows of uniforms drawn at once per slot: bounds the sampler's scratch to
# 16 MiB whatever the chunk length.
_SAMPLE_FLOATS = 1 << 22


def sample_blocks(generators: list[torch.Generator], d: int, b: int,
                  steps: int, device: torch.device) -> torch.Tensor:
    """(steps, S, b) int32: for every step and slot, b distinct coordinates
    of [0, d), uniform without replacement, from the slot's own
    generator: the indices of the b largest of d uniforms."""
    if steps == 0:
        return torch.empty((0, len(generators), b), dtype=torch.int32,
                           device=device)
    per = max(1, _SAMPLE_FLOATS // d)
    out = []
    for g in generators:
        parts = [torch.rand((min(per, steps - s0), d), generator=g,
                            device=device).topk(b, dim=-1).indices
                 for s0 in range(0, steps, per)]
        out.append(torch.cat(parts) if len(parts) > 1 else parts[0])
    return torch.stack(out, dim=1).to(torch.int32)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _all_sum(x: torch.Tensor) -> torch.Tensor:
    """psum over the leading client axis: every client gets the sum of all
    clients' values (a sum over dimension 0, the same order every call)."""
    collective_counts["all-reduce", "add", x[0].numel()] += 1
    return x.sum(dim=0, keepdim=True).expand_as(x)


def _all_max(x: torch.Tensor) -> torch.Tensor:
    """pmax over the leading client axis."""
    collective_counts["all-reduce", "max", x[0].numel()] += 1
    return x.amax(dim=0, keepdim=True).expand_as(x)


def client_hooks(clients: bool):
    """(all_sum, all_max): the client reductions, or the identity for a
    serial step."""
    return (_all_sum, _all_max) if clients else (_identity, _identity)


def draw_blocks(generator: torch.Generator, d: int, b: int, steps: int,
                device: torch.device) -> torch.Tensor:
    """(steps, b) int32 coordinate blocks of one problem from one
    generator: the server's draw, broadcast to every client."""
    return sample_blocks([generator], d, b, steps, device)[:, 0]


# ==========================================================================
# Reference (unpacked) step: two kernel calls per class, the parity oracle
# of the packed step.
# ==========================================================================

def _dual_update(cols, log_lam, u, dw, sign: float, p, all_sum, all_max):
    """Lines 5-6 of Algorithm 2 and the incremental u for one class,
    normalized by a logsumexp combined across clients (rounds 2-3 of
    Algorithm 4).  Returns (log_new, u_new)."""
    d_eff = p.d / p.block_size
    log_new, u_new, m_loc, s_loc = ops.mwu_update(
        cols, log_lam, u, dw, sign, p.gamma, p.tau, d_eff, normalize=False)
    m = all_max(m_loc)
    s = all_sum(s_loc * torch.exp(m_loc - m))
    return log_new - (m + torch.log(s))[..., None], u_new


def _capped_project(log_lam: torch.Tensor, nu: float, clients: bool,
                    all_sum) -> torch.Tensor:
    """Reference nu-projection: Rule 2 serially (one sort per class), the
    Rule-3 loop across clients (round 4 of Algorithm 4).  Zero weights map
    to log(1e-38) serially and to NEG_INF under clients, as in the JAX
    package.  The loop's stop test reads the client-summed varsigma back
    to the host once per round, reproducing the JAX ``while_loop`` and its
    ``> 1e-12`` stop; the packed step replaces both rules by the
    fixed-round bisection."""
    if not clients:
        eta = projections.capped_simplex_project_sorted(torch.exp(log_lam),
                                                        nu)
        return torch.log(torch.clamp(eta, min=1e-38))
    eta = projections.capped_simplex_project_loop(torch.exp(log_lam), nu,
                                                  all_sum=all_sum)
    return torch.where(eta > 0, torch.log(torch.clamp(eta, min=1e-38)),
                       NEG_INF)


def step(state, xp: torch.Tensor, xm: torch.Tensor, p, *,
         idx: torch.Tensor | None = None,
         generator: torch.Generator | None = None, clients: bool = False):
    """One REFERENCE Algorithm-2/4 iteration (two kernel calls per class;
    the production step is :func:`_step_packed_core`).

    ``state`` is any NamedTuple with the eight per-class fields
    (SaddleState / ShardedState); the same type is returned.  Serially
    ``xp`` (n1, d) and ``xm`` (n2, d) are the point matrices and the
    fields unbatched; with ``clients`` every field and matrix carries the
    leading client axis k (``xp`` (k, m1, d)) and the reductions run
    across it.  ``idx`` (b,) is the step's coordinate block, the same for
    every client (the server broadcasts it), drawn from ``generator``
    when not given."""
    d, b = p.d, p.block_size
    if idx is None:
        idx = draw_blocks(generator, d, b, 1, xp.device)[0]
    all_sum, all_max = client_hooks(clients)
    idx_l = idx.long()
    cols_p = xp[..., idx_l]                     # (..., n1, B)
    cols_m = xm[..., idx_l]

    # Lines 2-3 (round 1): momentum dots, summed over clients.
    delta_p = all_sum(ops.momentum_dot(cols_p, state.log_eta,
                                       state.log_eta_prev, p.theta))
    delta_m = all_sum(ops.momentum_dot(cols_m, state.log_xi,
                                       state.log_xi_prev, p.theta))

    # Line 4 (round 2): every client makes the same w update, multiplying
    # by the reciprocal of sigma + 1 as the JAX package does.
    w_old = state.w[..., idx_l]
    w_new = (w_old + p.sigma * (delta_p - delta_m)) * (1.0 / (p.sigma + 1.0))
    dw = w_new - w_old

    # Lines 5-6 (rounds 2-3): the MWU updates.
    log_eta, u_p = _dual_update(cols_p, state.log_eta, state.u_p, dw, 1.0,
                                p, all_sum, all_max)
    log_xi, u_m = _dual_update(cols_m, state.log_xi, state.u_m, dw, -1.0,
                               p, all_sum, all_max)

    # Rule 2 / round 4: the nu-Saddle capped-simplex projection.
    if p.nu > 0.0:
        log_eta = _capped_project(log_eta, p.nu, clients, all_sum)
        log_xi = _capped_project(log_xi, p.nu, clients, all_sum)

    w = state.w.clone()
    w[..., idx_l] = w_new
    return type(state)(
        w=w, log_eta=log_eta, log_eta_prev=state.log_eta,
        log_xi=log_xi, log_xi_prev=state.log_xi, u_p=u_p, u_m=u_m,
        t=state.t + 1)


def objective_from_state(state, xp: torch.Tensor, xm: torch.Tensor,
                         clients: bool = False) -> torch.Tensor:
    """0.5 * ||A eta - B xi||^2 of a per-class state, the dual
    combination summed over clients when ``clients`` (then one value per
    client, all equal)."""
    all_sum, _ = client_hooks(clients)
    diff = ((torch.exp(state.log_eta)[..., None, :] @ xp)
            - (torch.exp(state.log_xi)[..., None, :] @ xm))[..., 0, :]
    diff = all_sum(diff)
    return 0.5 * (diff * diff).sum(dim=-1)


def chunk_body(state, xp, xm, params, num_steps: int, *,
               idx: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               clients: bool = False):
    """Reference chunk: ``num_steps`` unpacked iterations with the blocks
    ``idx`` (num_steps, b), drawn from ``generator`` when not given, and
    the objective at the end.  Returns (state, objective)."""
    if idx is None:
        idx = draw_blocks(generator, params.d, params.block_size,
                          num_steps, xp.device)
    for i in range(num_steps):
        state = step(state, xp, xm, params, idx=idx[i], clients=clients)
    return state, objective_from_state(state, xp, xm, clients)


def run_chunk(state, xp, xm, num_steps: int, *, params,
              idx: torch.Tensor | None = None,
              generator: torch.Generator | None = None):
    """Serial reference chunk (the JAX package jits it with the state
    donated; here it runs as it is)."""
    return chunk_body(state, xp, xm, params, num_steps, idx=idx,
                      generator=generator, clients=False)


class PackedState(NamedTuple):
    """Solver state over the packed layout; fields may carry the leading
    slot axis.  Padding slots carry log weight NEG_INF forever."""
    w: torch.Tensor             # (..., d)
    log_lam: torch.Tensor       # (..., n_pad) [log eta | log xi | NEG_INF]
    log_lam_prev: torch.Tensor  # (..., n_pad)
    u: torch.Tensor             # (..., n_pad) <w, x_i>, kept incrementally
    t: torch.Tensor             # (...,) int32 iteration counter


def init_packed_state(sign: torch.Tensor, n1: int, n2: int,
                      d: int) -> PackedState:
    """Line 5 of Algorithm 1 on the packed layout: w = 0, eta = 1/n1,
    xi = 1/n2."""
    neg = torch.full_like(sign, NEG_INF)
    log_lam = torch.where(sign > 0, torch.full_like(sign, -math.log(n1)),
                          torch.where(sign < 0,
                                      torch.full_like(sign, -math.log(n2)),
                                      neg))
    return PackedState(
        w=torch.zeros(sign.shape[:-1] + (d,), dtype=torch.float32,
                      device=sign.device),
        log_lam=log_lam, log_lam_prev=log_lam.clone(),
        u=torch.zeros_like(log_lam),
        t=torch.zeros(sign.shape[:-1], dtype=torch.int32, device=sign.device))


def warm_packed_state(x_t: torch.Tensor, w: torch.Tensor,
                      log_lam: torch.Tensor,
                      log_lam_prev: torch.Tensor) -> PackedState:
    """Warm-start state from a previous solution: carry ``w`` and the
    re-placed log duals (``preprocess.repack_warm_duals``) and recompute
    ``u = w @ x_t`` so the invariant u_i == <w, x_i> holds exactly for
    every point.  ``t`` restarts at 0."""
    return PackedState(w=w, log_lam=log_lam, log_lam_prev=log_lam_prev,
                       u=w @ x_t,
                       t=torch.zeros((), dtype=torch.int32, device=w.device))


def unpack_state(pstate: PackedState, n1: int, n2: int, cls):
    """Slice a packed state back into the per-class 8-field view ``cls``:
    slots [0, n1) are eta, [n1, n1+n2) are xi, padding is dropped."""
    lam, prev, u = pstate.log_lam, pstate.log_lam_prev, pstate.u
    return cls(
        w=pstate.w,
        log_eta=lam[..., :n1], log_eta_prev=prev[..., :n1],
        log_xi=lam[..., n1:n1 + n2], log_xi_prev=prev[..., n1:n1 + n2],
        u_p=u[..., :n1], u_m=u[..., n1:n1 + n2],
        t=pstate.t,
    )


class SlotParams(NamedTuple):
    """Per-problem step scalars.  On the slot path every field is an (S,)
    float32 tensor holding the float32 rounding of a value derived in
    float64 on the host (:func:`scalarize_params` gives the python
    floats, :func:`stack_slot_params` the tensors), as in the JAX
    package.  ``nu`` is the EFFECTIVE cap (1.0 for hard margin, where the
    projection is the identity); ``gap_tol`` is the relative duality-gap
    early stop (0 disables)."""
    theta: torch.Tensor
    sigma: torch.Tensor
    inv_sig1: torch.Tensor   # 1 / (sigma + 1), the w-update scale
    gamma: torch.Tensor
    tau: torch.Tensor
    mwu_c: torch.Tensor      # 1 / (gamma + d_eff / tau)
    mwu_dot: torch.Tensor    # d_eff / tau
    nu: torch.Tensor         # effective cap (1.0 == identity)
    gap_tol: torch.Tensor


def scalarize_params(p, gap_tol: float = 0.0) -> SlotParams:
    """The step scalars of a ``SaddleParams``, as python floats derived in
    float64."""
    d_eff = p.d / p.block_size
    return SlotParams(
        theta=p.theta, sigma=p.sigma, inv_sig1=1.0 / (p.sigma + 1.0),
        gamma=p.gamma, tau=p.tau,
        mwu_c=1.0 / (p.gamma + d_eff / p.tau),
        mwu_dot=d_eff / p.tau,
        nu=p.nu if p.nu > 0.0 else 1.0,
        gap_tol=gap_tol)


def slot_params_row(p, gap_tol: float = 0.0) -> SlotParams:
    """:func:`scalarize_params` as a row of float32 numpy scalars."""
    sc = scalarize_params(p, gap_tol)
    return SlotParams(*(np.float32(v) for v in sc))


def stack_slot_params(rows: list[SlotParams],
                      device: torch.device) -> SlotParams:
    """Stack per-slot rows into the (S,)-tensor SlotParams of a batch."""
    return SlotParams(*(torch.tensor(np.asarray(col, np.float32),
                                     device=device)
                        for col in zip(*rows)))


def _dual_update_packed(x_t, idx, log_lam, u, dw, sign, sc: SlotParams,
                        d_eff: float, all_sum=_identity, all_max=_identity):
    """Packed lines 5-6 + incremental u for BOTH classes in one kernel
    call, normalized per class by the logsumexp of the kernel's masked
    (m, s) (S, 2), combined across clients as one (2,) max and one (2,)
    sum (rounds 2-3).  Returns (log_new_normalized, u_new)."""
    log_new, u_new, m_loc, s_loc = ops.mwu_update_packed(
        x_t, idx, log_lam, u, dw, sign, sc.mwu_c, sc.mwu_dot, d_eff)
    m = all_max(m_loc)
    s = all_sum(s_loc * torch.exp(m_loc - m))
    lse = m + torch.log(s)
    return log_new - torch.where(sign > 0, lse[:, 0:1], lse[:, 1:2]), u_new


def _capped_project_packed(log_lam: torch.Tensor, sign: torch.Tensor,
                           nu: torch.Tensor, all_sum=_identity,
                           all_max=_identity) -> torch.Tensor:
    """Sort-free nu-Saddle projection of both classes in one sweep per
    bisection round (round 4: across clients, one (2,) max, one (2,) sum
    per round and one (4,) sum).  Padding (sign 0) belongs to neither
    mask, projects to 0 and so keeps its NEG_INF marker."""
    masks = torch.stack([sign > 0, sign < 0], dim=-2)   # (S, 2, n_pad)
    eta = projections.capped_bisect_masked(
        torch.exp(log_lam), nu, masks,
        rounds=projections.BISECT_ROUNDS_SOLVER, all_sum=all_sum,
        all_max=all_max)
    return torch.where(eta > 0, torch.log(torch.clamp(eta, min=1e-38)),
                       NEG_INF)


def _step_packed_core(state: PackedState, x_t: torch.Tensor,
                      sign: torch.Tensor, sc: SlotParams, *, d: int,
                      block_size: int, project: bool,
                      idx: torch.Tensor | None = None,
                      generators: list[torch.Generator] | None = None,
                      all_sum=_identity, all_max=_identity) -> PackedState:
    """One packed iteration of every slot of the batch.

    ``state`` fields carry the slot axis S; ``idx`` (S, b) int32 is the
    step's coordinate block, drawn from ``generators`` (one per slot)
    when not given.  ``all_sum`` / ``all_max`` are the client hooks
    (identity when the slots are independent problems)."""
    d_eff = d / block_size
    if idx is None:
        idx = sample_blocks(generators, d, block_size, 1, x_t.device)[0]
    delta = all_sum(ops.momentum_dot_packed(
        x_t, idx, state.log_lam, state.log_lam_prev, sign, sc.theta))

    # Line 4: the w update multiplies by the precomputed 1 / (sigma + 1)
    # (delta already is delta+ - delta-, folded by the sign).
    idx_l = idx.long()
    w_old = torch.gather(state.w, 1, idx_l)
    w_new = (w_old + sc.sigma[:, None] * delta) * sc.inv_sig1[:, None]
    dw = w_new - w_old

    # Lines 5-6: ONE packed MWU pass for both classes.
    log_new, u_new = _dual_update_packed(
        x_t, idx, state.log_lam, state.u, dw, sign, sc, d_eff, all_sum,
        all_max)

    if project:
        log_new = _capped_project_packed(log_new, sign, sc.nu, all_sum,
                                         all_max)

    return PackedState(
        w=state.w.scatter(1, idx_l, w_new),
        log_lam=log_new, log_lam_prev=state.log_lam,
        u=u_new, t=state.t + 1,
    )


def objective_from_duals(log_lam: torch.Tensor, x_t: torch.Tensor,
                         sign: torch.Tensor,
                         all_sum=_identity) -> torch.Tensor:
    """0.5 * ||A eta - B xi||^2 from packed log duals: the signed dual
    combination x_t @ (sign * lam) IS A eta - B xi, summed over clients
    by ``all_sum``.  Leading slot axes are carried through."""
    diff = all_sum((x_t @ (sign * torch.exp(log_lam))[..., None])[..., 0])
    return 0.5 * (diff * diff).sum(dim=-1)


def chunk_body_packed(state: PackedState, x_t: torch.Tensor,
                      sign: torch.Tensor, params, num_steps: int, *,
                      idx: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      clients: bool = False):
    """Packed chunk of ONE problem over the S rows of ``state``, ``x_t``
    (S, d, n_pad) and ``sign`` (S, n_pad): S = 1 serially, or the k
    clients of Algorithm 4 with ``clients``.  Every row takes the same
    step scalars and each step's block ``idx[i]`` (b,) (drawn from
    ``generator`` when ``idx`` is not given).  Returns (state, objective
    (S,))."""
    rows = x_t.shape[0]
    d, b = params.d, params.block_size
    sc = stack_slot_params([slot_params_row(params)] * rows, x_t.device)
    all_sum, all_max = client_hooks(clients)
    if idx is None:
        idx = draw_blocks(generator, d, b, num_steps, x_t.device)
    for i in range(num_steps):
        state = _step_packed_core(
            state, x_t, sign, sc, d=d, block_size=b,
            project=params.nu > 0.0,
            idx=idx[i][None].expand(rows, b).contiguous(),
            all_sum=all_sum, all_max=all_max)
    return state, objective_from_duals(state.log_lam, x_t, sign, all_sum)


def run_chunk_packed(state: PackedState, x_t: torch.Tensor,
                     sign: torch.Tensor, num_steps: int, *, params,
                     idx: torch.Tensor | None = None,
                     generator: torch.Generator | None = None):
    """Serial packed chunk (S = 1)."""
    return chunk_body_packed(state, x_t, sign, params, num_steps, idx=idx,
                             generator=generator, clients=False)


def drive(state, num_iters: int, chunk: int, run, draw,
          event=None) -> tuple:
    """Host loop over chunks: ``draw(done, ns)`` gives the next chunk's
    (ns, b) coordinate blocks and ``run(state, idx) -> (state, obj)``
    runs it; each chunk's objective stays on the device until ONE
    transfer at the end.  ``event = (at, fn)`` ends a chunk at iteration
    ``at`` (if it falls before ``num_iters``) and there calls ``fn(state)
    -> (state, row)``; the loop goes on from the returned state, its
    chunks counted from ``at``.  Returns (state, [(done, obj), ...]), the
    objective read from client 0, or from ``row`` after the event."""
    at, fn = event if event is not None else (num_iters, None)
    objs, marks = [], []
    done, row = 0, 0
    while done < num_iters:
        if fn is not None and done == at:
            state, row = fn(state)
            fn = None
        ns = min(chunk, (at if done < at else num_iters) - done)
        state, obj = run(state, draw(done, ns))
        done += ns
        objs.append(obj.reshape(-1)[row])
        marks.append(done)
    return state, list(zip(marks, torch.stack(objs).tolist()))


class SlotState(NamedTuple):
    """S independent packed solver states stacked on a leading slot axis,
    plus the per-slot lifecycle: a slot steps while ``active`` and
    ``t < max_t``; the chunk driver clears ``active`` when the budget is
    spent, the gap has converged or the slot's values went non-finite.
    ``generators`` are the slots' own samplers."""
    w: torch.Tensor             # (S, d)
    log_lam: torch.Tensor       # (S, n_pad)
    log_lam_prev: torch.Tensor  # (S, n_pad)
    u: torch.Tensor             # (S, n_pad)
    t: torch.Tensor             # (S,) int32 iteration counter
    max_t: torch.Tensor         # (S,) int32 iteration budget
    generators: list            # S torch.Generators, one per slot
    active: torch.Tensor        # (S,) bool lifecycle mask

    @property
    def num_slots(self) -> int:
        return self.w.shape[0]


def init_slot_state(num_slots: int, n_pad: int, d: int,
                    device: torch.device) -> SlotState:
    """An all-free slot table for one (n_pad, d) bucket."""
    s = num_slots
    neg = torch.full((s, n_pad), NEG_INF, dtype=torch.float32,
                     device=device)
    return SlotState(
        w=torch.zeros((s, d), dtype=torch.float32, device=device),
        log_lam=neg, log_lam_prev=neg.clone(),
        u=torch.zeros((s, n_pad), dtype=torch.float32, device=device),
        t=torch.zeros((s,), dtype=torch.int32, device=device),
        max_t=torch.zeros((s,), dtype=torch.int32, device=device),
        generators=[torch.Generator(device=device).manual_seed(i)
                    for i in range(s)],
        active=torch.zeros((s,), dtype=torch.bool, device=device),
    )


def admit_into_slot(state: SlotState, slot: int, pstate: PackedState,
                    generator: torch.Generator, max_t: int) -> SlotState:
    """Admit a freshly initialized problem into lane ``slot``, IN PLACE.
    Every per-slot field is overwritten (w, duals, u, t, budget, sampler,
    active flag), so a reused lane cannot leak its previous occupant's
    state."""
    state.w[slot] = pstate.w
    state.log_lam[slot] = pstate.log_lam
    state.log_lam_prev[slot] = pstate.log_lam_prev
    state.u[slot] = pstate.u
    state.t[slot] = pstate.t
    state.max_t[slot] = max_t
    state.generators[slot] = generator
    state.active[slot] = True
    return state


def deactivate_slot(state: SlotState, slot: int) -> SlotState:
    """Freeze one lane, IN PLACE (the cancellation path); its buffers are
    left as they are."""
    state.active[slot] = False
    return state


def _capped_min_masked(scores: torch.Tensor, mask: torch.Tensor,
                       nu: torch.Tensor) -> torch.Tensor:
    """min over eta in D(nu) of <scores, eta> restricted to ``mask``,
    per slot: greedy water-filling puts min(nu, max(0, 1 - i nu)) on the
    i-th smallest masked score.  nu = 1 is the plain min."""
    big = torch.full_like(scores, 1e30)
    s = torch.sort(torch.where(mask, scores, big), dim=-1).values
    ramp = torch.arange(s.shape[-1], dtype=s.dtype, device=s.device)
    nu = nu[..., None]
    w = torch.minimum(torch.clamp(1.0 - ramp * nu, min=0.0), nu)
    return torch.where(w > 0, s * w, torch.zeros_like(s)).sum(dim=-1)


def saddle_gap_packed(w: torch.Tensor, x_t: torch.Tensor, sign: torch.Tensor,
                      nu: torch.Tensor) -> torch.Tensor:
    """g(w) = min_{eta,xi} w^T A eta - w^T B xi - ||w||^2/2 per slot on the
    packed layout (nu is the EFFECTIVE cap, 1.0 for hard margin)."""
    s = (w[..., None, :] @ x_t)[..., 0, :]           # (S, n_pad) <w, x_i>
    inner_p = _capped_min_masked(s, sign > 0, nu)
    inner_m = -_capped_min_masked(-s, sign < 0, nu)
    return inner_p - inner_m - 0.5 * (w * w).sum(dim=-1)


def slot_trace_key(num_slots: int, n_pad: int, d: int, block_size: int,
                   chunk_steps: int, project: bool,
                   check_gap: bool) -> tuple:
    """The ``trace_counts`` key of one slot-chunk configuration."""
    return ("slots", num_slots, n_pad, d, block_size, chunk_steps, project,
            check_gap)


def chunk_body_slots(state: SlotState, x_t: torch.Tensor, sign: torch.Tensor,
                     sp: SlotParams, num_steps: int, *, chunk_steps: int,
                     d: int, block_size: int, project: bool,
                     check_gap: bool, idx: torch.Tensor | None = None):
    """One slot-batched chunk of ``num_steps`` (<= ``chunk_steps``) packed
    iterations over every lane.

    Each step is computed for every lane and kept only where
    ``active & (t < max_t)``, so a lane that spends its budget mid-chunk
    freezes at exactly ``max_t`` without halting the batch.  The chunk's
    coordinate blocks come from ``idx`` (num_steps, S, b) when given,
    else from each slot's generator.  Nothing is read back to the host.

    At the chunk boundary every slot's objective and finite-health flag
    are computed on the device (w and u finite, log_lam free of NaN and
    +inf, objective finite), and -- when ``check_gap`` -- its duality
    gap; a slot that is done (budget spent, unhealthy, or relative gap
    below its ``gap_tol``) goes inactive.

    Returns (new_state, obj (S,), healthy (S,) bool).
    """
    if not 0 <= num_steps <= chunk_steps:
        raise ValueError(f"num_steps={num_steps} must be in "
                         f"[0, chunk_steps={chunk_steps}]")
    key = slot_trace_key(state.num_slots, x_t.shape[-1], d, block_size,
                         chunk_steps, project, check_gap)
    if key not in trace_counts:
        trace_counts[key] += 1
    if idx is None:
        idx = sample_blocks(state.generators, d, block_size, num_steps,
                            x_t.device)

    ps = PackedState(w=state.w, log_lam=state.log_lam,
                     log_lam_prev=state.log_lam_prev, u=state.u, t=state.t)
    for i in range(num_steps):
        new = _step_packed_core(ps, x_t, sign, sp, d=d,
                                block_size=block_size, project=project,
                                idx=idx[i])
        do = state.active & (ps.t < state.max_t)            # (S,)
        col = do[:, None]
        ps = PackedState(
            w=torch.where(col, new.w, ps.w),
            log_lam=torch.where(col, new.log_lam, ps.log_lam),
            log_lam_prev=torch.where(col, new.log_lam_prev,
                                     ps.log_lam_prev),
            u=torch.where(col, new.u, ps.u),
            t=torch.where(do, new.t, ps.t))
    state = state._replace(w=ps.w, log_lam=ps.log_lam,
                           log_lam_prev=ps.log_lam_prev, u=ps.u, t=ps.t)

    obj = objective_from_duals(state.log_lam, x_t, sign)
    healthy = (torch.isfinite(state.w).all(dim=-1)
               & torch.isfinite(state.u).all(dim=-1)
               & ~torch.isnan(state.log_lam).any(dim=-1)
               & ~torch.isposinf(state.log_lam).any(dim=-1)
               & torch.isfinite(obj))
    done = (state.t >= state.max_t) | ~healthy
    if check_gap:
        gap = saddle_gap_packed(state.w, x_t, sign, sp.nu)
        converged = (sp.gap_tol > 0) & (
            obj - gap <= sp.gap_tol * torch.clamp(obj, min=1e-12))
        done = done | converged
    return state._replace(active=state.active & ~done), obj, healthy


# The serving entry point: in eager PyTorch the chunk body runs as it is
# (the JAX package jits it with the state donated).
run_chunk_slots = chunk_body_slots


def run_solve_slots(state: SlotState, x_t: torch.Tensor, sign: torch.Tensor,
                    sp: SlotParams, num_iters: int, *, chunk_steps: int,
                    num_chunks: int, d: int, block_size: int, project: bool,
                    check_gap: bool = False,
                    idx: torch.Tensor | None = None):
    """Multi-chunk solve driver: a host loop over :func:`chunk_body_slots`
    that keeps each boundary's per-slot objective and iteration mark on
    the device.

    Without the gap check nothing is read back until the end.  With it,
    the loop reads whether any lane is still active at each chunk
    boundary and stops when none is, as the JAX package's device loop
    does.  Without it, a batch whose every lane froze early (health)
    runs its remaining chunks as masked no-ops, and the history is cut
    after the first chunk that left no lane active -- where the JAX loop
    exits.  ``idx`` (num_iters, S, b) injects the whole schedule.

    Returns (state, objs (nc, S), marks (nc, S), nc).
    """
    objs, marks, live = [], [], []
    done = 0
    while done < num_iters and len(objs) < num_chunks:
        ns = min(chunk_steps, num_iters - done)
        state, obj, _healthy = chunk_body_slots(
            state, x_t, sign, sp, ns, chunk_steps=chunk_steps, d=d,
            block_size=block_size, project=project, check_gap=check_gap,
            idx=None if idx is None else idx[done:done + ns])
        done += ns
        objs.append(obj)
        marks.append(state.t.clone())
        live.append(state.active.any())
        if check_gap and not bool(live[-1]):      # chunk-boundary read-back
            break
    alive = torch.stack(live).tolist()
    nc = alive.index(False) + 1 if False in alive else len(alive)
    return state, torch.stack(objs)[:nc], torch.stack(marks)[:nc], nc
