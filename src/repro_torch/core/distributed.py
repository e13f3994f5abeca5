"""Saddle-DSVC (Section 4 / Algorithm 4), the distributed solver, in PyTorch.

Counterpart of ``repro.core.distributed``.  The paper's server/clients
protocol, per iteration:

  round 1  server broadcasts i*; clients send partial delta+-    -> sum
  round 2  server broadcasts summed delta+-; clients update w,
           eta, xi locally and send partial normalizers Z+-      -> max, sum
  round 3  server broadcasts Z+-; clients normalize               (local)
  round 4  (nu-Saddle only) the capped-simplex projection: a feasibility
           max, one (2,) sum per bisection round and a cap-set sum

Every "send partials / broadcast the result" pair is one all-reduce of
O(1) scalars over the clients (Theorem 8's O(k) communication).  Here the
k clients are simulated on one device as an explicit leading client axis
of every state field and operand, and an all-reduce is a sum or max over
that axis (``engine._all_sum`` / ``engine._all_max``, tallied in
``engine.collective_counts``).  The packed step is the engine's
``_step_packed_core`` with the client axis as its slot axis S = k, so its
two kernels serve all k clients in one launch each; the unpacked
reference (:func:`run_chunk_sim`) is the engine's ``step`` with
``clients=True``, four launches per step for any k.

Both produce the iterates of the serial solver, because summing per-client
partial dot products and normalizers over the round-robin shards is the
serial sum regrouped; k = 1 is the serial step bit for bit.

The JAX package's real-mesh runner (``shard_map``) is not ported: see
``ROADMAP.md``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core import preprocess as pp
from repro_torch.core import projections
from repro_torch.core import saddle
from repro_torch.core.engine import NEG_INF
from repro_torch.device import resolve_device


class ShardedState(NamedTuple):
    """Per-client slices of the solver state, stacked on a leading client
    axis k."""
    w: torch.Tensor             # (k, d) -- every client keeps the same w
    log_eta: torch.Tensor       # (k, m1)
    log_eta_prev: torch.Tensor
    log_xi: torch.Tensor        # (k, m2)
    log_xi_prev: torch.Tensor
    u_p: torch.Tensor
    u_m: torch.Tensor
    t: torch.Tensor             # (k,)


class CommModel(NamedTuple):
    """Analytic communication accounting for Algorithm 4.

    * ``scalars_per_iteration`` -- the paper's convention (Theorem 8):
      numbers exchanged per iteration, every client's up and down traffic
      counted, O(k).
    * ``collectives_per_iteration`` / ``collective_multiset`` /
      ``payload_elements_per_iteration`` -- the implementation's view: the
      all-reduces one packed step makes per iteration, keyed (op, reduce
      kind, elements per client).  ``engine.collective_counts`` tallies
      the same keys as the step runs.
    """
    k: int
    nu_rounds_per_iter: float   # 0 for HM-Saddle; else BISECT_ROUNDS_SOLVER

    def scalars_per_iteration(self) -> float:
        k = self.k
        # round 1: broadcast i* (k) + 2 scalars up from each client (2k)
        # round 2: broadcast 2 (2k) + Z's up (2k)
        # round 3: broadcast Z's (2k)
        base = k + 2 * k + 2 * k + 2 * k + 2 * k
        # round 4 (nu-Saddle): one (2,) all-reduce per bisection round --
        # 2 scalars up (2k) + 2 down (2k) -- for a fixed round count, plus
        # the (2,) feasibility max (4k) and the (4,) cap-set stats (8k)
        nu_fixed = 12 * k if self.nu_rounds_per_iter else 0
        return base + self.nu_rounds_per_iter * 4 * k + nu_fixed

    def total(self, iters: int) -> float:
        return self.scalars_per_iteration() * iters

    def collective_multiset(self, block_size: int = 1) -> dict:
        """The all-reduces of one packed iteration, keyed
        ("all-reduce", kind, elements):

          round 1    momentum sum            add  (B,)
          rounds 2-3 normalizer max + sum    max/add  (2,)
          round 4    feasibility max         max  (2,)
                     one sum per bisection   add  (2,)
                     cap-set stats sum       add  (4,)
        """
        ms: dict = {}

        def bump(kind, elems, cnt=1):
            key = ("all-reduce", kind, elems)
            ms[key] = ms.get(key, 0) + cnt

        bump("add", block_size)
        bump("max", 2)
        bump("add", 2)
        if self.nu_rounds_per_iter:
            bump("max", 2)
            bump("add", 2, int(self.nu_rounds_per_iter))
            bump("add", 4)
        return ms

    def collectives_per_iteration(self, block_size: int = 1) -> int:
        """All-reduces per iteration, constant in n, d and k: 3 for
        HM-Saddle, 5 + BISECT_ROUNDS_SOLVER for nu-Saddle."""
        return sum(self.collective_multiset(block_size).values())

    def payload_elements_per_iteration(self, block_size: int = 1) -> int:
        """All-reduce elements per client per iteration: O(B + rounds),
        independent of n."""
        return sum(elems * cnt for (_, _, elems), cnt
                   in self.collective_multiset(block_size).items())


def dsvc_step(state: ShardedState, xp: torch.Tensor, xm: torch.Tensor,
              p: saddle.SaddleParams, *, idx: torch.Tensor | None = None,
              generator: torch.Generator | None = None) -> ShardedState:
    """One Algorithm-4 iteration of all k clients (the engine's reference
    step across the client axis).  ``xp`` / ``xm`` are the stacked
    (k, m1, d) / (k, m2, d) shards; the block ``idx`` (b,) is the same
    for every client (the server broadcasts i*)."""
    return engine.step(state, xp, xm, p, idx=idx, generator=generator,
                       clients=True)


def shard_points(x: np.ndarray, k: int):
    """Round-robin partition of n points into k equal shards, padded with
    zero points (whose log weight is NEG_INF).  Returns the (k, m, d)
    shards and their (k, m) validity mask."""
    x = np.asarray(x)
    n, d = x.shape
    m = -(-n // k)
    pad = k * m - n
    xpad = np.concatenate([x, np.zeros((pad, d), x.dtype)], 0)
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    order = np.arange(k * m).reshape(m, k).T.reshape(-1)   # round robin
    return xpad[order].reshape(k, m, d), mask[order].reshape(k, m)


def gather_duals(state: ShardedState, n1: int, n2: int, k: int):
    """Undo the round-robin sharding of :func:`shard_points`: shard c,
    slot j holds original point j*k + c.  Returns (eta, xi) as numpy
    arrays of length n1, n2."""
    def unshard(log_v, n):
        log_v = convert.to_numpy_array(log_v)
        if log_v.shape[0] != k:
            raise ValueError(
                f"state has {log_v.shape[0]} client shards, expected k={k}")
        flat = log_v.T.reshape(-1)          # flat[j*k + c] = v[c, j]
        return np.exp(flat[:n])
    return unshard(state.log_eta, n1), unshard(state.log_xi, n2)


def pack_shards(xp_sh: np.ndarray, mask_p: np.ndarray, xm_sh: np.ndarray,
                mask_m: np.ndarray):
    """Pack each client's two class shards into the single-sweep layout
    (see preprocess.pack_points): returns the stacked column-major
    mirrors (k, d, m_pad) and sign vectors (k, m_pad), numpy.  Round-robin
    padding points get sign 0, like the lane padding."""
    k, m1, d = xp_sh.shape
    m2 = xm_sh.shape[1]
    m_pad = pp.packed_length(m1 + m2)
    x = np.zeros((k, m_pad, d), np.float32)
    x[:, :m1] = xp_sh
    x[:, m1:m1 + m2] = xm_sh
    sign = np.zeros((k, m_pad), np.float32)
    sign[:, :m1] = np.where(mask_p, 1.0, 0.0)
    sign[:, m1:m1 + m2] = np.where(mask_m, -1.0, 0.0)
    return np.ascontiguousarray(x.transpose(0, 2, 1)), sign


def unpack_sharded_state(pstate: engine.PackedState, m1: int,
                         m2: int) -> ShardedState:
    """Slice the stacked packed state back into the per-class
    ShardedState view."""
    return engine.unpack_state(pstate, m1, m2, ShardedState)


def init_sharded_state(n1: int, n2: int, d: int, mask_p: np.ndarray,
                       mask_m: np.ndarray, *,
                       device: str | torch.device | None = None
                       ) -> ShardedState:
    """Stacked (k, ...) client states of the reference step: eta = 1/n1,
    xi = 1/n2 on real points, NEG_INF on padding."""
    dev = resolve_device(device)
    k, m1 = mask_p.shape
    m2 = mask_m.shape[1]

    def logs(mask, n):
        return torch.as_tensor(
            np.where(mask, -np.log(n), NEG_INF).astype(np.float32),
            device=dev)

    log_eta, log_xi = logs(mask_p, n1), logs(mask_m, n2)
    return ShardedState(
        w=torch.zeros((k, d), dtype=torch.float32, device=dev),
        log_eta=log_eta, log_eta_prev=log_eta.clone(),
        log_xi=log_xi, log_xi_prev=log_xi.clone(),
        u_p=torch.zeros((k, m1), dtype=torch.float32, device=dev),
        u_m=torch.zeros((k, m2), dtype=torch.float32, device=dev),
        t=torch.zeros((k,), dtype=torch.int32, device=dev))


def run_chunk_sim(state: ShardedState, xp: torch.Tensor, xm: torch.Tensor,
                  num_steps: int, *, params: saddle.SaddleParams,
                  idx: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
    """``num_steps`` reference iterations of all k clients (four kernel
    launches per step), with the blocks ``idx`` (num_steps, b) or drawn
    from ``generator``.  Returns (state, per-client objective (k,))."""
    return engine.chunk_body(state, xp, xm, params, num_steps, idx=idx,
                             generator=generator, clients=True)


def run_chunk_sim_packed(state: engine.PackedState, x_t: torch.Tensor,
                         sign: torch.Tensor, num_steps: int, *,
                         params: saddle.SaddleParams,
                         idx: torch.Tensor | None = None,
                         generator: torch.Generator | None = None):
    """``num_steps`` packed iterations of all k clients (two kernel
    launches per step): ``x_t`` (k, d, m_pad), ``sign`` (k, m_pad).
    Returns (state, per-client objective (k,))."""
    return engine.chunk_body_packed(state, x_t, sign, params, num_steps,
                                    idx=idx, generator=generator,
                                    clients=True)


def _apply_client_drop(state: engine.PackedState, sign: torch.Tensor,
                       client: int):
    """Remove one client from the simulation without changing any shape:
    its sign row goes to 0 (its points leave every masked reduction) and
    its dual weights to NEG_INF, its u to 0 (exp(NEG_INF) = 0, so it adds
    nothing to any sum).  The next iteration's normalizer round rescales
    each class's surviving mass to 1: the MWU normalization is the
    repair.  Returns new (state, sign)."""
    drop = (torch.arange(sign.shape[0], device=sign.device)
            == client)[:, None]
    return state._replace(
        log_lam=torch.where(drop, NEG_INF, state.log_lam),
        log_lam_prev=torch.where(drop, NEG_INF, state.log_lam_prev),
        u=torch.where(drop, 0.0, state.u),
    ), torch.where(drop, 0.0, sign)


class DistSolveResult(NamedTuple):
    state: ShardedState
    history: list            # [(iteration, scalars sent, objective)]
    comm: CommModel
    scalars_sent: float


def solve_distributed(xp, xm, *, k: int = 20, eps: float = 1e-3,
                      beta: float = 0.1, nu: float = 0.0,
                      num_iters: int | None = None, block_size: int = 1,
                      seed: int = 0, record_every: int | None = None,
                      mesh=None, drop_client: tuple[int, int] | None = None,
                      idx_schedule=None,
                      device: str | torch.device | None = None
                      ) -> DistSolveResult:
    """Run Saddle-DSVC with k clients simulated on one device.

    Data must already be preprocessed (Algorithm 3 runs WD per client with
    the same shared D, which is the same as transforming up front).

    Args:
      xp, xm: (n1, d), (n2, d) transformed point matrices.
      mesh: the JAX package's real-mesh mode; not ported (raises).
      drop_client: ``(c, at_iter)`` removes client c at iteration
        ``at_iter`` (see :func:`_apply_client_drop`); the solve goes on
        over the k - 1 survivors.
      idx_schedule: optional (num_iters, block_size) coordinate schedule
        (in steps) replacing the sampler, e.g. the JAX package's.
      device: "cuda" (default: the hand-written kernels) or "cpu".

    The default blocks come from a ``torch.Generator`` on the device
    seeded with ``seed``, drawn chunk by chunk as the serial
    ``saddle.solve`` draws them, so k = 1 replays the serial solve.
    """
    if drop_client is not None and mesh is not None:
        raise ValueError("drop_client injection is simulation-only "
                         "(mesh=None)")
    if mesh is not None:
        raise NotImplementedError(
            "the real-collective runner (mesh=) is not ported yet; see "
            "ROADMAP.md")
    dev = resolve_device(device)
    xp = convert.to_numpy_array(xp).astype(np.float32)
    xm = convert.to_numpy_array(xm).astype(np.float32)
    n1, d = xp.shape
    n2 = xm.shape[0]
    params = saddle.make_params(n1 + n2, d, eps, beta, nu=nu,
                                block_size=block_size)
    num_iters = saddle.resolve_num_iters(num_iters, d, eps, beta, n1 + n2,
                                         block_size)

    xp_sh, mask_p = shard_points(xp, k)
    xm_sh, mask_m = shard_points(xm, k)
    m1, m2 = mask_p.shape[1], mask_m.shape[1]
    x_t, sign = (torch.as_tensor(a, device=dev)
                 for a in pack_shards(xp_sh, mask_p, xm_sh, mask_m))
    state = engine.init_packed_state(sign, n1, n2, d)
    chunk = min(record_every or num_iters, num_iters)

    if idx_schedule is None:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def draw(_done, ns):
            return engine.draw_blocks(gen, d, block_size, ns, dev)
    else:
        sched = saddle._schedule(idx_schedule, num_iters, d, block_size,
                                 dev)[:, 0]

        def draw(done, ns):
            return sched[done:done + ns]

    # round-4 bisection rounds per iteration: a fixed count, one (2,)
    # all-reduce each
    nu_rounds = float(projections.BISECT_ROUNDS_SOLVER) if nu > 0 else 0.0
    comm = CommModel(k=k, nu_rounds_per_iter=nu_rounds)

    def run(st, idx):
        # ``sign`` is read when the chunk runs, so a drop takes effect
        return run_chunk_sim_packed(st, x_t, sign, idx.shape[0],
                                    params=params, idx=idx)

    event = None
    if drop_client is not None:
        drop_c, drop_at = drop_client

        def drop(st):
            nonlocal sign
            st, sign = _apply_client_drop(st, sign, drop_c)
            # the objective agrees across live clients; read a survivor's
            return st, (drop_c + 1) % k

        event = (max(0, min(int(drop_at), num_iters)), drop)
    state, hist = engine.drive(state, num_iters, chunk, run, draw, event)
    history = [(done, comm.total(done), obj) for done, obj in hist]
    return DistSolveResult(state=unpack_sharded_state(state, m1, m2),
                           history=history, comm=comm,
                           scalars_sent=comm.total(num_iters))
