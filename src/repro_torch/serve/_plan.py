"""The device side of the fit service (``solver_service.SolverService``):
one rank's shard of a group's slot buffers, the plan rank 0 broadcasts
each scheduler step over a process group, and the functions every rank
applies it with.  Private to the service."""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.launch import mesh as meshlib


def write_slot_data(batch: "Batch", slot: int, x_t: torch.Tensor,
                     sign: torch.Tensor) -> None:
    """Copy one request's packed operand into lane ``slot`` of the batch
    buffers, in place."""
    batch.x_t[slot].copy_(x_t)
    batch.sign[slot].copy_(sign)


# a free lane's step scalars (its outputs are discarded by the mask)
FREE_ROW = engine.SlotParams(*(np.float32(v) for v in (
    0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0)))

# The service's own traffic over a group, by kind: the plan broadcast,
# rank 0's admission data and the harvest gathers.
TRAFFIC = ("plan", "data", "harvest")


class Batch:
    """One bucket's DEVICE buffers on this rank: slot-batched engine
    state, the packed operands and the per-slot SlotParams rows (numpy
    float32, mirrored on the device by ``engine.stack_slot_params`` when
    an admission changed them).  The host-side queue and lane occupancy
    live in the scheduler's Group (on rank 0 this object is that group's
    ``payload``).

    Everything else follows from the group key: the (n, d) bucket, the
    block size and ``project``/``check_gap``, FIXED at batch creation
    (hard-margin and nu-SVM requests live in separate batches), so a
    request's chunk configuration -- and therefore its numeric trajectory
    -- is fully determined by the request itself, never by which
    co-tenants happen to share its bucket at admission time; and on a
    group of k ranks the placement, which fixes this rank's SHARD: lanes
    [first, first + S/k) whole ("lanes"), or every lane's points
    [r m, (r+1) m), m = n_pad / k ("points")."""

    def __init__(self, key: tuple, num_slots: int, device: torch.device,
                 mesh=None):
        n_pad, d_pad = key[:2]
        self.key = key
        self.bucket = (n_pad, d_pad)
        self.block_size, self.project, self.check_gap = key[2:5]
        self.placement = key[5] if len(key) > 5 else None
        self.num_slots = num_slots
        k, r = (1, 0) if mesh is None else (mesh.size, mesh.rank)
        s_loc, m = num_slots, n_pad
        self.first = 0                          # global index of lane 0
        if self.placement == "lanes":
            s_loc = num_slots // k
            self.first = r * s_loc
        elif self.placement == "points":
            m = n_pad // k
        self.state = engine.init_slot_state(s_loc, m, d_pad, device)
        self.x_t = torch.zeros((s_loc, d_pad, m), dtype=torch.float32,
                               device=device)
        self.sign = torch.zeros((s_loc, m), dtype=torch.float32,
                                device=device)
        self.sp = [FREE_ROW] * s_loc
        self.sp_dev = None                      # device mirror of sp
        self.keep = [False] * s_loc             # streaming tenant's lane

    def local(self, lane: int) -> int | None:
        """This rank's index of global ``lane``, None if another rank
        holds it."""
        j = lane - self.first
        return j if 0 <= j < len(self.sp) else None

    @property
    def nbytes(self) -> int:
        st = self.state
        return sum(t.numel() * t.element_size() for t in (
            st.w, st.log_lam, st.log_lam_prev, st.u, st.t, st.max_t,
            st.active, self.x_t, self.sign))


class Admit(NamedTuple):
    """One admission of a plan: what every rank that holds the lane needs
    beside its data (which rank 0 sends the lane's holders)."""
    lane: int                   # global lane
    sp: engine.SlotParams       # the lane's step scalars (float32 row)
    seed: int                   # its sampler's seed
    num_iters: int              # its budget
    keep: bool                  # streaming: harvest also reads prev and w


class Plan(NamedTuple):
    """Rank 0's decisions for one scheduler step, which every rank of the
    group applies in this order: ``ops`` (device writes of front-end
    calls and evictions since the last plan, ("deactivate", key, lane) /
    ("evict", key)), then for the ``group`` (key, num_slots) picked, if
    any: the admissions, the poisoned lanes, and one chunk, its blocks
    taken from ``inject`` (lane -> (chunk_steps, b) rows of a replayed
    schedule) where given.  ``stop``: rank 0's ``run`` has drained the
    service.  ``seq`` numbers the plans, so that ranks whose calls
    disagree raise."""
    seq: int
    ops: tuple
    group: tuple | None = None
    admits: tuple = ()
    poison: tuple = ()
    inject: dict | None = None
    stop: bool = False


def lane_parts(batch: Batch, lane: int, data: tuple, mesh) -> list:
    """(rank, its part of a lane's (x_t, sign, w, log_lam,
    log_lam_prev, u)): the whole lane for its holder, or each rank's
    columns of a point-sharded lane (w whole on every rank)."""
    if batch.placement == "points":
        x_t, sign, w, lam, prev, u = data
        m = batch.bucket[0] // mesh.size
        return [(r, (x_t[:, c], sign[c], w, lam[c], prev[c], u[c]))
                for r in range(mesh.size)
                for c in (slice(r * m, (r + 1) * m),)]
    per_rank = len(batch.sp)
    return [(lane // per_rank if batch.placement else 0, data)]


def write_lane(batch: Batch, new: Admit, part, device: torch.device) -> None:
    """Admit one lane into this rank's shard, in place: its operand,
    state, budget, step scalars and a sampler seeded with the request's
    seed (a point-sharded lane's on every rank, so that every rank draws
    the same blocks)."""
    j = batch.local(new.lane)
    x_t, sign, w, lam, prev, u = (torch.as_tensor(v, device=device)
                                  for v in part)
    write_slot_data(batch, j, x_t, sign)
    pstate = engine.PackedState(
        w=w, log_lam=lam, log_lam_prev=prev, u=u,
        t=torch.zeros((), dtype=torch.int32, device=device))
    gen = torch.Generator(device=device).manual_seed(new.seed)
    engine.admit_into_slot(batch.state, j, pstate, gen, new.num_iters)
    batch.sp[j] = new.sp
    batch.keep[j] = new.keep
    batch.sp_dev = None                     # refresh device mirror


def chunk_blocks(batch: Batch, inject: dict | None, chunk_steps: int,
                 device: torch.device):
    """This rank's (chunk_steps, S, b) coordinate blocks when a lane
    replays an injected schedule, else None (every lane draws from its
    own sampler inside the chunk).  A replaying lane takes its rows,
    padded to a full chunk; every other lane draws from its own
    generator exactly as the chunk would."""
    if not inject:
        return None
    d, c, b = batch.bucket[1], chunk_steps, batch.block_size
    cols = []
    for j, gen in enumerate(batch.state.generators):
        rows = inject.get(batch.first + j)
        if rows is None:
            cols.append(engine.sample_blocks([gen], d, b, c,
                                             device)[:, 0])
            continue
        rows = torch.as_tensor(rows, device=device)
        pad = torch.arange(b, dtype=rows.dtype, device=rows.device)
        cols.append(torch.cat([rows, pad.expand(c - len(rows), b)]))
    return torch.stack(cols, dim=1)


def collect(batch: Batch, obj, healthy, before, mesh, count) -> tuple:
    """The chunk's harvest read.  Rank 0 gets the (4, S) lifecycle rows
    (active, t, objective, health; float64) and a function of a finished
    lane that returns its (log_lam, log_lam_prev, w) on the device; other
    ranks get None.  ONE device-to-host transfer a rank for all
    (S,)-sized vectors; a lane's big state moves only once it has
    finished (active before the chunk, healthy and inactive after it):
    over a group, the lanes placement gathers every rank's rows with its
    finished lanes, the points placement (whose rows every rank holds)
    each rank's columns of the finished lanes.  ``count(kind, bytes,
    t0)`` records the gather's traffic."""
    st = batch.state
    vecs = [st.active, st.t, obj, healthy]
    if before is not None:
        vecs.append(before)
    local = torch.stack([v.to(torch.float64) for v in vecs]).cpu().numpy()
    rows = local[:4]
    if before is None:                       # meshless or one rank
        return rows, lambda lane: (st.log_lam[lane],
                                   st.log_lam_prev[lane], st.w[lane])
    done = [j for j in range(len(batch.sp))
            if local[4, j] and not local[0, j] and local[3, j]]

    def part(j, with_w: bool):
        keep = batch.keep[j]
        return (st.log_lam[j].cpu().numpy(),
                st.log_lam_prev[j].cpu().numpy() if keep else None,
                st.w[j].cpu().numpy() if keep and with_w else None)

    if batch.placement == "lanes":
        mine = (rows, {batch.first + j: part(j, True) for j in done})
    elif done:
        mine = {j: part(j, False) for j in done}     # w: every rank's
    else:
        return (rows if mesh.rank == 0 else None), None
    t0 = time.perf_counter()
    got, nbytes = meshlib.gather_objects(mesh, mine)
    count("harvest", nbytes, t0)
    if mesh.rank:
        return None, None
    dev = batch.x_t.device

    def tensor(a):
        return None if a is None else torch.tensor(a, device=dev)

    if batch.placement == "lanes":
        rows = np.concatenate([g[0] for g in got], axis=1)
        far = {lane: v for g in got[1:] for lane, v in g[1].items()}

        def lane_state(lane):
            j = batch.local(lane)
            if j is not None:
                return st.log_lam[j], st.log_lam_prev[j], st.w[j]
            return tuple(tensor(a) for a in far[lane])
        return rows, lane_state

    def lane_state(lane):
        lam = [st.log_lam[lane]] + [tensor(g[lane][0]) for g in got[1:]]
        prev = [st.log_lam_prev[lane]] + [tensor(g[lane][1])
                                          for g in got[1:]]
        return (torch.cat(lam),
                torch.cat(prev) if batch.keep[lane] else None,
                st.w[lane])
    return rows, lane_state
