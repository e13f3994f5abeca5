"""Wrappers of the saddle-step CUDA kernels (``csrc/saddle_update.cu``).

The unpacked per-class kernels (:func:`momentum_dot`, :func:`mwu_update`,
the reference step's four launches) take ``cols`` (n, B), the step's B
sampled coordinates of n points, and point vectors (n,), or the same with
a leading client axis K: cols (K, n, B), vectors (K, n), ``dw`` (K, B).
Any n is taken; the step scalars are python floats.  Each is one launch
whose outputs are final, the MWU's normalisation included: a client of
several point blocks merges them inside the launch, as the packed kernels
do, through the same workspace.

The packed kernels take a leading slot axis S: ``x_t`` (S, d, n_pad),
``idx`` (S, b) int32 with any b from 1 to d, point vectors (S, n_pad) and
per-slot scalars (S,), all float32 except ``idx``.  Each call is one kernel
launch whose outputs are final: the kernels merge their per-tile partials
themselves, the last block of a group taking a ticket from the group's
counter.  Many sampled rows over few points cut a slot's rows into
contiguous splits, a third grid axis (:func:`packed_row_splits`), whose
partials merge the same way.  The counters and the partials' scratch are
a workspace per device that the packed wrappers and the unpacked kernels
share, so these kernels assume one stream at a time.

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors it
runs the plain version in :mod:`repro_torch.kernels.ref`.

Each launch comes from a :class:`Launch` (:func:`packed_launch`,
:func:`momentum_dot_launch`, :func:`mwu_update_launch`, memoised by
shape): the C launcher's geometry arguments, the grid and dynamic shared
memory it derives from them, and the workspace the wrapper allocates.
``repro_torch.analysis.kernel_audit`` builds its launch plans from the
same tuples, and ``launch_geometry`` in the library reports the C side's
grid and shared memory for a check on the card.

``idx`` must hold distinct coordinates in [0, d) (the solver's sampler
and ``saddle.solve``'s injected schedules are validated where they are
made).  An index outside that range raises ``IndexError`` on the CPU; on
CUDA, where checking it would cost a read-back every step, the kernels
skip the row and the outputs it touches are NaN.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, launch_counts, ref

LANE = 128   # points per kernel tile; packed lengths are multiples of it
THREADS = 256  # threads per block of every kernel in the source
DOT_COLS = 128      # most columns a block of the unpacked dot covers
DOT_POINTS = 4_096  # most points a block of the unpacked dot takes (B > 1):
                    # their momentum in 16 KB of shared memory
DOT_UNROLL = 8      # rows whose loads a lane of an unpacked kernel issues
                    # at once
MWU_POINTS = 2_048  # most points a block of the unpacked MWU takes: their
                    # dv, log_lam and u in 24 KB of shared memory
SMS = 132           # streaming multiprocessors of an H100
MAX_SPLITS = 64     # most row splits of a packed slot
SPLIT_ROWS = 1_024  # fewest rows a packed row split is cut to
DOT_WAVE = 2 * SMS  # most blocks of an unpacked kernel before a block
                    # takes more rounds
# The packed kernels' dynamic shared memory, as csrc/saddle_update.cu sizes
# it: a ring of up to MAX_STAGES stages of STAGE_FLOATS floats, then the
# sampled rows' indices (dot) or dw (MWU), CHUNK_ROWS of them at a time.
STAGE_FLOATS = 4_096
MAX_STAGES = 4
CHUNK_ROWS = 32_768
MAX_SMEM = 232_448  # bytes of shared memory an H100 block may use


def _check_f32(name: str, t: torch.Tensor, shape: tuple,
               device: torch.device, aligned: bool = False) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device``, and with ``aligned`` 16-byte aligned (the CUDA kernels
    read it in float4s)."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x_t on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")


def check_packed(x_t: torch.Tensor, idx: torch.Tensor,
                 vectors: dict[str, torch.Tensor],
                 scalars: dict[str, torch.Tensor],
                 rows: dict[str, torch.Tensor] | None = None):
    """Validate the packed operands; returns (S, d, n_pad, b)."""
    if x_t.ndim != 3:
        raise ValueError(f"x_t must be (S, d, n_pad), got shape "
                         f"{tuple(x_t.shape)}")
    s, d, n_pad = x_t.shape
    if n_pad % LANE or n_pad == 0:
        raise ValueError(
            f"packed length {n_pad} must be lane-aligned (a positive "
            f"multiple of {LANE}); use preprocess.pack_points")
    if idx.ndim != 2 or idx.shape[0] != s or idx.shape[1] < 1:
        raise ValueError(f"idx must be ({s}, b) with b >= 1, got shape "
                         f"{tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.device != x_t.device or not idx.is_contiguous():
        raise ValueError("idx must be contiguous and on x_t's device")
    b = idx.shape[1]
    if b > d:
        raise ValueError(f"b={b} sampled rows exceed d={d}")
    dev = x_t.device
    kind = dev.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"packed kernels run on cuda or cpu, not {dev}")
    cuda = kind == "cuda"
    _check_f32("x_t", x_t, (s, d, n_pad), dev, aligned=cuda)
    for name, t in vectors.items():
        _check_f32(name, t, (s, n_pad), dev, aligned=cuda)
    for name, t in (rows or {}).items():
        _check_f32(name, t, (s, b), dev)
    for name, t in scalars.items():
        _check_f32(name, t, (s,), dev)
    if not cuda and (idx.min() < 0 or idx.max() >= d):
        raise IndexError(f"idx entries must lie in [0, {d})")
    return s, d, n_pad, b


def packed_tiles_per_block(b: int) -> int:
    """128-point tiles per block of a packed kernel for b sampled rows: a
    block's 8 warps cover T tiles in 8 / T row groups (never more groups
    than rows), so b = 1 spreads a block over 8 tiles and b >= 8 puts all
    8 warps on one tile."""
    return 1 if b >= 8 else 2 if b >= 4 else 4 if b >= 2 else 8


def packed_ring_stages(b: int, tpb: int) -> int:
    """Stages of a packed block's row ring (``ring_stages`` in the CUDA
    source): one per 32 / T rows, at most MAX_STAGES."""
    rows = STAGE_FLOATS // (tpb * LANE)
    return min(-(-b // rows), MAX_STAGES)


def packed_smem(b: int) -> int:
    """Bytes of dynamic shared memory of a packed block that walks b
    sampled rows (``packed_smem`` in the CUDA source): the ring, then one
    chunk of the rows' indices or dw, all b up to CHUNK_ROWS, rounded up to
    16 bytes.  A block of a row split walks its split's rows."""
    nbuf = packed_ring_stages(b, packed_tiles_per_block(b))
    return nbuf * STAGE_FLOATS * 4 + -(-min(b, CHUNK_ROWS) * 4 // 16) * 16


def packed_split_rows(b: int, splits: int) -> int:
    """Rows of each of ``splits`` row splits of b sampled rows (the last
    may hold fewer; ``split_span`` in the CUDA source): b / splits rounded
    up to a stage of the ring (32 / T rows), at most b."""
    rows = STAGE_FLOATS // (packed_tiles_per_block(b) * LANE)
    per = -(-b // splits)
    return min(b, -(-per // rows) * rows)


def packed_row_splits(n_pad: int, b: int) -> int:
    """Contiguous row splits R of a packed slot's b sampled rows over
    ``n_pad`` points: the third grid axis of both packed kernels.  A
    slot's point blocks alone leave most of the card idle where the points
    are few and the rows many (n_pad = 1,536: 12 blocks on 132 SMs), each
    walking all b rows; splitting the rows puts about two blocks on every
    SM (2 SMS blocks a slot), keeping at least SPLIT_ROWS rows a split (so
    R = 1 below 2,048 rows) and at most MAX_SPLITS splits, each starting
    on a stage of the ring, none empty.  R = 1 also where the point blocks
    fill the card.  R does not depend on the slot count S: a slot's bits
    do not depend on its batch-mates."""
    blocks = -(-(n_pad // LANE) // packed_tiles_per_block(b))
    want = min(MAX_SPLITS, -(-2 * SMS // blocks), b // SPLIT_ROWS)
    if want <= 1:
        return 1
    return -(-b // packed_split_rows(b, want))


class Launch(NamedTuple):
    """One launch of a kernel: ``args``, the C launcher's geometry
    arguments (``(tpb, splits)``, or ``(lanes, points)``); the ``grid``
    (x, y, z) and ``dynamic_smem`` bytes the launcher derives from them;
    and the workspace the wrapper allocates, ``counters`` ticket counters
    and ``floats`` floats of per-block partials."""

    args: tuple
    grid: tuple
    dynamic_smem: int
    counters: int
    floats: int


@functools.lru_cache(maxsize=None)
def packed_launch(kernel: str, s: int, n_pad: int, b: int) -> Launch:
    """The launch of packed ``kernel`` (``momentum_dot_packed`` or
    ``mwu_update_packed``) for S = ``s`` slots of ``n_pad`` points and b
    sampled rows: grid (point blocks of ``packed_tiles_per_block(b)``
    tiles, slots, R = ``packed_row_splits`` row splits).  The dot: a
    partial of b (rounded up to 4) floats a tile, a counter a (slot,
    split).  The MWU: the 4 (m, s) floats a tile and a counter a slot,
    and with R > 1 after them each split's dv (S, R, n_pad) and a counter
    a (slot, point block)."""
    tpb = packed_tiles_per_block(b)
    splits = packed_row_splits(n_pad, b)
    tiles = n_pad // LANE
    blocks = -(-tiles // tpb)
    grid = (blocks, s, splits)
    smem = packed_smem(packed_split_rows(b, splits))
    if kernel == "momentum_dot_packed":
        return Launch((tpb, splits), grid, smem, s * splits,
                      s * tiles * (-(-b // 4) * 4))
    if splits == 1:
        return Launch((tpb, 1), grid, smem, s, s * tiles * 4)
    return Launch((tpb, splits), grid, smem, s + s * blocks,
                  s * tiles * 4 + s * splits * n_pad)


# device index -> (counters (S,) int32, zero between launches; scratch)
_workspace: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def workspace(device: torch.device, slots: int, floats: int):
    """The ticket kernels' (counters, scratch) on a CUDA ``device``: at
    least ``slots`` ticket counters (one per packed slot, or per client
    and column chunk of the unpacked dot) and ``floats`` floats of
    per-block partials.  Zeroed once and grown when needed; the kernels
    leave every counter at 0, so calls on one stream can share them."""
    ws = _workspace.get(device.index)
    if ws is None or ws[0].numel() < slots or ws[1].numel() < floats:
        if ws is not None:
            slots = max(slots, ws[0].numel())
            floats = max(floats, ws[1].numel())
        ws = (torch.zeros(slots, dtype=torch.int32, device=device),
              torch.empty(floats, dtype=torch.float32, device=device))
        _workspace[device.index] = ws
    return ws


def _launch(name: str, fn, device: torch.device, *args) -> None:
    """Call a kernel's C launcher on ``device``'s current stream (making
    ``device`` current only when it is not), raise on a launch error and
    count the launch."""
    if torch.cuda.current_device() != device.index:
        with torch.cuda.device(device):
            return _launch(name, fn, device, *args)
    build.check(fn(*args, torch.cuda.current_stream(device).cuda_stream),
                name)
    launch_counts[name] += 1


def momentum_dot_packed(x_t: torch.Tensor, idx: torch.Tensor,
                        log_lam: torch.Tensor, log_prev: torch.Tensor,
                        sign: torch.Tensor,
                        theta: torch.Tensor) -> torch.Tensor:
    """delta (S, b) = sum_i sign_i mom_i x_t[s, idx[s, j], i] with the
    momentum mom = lam + theta (lam - lam_prev), lam = exp(log_lam):
    lines 2-3 of Algorithm 2 for both classes in one sweep."""
    s, d, n_pad, b = check_packed(
        x_t, idx, dict(log_lam=log_lam, log_prev=log_prev, sign=sign),
        dict(theta=theta))
    if x_t.device.type == "cpu":
        return ref.momentum_dot_packed_ref(x_t, idx, log_lam, log_prev,
                                           sign, theta)
    out = torch.empty((s, b), dtype=torch.float32, device=x_t.device)
    ln = packed_launch("momentum_dot_packed", s, n_pad, b)
    counters, parts = workspace(x_t.device, ln.counters, ln.floats)
    _launch("momentum_dot_packed",
            build.library("saddle_update").momentum_dot_packed_f32,
            x_t.device, x_t.data_ptr(), idx.data_ptr(), log_lam.data_ptr(),
            log_prev.data_ptr(), sign.data_ptr(), theta.data_ptr(),
            out.data_ptr(), parts.data_ptr(), counters.data_ptr(), s, d,
            n_pad, b, *ln.args)
    return out


def mwu_update_packed(x_t: torch.Tensor, idx: torch.Tensor,
                      log_lam: torch.Tensor, u: torch.Tensor,
                      dw: torch.Tensor, sign: torch.Tensor,
                      mwu_c: torch.Tensor, mwu_dot: torch.Tensor,
                      d_eff: float):
    """Packed dual update (lines 5-6 of Algorithm 2 and the incremental
    u) for both classes in one sweep.  Returns (log_new UNNORMALIZED,
    u_new, m, s) with m and s (S, 2), column 0 the class of sign +1 and
    column 1 that of sign -1: per-class lse = m + log(s)."""
    s, d, n_pad, b = check_packed(
        x_t, idx, dict(log_lam=log_lam, u=u, sign=sign),
        dict(mwu_c=mwu_c, mwu_dot=mwu_dot), rows=dict(dw=dw))
    if x_t.device.type == "cpu":
        return ref.mwu_update_packed_ref(x_t, idx, log_lam, u, dw, sign,
                                         mwu_c, mwu_dot, d_eff)
    log_new = torch.empty_like(log_lam)
    u_new = torch.empty_like(u)
    ms = torch.empty((2, s, 2), dtype=torch.float32, device=x_t.device)
    ln = packed_launch("mwu_update_packed", s, n_pad, b)
    counters, parts = workspace(x_t.device, ln.counters, ln.floats)
    _launch("mwu_update_packed",
            build.library("saddle_update").mwu_update_packed_f32,
            x_t.device, x_t.data_ptr(), idx.data_ptr(), dw.data_ptr(),
            log_lam.data_ptr(), u.data_ptr(), sign.data_ptr(),
            mwu_c.data_ptr(), mwu_dot.data_ptr(), float(d_eff),
            log_new.data_ptr(), u_new.data_ptr(), ms.data_ptr(),
            parts.data_ptr(), counters.data_ptr(), s, d, n_pad, b,
            *ln.args)
    return log_new, u_new, ms[0], ms[1]


def momentum_dot_geometry(k: int, n: int,
                          b: int) -> tuple[int, int, int, int]:
    """(lanes per row, points per block, point blocks, column chunks) of
    the unpacked momentum dot for k clients of n points and B = ``b``
    columns.  A warp puts ``lanes`` lanes on a row, each on 4 columns, and
    32 / lanes rows side by side; a block covers a chunk of 4 * lanes
    columns and its loads THREADS / lanes * DOT_UNROLL rows at once (a
    round).  Fewer lanes a row give more chunks and rounds of more rows:
    where some lanes >= 2 (a 32-byte sector a row) fit the client's n
    points in one round, the widest such rows are taken, then halved while
    the grid has fewer blocks than the card has SMs, and no block merges
    (the reference step's clients of 250 points at B = 1 and 128).  A
    longer client keeps its widest rows and takes blocks of whole rounds,
    as many as keep the grid within DOT_WAVE blocks, which merge; two
    rounds of one block where that avoids the merge."""
    def per_round(lanes):
        return THREADS // lanes * DOT_UNROLL

    def chunks(lanes):
        return -(-b // (4 * lanes))

    lanes = min(32, 1 << (-(-min(b, DOT_COLS) // 4) - 1).bit_length())
    fit = [w for w in (32, 16, 8, 4, 2) if w <= lanes and n <= per_round(w)]
    if fit:
        lanes = fit[0]
        while lanes > 2 and k * chunks(lanes) < SMS:
            lanes //= 2
    want = -(-n // per_round(lanes))             # blocks of one round
    rounds = (2 if want == 2
              else -(-want // max(1, DOT_WAVE // (k * chunks(lanes)))))
    blocks = -(-n // (per_round(lanes) * rounds))
    if b > 1:
        blocks = max(blocks, -(-n // DOT_POINTS))
    return lanes, -(-n // blocks), blocks, chunks(lanes)


@functools.lru_cache(maxsize=None)
def momentum_dot_launch(k: int, n: int, b: int) -> Launch:
    """The launch of :func:`momentum_dot` for k clients of n points and
    B = ``b`` columns, from :func:`momentum_dot_geometry`: grid (point
    blocks, column chunks, clients), a counter a client and chunk, and
    DOT_COLS floats of partial a block."""
    lanes, points, blocks, chunks = momentum_dot_geometry(k, n, b)
    return Launch((lanes, points), (-(-n // points), chunks, k), 0,
                  k * chunks, k * chunks * blocks * DOT_COLS)


def mwu_update_geometry(k: int, n: int, b: int) -> tuple[int, int, int]:
    """(lanes per row, points per block, point blocks) of the unpacked
    MWU for k clients of n points and B = ``b`` columns.  A warp puts
    ``lanes`` lanes on a row, each on 4 columns: the widest rows that B
    fills (one pass over a row up to B = 128).  A block's loads cover
    THREADS / lanes * DOT_UNROLL rows at once (a round).  Blocks split by
    points only, at most MWU_POINTS a block.  A client of at most two
    rounds takes one block, which needs no merge (the reference step's
    clients of 250 points at B = 1); a longer one takes blocks of one
    round (those of 251 points at B = 128: 4 blocks), fewer and longer
    where one-round blocks would make the grid larger than DOT_WAVE (at
    most two blocks an SM: a third on a few SMs costs more than longer
    blocks), and twice as many while twice the grid still fits in one
    wave of the card's SMS and a block keeps a row for every lane (the
    serial B = 1 call of 5,000 points: 12 blocks); its blocks merge
    inside the launch."""
    lanes = min(32, 1 << (-(-b // 4) - 1).bit_length())
    per_round = THREADS // lanes * DOT_UNROLL
    if n <= min(2 * per_round, MWU_POINTS):
        return lanes, n, 1
    blocks = -(-n // min(per_round, MWU_POINTS))
    if k * blocks > DOT_WAVE:
        blocks = max(DOT_WAVE // k, -(-n // MWU_POINTS), 1)
    while 2 * k * blocks <= SMS and -(-n // (2 * blocks)) >= THREADS // lanes:
        blocks *= 2
    return lanes, -(-n // blocks), blocks


@functools.lru_cache(maxsize=None)
def mwu_update_launch(k: int, n: int, b: int) -> Launch:
    """The launch of :func:`mwu_update` for k clients of n points and
    B = ``b`` columns, from :func:`mwu_update_geometry`: grid (point
    blocks, clients), 3 ``points`` floats of shared memory, a counter a
    client and an (m, s) partial a block."""
    lanes, points, blocks = mwu_update_geometry(k, n, b)
    return Launch((lanes, points), (-(-n // points), k, 1), 3 * points * 4,
                  k, 2 * k * blocks)


def check_unpacked(cols: torch.Tensor, vectors: dict[str, torch.Tensor],
                   dw: torch.Tensor | None = None):
    """Validate the unpacked operands: cols (n, B) or (K, n, B), every
    point vector (n,) or (K, n) and ``dw`` (B,) or (K, B) with the same
    leading client axis, all float32 and contiguous on one device.
    Returns (lead, n, b) with ``lead`` () or (K,)."""
    if cols.ndim not in (2, 3):
        raise ValueError(f"cols must be (n, B) or (K, n, B), got shape "
                         f"{tuple(cols.shape)}")
    lead = tuple(cols.shape[:-2])
    n, b = cols.shape[-2:]
    if n < 1 or b < 1 or (lead and lead[0] < 1):
        raise ValueError(f"cols has an empty axis: {tuple(cols.shape)}")
    _check_f32("cols", cols, tuple(cols.shape), cols.device)
    for name, t in vectors.items():
        _check_f32(name, t, lead + (n,), cols.device)
    if dw is not None:
        _check_f32("dw", dw, lead + (b,), cols.device)
    if cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unpacked kernels run on cuda or cpu, not "
                         f"{cols.device}")
    return lead, n, b


def momentum_dot(cols: torch.Tensor, log_lam: torch.Tensor,
                 log_prev: torch.Tensor, theta: float) -> torch.Tensor:
    """delta (B,) = cols^T (lam + theta (lam - lam_prev)), lam =
    exp(log_lam): lines 2-3 of Algorithm 2 for one class; (K, B) with a
    leading client axis (no sum over clients)."""
    lead, n, b = check_unpacked(cols, dict(log_lam=log_lam,
                                           log_prev=log_prev))
    if cols.device.type == "cpu":
        return ref.momentum_dot_ref(cols, log_lam, log_prev, float(theta))
    k = lead[0] if lead else 1
    ln = momentum_dot_launch(k, n, b)
    out = torch.empty(lead + (b,), dtype=torch.float32, device=cols.device)
    counters, parts = workspace(cols.device, ln.counters, ln.floats)
    vec4 = b % 4 == 0 and cols.data_ptr() % 16 == 0
    _launch("momentum_dot", build.library("saddle_update").momentum_dot_f32,
            cols.device, cols.data_ptr(), log_lam.data_ptr(),
            log_prev.data_ptr(), float(theta), out.data_ptr(),
            parts.data_ptr(), counters.data_ptr(), k, n, b, *ln.args,
            int(vec4))
    return out


def mwu_update(cols: torch.Tensor, log_lam: torch.Tensor, u: torch.Tensor,
               dw: torch.Tensor, sign: float, gamma: float, tau: float,
               d_eff: float, *, normalize: bool = True):
    """Fused per-class dual update (lines 5-6 of Algorithm 2) and the
    incremental u, one launch on CUDA.  Returns (log_new normalized,
    u_new), or with ``normalize=False`` (log_new UNNORMALIZED, u_new, m,
    s), lse = m + log(s) per client ((K,) each, scalars without a client
    axis), so a caller can combine the partials across clients before
    applying them."""
    lead, n, b = check_unpacked(cols, dict(log_lam=log_lam, u=u), dw)
    scalars = [float(v) for v in (sign, gamma, tau, d_eff)]
    if cols.device.type == "cpu":
        return ref.mwu_update_ref(cols, log_lam, u, dw, *scalars,
                                  normalize=normalize)
    k = lead[0] if lead else 1
    ln = mwu_update_launch(k, n, b)
    log_new = torch.empty_like(log_lam)
    u_new = torch.empty_like(u)
    ms = torch.empty((2, k), dtype=torch.float32, device=cols.device)
    counters, parts = workspace(cols.device, ln.counters, ln.floats)
    vec4 = b % 4 == 0 and cols.data_ptr() % 16 == 0
    _launch("mwu_update", build.library("saddle_update").mwu_update_f32,
            cols.device, cols.data_ptr(), log_lam.data_ptr(), u.data_ptr(),
            dw.data_ptr(), *scalars, int(normalize), log_new.data_ptr(),
            u_new.data_ptr(), ms.data_ptr(), parts.data_ptr(),
            counters.data_ptr(), k, n, b, *ln.args, int(vec4))
    m, s = ms if lead else ms[:, 0]
    if normalize:
        return log_new, u_new
    return log_new, u_new, m, s
