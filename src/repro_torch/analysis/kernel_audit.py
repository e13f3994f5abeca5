"""Layer 1: static audit of every hand-written CUDA kernel's launch plan.

Counterpart of ``repro.analysis.pallas_audit``.  The kernel wrappers
(:mod:`repro_torch.kernels.saddle_update`, :mod:`repro_torch.kernels.fwht`)
launch from small memoised tuples (``saddle_update.Launch``,
``fwht.FwhtPlan``): the C launcher's geometry arguments, the grid and
shared memory it derives from them, the workspace.  ``<kernel>_plan(**shape)``
here builds a plan dict from the SAME tuple the wrapper launches from and
adds what only the audit needs, each block's ranges; :func:`registry` maps
each CUDA entry point to its plan function.  ``chip_smoke.py`` holds each
plan's grid and shared memory equal to what the library's
``launch_geometry`` / ``fwht_geometry`` report on the card.  A plan (one
dict, or ``passes`` of them for the FWHT's kernel passes) holds:

``grid`` / ``threads``           the launch's (x, y, z) blocks and threads
``static_smem`` / ``dynamic_smem``  shared memory of a block, bytes
``axes``       one dict a grid axis: the operand ``dim`` its blocks split
               (None: one block, nothing split) and each block's
               ``[lo, hi)`` of it, out of ``extent``
``reads`` / ``writes``  operands by name: shape and the dim of each axis;
               a write is made ``by`` its ``blocks``, by the ``merge`` of
               the last block of each group of x-blocks, or both
``partials``   each block's ``[lo, hi)`` of floats in the workspace (None
               where no block writes one)
``ticket`` / ``counter``  whether a group's x-blocks merge by an integer
               ticket, and each group's counter
``workspace``  the counters and floats the wrapper allocates

and the rules:

BLOCK-001  every block's range lies inside each operand it touches, its
           partials inside the workspace, its counter inside the counters
COVER-001  every point of every slot or client, every column and every
           FWHT row or column is written by exactly one block, or by a
           declared merge
RACE-001   blocks that share an output write distinct partial slots and
           merge by a ticket on a counter of their own, so that only the
           ticket's last block writes the merged value
SMEM-001   static plus dynamic shared memory is at most ``MAX_SMEM`` =
           232,448 B, the H100's opt-in limit a block (this replaces the
           JAX audit's 16 MiB VMEM-001)
GRID-001   gridDim.x <= 2^31 - 1, gridDim.y and gridDim.z <= 65,535, at
           most 1,024 threads a block

Zero findings over :func:`audit_cases` is part of the gate
(``python -m repro_torch.analysis.run``).  It needs no card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from repro_torch.kernels import fwht
from repro_torch.kernels import saddle_update as su
from repro_torch.kernels.saddle_update import MAX_SMEM

MAX_GRID_X = 2**31 - 1
MAX_GRID_YZ = 65_535
MAX_THREADS = 1_024
FWHT_STRIDED_THREADS = 256   # a strided FWHT pass: a thread a column
WARP = 32

# Static shared memory of each kernel, from its ``__shared__`` declarations
# in the CUDA source: each rounded up to 16 bytes, the block's sum to 128,
# as nvcc lays them out for sm_90a (``static_smem`` in the library reads
# the compiled figure on the card; chip_smoke.py n2 holds the two equal).
STATIC_SMEM = {name: -(-nbytes // 128) * 128 for name, nbytes in {
    "momentum_dot_packed": 48 + 16 * su.THREADS + 16,  # full[5], vec, last
    "mwu_update_packed": 48 + 16 * su.THREADS + 16,    # full[5], red, last
    "momentum_dot[b=1]": 16 + 16 * su.THREADS + 16,    # mom[1], red, last
    "momentum_dot": 4 * su.DOT_POINTS + 16 * su.THREADS + 16,
    "mwu_update": 32 + 3 * 16,                          # red[8], bc, lse, last
}.items()}
# the kernels that ``static_smem(which)`` in the library reports, in its
# order, by their STATIC_SMEM key
STATIC_SMEM_ORDER = ("momentum_dot_packed", "mwu_update_packed",
                     "momentum_dot[b=1]", "momentum_dot", "momentum_dot",
                     "mwu_update", "mwu_update")

#: serving bucket rungs: preprocess.bucket_length pads every fit to
#: 128 * 2^k, so these are the n_pad values the slot engine launches at
SERVING_RUNGS = tuple(128 * 2 ** k for k in range(8))

RULES = {
    "BLOCK-001": "every block's range inside its operands",
    "COVER-001": "every output element written by exactly one block or "
                 "a declared merge",
    "RACE-001": "shared outputs merge by ticket over distinct partials",
    "SMEM-001": f"static + dynamic shared memory <= {MAX_SMEM} B",
    "GRID-001": "gridDim.y, gridDim.z <= 65,535; <= 1,024 threads",
}


class Finding(NamedTuple):
    rule: str          # BLOCK-001 / COVER-001 / RACE-001 / SMEM-001 / ...
    kernel: str
    case: str
    detail: str


class AuditCase(NamedTuple):
    kernel: str        # registry key
    case: str          # human-readable shape label
    kwargs: dict       # the plan function's kwargs


# ---------------------------------------------------------------- plans

def _axis(dim, lo, hi, extent: int) -> dict:
    """One grid axis of a plan: the ``dim`` of the operands its blocks
    split (None for an axis of one block that splits nothing) and each
    block's [lo, hi) of it, out of ``extent``."""
    return {"dim": dim, "lo": np.asarray(lo, np.int64),
            "hi": np.asarray(hi, np.int64), "extent": int(extent)}


def _split(extent: int, per: int, blocks: int) -> dict:
    """[lo, hi) of ``blocks`` blocks of ``per`` items over ``extent``."""
    lo = np.arange(blocks, dtype=np.int64) * per
    return {"lo": lo, "hi": np.minimum(lo + per, extent)}


def _launch_keys(ln: su.Launch, names: tuple) -> dict:
    """The plan keys a wrapper's launch tuple fixes."""
    return {"grid": ln.grid, "dynamic_smem": ln.dynamic_smem,
            "workspace": {"counters": ln.counters, "floats": ln.floats},
            "args": dict(zip(names, ln.args))}


def _packed_plan(name: str, s: int, d: int, n_pad: int, b: int,
                 part_floats: int, reads: dict, writes: dict) -> dict:
    ln = su.packed_launch(name, s, n_pad, b)
    (tpb,), (gx, _, _) = ln.args, ln.grid
    tiles = n_pad // su.LANE
    x = _split(tiles, tpb, gx)
    t0, t1 = x["lo"], x["hi"]
    slot = np.arange(s, dtype=np.int64)[None, :, None]
    # block (x, y) writes the partials of its tiles of slot y
    plo = (slot * tiles + t0[:, None, None]) * part_floats
    phi = (slot * tiles + t1[:, None, None]) * part_floats
    return {
        "name": name, "threads": su.THREADS,
        "static_smem": STATIC_SMEM[name],
        **_launch_keys(ln, ("tpb",)),
        "axes": [_axis("point", t0 * su.LANE, t1 * su.LANE, n_pad),
                 _axis("slot", np.arange(s), np.arange(s) + 1, s),
                 _axis(None, [0], [1], 1)],
        "reads": {"x_t": ((s, d, n_pad), ("slot", None, "point")),
                  "idx": ((s, b), ("slot", None)), **reads},
        "writes": writes,
        "partials": {"lo": plo, "hi": phi},
        "ticket": gx > 1,
        "counter": np.arange(s, dtype=np.int64)[:, None],
    }


def momentum_dot_packed_plan(*, s: int, d: int, n_pad: int, b: int) -> dict:
    """The launch of ``saddle_update.momentum_dot_packed`` for S = ``s``
    slots of ``n_pad`` points and b sampled rows of d: grid (point blocks
    of ``packed_tiles_per_block(b)`` tiles, slots); each block writes its
    tiles' partials (S, tiles, b rounded up to 4) and the slot's last
    block, by ticket, merges them into delta (S, b)."""
    vec = ((s, n_pad), ("slot", "point"))
    return _packed_plan(
        "momentum_dot_packed", s, d, n_pad, b, -(-b // 4) * 4,
        {name: vec for name in ("log_lam", "log_prev", "sign")}
        | {"theta": ((s,), ("slot",))},
        {"out": {"shape": (s, b), "dims": ("slot", None), "by": "merge"}})


def mwu_update_packed_plan(*, s: int, d: int, n_pad: int, b: int) -> dict:
    """The launch of ``saddle_update.mwu_update_packed``: the grid of
    :func:`momentum_dot_packed_plan`; each block writes log_new and u_new
    at its points and a tile's (m, s) partial (4 floats) a tile, and the
    slot's last block merges them into (m, s) (2, S, 2)."""
    vec = ((s, n_pad), ("slot", "point"))
    return _packed_plan(
        "mwu_update_packed", s, d, n_pad, b, 4,
        {name: vec for name in ("log_lam", "u", "sign")}
        | {"dw": ((s, b), ("slot", None)),
           **{name: ((s,), ("slot",)) for name in ("mwu_c", "mwu_dot")}},
        {"log_new": {"shape": (s, n_pad), "dims": ("slot", "point"),
                     "by": "blocks"},
         "u_new": {"shape": (s, n_pad), "dims": ("slot", "point"),
                   "by": "blocks"},
         "ms": {"shape": (2, s, 2), "dims": (None, "slot", None),
                "by": "merge"}})


def momentum_dot_plan(*, k: int, n: int, b: int) -> dict:
    """The launch of ``saddle_update.momentum_dot`` for k clients of n
    points and B = b columns: grid (point blocks, column chunks of 4 lanes
    columns, clients).  A client of one point block writes delta itself;
    else each block writes its chunk's partial (DOT_COLS floats a block,
    in the slot of its client and chunk) and the last block of the
    (client, chunk), by ticket, sums them into delta (K, B)."""
    ln = su.momentum_dot_launch(k, n, b)
    (lanes, points), (gx, chunks, _) = ln.args, ln.grid
    x = _split(n, points, gx)
    c = _split(b, 4 * lanes, chunks)
    group = (np.arange(k, dtype=np.int64)[None, :] * chunks
             + np.arange(chunks, dtype=np.int64)[:, None])   # (chunks, k)
    plo = ((group[None] * gx + np.arange(gx)[:, None, None]) * su.DOT_COLS)
    width = (c["hi"] - c["lo"])[None, :, None]
    return {
        "name": "momentum_dot", "threads": su.THREADS,
        "static_smem": STATIC_SMEM["momentum_dot[b=1]" if b == 1
                                   else "momentum_dot"],
        **_launch_keys(ln, ("lanes", "points")),
        "axes": [_axis("point", x["lo"], x["hi"], n),
                 _axis("column", c["lo"], c["hi"], b),
                 _axis("client", np.arange(k), np.arange(k) + 1, k)],
        "reads": {"cols": ((k, n, b), ("client", "point", "column")),
                  "log_lam": ((k, n), ("client", "point")),
                  "log_prev": ((k, n), ("client", "point"))},
        "writes": {"out": {"shape": (k, b), "dims": ("client", "column"),
                           "by": "merge" if gx > 1 else "blocks"}},
        "partials": ({"lo": plo, "hi": plo + width} if gx > 1 else None),
        "ticket": gx > 1,
        "counter": group,
    }


def mwu_update_plan(*, k: int, n: int, b: int,
                    normalize: bool = True) -> dict:
    """The launch of ``saddle_update.mwu_update`` for k clients of n
    points and B = b columns: grid (point blocks, clients), 3 ``points``
    floats of dynamic shared memory.  Each block writes log_new and u_new
    at its points; a client of one block writes its (m, s) itself, a
    longer one's blocks write an (m, s) partial each and the last block,
    by ticket, merges them into (m, s) (2, K) and, with ``normalize``,
    rewrites the client's whole log_new."""
    ln = su.mwu_update_launch(k, n, b)
    (_, points), (gx, _, _) = ln.args, ln.grid
    x = _split(n, points, gx)
    plo = (np.arange(k, dtype=np.int64)[None, :, None] * gx
           + np.arange(gx)[:, None, None]) * 2
    vec = ((k, n), ("client", "point"))
    merged = gx > 1
    return {
        "name": "mwu_update", "threads": su.THREADS,
        "static_smem": STATIC_SMEM["mwu_update"],
        **_launch_keys(ln, ("lanes", "points")),
        "axes": [_axis("point", x["lo"], x["hi"], n),
                 _axis("client", np.arange(k), np.arange(k) + 1, k),
                 _axis(None, [0], [1], 1)],
        "reads": {"cols": ((k, n, b), ("client", "point", None)),
                  "log_lam": vec, "u": vec, "dw": ((k, b), ("client", None))},
        "writes": {
            "log_new": {"shape": (k, n), "dims": ("client", "point"),
                        "by": ("blocks+merge" if merged and normalize
                               else "blocks")},
            "u_new": {"shape": (k, n), "dims": ("client", "point"),
                      "by": "blocks"},
            "ms": {"shape": (2, k), "dims": (None, "client"),
                   "by": "merge" if merged else "blocks"}},
        "partials": {"lo": plo, "hi": plo + 2} if merged else None,
        "ticket": merged,
        "counter": np.arange(k, dtype=np.int64)[:, None],
    }


def _fwht_pass(name: str, dim: str, rows: int, width: int, per: int,
               threads: int, smem: int, args: dict) -> dict:
    """One FWHT kernel pass over ``rows`` rows (or columns) of ``width``
    values, ``per`` a block, in place after the first."""
    grid = min(max(1, -(-rows // per)), MAX_GRID_X)
    lo = np.arange(grid, dtype=np.int64) * per
    one = _axis(None, [0], [1], 1)
    return {
        "name": name, "grid": (grid, 1, 1), "threads": threads,
        "static_smem": 0, "dynamic_smem": smem,
        "axes": [_axis(dim, lo, np.minimum(lo + per, rows), rows), one,
                 dict(one)],
        "reads": {"x": ((rows, width), (dim, None))},
        "writes": {"out": {"shape": (rows, width), "dims": (dim, None),
                           "by": "blocks"}},
        "partials": None, "ticket": False, "counter": None,
        "workspace": {"counters": 0, "floats": 0}, "args": args,
    }


def fwht_rows_plan(*, n: int, d: int) -> dict:
    """The launches of ``fwht.fwht_rows`` for n rows of length d, from
    ``fwht.fwht_plan(d)``: pass 0 the row kernel of its variant over the
    n d1 rows of length d2, ``rows_per_block`` rows a block; then each
    strided pass over the (n d) / 2^log_m columns of 2^log_m values at
    stride 2^log_s, a thread a column.  Every pass writes each of its
    rows or columns from exactly one block."""
    plan = fwht.fwht_plan(d)
    threads = (fwht.THREAD_ROWS if plan.variant == "thread"
               else WARP * fwht.WARP_ROWS if plan.variant == "warp"
               else plan.d2 // 32)            # a warp a 1,024-value chunk
    passes = [_fwht_pass(
        f"fwht_{plan.variant}", "row", n * plan.d1, plan.d2,
        plan.rows_per_block, threads,
        plan.d2 * 4 if plan.variant == "block" else 0,
        {"rows": n * plan.d1, "d2": plan.d2, "log_s": None, "log_m": None})]
    log_s = plan.d2.bit_length() - 1
    for log_m in plan.strided:
        cols = (n * d) >> log_m
        passes.append(_fwht_pass(
            "fwht_strided", "column", cols, 1 << log_m,
            FWHT_STRIDED_THREADS, FWHT_STRIDED_THREADS, 0,
            {"rows": cols, "d2": None, "log_s": log_s, "log_m": log_m}))
        log_s += log_m
    return {"name": "fwht", "n": n, "d": d, "variant": plan.variant,
            "passes": passes}


def registry() -> dict[str, Callable[..., dict]]:
    """CUDA entry point -> plan function, covering every kernel of
    ``kernels/csrc`` (grep for ``<<<`` when adding a kernel)."""
    return {
        "momentum_dot_packed": momentum_dot_packed_plan,
        "mwu_update_packed": mwu_update_packed_plan,
        "momentum_dot": momentum_dot_plan,
        "mwu_update": mwu_update_plan,
        "fwht": fwht_rows_plan,
    }


def launches(plan: dict) -> list[dict]:
    """The kernel launches of a plan: its ``passes``, or itself."""
    return plan.get("passes", [plan])


# ---------------------------------------------------------------- rules

def _partition(lo: np.ndarray, hi: np.ndarray, extent: int) -> str:
    """'' when the ranges [lo, hi) cover [0, extent) exactly once, else
    what is wrong."""
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    if lo[0] > 0:
        return f"[0, {lo[0]}) is written by no block"
    if hi[-1] < extent:
        return f"[{hi[-1]}, {extent}) is written by no block"
    gap = np.flatnonzero(lo[1:] > hi[:-1])
    if gap.size:
        return (f"[{hi[gap[0]]}, {lo[gap[0] + 1]}) is written by no "
                "block")
    over = np.flatnonzero(lo[1:] < hi[:-1])
    if over.size:
        return (f"[{lo[over[0] + 1]}, {hi[over[0]]}) is written by two "
                "blocks")
    return ""


def _check_grid(p: dict, name: str, case: str, out: list) -> None:
    gx, gy, gz = p["grid"]
    if not (1 <= gx <= MAX_GRID_X and 1 <= gy <= MAX_GRID_YZ
            and 1 <= gz <= MAX_GRID_YZ and 1 <= p["threads"] <= MAX_THREADS):
        out.append(Finding(
            "GRID-001", name, case,
            f"{p['name']}: grid {p['grid']} x {p['threads']} threads "
            f"(x <= {MAX_GRID_X}, y, z <= {MAX_GRID_YZ}, threads <= "
            f"{MAX_THREADS})"))


def _check_smem(p: dict, name: str, case: str, out: list) -> None:
    total = p["static_smem"] + p["dynamic_smem"]
    if total > MAX_SMEM:
        out.append(Finding(
            "SMEM-001", name, case,
            f"{p['name']}: {p['static_smem']} B static + "
            f"{p['dynamic_smem']} B dynamic shared memory = {total} B, "
            f"above {MAX_SMEM} B a block"))


def _check_blocks(p: dict, name: str, case: str, out: list) -> bool:
    """BLOCK-001; False where the plan is too malformed to go on."""
    ok = True
    dims = {}
    for a, (ax, g) in enumerate(zip(p["axes"], p["grid"])):
        lo, hi = ax["lo"], ax["hi"]
        if lo.shape != (g,) or hi.shape != (g,):
            out.append(Finding(
                "BLOCK-001", name, case,
                f"{p['name']}: axis {a} has {lo.shape} ranges for "
                f"{g} blocks"))
            ok = False
            continue
        bad = np.flatnonzero((lo < 0) | (hi > ax["extent"]) | (lo >= hi))
        if bad.size:
            i = int(bad[0])
            out.append(Finding(
                "BLOCK-001", name, case,
                f"{p['name']}: block {i} of axis {a} covers "
                f"[{lo[i]}, {hi[i]}) of {ax['dim']}, outside "
                f"[0, {ax['extent']})"))
        if ax["dim"] is not None:
            dims[ax["dim"]] = ax["extent"]
    ops = [(k, v[0], v[1]) for k, v in p["reads"].items()]
    ops += [(k, w["shape"], w["dims"]) for k, w in p["writes"].items()]
    for op, shape, opdims in ops:
        for size, dim in zip(shape, opdims):
            if dim is not None and dims.get(dim, size) > size:
                out.append(Finding(
                    "BLOCK-001", name, case,
                    f"{p['name']}: blocks span {dims[dim]} of {dim}, "
                    f"past {op}'s {size}"))
    part = p["partials"]
    if part is not None:
        if part["lo"].min() < 0 or part["hi"].max() > \
                p["workspace"]["floats"]:
            out.append(Finding(
                "BLOCK-001", name, case,
                f"{p['name']}: partials reach float "
                f"{int(part['hi'].max())} of a workspace of "
                f"{p['workspace']['floats']}"))
    if p["ticket"] and (p["counter"].min() < 0 or p["counter"].max()
                        >= p["workspace"]["counters"]):
        out.append(Finding(
            "BLOCK-001", name, case,
            f"{p['name']}: counter {int(p['counter'].max())} outside the "
            f"workspace's {p['workspace']['counters']}"))
    return ok


def _check_writes(p: dict, name: str, case: str, out: list) -> None:
    """COVER-001 and RACE-001 for every output of one launch."""
    axes = p["axes"]
    by_dim = {ax["dim"]: a for a, ax in enumerate(axes)
              if ax["dim"] is not None}
    for op, w in p["writes"].items():
        mapped = {by_dim[d] for d in w["dims"] if d in by_dim}
        for d, size in zip(w["dims"], w["shape"]):
            if d is not None and d not in by_dim:
                out.append(Finding(
                    "COVER-001", name, case,
                    f"{p['name']}: {op}'s {d} is split by no grid axis"))
        merge = "merge" in w["by"]
        blocks = "blocks" in w["by"]
        for a, ax in enumerate(axes):
            g = len(ax["lo"])
            if a == 0 and merge and not blocks:
                # the merge writes the group's whole x; what it merges
                # must take every point's partial exactly once
                if ax["dim"] is not None:
                    why = _partition(ax["lo"], ax["hi"], ax["extent"])
                    if why:
                        out.append(Finding(
                            "COVER-001", name, case,
                            f"{p['name']}: {op} merges {ax['dim']}s of "
                            f"which {why}"))
                continue
            if a in mapped:
                why = _partition(ax["lo"], ax["hi"],
                                 w["shape"][w["dims"].index(ax["dim"])])
                if why:
                    out.append(Finding(
                        "COVER-001", name, case,
                        f"{p['name']}: {op} along {ax['dim']}: {why}"))
            elif g > 1 and not (a == 0 and merge):
                out.append(Finding(
                    "RACE-001", name, case,
                    f"{p['name']}: the {g} blocks of grid axis {a} all "
                    f"write {op}'s same elements, with no merge"))
        if merge and len(axes[0]["lo"]) > 1:
            _check_merge(p, name, case, op, out)


def _check_merge(p: dict, name: str, case: str, op: str, out: list) -> None:
    if not p["ticket"]:
        out.append(Finding(
            "RACE-001", name, case,
            f"{p['name']}: {len(p['axes'][0]['lo'])} blocks merge {op} "
            "with no ticket: each would write the merged value"))
        return
    counter = np.asarray(p["counter"]).reshape(-1)
    if np.unique(counter).size != counter.size:
        out.append(Finding(
            "RACE-001", name, case,
            f"{p['name']}: two groups of blocks take tickets on one "
            "counter"))
    part = p["partials"]
    if part is None:
        out.append(Finding(
            "RACE-001", name, case,
            f"{p['name']}: blocks merge {op} but write no partials"))
        return
    lo, hi = part["lo"].reshape(-1), part["hi"].reshape(-1)
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    clash = np.flatnonzero(lo[1:] < hi[:-1])
    if clash.size:
        i = int(clash[0])
        out.append(Finding(
            "RACE-001", name, case,
            f"{p['name']}: two blocks write partial floats "
            f"[{lo[i + 1]}, {min(hi[i], hi[i + 1])}) of the workspace"))


def audit_plan(plan: dict, *, kernel: str = "", case: str = ""
               ) -> list[Finding]:
    """All five rules over every launch of one plan."""
    kernel = kernel or plan["name"]
    out: list[Finding] = []
    for p in launches(plan):
        _check_grid(p, kernel, case, out)
        _check_smem(p, kernel, case, out)
        if _check_blocks(p, kernel, case, out):
            _check_writes(p, kernel, case, out)
    return out


# ------------------------------------------------------------ case sweep

def audit_cases() -> list[AuditCase]:
    """The shape matrix the gate proves clean: the serving rungs at the
    block sizes the engines launch, the packed kernels above 32,768
    features and sampled rows, the unpacked kernels at the reference
    step's client shapes, the FWHT at every power of two to 131,072 (one
    pass and two), and every shape ``PERF.md`` section 6 lists.  The
    per-client shard shapes of the launch dry-run join when
    ``launch/specs.py`` is ported."""
    cases: list[AuditCase] = []

    def packed(label, **kw):
        for kernel in ("momentum_dot_packed", "mwu_update_packed"):
            cases.append(AuditCase(kernel, label, dict(kw)))

    def unpacked(label, **kw):
        cases.append(AuditCase("momentum_dot", label, dict(kw)))
        for normalize in (True, False):
            cases.append(AuditCase("mwu_update", label,
                                   dict(kw, normalize=normalize)))

    for n_pad in SERVING_RUNGS:
        for d in (32, 256):
            for b in dict.fromkeys((1, 8, min(128, d))):
                for s in (1, 8):
                    packed(f"rung n_pad={n_pad} d={d} b={b} S={s}",
                           s=s, d=d, n_pad=n_pad, b=b)
        for b in (1, 8, 128):
            unpacked(f"rung n={n_pad} B={b}", k=1, n=n_pad, b=b)
    for b in (1, 32_768, 32_769, 40_000, 65_536):
        packed(f"wide d=65536 n_pad=1536 b={b}", s=1, d=65_536,
               n_pad=1_536, b=b)
    for n in (250, 251, 2_048, 5_001):
        for b in (1, 3, 128, 130):
            unpacked(f"clients K=20 n={n} B={b}", k=20, n=n, b=b)
    # PERF.md section 6: the paths' packed shapes (S, d, n_pad, b)
    for s, d, n_pad, b in ((1, 512, 50_048, 1), (1, 256, 20_096, 128),
                           (20, 256, 512, 1), (20, 512, 384, 1),
                           (20, 256, 512, 128), (1, 256, 10_112, 1),
                           (1, 65_536, 1_536, 1), (1, 512, 10_112, 1),
                           (1, 128, 18_048, 1), (1, 128, 256, 1),
                           (1, 256, 18_048, 1), (8, 256, 8_192, 1),
                           (8, 512, 8_192, 1), (2, 256, 16_384, 1),
                           (2, 512, 32_768, 1), (4, 256, 32_768, 1)):
        packed(f"PERF.md S={s} d={d} n_pad={n_pad} b={b}", s=s, d=d,
               n_pad=n_pad, b=b)
    # ... and the unpacked ones (K, n, B)
    for k, n, b in ((20, 250, 1), (20, 251, 1), (20, 250, 128),
                    (20, 251, 128), (1, 4_999, 1), (1, 5_001, 1)):
        unpacked(f"PERF.md K={k} n={n} B={b}", k=k, n=n, b=b)
    for d in (2 ** j for j in range(1, 18)):
        for n in (1, 128, 1_024, 16_384, 25_134):
            cases.append(AuditCase("fwht", f"fwht n={n} d={d}",
                                   dict(n=n, d=d)))
    # PERF.md section 6: the paths' FWHT shapes (n, d)
    for n, d in ((24_866, 512), (25_134, 512), (9_873, 256),
                 (10_127, 256), (195, 65_536), (97, 131_072),
                 (747, 65_536), (753, 65_536), (3_032, 256),
                 (5_037, 512), (9_042, 128), (5_001, 256), (1_000, 32),
                 (80, 128), (8_934, 256), (9_066, 256)):
        cases.append(AuditCase("fwht", f"PERF.md fwht n={n} d={d}",
                               dict(n=n, d=d)))
    return cases


def audit_all(cases: list[AuditCase] | None = None,
              ) -> tuple[list[dict], list[Finding]]:
    """Run the sweep.  Returns (per-case records, findings)."""
    reg = registry()
    if cases is None:
        cases = audit_cases()
    records: list[dict] = []
    findings: list[Finding] = []
    for c in cases:
        plan = reg[c.kernel](**c.kwargs)
        fs = audit_plan(plan, kernel=c.kernel, case=c.case)
        findings.extend(fs)
        records.append({
            "kernel": c.kernel, "case": c.case,
            "grids": [list(p["grid"]) for p in launches(plan)],
            "smem": [p["static_smem"] + p["dynamic_smem"]
                     for p in launches(plan)],
            "findings": len(fs),
        })
    return records, findings
