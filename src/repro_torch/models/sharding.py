"""Logical->physical sharding of the model zoo, and the pieces that run
any of its LMs over a (data, model) group of ranks: the counterpart of
``repro.models.sharding``.

The rules are the JAX package's, a small logical-axis system: model code
names an activation's or a parameter's axes logically, :func:`spec_for`
resolves the names to the physical axes of the installed mesh
(:func:`set_mesh_axes`) or of a given ``launch.mesh.Layout``, dropping an
axis that does not divide its dimension or that an earlier dimension took,
and :func:`param_spec` keys a parameter's spec on its leaf name.  A spec
has one entry a dimension: None, an axis name, or a tuple of names (a
``PartitionSpec``'s entries).  Without a mesh, and on a mesh of one rank,
everything here is the identity and a model runs its unsharded code bit
for bit.

Physical axes:
  pod    -- slowest axis, across pods (multi-pod layouts only)
  data   -- batch / FSDP axis
  model  -- tensor / vocab / expert-parallel axis

GSPMD turns the JAX package's constraints into collectives; eager PyTorch
has no partitioner, so the port runs the same layouts explicitly,
Megatron-style, on each rank's own blocks (plain tensors):

* a parameter is held as this rank's block of its :func:`param_spec`
  (:func:`place` on a model built on the meta device, :func:`distribute`
  on a whole one), carrying its ``spec``, ``full_shape`` and ``block``;
  the optimizer's master and moments take the full-FSDP spec
  (``state_spec``), as the JAX package's ``train_state_sharding`` does;
* :func:`param` is a parameter in its compute layout: its ``data`` split
  all-gathered; in the backward its grad is reduce-scattered over
  ``data`` (all-reduced where the parameter is whole over ``data``), so
  it sums the batch's rows of every ``data`` rank;
* the caller splits the batch over ``data`` (:func:`batch_rows`);
* a layer split over ``model`` reads a whole activation through
  :func:`copy_to` (the identity; its backward all-reduces the grad over
  ``model``) and returns its partial sums through :func:`reduce_from` (an
  all-reduce over ``model``).  So every activation outside such a layer is
  whole and the same on the ranks of a ``model`` line, and so is its grad;
* :func:`shard` at the JAX package's sites moves such an activation into
  the layout the logical axes give (a slice; its backward an all-gather),
  or checks that the layer already made it so; :func:`gather` moves it
  back.

Why not DTensor.  ``DeviceMesh`` and the DTensor placements of a spec
(:func:`to_placements`, :attr:`Mesh.device_mesh`) describe the same
layouts, and the tests gather the blocks through them, but the step runs
on plain tensors: (1) when this was written, whether gloo (the backend
of ranks that share one card) takes DTensor's functional all-gather and
reduce-scatter on CUDA tensors was not known, while its tensor
collectives were (they do: ``chip_smoke.py`` path p); (2) GQA with fewer
KV heads than the ``model`` axis (chatglm3-6b's 2 on a 4-way axis) keeps
K and V whole while Q splits, and each rank pairs its query heads with
its own KV head, where a reshape of a split head axis would make DTensor
gather Q; (3) every collective a step makes is then one named call here,
which ``utils.dispatch_trace`` counts.

Under ``torch.utils.checkpoint`` a block's forward runs twice; its
weights are gathered once, before the checkpoint (:func:`gathered`,
:func:`using`), so the recomputation in the backward gathers nothing
again: the gathered blocks of every layer live until that layer's
backward (twice the parameters' local bytes at most).

The MoE (``models.moe``) keeps JAX's GSPMD layout: its routing groups
are the global batch's (:func:`batch_layout` says which rows this rank
holds, from the whole batch's row count that the caller passes to
``LM.forward(batch_size=)``; where ``data`` does not divide the groups,
:func:`all_gather` brings every row), the router's logits are
all-gathered over ``model`` and its experts (or, where they do not divide
``model``, their hidden units) run on their own ranks, whose partial sums
:func:`reduce_from` adds.  MLA
(``models.attention.MLAttention``) splits its heads over ``model`` and
computes its latent whole on every rank.

The recurrent mixers (``models.ssm``) follow the same invariant.  The
mLSTM and sLSTM split their heads over ``model`` and RG-LRU its channels;
where a rank then uses only its part of a whole activation or of a whole
parameter, the whole is made so that its grad is summed over ``model``:
:func:`copy_to` of an :func:`all_gather` (the grad summed over ``model``,
then this rank's block kept) for an activation, :func:`copy_to` or
:func:`own_block` on a parameter (a conv's
taps, a head norm's scale, RG-LRU's gates and ``lam``), so that its copies
on a model line stay equal.  The sLSTM's recurrence ``w_rec`` is gathered
whole over every axis that splits it once a block (:func:`param_whole`,
listed by the module's ``whole_params``), never inside its time loop.
Whisper's encoder runs its blocks as the decoder does, and each decoder
block's cross attention reads the encoder's whole output through
:func:`copy_to`.  Every registered config places on a mesh; a cache does
not (prefill and decode raise on a mesh).

Every collective of the sharded step is made in this module, and
:func:`tally` records them (as ``utils.dispatch_trace.Trace`` does, but
with no cost to the other ops, which a dispatch mode sees one by one).
"""

from __future__ import annotations

import contextlib
import re
import types
from typing import Any, NamedTuple, Sequence

import torch
import torch.distributed as dist

from repro_torch.utils.dispatch_trace import CollectiveRecord

# The installed mesh and rules: process-wide, not thread-local as the JAX
# package's, because autograd runs a CUDA backward (and the checkpoints'
# recomputation in it) on its own device thread
_state = types.SimpleNamespace(mesh=None, rules=None, gathered=None,
                               tally=None)

# logical axis -> tuple of physical mesh axes (in priority order): the
# JAX package's DEFAULT_RULES (its comments give each rule's reason)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": (),
    "seq_shard": ("data",),
    "kv_seq": ("model", "data", "pod"),
    "kv_seq_bp": ("data", "pod"),
    "embed": (),
    "act_embed": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "param_embed": ("data", "pod"),
    "expert_capacity": (),
}
BATCH_AXES = ("pod", "data")


class Mesh(NamedTuple):
    """This rank's view of a mesh of ranks (``launch.mesh.make_test_mesh``
    builds one): its ``layout`` (a ``launch.mesh.Layout``), this rank's
    rank in it, the ``world`` group of all its ranks, one group a mesh axis
    (the ranks that share this rank's coordinates on every other axis), the
    device the ranks compute on, and the ``DeviceMesh`` over the same
    groups (None where it could not be made)."""
    layout: Any
    rank: int
    world: Any                 # launch.mesh.ClientGroup
    groups: dict               # axis name -> ClientGroup
    device: torch.device
    device_mesh: Any = None

    @property
    def size(self) -> int:
        return self.layout.size

    @property
    def coords(self) -> dict:
        return self.layout.coords(self.rank)


def set_mesh_axes(mesh: Mesh | None, rules: dict | None = None) -> None:
    """Install ``mesh`` (None: no mesh) and the logical rules for this
    process, as the JAX package's launcher does before it builds a
    step."""
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES if rules is None else rules)


def get_mesh() -> Mesh | None:
    return _state.mesh


def _rules() -> dict:
    return DEFAULT_RULES if _state.rules is None else _state.rules


def active() -> Mesh | None:
    """The installed mesh when it has more than one rank, else None: a
    mesh of one rank runs the unsharded code."""
    mesh = get_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


# ------------------------------------------------------------------ rules
def spec_for(logical: Sequence[str | None], shape=None, layout=None,
             rules: dict | None = None) -> tuple:
    """Resolve logical names to physical axes on ``layout`` (default: the
    installed mesh's; none installed: ``()``, the JAX package's ``P()``).

    Divisibility-guarded: a physical axis is dropped when it does not
    divide its dimension (if ``shape`` is given) or an earlier dimension
    took it.  Returns one entry a dimension: None, an axis name or a tuple
    of names."""
    if layout is None:
        mesh = get_mesh()
        if mesh is None:
            return ()
        layout = mesh.layout
    rules = _rules() if rules is None else rules
    axis_sizes = layout.axis_sizes
    out: list = []
    used: set = set()
    for i, name in enumerate(logical):
        if name is None:
            out.append(None)
            continue
        phys = [a for a in rules.get(name, ()) if a in axis_sizes
                and a not in used]
        if shape is not None:
            keep, prod = [], 1
            for a in phys:
                if shape[i] % (prod * axis_sizes[a]) == 0:
                    keep.append(a)
                    prod *= axis_sizes[a]
            phys = keep
        used.update(phys)
        out.append(None if not phys else
                   phys[0] if len(phys) == 1 else tuple(phys))
    return tuple(out)


def param_spec(path: str, shape, layout=None, *, fsdp: bool = True,
               embed_fsdp: bool = True) -> tuple:
    """A parameter's spec, keyed on its leaf name (the last component of a
    dotted port name or a JAX tree path), on ``layout`` (default: the
    installed mesh's).

    Conventions (a JAX stacked period's leading axis is the caller's):
      embedding (V, D)         -> (vocab, param_embed)
      attn wq   (D, H, Dh)     -> (param_embed, heads, None)
      attn wkv  (D, KV, Dh)    -> (param_embed, heads, None)
      attn wo   (H, Dh, D)     -> (heads, None, param_embed)
      mlp w_in  (D, F)         -> (param_embed, mlp)
      mlp w_out (F, D)         -> (mlp, param_embed)
      moe experts (E, ...)     -> (experts,) + per-matrix rule
      biases / norms (D,)      -> replicated
    ``fsdp=False`` (ZeRO-2) leaves ``param_embed`` out; ``embed_fsdp=False``
    shards the embedding and LM head over the vocabulary only."""
    leaf = re.split(r"[./]", path)[-1]
    rank = len(shape)
    if leaf in ("embedding", "lm_head"):
        logical = ["vocab", "param_embed" if embed_fsdp else None]
    elif leaf in ("wq", "wk", "wv"):
        logical = ["param_embed", "heads", None]
    elif leaf == "wo":
        logical = ["heads", None, "param_embed"]
    elif leaf in ("w_gate", "w_up", "w_in"):
        logical = ["param_embed", "mlp"]
    elif leaf in ("w_down", "w_out"):
        logical = ["mlp", "param_embed"]
    elif leaf.startswith("expert_"):
        sub = {"expert_gate": ["param_embed", "mlp"],
               "expert_up": ["param_embed", "mlp"],
               "expert_down": ["mlp", "param_embed"]}[leaf]
        logical = ["experts"] + sub
    elif leaf == "router":
        logical = ["param_embed", "experts"]
    elif leaf in ("wkv_a", "wq_a"):          # MLA down-projections
        logical = ["param_embed", None]
    elif leaf.startswith("wkv_b") or leaf == "wq_b":
        logical = ["param_embed", "heads", None]
    elif leaf in ("w_rec", "w_x", "w_gates"):  # ssm mixers
        logical = ["param_embed", "heads", None][:rank]
    else:
        logical = [None] * rank
    if not fsdp:
        logical = [x if x != "param_embed" else None for x in logical]
    if len(logical) < rank:
        logical = [None] * (rank - len(logical)) + logical
    return spec_for(logical, shape, layout)


def param_sharding_tree(params, layout=None, *, fsdp: bool = True,
                        embed_fsdp: bool = True) -> dict:
    """Every parameter's :func:`param_spec` by name, of a module or a dict
    of tensors (whole shapes: a placed parameter's ``full_shape``).  The
    port keeps one tensor a layer, so no leading layer axis to skip."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {n: param_spec(n, full_shape(t), layout, fsdp=fsdp,
                          embed_fsdp=embed_fsdp)
            for n, t in params.items()}


def _axes(entry) -> tuple:
    return (() if entry is None else (entry,) if isinstance(entry, str)
            else tuple(entry))


def shards(spec: tuple, layout) -> int:
    """How many ways ``spec`` splits a tensor on ``layout``."""
    sizes = layout.axis_sizes
    n = 1
    for entry in spec:
        for a in _axes(entry):
            n *= sizes[a]
    return n


def to_placements(spec: tuple, axis_names: Sequence[str]) -> list:
    """DTensor placements of ``spec`` over a ``DeviceMesh`` whose dims are
    ``axis_names`` (``("data", "model")`` or ``("pod", "data", "model")``):
    ``Shard(i)`` on each mesh dim that splits dim i, ``Replicate()`` on the
    others.  Where two mesh dims split one tensor dim, DTensor orders them
    as the mesh does; the JAX package's ``param_embed`` tuple ("data",
    "pod") orders them data-major, so on the multi-pod layout the blocks'
    order differs (the bytes a device do not)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in axis_names]
    for dim, entry in enumerate(spec):
        for a in _axes(entry):
            out[list(axis_names).index(a)] = Shard(dim)
    return out


# ------------------------------------------------------------- placement
def full_shape(t: torch.Tensor) -> tuple:
    """A placed parameter's whole shape; any other tensor's own."""
    return tuple(getattr(t, "full_shape", t.shape))


def _block(shape, spec, layout, coords) -> tuple:
    """This rank's slices of a tensor of ``shape`` under ``spec``."""
    sizes = layout.axis_sizes
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        k, c = 1, 0
        for a in _axes(entry):               # the first axis the slowest
            k, c = k * sizes[a], c * sizes[a] + coords[a]
        out.append(slice(c * (n // k), (c + 1) * (n // k)))
    return tuple(out)


def _owner(module: torch.nn.Module, name: str):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


def _set_block(module, name, local, spec, shape, block, state_spec,
               requires_grad) -> None:
    owner, leaf = _owner(module, name)
    p = torch.nn.Parameter(local, requires_grad=requires_grad)
    p.spec, p.full_shape, p.block, p.state_spec = (spec, tuple(shape), block,
                                                   state_spec)
    setattr(owner, leaf, p)


def _placements(module, mesh: Mesh, fsdp: bool, embed_fsdp: bool):
    for name, p in list(module.named_parameters()):
        shape = tuple(p.shape)
        spec = param_spec(name, shape, mesh.layout, fsdp=fsdp,
                          embed_fsdp=embed_fsdp)
        yield (name, p, shape, spec, param_spec(name, shape, mesh.layout),
               _block(shape, spec, mesh.layout, mesh.coords))


def place(module: torch.nn.Module, mesh: Mesh, *, fsdp: bool = True,
          embed_fsdp: bool = True, device=None) -> torch.nn.Module:
    """Give every parameter of ``module`` (built on the meta device) this
    rank's block of its :func:`param_spec` on ``mesh``, as zeros on
    ``device`` (default: the mesh's) in its dtype; a later
    ``reset_parameters`` draws the blocks (``layers.normal_``)."""
    dev = mesh.device if device is None else device
    for name, p, shape, spec, state_spec, block in _placements(
            module, mesh, fsdp, embed_fsdp):
        local = torch.zeros([s.stop - s.start for s in block],
                            dtype=p.dtype, device=dev)
        _set_block(module, name, local, spec, shape, block, state_spec,
                   p.requires_grad)
    return module


@torch.no_grad()
def distribute(module: torch.nn.Module, mesh: Mesh, *, fsdp: bool = True,
               embed_fsdp: bool = True) -> torch.nn.Module:
    """Replace every parameter of a whole ``module`` by this rank's block
    of it under :func:`param_spec` on ``mesh`` (a copy: the whole tensor
    is freed with the module's last reference to it)."""
    for name, p, shape, spec, state_spec, block in _placements(
            module, mesh, fsdp, embed_fsdp):
        _set_block(module, name, p.detach()[block].clone(), spec, shape,
                   block, state_spec, p.requires_grad)
    return module


def split(p: torch.Tensor, dim: int, axis: str = "model") -> bool:
    """Whether placed parameter ``p``'s dim ``dim`` is split over ``axis``
    of the active mesh (False without one)."""
    spec = getattr(p, "spec", None)
    return (active() is not None and spec is not None
            and axis in _axes(spec[dim]))


def offset(p: torch.Tensor, dim: int) -> int:
    """Where this rank's block of placed parameter ``p`` starts on dim
    ``dim`` (0 for a whole tensor)."""
    block = getattr(p, "block", None)
    return 0 if block is None or active() is None else block[dim].start


# ------------------------------------------------------------ collectives
# torch 2.13 names them *_single and deprecates the *_tensor names, which
# the card's older torch has alone
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_scatter_into = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _record(op: str, ts, kind: str = "") -> None:
    """A collective into the active :func:`tally` (if any), with the
    tensors it is passed, as ``dispatch_trace.Trace`` records it."""
    if _state.tally is not None:
        _state.tally.append(CollectiveRecord(
            op, kind, sum(t.numel() for t in ts),
            sum(t.numel() * t.element_size() for t in ts)))


def _all_gather_single(out: torch.Tensor, src: torch.Tensor, group):
    _record("all-gather", (out, src))
    _gather_into(out, src, group=group.group)


def _reduce_scatter_single(out: torch.Tensor, src: torch.Tensor, group):
    _record("reduce-scatter", (out, src))
    _scatter_into(out, src, group=group.group)


def _all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    if group.size > 1:
        _record("all-reduce", (t,), "max" if op == dist.ReduceOp.MAX
                else "add")
        dist.all_reduce(t, op=op, group=group.group)
    return t


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``t`` concatenated along ``dim`` in rank
    order."""
    if group.size == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((group.size * src.shape[0],) + src.shape[1:])
    _all_gather_single(out, src, group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group of ``t``, this rank's block along ``dim``."""
    if group.size == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // group.size,) + src.shape[1:])
    _reduce_scatter_single(out, src, group)
    return out.movedim(0, dim).contiguous()


def _narrow(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = t.shape[dim] // group.size
    return t.narrow(dim, group.rank * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    """Identity; the backward all-reduces the grad over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum) over the group; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Slice(torch.autograd.Function):
    """This rank's block along ``dim``; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _narrow(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, ctx.group, ctx.dim), None, None


class _ParamBucket(torch.autograd.Function):
    """Parameter blocks of one dtype in their compute layout, in one
    collective each way: the blocks split over the group (each along its
    own dim in ``dims``) all-gathered as one flat buffer, the others kept
    as they are.  The backward sums their grads over the group: the
    gathered ones in one reduce-scatter, the others in one all-reduce."""

    @staticmethod
    def forward(ctx, group, dims, *ps):
        ctx.group, ctx.dims = group, dims
        ctx.shapes = [p.shape for p in ps]
        out = [p.view_as(p) for p in ps]
        split = [i for i, d in enumerate(dims) if d is not None]
        if not split:
            return tuple(out)
        moved = [ps[i].movedim(dims[i], 0) for i in split]
        flat = torch.cat([m.reshape(-1) for m in moved])
        full = flat.new_empty(group.size * flat.numel())
        _all_gather_single(full, flat, group)
        full, at = full.view(group.size, -1), 0
        for i, m in zip(split, moved):
            t = full[:, at:at + m.numel()].reshape(
                (group.size * m.shape[0],) + m.shape[1:])
            out[i] = t.movedim(0, dims[i]).contiguous()
            at += m.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        group, dims, k = ctx.group, ctx.dims, ctx.group.size
        grads = [None] * len(gs)
        split = [i for i, d in enumerate(dims) if d is not None]
        if split:
            moved = [gs[i].movedim(dims[i], 0) for i in split]
            flat = torch.cat([m.reshape(k, -1) for m in moved], dim=1)
            part = flat.new_empty(flat.shape[1])
            _reduce_scatter_single(part, flat.reshape(-1), group)
            at = 0
            for i, m in zip(split, moved):
                n = m.numel() // k
                grads[i] = part[at:at + n].view(
                    (m.shape[0] // k,) + m.shape[1:]).movedim(0, dims[i])
                at += n
        whole = [i for i, d in enumerate(dims) if d is None]
        if whole:
            flat = _all_reduce_(torch.cat([gs[i].reshape(-1)
                                           for i in whole]), group)
            at = 0
            for i in whole:
                n = gs[i].numel()
                grads[i] = flat[at:at + n].view(ctx.shapes[i])
                at += n
        return (None, None) + tuple(grads)


def _group(mesh: Mesh, axis: str):
    if axis not in mesh.groups:
        raise NotImplementedError(
            f"the port's sharded step runs on a (data, model) mesh; "
            f"{mesh.layout.name} has no {axis!r} group")
    return mesh.groups[axis]


def all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``x`` of the ranks of ``axis`` concatenated along
    ``dim`` in rank order; the backward keeps this rank's block of the
    grad, so what follows must be the same on every rank of ``axis`` and
    leave its grad so.  The identity without a mesh."""
    mesh = active()
    if mesh is None or mesh.layout.axis_sizes.get(axis, 1) == 1:
        return x
    return _Gather.apply(x, _group(mesh, axis), dim % x.dim())


def own_block(t: torch.Tensor, dim: int, axis: str = "model"
              ) -> torch.Tensor:
    """This rank's block along ``dim`` over ``axis`` of ``t``, a tensor
    whole on every rank of ``axis`` of which each rank uses its own block
    (RG-LRU's gates of its channels): the backward all-gathers the blocks'
    grads, so every rank gets the whole grad.  The identity without a
    mesh."""
    mesh = active()
    if mesh is None or mesh.layout.axis_sizes.get(axis, 1) == 1:
        return t
    return _Slice.apply(t, _group(mesh, axis), dim % t.dim())


def copy_to(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """``x`` into a layer split over ``axis`` (identity forward, the
    grad all-reduced over ``axis``); the identity without a mesh."""
    mesh = active()
    if mesh is None or mesh.layout.axis_sizes.get(axis, 1) == 1:
        return x
    return _CopyTo.apply(x, _group(mesh, axis))


def reduce_from(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The sum over ``axis`` of each rank's partial ``x`` (identity
    backward); the identity without a mesh."""
    mesh = active()
    if mesh is None or mesh.layout.axis_sizes.get(axis, 1) == 1:
        return x
    return _ReduceFrom.apply(x, _group(mesh, axis))


def all_max(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The elementwise max over ``axis`` (no grad): a copy of ``x``."""
    mesh = active()
    x = x.detach().clone()
    if mesh is None or mesh.layout.axis_sizes.get(axis, 1) == 1:
        return x
    return _all_reduce_(x, _group(mesh, axis), dist.ReduceOp.MAX)


def param(p: torch.Tensor) -> torch.Tensor:
    """A parameter in its compute layout: a placed block all-gathered over
    the batch axes that split it (``data``; its ``model`` split stays),
    its grad summed over them in the backward.  The identity without a
    mesh; a placed parameter without an active mesh raises."""
    spec = getattr(p, "spec", None)
    mesh = active()
    if mesh is None:
        if spec is not None and any(_axes(e) for e in spec):
            raise RuntimeError("a parameter placed on a mesh is used with "
                               "no mesh installed (set_mesh_axes)")
        return p
    if spec is None:
        raise RuntimeError("an unplaced parameter under an active mesh")
    if _state.gathered is not None and id(p) in _state.gathered:
        return _state.gathered[id(p)]
    return params([p])[0]


def _data_split(mesh: Mesh) -> bool:
    """Whether ``data`` splits anything on ``mesh`` (a ``pod`` axis
    raises: the sharded step takes a (data, model) mesh)."""
    if "pod" in mesh.layout.axis_names:
        _group(mesh, "pod")
    return mesh.layout.axis_sizes.get("data", 1) > 1


def _data_dim(p: torch.Tensor) -> int | None:
    """The dim of placed ``p`` that ``data`` splits (None: whole)."""
    spec = getattr(p, "spec", None)
    if spec is None:
        raise RuntimeError("an unplaced parameter under an active mesh")
    dims = [i for i, e in enumerate(spec) if "data" in _axes(e)]
    return dims[0] if dims else None


def params(ps: Sequence[torch.Tensor]) -> list:
    """:func:`param` of each of ``ps``, their ``data`` gathers in one
    all-gather a dtype and their grads' sums in one reduce-scatter and one
    all-reduce a dtype (:class:`_ParamBucket`), rather than a collective a
    parameter each way."""
    mesh = active()
    if mesh is None:
        return [param(p) for p in ps]
    if not _data_split(mesh):
        return list(ps)
    group, out = _group(mesh, "data"), [None] * len(ps)
    for dtype in dict.fromkeys(p.dtype for p in ps):
        idx = [i for i, p in enumerate(ps) if p.dtype == dtype]
        got = _ParamBucket.apply(group, tuple(_data_dim(ps[i]) for i in idx),
                                 *(ps[i] for i in idx))
        for i, t in zip(idx, got):
            out[i] = t
    return out


def param_whole(p: torch.Tensor, partial: bool) -> torch.Tensor:
    """A parameter whole on every rank: :func:`param` (its ``data`` split
    gathered), then its ``model`` split gathered too.  ``partial``: each
    rank of ``model`` uses only its own part of the whole (sLSTM's
    recurrence of its heads), so the grad is summed over ``model`` before
    this rank keeps its block (:func:`copy_to` of the :func:`all_gather`);
    else every rank uses it alike (:func:`all_gather`).  The identity
    without a mesh."""
    if _state.gathered is not None and ("whole", id(p)) in _state.gathered:
        return _state.gathered[("whole", id(p))]
    w = param(p)
    if active() is None:
        return w
    for dim, entry in enumerate(p.spec):
        if "model" in _axes(entry):
            w = all_gather(w, "model", dim)
    return copy_to(w) if partial else w


def gathered(module: torch.nn.Module) -> dict:
    """Every parameter of ``module`` in its compute layout (:func:`params`,
    one collective a dtype each way; :func:`param_whole` for those a
    submodule lists in its ``whole_params()``, by name: whether each is
    used in part) by ``id``, for :func:`using`."""
    out, rest = {}, []
    for mod in module.modules():
        whole = mod.whole_params() if hasattr(mod, "whole_params") else {}
        for name, p in mod.named_parameters(recurse=False):
            if name in whole:
                out[("whole", id(p))] = param_whole(p, whole[name])
            else:
                rest.append(p)
    out.update(zip(map(id, rest), params(rest)))
    return out


@contextlib.contextmanager
def using(weights: dict | None):
    """While it lasts, :func:`param` returns the tensors of ``weights``
    (:func:`gathered`) for their parameters instead of gathering them
    again (None: no change)."""
    prev = _state.gathered
    if weights is not None:
        _state.gathered = weights
    try:
        yield
    finally:
        _state.gathered = prev


@contextlib.contextmanager
def tally():
    """While it lasts, every collective of this module (the sharded step
    makes all of its collectives here) is recorded in the list it yields,
    as ``dispatch_trace.Trace`` records it, at no cost to the other ops
    (``dispatch_trace.collective_stats`` sums them)."""
    prev, _state.tally = _state.tally, []
    try:
        yield _state.tally
    finally:
        _state.tally = prev


def _convert(x, logical, shape, mesh, gather: bool):
    shape = tuple(x.shape) if shape is None else tuple(
        x.shape[i] if n is None else n for i, n in enumerate(shape))
    spec = spec_for(logical, shape, mesh.layout)
    sizes = mesh.layout.axis_sizes
    for dim, (name, entry) in enumerate(zip(logical, spec)):
        if name == "batch":                   # split by the caller
            continue
        axes = _axes(entry)
        if not axes:
            if x.shape[dim] != shape[dim]:
                raise ValueError(f"dim {dim} ({name}) holds {x.shape[dim]}"
                                 f" of {shape[dim]}, spec {spec}")
            continue
        if len(axes) > 1:
            raise NotImplementedError(f"{name} over {axes}")
        k, block = sizes[axes[0]], shape[dim] // sizes[axes[0]]
        group = _group(mesh, axes[0])
        if x.shape[dim] == block and k > 1:
            if gather:
                x = _Gather.apply(x, group, dim)
        elif x.shape[dim] == shape[dim]:
            if not gather:
                x = _Slice.apply(x, group, dim)
        else:
            raise ValueError(f"dim {dim} ({name}) holds {x.shape[dim]} of "
                             f"{shape[dim]}: not whole and not a block of "
                             f"{k}")
    return x


def shard(x: torch.Tensor, *logical: str | None, shape=None) -> torch.Tensor:
    """The JAX package's sharding constraint on logical axes: the identity
    without a mesh.  With one, ``x`` is this rank's rows of the batch
    (split by the caller) and, on every other dim, either whole or already
    this rank's block of ``shape`` (the whole shape; a None entry or no
    ``shape``: ``x``'s size, whole) under ``spec_for(logical)``; a whole
    dim the spec splits is sliced to this rank's block (the backward
    all-gathers), a block is kept, anything else raises."""
    mesh = active()
    if mesh is None:
        return x
    return _convert(x, logical, shape, mesh, gather=False)


def gather(x: torch.Tensor, *logical: str | None, shape) -> torch.Tensor:
    """:func:`shard`'s inverse: every dim that ``x`` holds as this rank's
    block of ``shape`` under ``spec_for(logical)`` all-gathered whole (the
    backward keeps the block); the identity without a mesh."""
    mesh = active()
    if mesh is None:
        return x
    return _convert(x, logical, shape, mesh, gather=True)


def batch_ways() -> int:
    """The ranks a batch row is spread over or repeated on: the product of
    the mesh's batch axes (1 without a mesh)."""
    mesh = active()
    if mesh is None:
        return 1
    sizes = mesh.layout.axis_sizes
    n = 1
    for a in BATCH_AXES:
        n *= sizes.get(a, 1)
    return n


def _batch_block(rows: int) -> slice:
    """This rank's rows of a whole batch of ``rows``: a block of the
    ``batch`` axes where they divide it, else every row."""
    mesh = active()
    spec = spec_for(["batch"], (rows,), mesh.layout)
    return _block((rows,), spec, mesh.layout, mesh.coords)[0]


def batch_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows of a whole batch (dim ``dim``): a block of the
    ``batch`` axes where they divide it, else every row (the identity
    without a mesh)."""
    if active() is None:
        return t
    block = _batch_block(t.shape[dim])
    return t.narrow(dim, block.start, block.stop - block.start)


def batch_layout(rows: int, whole: int | None) -> tuple[int, int]:
    """(the whole batch's rows, this rank's first row) where this rank
    holds ``rows`` rows, cut by :func:`batch_rows`, of a batch of
    ``whole``.  ``(rows, 0)`` without a mesh.  On one, ``whole`` is
    required, since the rows a rank holds do not tell a split batch from
    a repeated one (1 row of 2 on a 2-way ``data`` axis, or the whole of a
    1-row batch); a ``whole`` of which :func:`batch_rows` would not give
    ``rows`` rows raises ValueError."""
    if active() is None:
        return rows, 0
    if whole is None:
        raise ValueError("on a mesh the whole batch's row count is needed "
                         "(batch_size=): a rank's rows do not tell a split "
                         "batch from a repeated one")
    block = _batch_block(whole)
    if block.stop - block.start != rows:
        raise ValueError(f"{rows} rows are not this rank's rows of a batch "
                         f"of {whole} (sharding.batch_rows gives "
                         f"{block.stop - block.start})")
    return whole, block.start


def counts_once(p: torch.Tensor) -> bool:
    """Whether this rank's block of placed ``p`` is the one the global
    grad norm counts: the rank at coordinate 0 of every mesh axis that
    does not split ``p`` (True without a mesh)."""
    mesh = active()
    if mesh is None:
        return True
    used = {a for e in getattr(p, "spec", ()) for a in _axes(e)}
    coords = mesh.coords
    return all(coords[a] == 0 for a in mesh.layout.axis_names
               if a not in used)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over every rank of the mesh (in place; no grad)."""
    mesh = active()
    return x if mesh is None else _all_reduce_(x, mesh.world)


def state_block(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """This rank's block under placed ``p``'s ``state_spec`` of ``t``,
    which is laid out as ``p`` (``spec``): the optimizer's full-FSDP block
    of a parameter or grad that ZeRO-2 keeps whole over ``data``."""
    spec, state = getattr(p, "spec", None), getattr(p, "state_spec", None)
    if active() is None or spec is None or spec == state:
        return t
    mesh = active()
    for dim, (have, want) in enumerate(zip(spec, state)):
        if _axes(have) == _axes(want):
            continue
        if have is not None or len(_axes(want)) != 1:
            raise NotImplementedError(f"state spec {state} from {spec}")
        t = _narrow(t, _group(mesh, want), dim)
    return t


def param_from_state(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """:func:`state_block`'s inverse: a state block all-gathered into
    placed ``p``'s layout."""
    spec, state = getattr(p, "spec", None), getattr(p, "state_spec", None)
    if active() is None or spec is None or spec == state:
        return t
    mesh = active()
    for dim, (have, want) in enumerate(zip(spec, state)):
        if _axes(have) != _axes(want):
            t = _all_gather(t, _group(mesh, want), dim)
    return t


@torch.no_grad()
def model_line_drift(module: torch.nn.Module) -> tuple[list, int]:
    """(the names of ``module``'s parameters whole over ``model`` whose
    blocks are not bit-equal on every rank of this rank's ``model`` line,
    how many such parameters there are): one all-gather of them all, in
    float32 (exact for the model's dtypes).  A collective over ``model``;
    ``([], 0)`` without a mesh."""
    mesh = active()
    if mesh is None or mesh.layout.axis_sizes.get("model", 1) == 1:
        return [], 0
    group = _group(mesh, "model")
    held = [(n, p) for n, p in module.named_parameters()
            if not any(split(p, d) for d in range(p.dim()))]
    flat = torch.cat([p.detach().float().reshape(-1) for _, p in held])
    rows = _all_gather(flat, group, 0).view(group.size, -1)
    differ, at = [], 0
    for n, p in held:
        part = rows[:, at:at + p.numel()]
        at += p.numel()
        if not all(torch.equal(part[0], part[i])
                   for i in range(1, group.size)):
            differ.append(n)
    return differ, len(held)


@torch.no_grad()
def whole(t: torch.Tensor, spec=None) -> torch.Tensor:
    """The whole tensor of this rank's block ``t`` under ``spec`` (default:
    a placed parameter's own), all-gathered over every axis that splits
    it, on every rank: a new tensor (a copy of ``t`` where nothing splits
    it, or without a mesh)."""
    mesh = active()
    spec = getattr(t, "spec", None) if spec is None else spec
    out = t.detach()
    if mesh is not None and spec is not None:
        for dim, entry in enumerate(spec):
            for a in _axes(entry):
                out = _all_gather(out, _group(mesh, a), dim)
    return out.clone() if out.data_ptr() == t.data_ptr() else out

