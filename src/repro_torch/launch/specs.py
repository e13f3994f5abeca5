"""Input specs, sharding rules and step constructors of the launch dry-run.

Counterpart of ``repro.launch.specs``, whose functions return a jitted
step and ``ShapeDtypeStruct`` arguments carrying shardings for XLA to
lower and compile.  Eager PyTorch compiles nothing, so the port's
constructors return a step to RUN and its arguments:

* the LM entries (:func:`build_lowerable`): the train step, the prefill
  or the one-token decode over a shape's whole batch.  Built and run
  inside a ``torch._subclasses.FakeTensorMode``, they allocate nothing at
  any width: the weights are left undrawn there (``init_lm``'s draw reads
  a value back, which a fake tensor cannot give), and what the step
  dispatches is what the dry-run counts.
* the solver and serving entries (:func:`build_saddle_dsvc_runner`,
  :func:`build_saddle_serve_runner`): ONE rank's chunk at that rank's
  shard shape on a client group (a fake group of k = 256 or 512 ranks,
  ``launch.mesh.init_fake_group``).  Each rank's shard is drawn from a
  seed at its own shape: the 1M-point problem never exists whole.

The dry-run counts bytes a device by the JAX package's rules, applied to
the port's own tensors by name: :data:`DEFAULT_RULES`, :func:`spec_for`
and :func:`param_spec` of ``models.sharding`` (the rules a sharded train
step places its blocks by, ``launch.train --ranks``), and
:func:`_leaf_logical` (a copy of ``repro.launch.specs``'s).  A
parameter's rule keys on its leaf name, which the port shares with the
JAX pytree (``convert.lm_tree_to_named`` maps one onto the other); the
JAX package stacks a period's layers on a leading axis it never shards,
so a layer's bytes a device are the same either way.  The port's GQA
caches are laid out (B, KV, T, Dh) where JAX has (B, T, KV, Dh), and take
the same logical axes in their own order.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.launch.shapes import SHAPES, InputShape
# the one copy of the rules (re-exported: the dry-run and its tests read
# them here)
from repro_torch.models.sharding import (  # noqa: F401
    DEFAULT_RULES, param_spec, shards, spec_for)

CACHE_DTYPE = torch.bfloat16

# ------------------------------------------------------- sharding rules
def _leaf_logical(path: str, shape) -> list:
    """Logical axes for a serve-state / batch leaf, by name + rank (a
    copy of ``repro.launch.specs._leaf_logical``, on the JAX layouts)."""
    leaf = path.split("/")[-1]
    rank = len(shape)
    if leaf in ("k", "v") and rank == 4:
        return ["batch", "kv_seq_bp", "kv_heads", None]
    if leaf == "c_kv" and rank == 3:
        return ["batch", "kv_seq", None]
    if leaf == "k_rope" and rank == 3:
        return ["batch", "kv_seq", None]
    if leaf == "C" and rank == 4:
        return ["batch", "heads", None, None]
    if leaf in ("n", "m", "c", "h") and rank == 3:
        return ["batch", "heads", None]
    if leaf == "h" and rank == 2:
        return ["batch", "mlp"]
    if leaf == "conv" and rank == 3:
        return ["batch", None, "mlp"]
    if leaf == "last_logits" and rank == 2:
        return ["batch", "vocab"]
    if leaf in ("tokens", "targets", "vision_mask") and rank == 2:
        return ["batch", None]
    if leaf in ("vision_embeds", "enc_frames") and rank == 3:
        return ["batch", None, None]
    if leaf == "positions":
        return [None] * (rank - 2) + ["batch", None]
    return [None] * rank


def _port_cache_logical(path: str, shape) -> list:
    """:func:`_leaf_logical` of a port cache leaf: a GQA cache's (B, KV,
    T, Dh) K or V (self or cross) takes JAX's (B, T, KV, Dh) axes in its
    own order."""
    leaf = path.split("/")[-1]
    if leaf in ("k", "v", "cross_k", "cross_v") and len(shape) == 4:
        return ["batch", "kv_heads", "kv_seq_bp", None]
    return _leaf_logical(path, shape)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def param_bytes_per_device(params, layout, *, fsdp: bool = True,
                           embed_fsdp: bool = True) -> int:
    """Bytes a device of ``params`` (a module or a dict of tensors by the
    port's parameter names) under :func:`param_spec`."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return sum(_nbytes(t) // shards(param_spec(n, t.shape, layout,
                                               fsdp=fsdp,
                                               embed_fsdp=embed_fsdp),
                                    layout)
               for n, t in params.items())


def train_state_sharding(params, layout, cfg=None) -> dict:
    """Specs of a train state on ``layout`` (``repro.launch.specs.
    train_state_sharding``): the parameters' under the config's
    ``fsdp_params`` / ``embed_fsdp`` (both on without a config); AdamW's
    master and moments ALWAYS fully FSDP-sharded (ZeRO-2 where the
    compute parameters are not); its step count replicated.  ``params``
    is a module or a dict of tensors by the port's names (whole shapes)."""
    from repro_torch.models.sharding import param_sharding_tree

    fsdp = cfg.fsdp_params if cfg is not None else True
    embed_fsdp = cfg.embed_fsdp if cfg is not None else True
    full = param_sharding_tree(params, layout)
    return {"params": param_sharding_tree(params, layout, fsdp=fsdp,
                                          embed_fsdp=embed_fsdp),
            "master": full, "m": full, "v": full, "step": ()}


def train_state_bytes_per_device(cfg, layout) -> dict:
    """Bytes a device of each part of ``cfg``'s train state on ``layout``
    by :func:`train_state_sharding`: the parameters (their dtype), AdamW's
    float32 master and its moments (the config's state dtype)."""
    from repro_torch.models import transformer as tf

    model = tf.LM(cfg, "meta")
    sh = train_state_sharding(model, layout, cfg)
    params = dict(model.named_parameters())
    state = getattr(torch, cfg.optimizer_state_dtype)

    def part(key, dtype):
        return sum(p.numel() * (dtype or p.dtype).itemsize
                   // shards(sh[key][n], layout) for n, p in params.items())

    return {"params": part("params", None), "master": part("master",
                                                           torch.float32),
            "m": part("m", state), "v": part("v", state)}


def tensor_leaves(tree, prefix: str = ""):
    """(path joined with '/', tensor) of a nest of dicts, lists, tuples and
    named tuples."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tensor_leaves(v, f"{prefix}/{k}")
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from tensor_leaves(getattr(tree, k), f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tensor_leaves(v, f"{prefix}/{i}")


def state_bytes_per_device(tree, layout, logical=_port_cache_logical) -> int:
    """Bytes a device of a batch or a serve state under ``logical`` (the
    JAX package's ``state_sharding``)."""
    return sum(_nbytes(t) // shards(spec_for(logical(p, t.shape), t.shape,
                                             layout), layout)
               for p, t in tensor_leaves(tree))


def argument_bytes_per_device(cfg, kind: str, args, layout) -> int:
    """Bytes a device of a step's arguments (:func:`build_lowerable`'s
    ``args``): the parameters under the config's FSDP settings, AdamW's
    master and moments fully sharded, its step count replicated (JAX's
    ``train_state_sharding``), the batch, the tokens and the serve state
    by their logical axes."""
    model = args[0].model if kind == "train" else args[0]
    if kind != "train":
        total = param_bytes_per_device(model, layout, fsdp=cfg.fsdp_params,
                                       embed_fsdp=cfg.embed_fsdp)
    else:
        st = args[0].opt_state
        sh = train_state_sharding(model, layout, cfg)
        params = dict(model.named_parameters())
        total = _nbytes(st.step)
        for key, tree in (("params", params), ("master", st.master),
                          ("m", st.m), ("v", st.v)):
            total += sum(_nbytes(t) // shards(sh[key][n], layout)
                         for n, t in tree.items())
    for tree in args[1:]:
        total += state_bytes_per_device(tree, layout)
    return total


# ------------------------------------------------------------ input specs
def batch_specs(cfg, shape: InputShape, device="meta") -> dict:
    """Model inputs for one step of ``shape`` (train / prefill; decode's
    one token a row) as zero tensors on ``device`` (``"meta"``: shapes
    and dtypes alone), with the JAX package's keys, shapes and dtypes."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    d = cfg.d_model
    act = getattr(torch, cfg.compute_dtype)

    def zeros(shp, dtype):
        return torch.zeros(shp, dtype=dtype, device=device)

    out: dict[str, Any] = {"tokens": zeros((b, s), torch.int32)}
    if shape.kind == "train":
        out["targets"] = zeros((b, s), torch.int32)
    if cfg.vision_embeds and shape.kind != "decode":
        out["vision_embeds"] = zeros((b, s, d), act)
        out["vision_mask"] = zeros((b, s), torch.bool)
        out["positions"] = zeros((3, b, s), torch.int32)
    if cfg.is_encoder_decoder and shape.kind != "decode":
        out["enc_frames"] = zeros((b, cfg.enc_frames, d), act)
    return out


def input_specs(arch_or_cfg, shape_name: str = "train_4k") -> dict:
    """Public entry: ``meta`` stand-ins for every model input."""
    from repro_torch.configs import get_config

    cfg = arch_or_cfg if hasattr(arch_or_cfg, "d_model") \
        else get_config(arch_or_cfg)
    return batch_specs(cfg, SHAPES[shape_name])


# --------------------------------------------------- LM step constructors
def opt_config(cfg):
    from repro_torch.train import optimizer as opt

    return opt.AdamWConfig(state_dtype=cfg.optimizer_state_dtype)


def _model(cfg, device, seed):
    from repro_torch.models import transformer as tf

    if seed is None:
        return tf.LM(cfg, device)
    return tf.init_lm(cfg, seed=seed, device=device)


def build_lowerable(cfg, shape: InputShape, device=None, *,
                    seed: int | None = None):
    """Returns (fn, args): ``fn(*args)`` runs one step of ``shape`` over
    its whole batch -- the train step (AdamW state from ``opt.init``), the
    prefill into a ``seq_len`` bfloat16 cache, or one decode token a row
    against a ``seq_len`` bfloat16 cache at position ``seq_len - 1``.

    Inside a ``FakeTensorMode`` (the dry-run) call it with ``seed=None``:
    the weights stay undrawn and nothing is allocated; run ``fn`` inside
    the same mode.  With a seed the weights are ``init_lm``'s and the step
    runs for real (small configs)."""
    from repro_torch.device import resolve_device
    from repro_torch.serve import engine
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as train_steps

    dev = resolve_device(device)
    model = _model(cfg, dev, seed)
    b = shape.global_batch
    if shape.kind == "train":
        ocfg = opt_config(cfg)
        model = train_steps.trainable(model)
        state = train_steps.TrainState(model=model,
                                       opt_state=opt.init(model, ocfg))
        return (train_steps.make_train_step(cfg, ocfg),
                (state, batch_specs(cfg, shape, dev)))

    if shape.kind == "prefill":
        def prefill_step(model, batch):
            extras = {k: v for k, v in batch.items()
                      if k not in ("tokens", "positions")}
            return engine.prefill(model, batch["tokens"],
                                  max_len=shape.seq_len,
                                  cache_dtype=CACHE_DTYPE, **extras)

        return prefill_step, (model, batch_specs(cfg, shape, dev))

    cache = engine.init_cache(model, b, shape.seq_len, CACHE_DTYPE)
    cache["index"].fill_(shape.seq_len - 1)
    state = engine.ServeState(
        cache=cache,
        last_logits=torch.zeros((b, cfg.padded_vocab),
                                dtype=getattr(torch, cfg.compute_dtype),
                                device=dev),
        pos=torch.full((b,), shape.seq_len - 1, dtype=torch.int32,
                       device=dev))
    tokens = torch.zeros((b, 1), dtype=torch.int32, device=dev)

    def serve_step(model, tokens, state):
        return engine.decode_step(model, tokens, state)

    return serve_step, (model, tokens, state)


# ------------------------------------------------ saddle-dsvc (the solver)
SOLVER_ARCH = "saddle-dsvc"
EPS, BETA = 1e-3, 0.1          # the step sizes' accuracy and margin
SEED = 0                       # the shards' data and the draws


class SaddleDsvcShape(NamedTuple):
    """Input shape of the distributed Saddle-DSVC dry-run entry: clients
    over ALL mesh axes (a 16x16 pod is k = 256 clients, the 2x16x16
    multi-pod k = 512), each holding a round-robin shard of the packed
    +- point set (``repro.launch.specs.SaddleDsvcShape``)."""
    name: str
    n1: int
    n2: int
    d: int
    nu_frac: float        # 0 => HM-Saddle; else nu = 1 / (nu_frac * n1)
    block_size: int
    chunk_steps: int


SADDLE_DSVC_SHAPES: dict[str, SaddleDsvcShape] = {
    "svm_1m_nu": SaddleDsvcShape("svm_1m_nu", 1 << 19, 1 << 19, 256,
                                 0.8, 128, 50),
    "svm_1m_hm": SaddleDsvcShape("svm_1m_hm", 1 << 19, 1 << 19, 256,
                                 0.0, 1, 50),
}


def _nu(shape) -> float:
    return 1.0 / (shape.nu_frac * shape.n1) if shape.nu_frac else 0.0


def _rounds(nu: float) -> float:
    from repro_torch.core import projections

    return float(projections.BISECT_ROUNDS_SOLVER) if nu > 0 else 0.0


def saddle_dsvc_client_shape(shape: SaddleDsvcShape, k: int) -> dict:
    """Per-client packed shard shape of ``shape`` round-robined over ``k``
    clients: the lane-padded point count each client's kernels see
    (``n_pad``), the feature dim ``d`` and the block size ``b``."""
    from repro_torch.core.preprocess import packed_length

    m = math.ceil(shape.n1 / k) + math.ceil(shape.n2 / k)
    return {"n_pad": packed_length(m), "d": shape.d, "b": shape.block_size}


def _randn(shape, device, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def dsvc_client_shard(shape: SaddleDsvcShape, k: int, rank: int, device,
                      seed: int = SEED):
    """Client ``rank``'s packed shard of ``shape`` over ``k`` clients,
    drawn at its own shape: (x_t (1, d, n_pad), sign (1, n_pad)), its
    points as ``distributed.pack_shards`` lays them out (its positives,
    then its negatives, then lane padding of sign 0).  Round robin gives
    it the points j k + rank of each class."""
    cs = saddle_dsvc_client_shape(shape, k)
    m1 = math.ceil(shape.n1 / k)
    sign = torch.zeros((1, cs["n_pad"]), device=device)
    sign[0, :len(range(rank, shape.n1, k))] = 1.0
    sign[0, m1:m1 + len(range(rank, shape.n2, k))] = -1.0
    x_t = _randn((1, shape.d, cs["n_pad"]), device, seed * k + rank)
    return x_t.div_(math.sqrt(shape.d)).mul_(sign.abs()[:, None]), sign


def build_saddle_dsvc_runner(group, shape: SaddleDsvcShape, *,
                             seed: int = SEED):
    """Returns (fn, args, meta): ``fn(*args)`` runs the production chunk
    (``distributed.sharded_run_fn``, ``chunk_steps`` steps) of THIS rank's
    client on ``group`` (a ``launch.mesh.ClientGroup`` of k ranks) at its
    shard shape.  ``args`` = (state, x_t, sign, idx); ``meta`` carries
    the JAX entry's keys (k, nu, model = ``CommModel``, block_size,
    chunk_steps) and the shard's n_pad, d and step parameters."""
    from repro_torch.core import distributed, engine, saddle

    k, dev = group.size, group.device
    nu = _nu(shape)
    b = shape.block_size
    params = saddle.make_params(shape.n1 + shape.n2, shape.d, EPS, BETA,
                                nu=nu, block_size=b)
    x_t, sign = dsvc_client_shard(shape, k, group.rank, dev, seed)
    state = engine.init_packed_state(sign, shape.n1, shape.n2, shape.d)
    idx = engine.draw_blocks(torch.Generator(device=dev).manual_seed(seed),
                             shape.d, b, shape.chunk_steps, dev)
    fn = distributed.sharded_run_fn(group, params=params,
                                    chunk_steps=shape.chunk_steps)
    meta = {"k": k, "nu": nu,
            "model": distributed.CommModel(k=k,
                                           nu_rounds_per_iter=_rounds(nu)),
            "block_size": b, "chunk_steps": shape.chunk_steps,
            "n_pad": x_t.shape[-1], "d": shape.d, "params": params}
    return fn, (state, x_t, sign, idx), meta


# ---------------------------------------------- saddle-serve (mesh serving)
SERVE_ARCH = "saddle-serve"


class SaddleServeShape(NamedTuple):
    """Input shape of the serving dry-run entry (the
    ``engine.run_chunk_slots_sharded`` slot chunk;
    ``repro.launch.specs.SaddleServeShape``).  ``sharded=False`` is the
    LANES placement: lanes over every mesh axis, each rank owns whole
    lanes and issues no collective.  ``sharded=True`` is the POINTS
    placement: lanes over ``model`` (independent columns), each lane's
    points over the other axes (``data`` / ``pod x data``).  ``n1`` /
    ``n2`` are per-lane point counts; ``num_slots`` is the global lane
    count."""
    name: str
    num_slots: int
    n1: int
    n2: int
    d: int
    nu_frac: float        # 0 => HM; else nu = 1 / (nu_frac * n1)
    block_size: int
    chunk_steps: int
    sharded: bool


SADDLE_SERVE_SHAPES: dict[str, SaddleServeShape] = {
    "serve_lanes_512": SaddleServeShape(
        "serve_lanes_512", 512, 1500, 1400, 64, 0.8, 1, 50, False),
    "serve_points_1m": SaddleServeShape(
        "serve_points_1m", 32, 1 << 19, 1 << 19, 256, 0.8, 128, 50,
        True),
}


def saddle_serve_placement(layout, shape: SaddleServeShape):
    """(slot_axes, point_axes) of ``shape`` on ``layout`` (a
    ``launch.mesh.Layout``): the production placement rule of
    :class:`SaddleServeShape`."""
    axes = tuple(layout.axis_names)
    if not shape.sharded:
        return axes, ()
    if "model" not in axes:
        raise ValueError(
            f"points placement needs a 'model' axis, layout has {axes}")
    return ("model",), tuple(a for a in axes if a != "model")


def _lane_signs(n1: int, n2: int, lo: int, hi: int, device) -> torch.Tensor:
    """Signs of a lane's packed points [lo, hi): +1 below n1, -1 below
    n1 + n2, 0 (lane padding) after."""
    i = torch.arange(lo, hi, device=device)
    return torch.where(i < n1, 1.0, torch.where(i < n1 + n2, -1.0, 0.0))


def build_saddle_serve_runner(world, layout, shape: SaddleServeShape, *,
                              seed: int = SEED):
    """Returns (fn, args, meta): ``fn(*args, steps)`` runs ``steps`` steps
    (at most ``chunk_steps``) of the serving chunk of THIS rank of
    ``world`` (the default group, laid out as ``layout``) at its shard
    shape, in the production placement.  Points: every model column's
    group is made (in column order, on every call), and this rank steps
    its column's lanes on its share of their points over the column's
    group; lanes: it steps its own lanes alone.  ``args`` = (state, x_t,
    sign, sp); ``meta`` carries the JAX entry's keys (slot_axes,
    point_axes, k_slots, k_points, nu, model = ``ServeCommModel`` or
    None, num_slots, n_pad, d, block_size, chunk_steps) and this rank's
    ``lanes`` and ``rank_n_pad``."""
    from repro_torch.core import distributed, engine, saddle
    from repro_torch.core.preprocess import bucket_length
    from repro_torch.launch import mesh as meshlib

    slot_axes, point_axes = saddle_serve_placement(layout, shape)
    sizes = layout.axis_sizes
    ks = math.prod(sizes[a] for a in slot_axes)
    kp = math.prod(sizes[a] for a in point_axes)
    if shape.num_slots % ks:
        raise ValueError(
            f"{shape.name}: num_slots={shape.num_slots} not divisible by "
            f"the slot-axes extent {ks}")
    n = shape.n1 + shape.n2
    n_pad = kp * bucket_length(-(-n // kp)) if point_axes \
        else bucket_length(n)
    nu = _nu(shape)
    dev = world.device
    s = shape.num_slots // ks
    if point_axes:
        column = layout.coords(world.rank)["model"]
        group = meshlib.column_groups(world, layout)[column]
        first = column * s
        m = n_pad // kp
        lo = group.rank * m
        placement = "points"
    else:
        group, first, m, lo = world, world.rank * s, n_pad, 0
        placement = "lanes"
    lanes = range(first, first + s)
    sign = torch.stack([_lane_signs(shape.n1, shape.n2, lo, lo + m, dev)
                        for _ in lanes])
    x_t = torch.stack([_randn((shape.d, m), dev,
                              (seed * shape.num_slots + lane) * kp + lo // m)
                       for lane in lanes])
    x_t.div_(math.sqrt(shape.d)).mul_(sign.abs()[:, None])
    params = saddle.make_params(n, shape.d, EPS, BETA, nu=nu,
                                block_size=shape.block_size)
    state = engine.init_slot_state(s, m, shape.d, dev)
    for i, lane in enumerate(lanes):
        engine.admit_into_slot(
            state, i, engine.init_packed_state(sign[i], shape.n1, shape.n2,
                                               shape.d),
            torch.Generator(device=dev).manual_seed(seed + lane), 1 << 30)
    sp = engine.stack_slot_params([engine.slot_params_row(params)] * s, dev)

    def fn(state, x_t, sign, sp, steps):
        return engine.run_chunk_slots_sharded(
            state, x_t, sign, sp, steps, mesh=group, placement=placement,
            chunk_steps=shape.chunk_steps, d=shape.d,
            block_size=shape.block_size, project=nu > 0)

    model = distributed.ServeCommModel(
        k=kp, num_slots=s, nu_rounds_per_iter=_rounds(nu)) \
        if point_axes else None
    meta = {"slot_axes": slot_axes, "point_axes": point_axes,
            "k_slots": ks, "k_points": kp, "nu": nu, "model": model,
            "num_slots": shape.num_slots, "n_pad": n_pad, "d": shape.d,
            "block_size": shape.block_size,
            "chunk_steps": shape.chunk_steps, "lanes": s, "rank_n_pad": m}
    return fn, (state, x_t, sign, sp), meta
