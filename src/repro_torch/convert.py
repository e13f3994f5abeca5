"""State carried between the JAX package and the port.

The JAX package's NamedTuples (``Preprocessed``, ``SaddleState``,
``PackedState``, ...) reach this module as objects or dicts whose fields
are numpy arrays (or anything ``numpy.asarray`` reads, such as JAX
arrays) and python ints; :func:`to_port` builds the port's NamedTuple of
the same field names on a chosen device, and :func:`to_numpy` goes back.
The LM side's weights cross by :func:`lm_params_from_jax` (the JAX
package's ``init_lm`` pytree, numpy leaves, into the port's model) and
:func:`lm_params_to_numpy` (back).  This module imports neither JAX nor
the JAX package.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from repro_torch.device import resolve_device


def to_numpy_array(value) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _field(src, name: str):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def to_port(cls, src, device: str | torch.device | None = None):
    """The port's NamedTuple ``cls`` built from ``src``'s same-named fields.

    Fields annotated ``int`` (``d_orig``, ``n1``, ``n2``) stay python
    ints; every other field becomes a tensor on ``device``: int32 for
    integer arrays (iteration counters, indices), float32 otherwise."""
    dev = resolve_device(device)
    hints = typing.get_type_hints(cls)
    out = {}
    for name in cls._fields:
        value = _field(src, name)
        if hints.get(name) is int:
            out[name] = int(value)
            continue
        arr = to_numpy_array(value)
        integer = np.issubdtype(arr.dtype, np.integer)
        dtype = np.int32 if integer else np.float32
        out[name] = torch.as_tensor(np.array(arr, dtype, order="C"),
                                    device=dev)
    return cls(**out)


def to_numpy(state) -> dict:
    """Every field of a NamedTuple (the port's or the JAX package's) as
    numpy arrays; python ints stay ints."""
    return {name: value if isinstance(value, int) else to_numpy_array(value)
            for name, value in state._asdict().items()}


# ------------------------------------------------------------- LM weights
# A block's parameters are named as the JAX package's block pytree
# ("mixer.wq", "mixer.kv_norm.scale", "mlp.shared.w_gate", ...): the dotted
# name is the path of the leaf.


def _tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _leaves(tree, prefix: str = ""):
    """(dotted path, leaf) of a nested dict."""
    for key, sub in tree.items():
        if isinstance(sub, dict):
            yield from _leaves(sub, f"{prefix}{key}.")
        else:
            yield prefix + key, sub


def _tree_map(fn, *trees):
    return {key: (_tree_map(fn, *(t[key] for t in trees))
                  if isinstance(sub, dict) else fn(*(t[key] for t in trees)))
            for key, sub in trees[0].items()}


def _block_tree(block) -> dict:
    """A block's weights as the JAX package's nested dict of numpy."""
    tree: dict = {}
    for name, param in block.named_parameters():
        *parts, leaf = name.split(".")
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = _numpy_from_tensor(param)
    return tree


def _unstack(stack, plan) -> list[dict]:
    """A JAX stack's per-layer trees (head, the periods, tail): the
    stacked period axis of ``stack["blocks"]`` unstacked."""
    layers = list(stack["head"])
    for p in range(plan.n_periods):
        layers += [_tree_map(lambda leaf, p=p: leaf[p], stack["blocks"][j])
                   for j in range(len(plan.period))]
    return layers + list(stack["tail"])


def _load_stack(blocks, final_norm, stack, plan, name: str, dev) -> None:
    """Copy a JAX stack's weights into ``blocks`` (a ModuleList) and
    ``final_norm``: every leaf of a block must have its parameter, and
    every parameter its leaf."""
    layers = _unstack(stack, plan)
    if len(layers) != len(blocks):
        raise ValueError(f"{len(layers)} layers in the tree, "
                         f"{len(blocks)} in {name}")
    for i, (block, src) in enumerate(zip(blocks, layers)):
        leaves = dict(_leaves(src))
        params = dict(block.named_parameters())
        if leaves.keys() != params.keys():
            raise ValueError(
                f"layer {i}: leaves {sorted(leaves)} in the tree, "
                f"parameters {sorted(params)} in {name}")
        for pname, param in params.items():
            param.copy_(_tensor_from_numpy(leaves[pname], dev))
    final_norm.scale.copy_(_tensor_from_numpy(stack["final_norm"]["scale"],
                                              dev))


def _stack_tree(blocks, final_norm, plan) -> dict:
    """A stack's weights as the JAX package's pytree of numpy (the period
    axis stacked again)."""
    trees = [_block_tree(b) for b in blocks]
    nh, per = len(plan.head), len(plan.period)
    body = trees[nh:nh + plan.n_periods * per]
    stacked = [_tree_map(lambda *xs: np.stack(xs),
                         *body[j::per]) if plan.n_periods else None
               for j in range(per)]
    return {"head": trees[:nh], "blocks": stacked,
            "tail": trees[nh + plan.n_periods * per:],
            "final_norm": {"scale": _numpy_from_tensor(final_norm.scale)}}


def lm_params_from_jax(tree, cfg, device=None):
    """The port's model for ``cfg`` with the weights of the JAX package's
    ``init_lm`` pytree ``tree`` (leaves as numpy arrays, bfloat16 as
    ``ml_dtypes.bfloat16``): the stacked period axis of
    ``tree["decoder"]["blocks"]`` (and of an encoder-decoder's
    ``tree["encoder"]``) is unstacked into the per-layer blocks, in the
    JAX package's layer order (head, periods, tail).  Every leaf of a block
    must have its parameter, and every parameter its leaf: a layer without
    an MLP (mLSTM, sLSTM) carries its norm and mixer only, a decoder block
    of an encoder-decoder its ``norm_x`` and ``cross`` too, and a leaf
    keeps its dtype (RG-LRU's ``lam`` is float32 in a bfloat16 model)."""
    from repro_torch.models import transformer as tf

    model = tf.LM(cfg, device)
    dev = model.device
    with torch.no_grad():
        _load_stack(model.layers, model.final_norm, tree["decoder"],
                    tf.layer_plan(cfg), cfg.name, dev)
        if model.encoder is not None:
            enc = model.encoder
            _load_stack(enc.layers, enc.final_norm, tree["encoder"],
                        tf.layer_plan(enc.cfg), f"{cfg.name}'s encoder", dev)
        model.embed.embedding.copy_(
            _tensor_from_numpy(tree["embed"]["embedding"], dev))
        if model.embed.lm_head is not None:
            model.embed.lm_head.copy_(
                _tensor_from_numpy(tree["embed"]["lm_head"], dev))
    return model


def lm_params_to_numpy(model) -> dict:
    """The JAX package's ``init_lm`` pytree of ``model``'s weights, as
    numpy arrays (the period axis stacked again)."""
    from repro_torch.models import transformer as tf

    embed = {"embedding": _numpy_from_tensor(model.embed.embedding)}
    if model.embed.lm_head is not None:
        embed["lm_head"] = _numpy_from_tensor(model.embed.lm_head)
    out = {"embed": embed, "decoder": _stack_tree(
        model.layers, model.final_norm, tf.layer_plan(model.cfg))}
    if model.encoder is not None:
        enc = model.encoder
        out["encoder"] = _stack_tree(enc.layers, enc.final_norm,
                                     tf.layer_plan(enc.cfg))
    return out
