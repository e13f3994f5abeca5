"""Flat-npz checkpoints of nested trees (parameters, optimizer states,
solver results): the counterpart of ``repro.train.checkpoint``.

A tree is a nested dict (or list, tuple, NamedTuple) whose leaves are
tensors (any device), numpy arrays or scalars; a model's ``state_dict``
is such a tree.  Keys are the '/'-joined paths of the leaves, as the JAX
package writes them, so a float32 tree written here is read by the JAX
package's ``restore``.  numpy has no bfloat16: a bfloat16 leaf is stored
as its uint16 bits, and its key is listed in the file's
``__bfloat16__`` entry, so it comes back bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

BF16_KEY = "__bfloat16__"


def _items(tree, prefix: str = ""):
    """(path, leaf) of every leaf, in the tree's order."""
    if isinstance(tree, dict):
        pairs = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        pairs = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        pairs = enumerate(tree)
    else:
        yield prefix[:-1], tree
        return
    for key, sub in pairs:
        yield from _items(sub, f"{prefix}{key}/")


def _flatten(tree) -> tuple[dict[str, np.ndarray], list[str]]:
    """The leaves as numpy arrays by path, and the paths of the bfloat16
    leaves (stored as their uint16 bits)."""
    out, bf16 = {}, []
    for path, leaf in _items(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                bf16.append(path)
                leaf = leaf.view(torch.int16)
                out[path] = leaf.numpy().view(np.uint16)
                continue
            leaf = leaf.numpy()
        out[path] = np.asarray(leaf)
    return out, bf16


def save(path: str, tree) -> None:
    """Write ``tree`` to ``path`` (an .npz; directories are made)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat, bf16 = _flatten(tree)
    if bf16:
        flat[BF16_KEY] = np.asarray(bf16)
    np.savez(path, **flat)


def _rebuild(like, leaves):
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def restore(path: str, like):
    """Load into the structure of ``like``, dtypes from the file: a leaf
    comes back as a tensor on the device of ``like``'s leaf where that is
    a tensor, else as a numpy array (a bfloat16 leaf as a CPU tensor:
    numpy has no bfloat16).  Raises ValueError if the file lacks a path
    of ``like``."""
    items = list(_items(like))
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        missing = {p for p, _ in items} - set(data.files)
        if missing:
            raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}")
        bf16 = set(data[BF16_KEY].tolist()) if BF16_KEY in data.files \
            else set()
        leaves = []
        for p, leaf in items:
            arr = data[p]
            if p in bf16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            elif isinstance(leaf, torch.Tensor):
                t = torch.from_numpy(np.array(arr))
            else:
                leaves.append(arr)
                continue
            leaves.append(t.to(leaf.device) if isinstance(leaf, torch.Tensor)
                          else t)
    return _rebuild(like, iter(leaves))
