"""State carried between the JAX package and the port.

The JAX package's NamedTuples (``Preprocessed``, ``SaddleState``,
``PackedState``, ...) reach this module as objects or dicts whose fields
are numpy arrays (or anything ``numpy.asarray`` reads, such as JAX
arrays) and python ints; :func:`to_port` builds the port's NamedTuple of
the same field names on a chosen device, and :func:`to_numpy` goes back.
This module imports neither JAX nor the JAX package.
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
