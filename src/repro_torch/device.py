"""Device resolution for every entry point of the port.

An entry point runs on the card unless its caller asks for the CPU.
Asking for ``cuda`` on a machine without a card raises; nothing carries on
quietly on the CPU.  Importing this module also pins float32 matrix
products to full float32 (no TF32): the solver's objective
``x_t @ (sign * lam)`` and the duality gap's ``w @ x_t`` are compared
against float32 references.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on: ``cuda`` by default,
    ``cpu`` only when asked for (``meta``, shapes alone, when asked
    for: a model placed on a mesh is built there first).  Raises RuntimeError for ``cuda`` without
    a visible card and ValueError for any other device type."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev
