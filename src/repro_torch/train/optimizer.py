"""AdamW with the JAX package's mixed-precision discipline: the
counterpart of ``repro.train.optimizer``.

  * parameters in their own dtype (bfloat16 at full width: what the model
    computes with),
  * a float32 master copy of every parameter,
  * (m, v) in ``state_dtype`` (bfloat16 for the configs that ask for it).

The state is keyed by the model's parameter names (``named_parameters``).
The rules are the JAX package's, step for step: the global grad norm is
the square root of the sum over leaves of each float32 grad's sum of
squares, reported before clipping; clipping scales by ``min(1, clip /
(gnorm + 1e-9))`` when ``grad_clip > 0``; the warm-up takes the step count
from before the increment, the bias corrections the count after it;
weight decay goes into every leaf's master update (norms, router and
embeddings included); m and v are rounded to ``state_dtype`` after their
update, and the new parameters are the master cast to each parameter's
dtype.

``apply`` updates the state and the parameters in place, one leaf at a
time: no second copy of the model exists while it runs, only float32
temporaries of the leaf being updated.  The step count, the learning rate
and the clipping scale stay on the device, so a step reads nothing back
to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100


class OptState(NamedTuple):
    master: dict      # name -> float32 copy of the parameter (own storage)
    m: dict           # name -> first moment, in state_dtype
    v: dict           # name -> second moment, in state_dtype
    step: torch.Tensor   # () int32, steps taken


def named(params) -> dict:
    """A model's parameters by name, or ``params`` if already a dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init(params, cfg: AdamWConfig) -> OptState:
    """Zero moments and a float32 master of ``params`` (a module or a dict
    of tensors).  The master never shares storage with a parameter: a
    float32 parameter's ``.float()`` would be the parameter itself."""
    params = named(params)
    sd = getattr(torch, cfg.state_dtype)
    master = {n: p.detach().to(torch.float32, copy=True)
              for n, p in params.items()}
    device = next(iter(params.values())).device
    return OptState(master=master,
                    m={n: torch.zeros_like(p, dtype=sd)
                       for n, p in params.items()},
                    v={n: torch.zeros_like(p, dtype=sd)
                       for n, p in params.items()},
                    step=torch.zeros((), dtype=torch.int32, device=device))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return warm * cfg.lr


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each grad's float32 sum of squares,
    added leaf after leaf as the JAX package's Python ``sum`` does."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads))


@torch.no_grad()
def apply(grads, opt_state: OptState, params, cfg: AdamWConfig):
    """Returns (params, new_opt_state, grad_norm), as the JAX package's
    ``apply``; here the parameters, master and moments are updated in
    place and returned.  ``grads`` maps each parameter name to its grad
    (None counts as zeros)."""
    params = named(params)
    grads = {n: (torch.zeros_like(p) if grads.get(n) is None
                 else grads[n]) for n, p in params.items()}
    gnorm = global_norm(grads.values())
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    step = opt_state.step + 1
    lr = _schedule(cfg, opt_state.step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    for name, p in params.items():
        g32 = grads[name].float() * scale
        m, v, master = opt_state.m[name], opt_state.v[name], \
            opt_state.master[name]
        # m.float() is m itself for float32 moments: updated in place
        m32 = m.float().mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v32 = v.float().mul_(cfg.b2).add_(g32 * (1 - cfg.b2) * g32)
        update = (m32 / b1c).div_(torch.sqrt(v32 / b2c).add_(cfg.eps))
        master.sub_(lr * update.add_(master * cfg.weight_decay))
        if m.dtype != torch.float32:
            m.copy_(m32)
            v.copy_(v32)
        p.copy_(master)
    new_state = OptState(master=opt_state.master, m=opt_state.m,
                         v=opt_state.v, step=step)
    return params, new_state, gnorm
