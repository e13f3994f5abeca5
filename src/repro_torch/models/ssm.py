"""Recurrent sequence mixers: the counterpart of ``repro.models.ssm``.

  * mLSTM  (xLSTM [arXiv:2405.04517]): matrix-memory LSTM.  A prompt runs
    the stabilised PARALLEL (quadratic) form in query chunks, and its
    final (C, n, m) state comes in closed form; decode is the O(1)
    recurrence.
  * sLSTM  (xLSTM): scalar-memory LSTM with exponential gating and a
    per-head recurrence; sequential by nature, so a prompt is a loop
    over its time steps (the JAX package's ``lax.scan``), decode one step.
  * RG-LRU (Griffin / RecurrentGemma [arXiv:2402.19427]): a gated linear
    recurrence h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (sigmoid(i_t) x_t); a
    prompt runs a log-depth inclusive scan in torch ops (the parallel
    form of the JAX package's ``associative_scan``, rounding in another
    order), decode one step.

Each block carries a depthwise causal conv where the source arch has
one; decode keeps its last ``width - 1`` inputs as history.  Weights keep
the JAX package's names and layouts (``w_up`` (D, 2 inner), ``wq`` (inner,
H, Dh), ``w_rec`` (H, Dh, 4 Dh), ``lam`` (W,) float32 even in a bfloat16
model, ...), so ``repro_torch.convert`` maps them one to one.

Caches (one dict a layer, every state float32; the conv history holds
the activations' values, which float32 stores exactly):

  RG-LRU  {h: (B, W), conv: (B, width - 1, W)}
  mLSTM   {state: {C: (B, H, Dh, Dh), n: (B, H, Dh), m: (B, H)},
           conv: (B, width - 1, inner)}
  sLSTM   {state: {c, n, h, m: (B, H, Dh)}}

m starts at -1e30.  A prompt (S > 1) fills an empty cache in place; a
decode step (S == 1) runs on the transformer's row-padded batch: the
rows after the cache's rows (its lanes) read a fresh state, and only the
lanes' state and history are written back.  All of it is
plain torch ops: the JAX package has no Pallas kernel here.

On a mesh of ranks (``models.sharding``; training, no cache) the JAX
package's specs place the weights and the port picks each mixer's compute
layout (GSPMD picks JAX's; the values are the same):

  mLSTM   ``w_up``'s column block a rank, gathered whole over ``model``
          (``copy_to`` of its ``all_gather``); the conv on every channel; q / k / v and the
          gates of this rank's heads; the cell and head norm per head;
          ``w_down``'s rows of those heads, the ranks' sums added.
  sLSTM   the gates and the recurrence of this rank's heads, ``w_rec``
          gathered whole once a block (never inside the time loop); the
          hidden state gathered whole, ``w_in``'s column block gathered
          whole for the GeGLU, ``w_out``'s rows of this rank's units.
  RG-LRU  ``w_in``'s columns give each rank its channels: the conv, the
          gates and the scan on them (``xc`` gathered whole for the gates'
          products), ``w_out``'s rows of them, the ranks' sums added.

Where a dim does not divide ``model`` it stays whole and every rank runs
it alike.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharding as shd
from repro_torch.models.layers import (RMSNorm, empty_param, matmul,
                                      normal_, zeros_param)

M_INIT = -1e30          # the stabiliser m of a fresh state
RGLRU_C = 8.0


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsi,i...->bs...", x, w)``: x (B, S, I) through a weight
    (I, ...)."""
    b, s, _ = x.shape
    return matmul(x, w.reshape(w.shape[0], -1)).reshape(
        (b, s) + w.shape[1:])


def _rows(t: torch.Tensor, rows: int, fill: float = 0.0) -> torch.Tensor:
    """A cache tensor of n lanes extended to ``rows`` rows of fresh state
    (``fill``), for a decode on the row-padded batch."""
    n = t.shape[0]
    if rows == n:
        return t
    return torch.cat([t, t.new_full((rows - n,) + t.shape[1:], fill)])


def _up_whole(x: torch.Tensor, w: torch.Tensor, partial: bool):
    """``x @ w`` whole on every rank of ``model``: where ``w``'s columns
    split over ``model``, this rank's block gathered (``x`` entering through
    ``copy_to``).  ``partial``: each rank then uses only its own part of the
    product, so its grad is summed over ``model``."""
    if shd.split(w, 1):
        y = matmul(shd.copy_to(x), shd.param(w))
        y = shd.all_gather(y, "model", -1)
        return shd.copy_to(y) if partial else y
    y = matmul(x, shd.param(w))
    return shd.copy_to(y) if partial else y


def _shared(p: torch.Tensor, partial: bool) -> torch.Tensor:
    """A parameter whole over ``model`` in its compute layout; ``partial``:
    used on this rank's part of an activation, its grad summed over
    ``model`` too."""
    w = shd.param(p)
    return shd.copy_to(w) if partial else w


def _write_state(dst: dict, src: dict) -> None:
    """The first ``len(dst)`` rows of each ``src`` state into ``dst``, in
    place."""
    for name, t in dst.items():
        t.copy_(src[name][:t.shape[0]])


# ----------------------------------------------------------- causal conv1d
def causal_conv1d(w: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                  buf: torch.Tensor | None = None):
    """Depthwise causal conv of x (B, S, C) with taps w (W, C); ``buf``
    (B, W - 1, C) is the history before x (None: zeros).  Returns (y,
    the last W - 1 inputs)."""
    width, s = w.shape[0], x.shape[1]
    if buf is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([buf.to(x.dtype), x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i]
    y = y + bias
    return y, (xp[:, -(width - 1):] if width > 1 else buf)


class CausalConv1d(nn.Module):
    """``init_conv1d``: taps ``w`` (width, C), bias ``b`` (C,) zeros; the
    mixers apply them (``causal_conv1d``) in their own layout on a mesh."""

    def __init__(self, width: int, channels: int, cfg, device):
        super().__init__()
        self.w = empty_param((width, channels), cfg, device)
        self.b = zeros_param((channels,), cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.w, 1.0 / math.sqrt(shd.full_shape(self.w)[0]),
                generator)


def _conv_history(cache, rows: int):
    """The conv history a block reads: none without a cache, the cache's
    for a prompt, padded to ``rows`` rows for a decode step."""
    if cache is None:
        return None
    return _rows(cache["conv"], rows)


# ================================================================== mLSTM
def mlstm_parallel(q, k, v, i_pre, f_pre, chunk: int = 1024):
    """Stabilised parallel mLSTM.  q, k, v: (B, S, H, Dh); gates (B, S,
    H).  Queries run in chunks of ``chunk``, the last padded."""
    b, s, h, dh = q.shape
    logf = F.logsigmoid(f_pre.float())                      # (B, S, H)
    cumf = torch.cumsum(logf, dim=1)                        # F_t
    i32 = i_pre.float()
    m = cumf + torch.cummax(i32 - cumf, dim=1).values       # (B, S, H)
    scale = 1.0 / math.sqrt(dh)
    chunk = min(chunk, s)
    pad = (-s) % chunk
    qh = F.pad(q, (0, 0, 0, 0, 0, pad)).float().permute(0, 2, 1, 3)
    cumf_q = F.pad(cumf, (0, 0, 0, pad)).transpose(1, 2)    # (B, H, Sq)
    m_q = F.pad(m, (0, 0, 0, pad), value=1.0).transpose(1, 2)
    cumf_k, i_k = cumf.transpose(1, 2), i32.transpose(1, 2)  # (B, H, S)
    kf = k.float().permute(0, 2, 3, 1)                      # (B, H, Dh, S)
    vt = v.permute(0, 2, 1, 3)                              # (B, H, S, Dh)
    t_pos = torch.arange(s, device=q.device)
    out = []
    for c0 in range(0, s + pad, chunk):
        ff = cumf_q[:, :, c0:c0 + chunk, None]              # (B, H, C, 1)
        mm = m_q[:, :, c0:c0 + chunk]
        dmat = (ff - cumf_k[:, :, None, :] + i_k[:, :, None, :]
                - mm[..., None])                            # (B, H, C, S)
        q_pos = torch.arange(c0, c0 + chunk, device=q.device)
        dmat = torch.where(t_pos[None, :] <= q_pos[:, None], dmat,
                           -math.inf)
        sd = (qh[:, :, c0:c0 + chunk] @ kf) * scale * torch.exp(dmat)
        denom = torch.maximum(sd.sum(-1).abs(), torch.exp(-mm)) + 1e-6
        out.append((sd / denom[..., None]).to(v.dtype) @ vt)
    return torch.cat(out, dim=2).transpose(1, 2)[:, :s]    # (B, S, H, Dh)


def mlstm_recurrent(q, k, v, i_pre, f_pre, state: dict):
    """One recurrent mLSTM step.  q, k, v: (B, 1, H, Dh); state {C, n, m}.
    Returns (out (B, 1, H, Dh), new state)."""
    dh = q.shape[-1]
    qq, kk, vv = q[:, 0], k[:, 0], v[:, 0]
    i_t = i_pre[:, 0].float()
    logf = F.logsigmoid(f_pre[:, 0].float())
    m_new = torch.maximum(logf + state["m"], i_t)
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(logf + state["m"] - m_new)
    c = (f_s[..., None, None] * state["C"]
         + i_s[..., None, None] * kk[..., :, None] * vv[..., None, :])
    n = f_s[..., None] * state["n"] + i_s[..., None] * kk
    qs = (qq * (1.0 / math.sqrt(dh))).float()
    num = (qs[..., None, :] @ c)[..., 0, :]                 # (B, H, Dh)
    den = torch.maximum((qs * n).sum(-1).abs(), torch.exp(-m_new)) + 1e-6
    out = (num / den[..., None]).to(v.dtype)[:, None]
    return out, {"C": c, "n": n, "m": m_new}


def mlstm_final_state(k, v, i_pre, f_pre) -> dict:
    """Closed-form (C, n, m) after a whole prompt, the sums the recurrence
    accumulates step by step:
      m_T = F_T + max_s (i_s - F_s)
      C_T = sum_s exp(F_T - F_s + i_s - m_T) k_s v_s^T."""
    logf = F.logsigmoid(f_pre.float())
    cumf = torch.cumsum(logf, dim=1)
    f_total = cumf[:, -1]                                   # (B, H)
    src = i_pre.float() - cumf                              # (B, S, H)
    m = f_total + src.max(dim=1).values
    wk = torch.exp(f_total[:, None] + src - m[:, None])[..., None] * k.float()
    c = wk.permute(0, 2, 3, 1) @ v.float().permute(0, 2, 1, 3)
    return {"C": c, "n": wk.sum(dim=1), "m": m}


class MLSTM(nn.Module):
    """mLSTM block (``init_mlstm`` / ``mlstm_block``): up-projection to
    2 inner, causal conv and SiLU on the q / k / gate branch, the cell,
    a per-head norm, an output gate SiLU(z), the down-projection."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.num_heads
        inner = int(d * cfg.mlstm_proj_factor)
        dh = inner // h
        self.w_up = empty_param((d, 2 * inner), cfg, device)
        self.conv = CausalConv1d(cfg.conv1d_width, inner, cfg, device)
        self.wq = empty_param((inner, h, dh), cfg, device)
        self.wk = empty_param((inner, h, dh), cfg, device)
        self.wv = empty_param((inner, h, dh), cfg, device)
        self.w_gates = empty_param((inner, h, 2), cfg, device)
        self.head_norm = RMSNorm(dh, cfg, device)
        self.w_down = empty_param((inner, d), cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        inner, d = shd.full_shape(self.w_down)
        normal_(self.w_up, 1.0 / math.sqrt(d), generator)
        self.conv.reset_parameters(generator)
        for w in (self.wq, self.wk, self.wv, self.w_gates, self.w_down):
            normal_(w, 1.0 / math.sqrt(inner), generator)

    def forward(self, x, cache=None):
        """On a mesh (no cache) this rank's heads: module docstring."""
        b, s, _ = x.shape
        split = shd.split(self.wq, 1)
        if split != shd.split(self.w_down, 0):
            raise NotImplementedError("mLSTM: heads and w_down's rows split "
                                      "unlike over model")
        up = _up_whole(x, self.w_up, split)
        inner = up.shape[-1] // 2
        x_in, z = up[..., :inner], up[..., inner:]
        xc, new_buf = causal_conv1d(_shared(self.conv.w, split),
                                    _shared(self.conv.b, split), x_in,
                                    _conv_history(cache, b))
        xc = F.silu(xc)
        q = _project(xc, shd.param(self.wq))
        k = _project(xc, shd.param(self.wk))
        v = _project(x_in, shd.param(self.wv))
        gates = _project(xc, shd.param(self.w_gates))
        i_pre, f_pre = gates[..., 0], gates[..., 1]
        if cache is None or s > 1:
            out = mlstm_parallel(q, k, v, i_pre, f_pre)
            if cache is not None:
                _write_state(cache["state"],
                             mlstm_final_state(k, v, i_pre, f_pre))
        else:
            st = {name: _rows(t, b, M_INIT if name == "m" else 0.0)
                  for name, t in cache["state"].items()}
            out, st = mlstm_recurrent(q, k, v, i_pre, f_pre, st)
            _write_state(cache["state"], st)
        if cache is not None:
            cache["conv"].copy_(new_buf[:cache["conv"].shape[0]])
        hl, dh = q.shape[2:]
        c0 = shd.offset(self.wq, 1) * dh
        out = self.head_norm(out, partial=split).reshape(b, s, hl * dh)
        out = matmul(out * F.silu(z[..., c0:c0 + hl * dh]),
                     shd.param(self.w_down))
        return shd.reduce_from(out) if split else out


def init_mlstm_cache(cfg, batch: int, device=None) -> dict:
    inner = int(cfg.d_model * cfg.mlstm_proj_factor)
    h = cfg.num_heads
    dh = inner // h
    kw = dict(dtype=torch.float32, device=device)
    return {"state": {"C": torch.zeros((batch, h, dh, dh), **kw),
                      "n": torch.zeros((batch, h, dh), **kw),
                      "m": torch.full((batch, h), M_INIT, **kw)},
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, inner), **kw)}


# ================================================================== sLSTM
def slstm_cell(pre, state: dict, dh: int) -> dict:
    """pre: (B, H, 4 Dh) gate pre-activations (i, f, z, o; the input part
    plus R h); state {c, n, h, m}, each (B, H, Dh)."""
    # one float32 cast of all four gates (exact), then views
    i_pre, f_pre, z_pre, o_pre = pre.float().split(dh, dim=-1)
    logf_m = F.logsigmoid(f_pre) + state["m"]
    m_new = torch.maximum(logf_m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(logf_m - m_new)
    c = f_s * state["c"] + i_s * torch.tanh(z_pre)
    n = f_s * state["n"] + i_s
    hid = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": hid, "m": m_new}


class SLSTM(nn.Module):
    """sLSTM block (``init_slstm`` / ``slstm_block``): input gates
    ``w_x``, the per-head recurrence ``w_rec``, a per-head norm, a GeGLU
    up-projection ``w_in`` and ``w_out``."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.num_heads
        dh = d // h
        up = int(d * cfg.slstm_proj_factor)
        self.w_x = empty_param((d, h, 4 * dh), cfg, device)
        self.w_rec = empty_param((h, dh, 4 * dh), cfg, device)
        self.head_norm = RMSNorm(dh, cfg, device)
        self.w_in = empty_param((d, 2 * up), cfg, device)
        self.w_out = empty_param((up, d), cfg, device)

    def whole_params(self) -> dict:
        """``w_rec``, gathered whole once a block (``sharding.gathered``),
        of which each rank takes its own heads where they split."""
        return {"w_rec": shd.split(self.w_x, 1)}

    def reset_parameters(self, generator: torch.Generator) -> None:
        d = shd.full_shape(self.w_x)[0]
        dh = shd.full_shape(self.w_rec)[1]
        up = shd.full_shape(self.w_out)[0]
        normal_(self.w_x, 1.0 / math.sqrt(d), generator)
        normal_(self.w_rec, 1.0 / math.sqrt(dh), generator)
        normal_(self.w_in, 1.0 / math.sqrt(d), generator)
        normal_(self.w_out, 1.0 / math.sqrt(up), generator)

    def forward(self, x, cache=None):
        """No cache: from a fresh state; a prompt: from the cache's state;
        a decode step: one step on the row-padded batch."""
        b, s, d = x.shape
        split = shd.split(self.w_x, 1)
        pre_x = _project(shd.copy_to(x) if split else x,
                         shd.param(self.w_x))              # (B, S, H, 4 Dh)
        h = pre_x.shape[2]                                  # this rank's heads
        w_rec = shd.param_whole(self.w_rec, split)
        h0 = shd.offset(self.w_x, 1)
        w_rec = w_rec[h0:h0 + h]
        dh = w_rec.shape[1]
        if cache is None:
            st = slstm_state(b, h, dh, x.device)
        else:
            st = {name: _rows(t, b, M_INIT if name == "m" else 0.0)
                  for name, t in cache["state"].items()}
        hidden = []
        for t in range(s):
            rec = torch.matmul(st["h"].to(pre_x.dtype).transpose(0, 1),
                               w_rec).transpose(0, 1)       # (B, H, 4 Dh)
            st = slstm_cell(pre_x[:, t] + rec, st, dh)
            hidden.append(st["h"])
        if cache is not None:
            _write_state(cache["state"], st)
        hid = self.head_norm(torch.stack(hidden, dim=1).to(x.dtype),
                             partial=split).reshape(b, s, h * dh)
        if split:
            hid = shd.all_gather(hid, "model", -1)
        out_split = shd.split(self.w_out, 0)
        up = _up_whole(hid, self.w_in, out_split)
        half = up.shape[-1] // 2
        out = F.gelu(up[..., :half], approximate="tanh") * up[..., half:]
        w_out = shd.param(self.w_out)
        if out_split:
            r0 = shd.offset(self.w_out, 0)
            out = out[..., r0:r0 + w_out.shape[0]]
        out = matmul(out, w_out)
        return shd.reduce_from(out) if out_split else out


def slstm_state(batch: int, h: int, dh: int, device=None) -> dict:
    kw = dict(dtype=torch.float32, device=device)
    st = {name: torch.zeros((batch, h, dh), **kw) for name in ("c", "n", "h")}
    st["m"] = torch.full((batch, h, dh), M_INIT, **kw)
    return st


def init_slstm_cache(cfg, batch: int, device=None) -> dict:
    h = cfg.num_heads
    return {"state": slstm_state(batch, h, cfg.d_model // h, device)}


# ================================================================= RG-LRU
def rglru_gates(x, r, i, lam):
    """(a, sqrt(1 - a^2) sigmoid(i) x) of the recurrence, float32."""
    a = torch.exp(-RGLRU_C * F.softplus(lam) * torch.sigmoid(r.float()))
    gated = (torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
             * torch.sigmoid(i.float()) * x.float())
    return a, gated


def rglru_scan(x, r, i, lam) -> torch.Tensor:
    """h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (sigmoid(i_t) x_t) from h = 0
    over (B, S, W): a log-depth inclusive scan of the pairs (a, b) under
    (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), ceil(log2 S) rounds."""
    a, h = rglru_gates(x, r, i, lam)
    s, d = h.shape[1], 1
    while d < s:
        h = torch.cat([h[:, :d], a[:, d:] * h[:, :-d] + h[:, d:]], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return h


class RGLRU(nn.Module):
    """RG-LRU mixer (``init_rglru`` / ``rglru_block``): a GeLU gate branch,
    the input branch through a causal conv, recurrence and input gates
    ``w_r`` / ``w_i``, the scan, the output projection.  ``lam`` is float32
    in every model and is ``linspace(-4, -1, W)``, never a draw."""

    def __init__(self, cfg, device):
        super().__init__()
        d = cfg.d_model
        w = cfg.rglru_width or d
        self.w_in = empty_param((d, w), cfg, device)
        self.w_gate_branch = empty_param((d, w), cfg, device)
        self.conv = CausalConv1d(cfg.conv1d_width, w, cfg, device)
        self.w_r = empty_param((w, w), cfg, device)
        self.w_i = empty_param((w, w), cfg, device)
        self.lam = nn.Parameter(torch.linspace(-4.0, -1.0, w,
                                               dtype=torch.float32,
                                               device=device),
                                requires_grad=False)
        self.w_out = empty_param((w, d), cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, w = shd.full_shape(self.w_in)
        normal_(self.w_in, 1.0 / math.sqrt(d), generator)
        normal_(self.w_gate_branch, 1.0 / math.sqrt(d), generator)
        self.conv.reset_parameters(generator)
        for p in (self.w_r, self.w_i, self.w_out):
            normal_(p, 1.0 / math.sqrt(w), generator)
        # lam is no draw: a placed (zero) block gets its part of the line
        lam = torch.linspace(-4.0, -1.0, w, dtype=torch.float32,
                             device=self.lam.device)
        block = getattr(self.lam, "block", None)
        with torch.no_grad():
            self.lam.copy_(lam if block is None else lam[block])

    def forward(self, x, cache=None):
        """On a mesh (no cache) this rank's channels: module docstring."""
        b, s, _ = x.shape
        split = shd.split(self.w_in, 1)
        if split != shd.split(self.w_out, 0):
            raise NotImplementedError("RG-LRU: w_in's columns and w_out's "
                                      "rows split unlike over model")

        def own(p, dim):    # this rank's channels of a whole parameter
            w = shd.param(p)
            return shd.own_block(w, dim) if split else w

        if split:
            x = shd.copy_to(x)
        branch = F.gelu(matmul(x, own(self.w_gate_branch, 1)),
                        approximate="tanh")
        xc, new_buf = causal_conv1d(own(self.conv.w, 1), own(self.conv.b, 0),
                                    matmul(x, shd.param(self.w_in)),
                                    _conv_history(cache, b))
        xw = shd.copy_to(shd.all_gather(xc, "model", -1)) if split else xc
        r, i = matmul(xw, own(self.w_r, 1)), matmul(xw, own(self.w_i, 1))
        lam = own(self.lam, 0)
        if cache is None or s > 1:
            h = rglru_scan(xc, r, i, lam)
            if cache is not None:
                cache["h"].copy_(h[:, -1])
        else:
            a, gated = rglru_gates(xc[:, 0], r[:, 0], i[:, 0], lam)
            h_new = a * _rows(cache["h"], b) + gated
            cache["h"].copy_(h_new[:cache["h"].shape[0]])
            h = h_new[:, None]
        if cache is not None:
            cache["conv"].copy_(new_buf[:cache["conv"].shape[0]])
        out = matmul(h.to(x.dtype) * branch, shd.param(self.w_out))
        return shd.reduce_from(out) if split else out


def init_rglru_cache(cfg, batch: int, device=None) -> dict:
    w = cfg.rglru_width or cfg.d_model
    kw = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, w), **kw),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), **kw)}
