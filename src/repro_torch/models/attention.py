"""Attention: grouped-query attention with full, sliding-window and
ring-buffer KV caches, and DeepSeek-V2's multi-head latent attention (MLA)
with its compressed cache and absorbed decode: ``repro.models.attention``.

Training and prefill attention is query-chunked (``_pick_chunk``: exact,
a row softmax a chunk), so a long prompt never holds an S x S score
tensor; decode is one query row against the cache.  The score product is
float32 (the JAX package's ``preferred_element_type``), the softmax is
float32 and is cast to the values' dtype before the value product, all
as plain torch matmuls: no library attention kernel.

Caches (one dict a layer; the stack's shared ``index`` lives beside
them, ``repro_torch.models.transformer.init_stack_cache``):

  full    {k, v: (B, KV, T_max, Dh)}
  window  {k, v: (B, KV, W, Dh), pos: (B, W)}      (ring buffer)
  MLA     {c_kv: (B, T_max, kv_lora), k_rope: (B, T_max, rope)}

K and V are stored in the cache's dtype (bfloat16 by default, even under
float32 parameters), cast where the JAX package casts them.  Every batch
row has its own index and position, so the same code serves a batch that
decodes in step (``serve.engine.generate``) and S lanes at different
depths (``serve.engine.decode_chunk_slots``).

Decode is batch-invariant: every row's bits are those of the same row
decoded alone.  The projections run on the row-padded batch the
transformer hands in (``transformer.decode_rows``), and the score and
value products run one row at a time, at the shapes of a batch of one,
so that no library's choice of algorithm for a batch size reaches a
row's result.  Everything else is elementwise or a row-wise softmax.
MLA's absorbed decode keeps the same split: its head products (q through
``wkv_b_k``, the context through ``wkv_b_v``) run on the padded batch, its
products against the compressed cache one row at a time.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import (RMSNorm, apply_rope, empty_param,
                                      matmul, normal_)

NEG_INF = -2.0 ** 30


def _pick_chunk(sq: int, t: int) -> int:
    if sq <= 1024:
        return sq
    return 256 if t >= 16384 else 1024


def dot_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                  chunk: int | None = None):
    """Exact chunked attention.

    q: (B, Sq, H, Dh); k, v: (B, T, KV, Dh); q_pos: (Sq,), k_pos: (T,).
    k_pos entries < 0 are invalid (empty ring-buffer slots)."""
    b, sq, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(dh)
    chunk = min(chunk or _pick_chunk(sq, t), sq)
    kf = k.float().permute(0, 2, 3, 1)[:, :, None]      # (B, KV, 1, Dh, T)
    vt = v.permute(0, 2, 1, 3)[:, :, None]              # (B, KV, 1, T, Dh)
    qg = q.float().reshape(b, sq, kv, g, dh).permute(0, 2, 3, 1, 4)
    out = []
    for c0 in range(0, sq, chunk):
        qpc = q_pos[c0:c0 + chunk]
        scores = (qg[:, :, :, c0:c0 + chunk] @ kf) * scale  # (B,KV,G,C,T)
        mask = k_pos[None, :] >= 0
        if causal:
            mask = mask & (k_pos[None, :] <= qpc[:, None])
        if window > 0:
            mask = mask & (k_pos[None, :] > qpc[:, None] - window)
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out.append(probs @ vt)                              # (B,KV,G,C,Dh)
    o = torch.cat(out, dim=3).permute(0, 3, 1, 2, 4)
    return o.reshape(b, sq, h, v.shape[-1])


def decode_attention(q, k_cache, v_cache, valid):
    """One query row per batch row against its own cache.

    q: (B, H, Dh); caches (B, KV, T, Dh); valid (B, T) bool.  The two
    products run row by row at a batch of one (batch-invariant, see the
    module docstring); the scale, mask and softmax run on all rows."""
    b, kv, t, dh = k_cache.shape
    h = q.shape[1]
    qf = q.float().reshape(b, kv, h // kv, dh)
    kf = k_cache.float().transpose(-1, -2)                  # (B, KV, Dh, T)
    scores = torch.empty((b, kv, h // kv, t), dtype=torch.float32,
                         device=q.device)
    for r in range(b):
        torch.matmul(qf[r], kf[r], out=scores[r])
    scores = scores * (1.0 / math.sqrt(dh))
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.empty((b, kv, h // kv, v_cache.shape[-1]),
                      dtype=v_cache.dtype, device=q.device)
    for r in range(b):
        torch.matmul(probs[r], v_cache[r], out=out[r])
    return out.reshape(b, h, v_cache.shape[-1])


class GQAttention(nn.Module):
    """Self-attention with ``num_kv_heads`` shared K/V heads.  Weights
    keep the JAX layouts: wq (D, H, Dh), wk / wv (D, KV, Dh), wo
    (H, Dh, D)."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        d, h, kv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim)
        self.wq = empty_param((d, h, dh), cfg, device)
        self.wk = empty_param((d, kv, dh), cfg, device)
        self.wv = empty_param((d, kv, dh), cfg, device)
        self.wo = empty_param((h, dh, d), cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.cfg.d_model
        h, dh = self.wo.shape[:2]
        for w in (self.wq, self.wk, self.wv):
            normal_(w, 1.0 / math.sqrt(d), generator)
        normal_(self.wo, 1.0 / math.sqrt(h * dh), generator)

    def _project(self, x, w):
        b, s, d = x.shape
        return matmul(x.reshape(b * s, d), w.reshape(d, -1)).reshape(
            b, s, w.shape[1], w.shape[2])

    def forward(self, x, *, positions, rope, window: int = 0, cache=None,
                index=None, lanes: int | None = None):
        """Returns the (B, S, D) output; a given cache is written in place.

        positions: (B, S); rope: their ``layers.rope_tables``.  Three
        regimes, as in the JAX package: no cache
        (causal over the input); a prefill (S > 1) into an EMPTY cache,
        attending within the prompt and writing K/V from slot 0 (the ring
        keeps the last window, rolled so that slot == pos % W); a decode
        (S == 1), where row r writes at its own ``index[r]`` and attends
        to its own cache.  ``lanes``: in a decode, the first ``lanes``
        rows own a cache row each; the rows after them are padding
        (zero output)."""
        b, s, _ = x.shape
        q = apply_rope(self._project(x, self.wq), *rope)
        k = apply_rope(self._project(x, self.wk), *rope)
        v = self._project(x, self.wv)
        if cache is None or s > 1:
            q_pos = positions[0]
            out = dot_attention(q, k, v, q_pos, q_pos, causal=True,
                                window=window)
            if cache is not None:
                _prefill_write(cache, k, v, q_pos)
        else:
            n = b if lanes is None else lanes
            out = torch.zeros((b, 1) + q.shape[2:], dtype=cache["v"].dtype,
                              device=x.device)
            valid = _decode_write(cache, k[:n, 0], v[:n, 0], index,
                                  positions[:n, 0], window)
            out[:n, 0] = decode_attention(q[:n, 0], cache["k"], cache["v"],
                                          valid)
        h, dh, d = self.wo.shape
        return matmul(out.reshape(b * s, h * dh),
                      self.wo.reshape(h * dh, d)).reshape(b, s, d)


def _prefill_write(cache, k, v, q_pos) -> None:
    """K/V of a prompt (B, S, KV, Dh) into an empty cache, cast to the
    cache's dtype."""
    s = k.shape[1]
    k = k.to(cache["k"].dtype).transpose(1, 2)              # (B, KV, S, Dh)
    v = v.to(cache["v"].dtype).transpose(1, 2)
    w = cache["k"].shape[2]
    if "pos" in cache and s >= w:
        # keep the last window, laid out so slot == pos % w (the decode
        # ring invariant: the write at index % w evicts the oldest entry)
        shift = s % w
        cache["k"].copy_(torch.roll(k[:, :, -w:], shift, dims=2))
        cache["v"].copy_(torch.roll(v[:, :, -w:], shift, dims=2))
        cache["pos"].copy_(torch.roll(q_pos[-w:], shift, dims=0))
        return
    if s > w:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{w} positions")
    cache["k"][:, :, :s] = k
    cache["v"][:, :, :s] = v
    if "pos" in cache:
        cache["pos"][:, :s] = q_pos


def _full_slot(index, t: int):
    """Each row's write slot in a full cache of ``t`` positions, and the
    (B, T) positions its query may see (-1 where not yet written).  A lane
    decoding past its capacity (frozen, its tokens unread) overwrites the
    last slot, as a clamped dynamic_update_slice does."""
    k_pos = torch.arange(t, device=index.device)[None, :]
    return (index.clamp(max=t - 1),
            torch.where(k_pos < (index + 1)[:, None], k_pos, -1))


def _decode_write(cache, k, v, index, q_pos, window: int):
    """Row r's K/V (KV, Dh) at its own index (ring: slot index % W); the
    (B, T) mask of the keys row r may attend to."""
    b, _, t, _ = cache["k"].shape
    rows = torch.arange(b, device=k.device)
    if "pos" in cache:
        slot = index % t
        cache["pos"][rows, slot] = q_pos.to(cache["pos"].dtype)
        k_pos = cache["pos"]
    else:
        slot, k_pos = _full_slot(index, t)
    cache["k"][rows, :, slot] = k.to(cache["k"].dtype)
    cache["v"][rows, :, slot] = v.to(cache["v"].dtype)
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window > 0:
        valid = valid & (k_pos > q_pos[:, None] - window)
    return valid


def init_gqa_cache(cfg, batch: int, t_max: int, *, window: int = 0,
                   dtype=torch.bfloat16, device=None) -> dict:
    kv, dh = cfg.num_kv_heads, cfg.head_dim
    t = min(window, t_max) if window > 0 else t_max
    cache = {"k": torch.zeros((batch, kv, t, dh), dtype=dtype, device=device),
             "v": torch.zeros((batch, kv, t, dh), dtype=dtype, device=device)}
    if window > 0:
        cache["pos"] = torch.full((batch, t), -1, dtype=torch.int32,
                                  device=device)
    return cache


# ------------------------------------------------------------------- MLA
class MLAttention(nn.Module):
    """DeepSeek-V2 multi-head latent attention (``init_mla`` /
    ``mla_attention``).  Weights keep the JAX layouts: wq (D, H, nope +
    rope), or wq_a (D, q_lora), q_norm, wq_b (q_lora, H, nope + rope);
    wkv_a (D, kv_lora + rope), kv_norm, wkv_b_k (kv_lora, H, nope),
    wkv_b_v (kv_lora, H, v), wo (H, v, D).  ``cfg.head_dim`` is the
    no-rope width; only ``cfg.mla_rope_dim`` dims of q and the one shared
    ``k_rope`` rotate (the ``rope`` tables a forward hands in are of that
    width)."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.num_heads
        nope, rope = cfg.head_dim, cfg.mla_rope_dim
        vd = cfg.mla_v_dim or cfg.head_dim
        lora = cfg.mla_kv_lora
        self.wkv_a = empty_param((d, lora + rope), cfg, device)
        self.wkv_b_k = empty_param((lora, h, nope), cfg, device)
        self.wkv_b_v = empty_param((lora, h, vd), cfg, device)
        self.wo = empty_param((h, vd, d), cfg, device)
        self.kv_norm = RMSNorm(lora, cfg, device)
        if cfg.mla_q_lora:
            self.wq_a = empty_param((d, cfg.mla_q_lora), cfg, device)
            self.wq_b = empty_param((cfg.mla_q_lora, h, nope + rope), cfg,
                                    device)
            self.q_norm = RMSNorm(cfg.mla_q_lora, cfg, device)
        else:
            self.wq = empty_param((d, h, nope + rope), cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        d, lora = cfg.d_model, cfg.mla_kv_lora
        h, vd = self.wo.shape[:2]
        normal_(self.wkv_a, 1.0 / math.sqrt(d), generator)
        normal_(self.wkv_b_k, 1.0 / math.sqrt(lora), generator)
        normal_(self.wkv_b_v, 1.0 / math.sqrt(lora), generator)
        normal_(self.wo, 1.0 / math.sqrt(h * vd), generator)
        if cfg.mla_q_lora:
            normal_(self.wq_a, 1.0 / math.sqrt(d), generator)
            normal_(self.wq_b, 1.0 / math.sqrt(cfg.mla_q_lora), generator)
        else:
            normal_(self.wq, 1.0 / math.sqrt(d), generator)

    def _query(self, x):
        """``_mla_q``: (B, S, H, nope + rope)."""
        b, s, _ = x.shape
        if self.cfg.mla_q_lora:
            x = self.q_norm(matmul(x, self.wq_a))
            w = self.wq_b
        else:
            w = self.wq
        return matmul(x, w.reshape(w.shape[0], -1)).reshape(
            b, s, w.shape[1], w.shape[2])

    def forward(self, x, *, positions, rope, cache=None, index=None,
                lanes: int | None = None):
        """Returns the (B, S, D) output; a given cache is written in place.

        The regimes of ``GQAttention.forward``: no cache and a prefill
        (S > 1, into an empty cache) run the EXPANDED path, K and V
        decompressed from the latent and exact causal attention at scale
        1/sqrt(nope + rope); a decode (S == 1) runs the ABSORBED path,
        q_nope through ``wkv_b_k`` once, then scores and context directly
        against the compressed cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        nope, lora = cfg.head_dim, cfg.mla_kv_lora
        q = self._query(x)
        q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], *rope)
        ckv = matmul(x, self.wkv_a)                         # (B, S, lora+rope)
        c_kv = self.kv_norm(ckv[..., :lora])
        k_rope = apply_rope(ckv[..., None, lora:], *rope)[:, :, 0]
        scale = 1.0 / math.sqrt(nope + cfg.mla_rope_dim)
        h, vd, d = self.wo.shape
        if cache is None or s > 1:
            k_nope = matmul(c_kv, self.wkv_b_k.reshape(lora, -1)).reshape(
                b, s, h, nope)
            v = matmul(c_kv, self.wkv_b_v.reshape(lora, -1)).reshape(
                b, s, h, vd)
            k = torch.cat([k_nope, k_rope[:, :, None].expand(
                b, s, h, k_rope.shape[-1])], dim=-1)
            q_pos = positions[0]
            out = dot_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                                q_pos, q_pos, causal=True, window=0)
            if cache is not None:
                t = cache["c_kv"].shape[1]
                if s > t:
                    raise ValueError(f"a prompt of {s} tokens does not fit "
                                     f"a cache of {t} positions")
                cache["c_kv"][:, :s] = c_kv.to(cache["c_kv"].dtype)
                cache["k_rope"][:, :s] = k_rope.to(cache["k_rope"].dtype)
        else:
            n = b if lanes is None else lanes
            rows = torch.arange(n, device=x.device)
            slot, k_pos = _full_slot(index, cache["c_kv"].shape[1])
            cache["c_kv"][rows, slot] = c_kv[:n, 0].to(cache["c_kv"].dtype)
            cache["k_rope"][rows, slot] = k_rope[:n, 0].to(
                cache["k_rope"].dtype)
            valid = (k_pos >= 0) & (k_pos <= positions[:n, 0, None])
            # q_abs (H, B, lora): every row, at the padded batch's shape
            q_abs = matmul(q_nope[:, 0].transpose(0, 1),
                           self.wkv_b_k.permute(1, 2, 0))
            ctx = torch.zeros((h, b, lora), dtype=torch.promote_types(
                c_kv.dtype, cache["c_kv"].dtype), device=x.device)
            ctx[:, :n] = absorbed_attention(
                q_abs[:, :n].transpose(0, 1), q_rope[:n, 0], cache, valid,
                scale, c_kv.dtype).transpose(0, 1)
            out = matmul(ctx, self.wkv_b_v.transpose(0, 1)).transpose(
                0, 1)[:, None]                              # (B, 1, H, vd)
        return matmul(out.reshape(b * s, h * vd),
                      self.wo.reshape(h * vd, d)).reshape(b, s, d)


def absorbed_attention(q_abs, q_rope, cache, valid, scale: float,
                       probs_dtype):
    """The absorbed decode against an MLA cache, one query row a batch
    row: q_abs (B, H, lora), q_rope (B, H, rope), valid (B, T) ->
    context (B, H, lora).

    Scores are float32 products of the operands cast to float32 (the JAX
    package's ``preferred_element_type``; TF32 is off), ``q_abs . c_kv``
    plus ``q_rope . k_rope``, then scaled, masked and softmaxed; the
    probabilities are cast to ``probs_dtype`` (the latent's) and the
    context is their product with ``c_kv`` in the promoted dtype.  The
    cache products run row by row at a batch of one (the module
    docstring)."""
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    b, t, lora = c_kv.shape
    h = q_abs.shape[1]
    ck = c_kv.float().transpose(1, 2)                       # (B, lora, T)
    kr = k_rope.float().transpose(1, 2)                     # (B, rope, T)
    qa, qr = q_abs.float(), q_rope.float()
    s_lat = torch.empty((b, h, t), dtype=torch.float32, device=q_abs.device)
    s_rope = torch.empty_like(s_lat)
    for r in range(b):
        torch.matmul(qa[r], ck[r], out=s_lat[r])
        torch.matmul(qr[r], kr[r], out=s_rope[r])
    scores = (s_lat + s_rope) * scale
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(probs_dtype)
    dt = torch.promote_types(probs_dtype, c_kv.dtype)
    probs, cv = probs.to(dt), c_kv.to(dt)
    ctx = torch.empty((b, h, lora), dtype=dt, device=q_abs.device)
    for r in range(b):
        torch.matmul(probs[r], cv[r], out=ctx[r])
    return ctx


def init_mla_cache(cfg, batch: int, t_max: int, *, dtype=torch.bfloat16,
                   device=None) -> dict:
    return {"c_kv": torch.zeros((batch, t_max, cfg.mla_kv_lora),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, t_max, cfg.mla_rope_dim),
                                  dtype=dtype, device=device)}
