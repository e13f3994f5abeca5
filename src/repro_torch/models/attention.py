"""Attention: grouped-query attention with full, sliding-window and
ring-buffer KV caches, whisper's cross attention with its static cache, and
DeepSeek-V2's multi-head latent attention (MLA) with its compressed cache
and absorbed decode: ``repro.models.attention``.

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
  cross   {cross_k, cross_v: (B, KV, T_enc, Dh)}    (beside a layer's own)

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

from repro_torch.models import sharding as shd
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
    (H, Dh, D).

    On a mesh (``models.sharding``) with the query heads split over
    ``model``, each rank attends with its own heads and the ranks' output
    projections are summed.  Where the KV heads split too, each rank's
    query heads read its own KV heads; where they do not (fewer KV heads
    than ranks, chatglm3-6b's 2 on a 4-way axis), every rank projects
    every KV head and keeps the ones its query heads share, and the
    grads of K and V are summed over the ranks."""

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
        h, dh = shd.full_shape(self.wo)[:2]
        for w in (self.wq, self.wk, self.wv):
            normal_(w, 1.0 / math.sqrt(d), generator)
        normal_(self.wo, 1.0 / math.sqrt(h * dh), generator)

    def _project(self, x, w):
        b, s, d = x.shape
        return matmul(x.reshape(b * s, d), w.reshape(d, -1)).reshape(
            b, s, w.shape[1], w.shape[2])

    def _own_kv(self, k, v):
        """The KV heads this rank's query heads share, of whole K and V
        (B, S, KV, Dh) (their grads summed over ``model``)."""
        h, kv = self.cfg.num_heads, self.cfg.num_kv_heads
        hq, group = self.wq.shape[1], h // kv
        first = shd.offset(self.wq, 1)
        if group % hq and hq % group:
            raise NotImplementedError(
                f"{hq} query heads a rank do not pair with KV groups of "
                f"{group}")
        lo, n = first // group, max(1, hq // group)
        k, v = shd.copy_to(k), shd.copy_to(v)
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]

    def forward(self, x, *, positions, rope, window: int = 0, cache=None,
                index=None, lanes: int | None = None):
        """Returns the (B, S, D) output; a given cache is written in place.

        positions: (B, S); rope: their ``layers.rope_tables`` (None:
        ``rope_kind="none"``, nothing rotates).  Three
        regimes, as in the JAX package: no cache
        (causal over the input); a prefill (S > 1) into an EMPTY cache,
        attending within the prompt and writing K/V from slot 0 (the ring
        keeps the last window, rolled so that slot == pos % W); a decode
        (S == 1), where row r writes at its own ``index[r]`` and attends
        to its own cache.  ``lanes``: in a decode, the first ``lanes``
        rows own a cache row each; the rows after them are padding
        (zero output).  On a mesh only the first (training) runs."""
        b, s, _ = x.shape
        cfg = self.cfg
        if cache is not None and shd.active() is not None:
            raise NotImplementedError(
                "a sharded cache (prefill, decode) is not ported: the "
                "sharded slice trains (ROADMAP.md queue 1 item 3)")
        heads_split, kv_split = shd.split(self.wq, 1), shd.split(self.wk, 1)
        xq = shd.copy_to(x) if heads_split else x
        xkv = xq if kv_split else x
        q = self._project(xq, shd.param(self.wq))
        k = self._project(xkv, shd.param(self.wk))
        if rope is not None:
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        v = self._project(xkv, shd.param(self.wv))
        # JAX constrains K and V's sequence over data at b == 1
        # ("seq_shard", a memory layout where the batch leaves data free);
        # the port's data ranks then all hold every key (ROADMAP.md)
        q = shd.shard(q, "batch", None, "heads", None,
                      shape=(None, None, cfg.num_heads, None))
        k = shd.shard(k, "batch", None, "kv_heads", None,
                      shape=(None, None, cfg.num_kv_heads, None))
        v = shd.shard(v, "batch", None, "kv_heads", None,
                      shape=(None, None, cfg.num_kv_heads, None))
        if heads_split and not kv_split:
            k, v = self._own_kv(k, v)
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
        out = shd.shard(out, "batch", None, "heads", None,
                        shape=(None, None, cfg.num_heads, None))
        wo = shd.param(self.wo)
        h, dh, d = wo.shape
        out = matmul(out.reshape(b * s, h * dh),
                     wo.reshape(h * dh, d)).reshape(b, s, d)
        return shd.reduce_from(out) if heads_split else out


class CrossAttention(GQAttention):
    """Decoder-to-encoder attention (``init_cross``, ``gqa_attention(
    cross_kv=)``): GQA's weights; q from the decoder's stream, K and V
    from the encoder's output (or the cross cache); no RoPE and no mask,
    every encoder frame visible to every query."""

    def forward(self, x, *, enc_out=None, cache=None,
                lanes: int | None = None):
        """Returns the (B, S, D) output.

        With ``enc_out`` (B, T_enc, D), K and V are its projections, and a
        given cache keeps them, in the activations' dtype whatever the
        cache's (the JAX package's prefill stores them uncast).  Without
        it they are the cache's (a decode; or a forward before any frames,
        against the zeros ``init_cross_cache`` made).  A decode (S == 1
        with a cache) runs its two products row by row
        (``decode_attention``), the rows after ``lanes`` padding (zero
        output), as ``GQAttention``'s decode."""
        b, s, _ = x.shape
        q = self._project(x, self.wq)
        if enc_out is not None:
            k, v = self._project(enc_out, self.wk), self._project(
                enc_out, self.wv)
            if cache is not None:
                cache["cross_k"] = k.transpose(1, 2).contiguous()
                cache["cross_v"] = v.transpose(1, 2).contiguous()
        elif cache is None:
            raise ValueError("cross attention needs the encoder's output "
                             "or a cross cache")
        else:
            k = cache["cross_k"].transpose(1, 2)
            v = cache["cross_v"].transpose(1, 2)
        t = k.shape[1]
        if cache is not None and s == 1:
            n = b if lanes is None else lanes
            out = torch.zeros((b, 1) + q.shape[2:],
                              dtype=cache["cross_v"].dtype, device=x.device)
            out[:n, 0] = decode_attention(
                q[:n, 0], cache["cross_k"], cache["cross_v"],
                torch.ones((n, t), dtype=torch.bool, device=x.device))
        else:
            out = dot_attention(
                q, k, v, torch.zeros((s,), dtype=torch.long, device=x.device),
                torch.arange(t, device=x.device), causal=False, window=0)
        h, dh, d = self.wo.shape
        return matmul(out.reshape(b * s, h * dh),
                      self.wo.reshape(h * dh, d)).reshape(b, s, d)


def init_cross_cache(cfg, batch: int, cross_len: int, *,
                     dtype=torch.bfloat16, device=None) -> dict:
    """Zero cross K/V (``init_block_cache(cross_len=)``), laid out as the
    self-attention cache, (B, KV, T_enc, Dh)."""
    shape = (batch, cfg.num_kv_heads, cross_len, cfg.head_dim)
    return {"cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


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
        h, vd = shd.full_shape(self.wo)[:2]
        normal_(self.wkv_a, 1.0 / math.sqrt(d), generator)
        normal_(self.wkv_b_k, 1.0 / math.sqrt(lora), generator)
        normal_(self.wkv_b_v, 1.0 / math.sqrt(lora), generator)
        normal_(self.wo, 1.0 / math.sqrt(h * vd), generator)
        if cfg.mla_q_lora:
            normal_(self.wq_a, 1.0 / math.sqrt(d), generator)
            normal_(self.wq_b, 1.0 / math.sqrt(cfg.mla_q_lora), generator)
        else:
            normal_(self.wq, 1.0 / math.sqrt(d), generator)

    def _query(self, x, heads_split: bool = False):
        """``_mla_q``: (B, S, H, nope + rope), this rank's heads where they
        split (the head-split product's input through ``copy_to``)."""
        b, s, _ = x.shape
        if self.cfg.mla_q_lora:
            x = self.q_norm(matmul(x, shd.param(self.wq_a)))
            w = shd.param(self.wq_b)
        else:
            w = shd.param(self.wq)
        if heads_split:
            x = shd.copy_to(x)
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
        against the compressed cache.

        On a mesh (``models.sharding``; training only) the heads split
        over ``model``: the latent ``c_kv``, ``k_rope`` and q-lora's ``cq``
        are computed whole on every rank (their weights whole over
        ``model``), enter the head-split products through ``copy_to``, and
        the ranks' output projections are summed (``reduce_from``)."""
        cfg = self.cfg
        b, s, _ = x.shape
        if cache is not None and shd.active() is not None:
            raise NotImplementedError(
                "a sharded cache (prefill, decode) is not ported: the "
                "sharded slice trains (ROADMAP.md queue 1 item 3)")
        nope, lora = cfg.head_dim, cfg.mla_kv_lora
        heads_split = shd.split(self.wkv_b_k, 1)
        q = self._query(x, heads_split)
        q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], *rope)
        ckv = matmul(x, shd.param(self.wkv_a))              # (B, S, lora+rope)
        c_kv = self.kv_norm(ckv[..., :lora])
        k_rope = apply_rope(ckv[..., None, lora:], *rope)[:, :, 0]
        scale = 1.0 / math.sqrt(nope + cfg.mla_rope_dim)
        wo = shd.param(self.wo)
        h, vd, d = wo.shape
        if cache is None or s > 1:
            c_in, kr_in = c_kv, k_rope
            if heads_split:   # one all-reduce of both grads
                lat = shd.copy_to(torch.cat([c_kv, k_rope], dim=-1))
                c_in, kr_in = lat[..., :lora], lat[..., lora:]
            k_nope = matmul(c_in, shd.param(self.wkv_b_k).reshape(
                lora, -1)).reshape(b, s, h, nope)
            v = matmul(c_in, shd.param(self.wkv_b_v).reshape(
                lora, -1)).reshape(b, s, h, vd)
            k = torch.cat([k_nope, kr_in[:, :, None].expand(
                b, s, h, kr_in.shape[-1])], dim=-1)
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
        out = shd.shard(out, "batch", None, "heads", None,
                        shape=(None, None, cfg.num_heads, None))
        out = matmul(out.reshape(b * s, h * vd),
                     wo.reshape(h * vd, d)).reshape(b, s, d)
        return shd.reduce_from(out) if heads_split else out


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
