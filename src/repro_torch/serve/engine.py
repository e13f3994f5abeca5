"""Serving engine of the LM side: the counterpart of ``repro.serve.engine``.

``prefill``      run the prompt through the model, filling the cache.
``decode_step``  one token for every row against the cache.
``generate``     greedy / temperature sampling loop.

Caches come from ``transformer.init_stack_cache``: full-attention
layers keep every position (GQA's K/V, or MLA's compressed ``c_kv`` and
shared ``k_rope``), sliding-window layers a ring buffer of ``window``
entries.

Prefill length bucketing
------------------------

``generate`` pads prompts RIGHT to a pow-2 length bucket and prefills at
the bucket's length.  This is exact for full-attention caches: inside
the prefill causal masking keeps every real query off the pad keys (they
sit at positions >= the true length); after it every cache ``index`` is
REWOUND to the true length, so decode masks the pad entries out
(``k_pos < index + 1``) and each decode write overwrites the next pad
entry exactly when its position would first become attendable.  Ring
buffers absorb prompt tokens order-dependently, so window configs take
the exact-length prefill (``_can_bucket``).

The JAX package counts jit traces in ``trace_counts``; the port has no
jit, so ``trace_counts`` tallies set-ups under the same keys: a key is
counted the first time a prefill bucket ``(name, s_bucket, max_len)`` or
a decode-chunk configuration (``lm_slot_trace_key``) is run, as the
port's SVM engine counts its chunk configurations.

Slot-granular decode (continuous batching)
------------------------------------------

``LMSlotState`` holds S decode lanes, each with its own cache row (and
cache index), position, sampling generator, token count, budget and
active flag; ``decode_chunk_slots`` advances all of them in one batched
forward a step (the JAX package's ``vmap`` of the solo decode over
lanes).  Decode is batch-invariant (``models.transformer``): a lane's
tokens are those of a solo ``generate`` at the same seed, prompt bucket,
cache capacity and decode ``rows`` (``decode_rows(S)``), bit for bit, for
any S.  Between chunks
the host admits a prefilled prompt into a freed lane; ``admit_lane``
overwrites every per-lane field, so a reused lane cannot leak its
previous occupant's KV state.

Sampling
--------

JAX samples ``argmax(logits / T + gumbel(sub))`` with a threefry chain
split once a token.  The port cannot reproduce those bits: each chain is
a ``torch.Generator`` seeded with the request's seed, drawing one Gumbel
row a token.  ``sample`` (and ``generate``) also take precomputed noise,
so a test can replay JAX's draws.  Greedy decoding (``temperature <= 0``)
is ``argmax`` in both packages and draws nothing.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from repro_torch.core.preprocess import next_pow2
from repro_torch.models import transformer as tf

# One count per set-up key (see the module docstring).
trace_counts: collections.Counter = collections.Counter()


def _tally(key) -> None:
    if key not in trace_counts:
        trace_counts[key] += 1


class ServeState(NamedTuple):
    cache: dict
    last_logits: torch.Tensor    # (B, V)
    pos: torch.Tensor            # (B,) next position of each row


def init_cache(model, batch: int, max_len: int,
               cache_dtype=torch.bfloat16) -> dict:
    return tf.init_stack_cache(model.cfg, batch, max_len,
                               cache_dtype=cache_dtype, device=model.device)


def _tokens(model, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.long, device=model.device)


@torch.no_grad()
def prefill(model, tokens, *, max_len: int,
            cache_dtype=torch.bfloat16) -> ServeState:
    tokens = _tokens(model, tokens)
    b, s = tokens.shape
    cache = init_cache(model, b, max_len, cache_dtype)
    logits, cache = model(tokens, cache=cache)
    return ServeState(cache=cache, last_logits=logits[:, -1],
                      pos=torch.full((b,), s, dtype=torch.int32,
                                     device=model.device))


@torch.no_grad()
def decode_step(model, tokens, state: ServeState,
                rows: int | None = None) -> ServeState:
    """tokens: (B, 1) next input token of each row; ``rows``: the padded
    row count of the step (``transformer.LM.forward``)."""
    logits, cache = model(_tokens(model, tokens), cache=state.cache,
                          positions=state.pos[:, None], rows=rows)
    return ServeState(cache=cache, last_logits=logits[:, -1],
                      pos=state.pos + 1)


def prompt_bucket(s: int, min_bucket: int = 8) -> int:
    """The pow-2 prompt-length ladder (8, 16, 32, ...): at most 2x pad."""
    return next_pow2(max(s, min_bucket))


def _can_bucket(cfg) -> bool:
    """Bucketed prefill is exact only for order-independent caches:
    full-attention blocks with no sliding window, no recurrent state,
    no encoder-decoder cross cache."""
    return (all(kind == "attn" for kind in cfg.block_pattern)
            and cfg.window == 0 and not cfg.is_encoder_decoder)


def _rewind_cache_index(cache: dict, true_len: int) -> dict:
    """Set the cache's ``index`` (every row) to the TRUE prompt length,
    undoing the pad tokens' advance: decode then writes at the true
    position and masks the pad entries out."""
    cache["index"].fill_(true_len)
    return cache


@torch.no_grad()
def _prefill_bucketed(model, tokens, true_len: int, *, max_len: int,
                      cache_dtype=torch.bfloat16) -> ServeState:
    """Bucket-shaped prefill: ``tokens`` is (B, s_bucket) with pad ids
    right of ``true_len``; one set-up serves every true length in the
    bucket."""
    tokens = _tokens(model, tokens)
    b, s_b = tokens.shape
    _tally((model.cfg.name, s_b, max_len))
    cache = init_cache(model, b, max_len, cache_dtype)
    logits, cache = model(tokens, cache=cache)
    cache = _rewind_cache_index(cache, true_len)
    return ServeState(cache=cache, last_logits=logits[:, true_len - 1],
                      pos=torch.full((b,), true_len, dtype=torch.int32,
                                     device=model.device))


def gumbel_noise(generator: torch.Generator, shape, dtype,
                 device) -> torch.Tensor:
    """Standard Gumbel noise in ``dtype`` (drawn in float32)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(dtype)


def sample(logits: torch.Tensor, temperature: float = 0.0, *,
           generators=(), gumbel=None) -> torch.Tensor:
    """Next tokens (B,) of logits (B, V): ``argmax`` for ``temperature <=
    0``, else ``argmax(logits / temperature + g)`` with Gumbel noise ``g``
    in the logits' dtype: the given ``gumbel`` (B, V), or one row from
    each of ``generators`` (one a row, or one for all rows)."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    scaled = logits / temperature
    if gumbel is None:
        b, v = logits.shape
        if len(generators) == 1:
            gumbel = gumbel_noise(generators[0], (b, v), scaled.dtype,
                                  logits.device)
        else:
            gumbel = torch.cat([gumbel_noise(g, (1, v), scaled.dtype,
                                             logits.device)
                                for g in generators])
    else:
        gumbel = torch.as_tensor(gumbel, device=logits.device).to(
            scaled.dtype)
    return (gumbel + scaled).argmax(-1)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@torch.no_grad()
def _decode_loop(model, state: ServeState, steps: int, temperature: float,
                 generator: torch.Generator, gumbel=None,
                 rows: int | None = None) -> torch.Tensor:
    toks = []
    for i in range(steps):
        tok = sample(state.last_logits, temperature, generators=(generator,),
                     gumbel=None if gumbel is None else gumbel[i])
        state = decode_step(model, tok[:, None], state, rows)
        toks.append(tok)
    return torch.stack(toks, dim=1)                     # (B, steps)


@torch.no_grad()
def generate(model, prompt_tokens, *, steps: int, temperature: float = 0.0,
             seed: int = 0, max_len: int | None = None,
             bucket_prompts: bool = True, gumbel=None,
             rows: int | None = None) -> torch.Tensor:
    """Batched generation; returns (B, steps) generated token ids.

    Prompts are padded to the pow-2 length bucket and prefilled at its
    length (exact, see the module docstring) whenever the cache family
    allows it; window configs and an explicit ``max_len`` below the bucket
    take the exact-length prefill.  The default ``max_len`` is s_bucket +
    steps (s + steps unbucketed).  ``gumbel`` (steps, B, V) replays given
    noise in place of the draws from ``seed``.  ``rows`` is the decode's
    padded row count (default ``decode_rows(B)``): a lane of an
    ``LMService`` equals a solo ``generate`` at the service's ``max_len``
    and ``rows``."""
    prompt_tokens = _tokens(model, prompt_tokens)
    b, s = prompt_tokens.shape
    s_b = prompt_bucket(s)
    if (bucket_prompts and _can_bucket(model.cfg)
            # an explicit max_len smaller than the bucket cannot hold
            # the padded prompt -- honor it via the exact-length path
            and (max_len is None or max_len >= s_b)):
        max_len = max_len or (s_b + steps)
        toks = torch.nn.functional.pad(prompt_tokens, (0, s_b - s))
        state = _prefill_bucketed(model, toks, s, max_len=max_len)
    else:
        max_len = max_len or (s + steps)
        state = prefill(model, prompt_tokens, max_len=max_len)
    return _decode_loop(model, state, steps, temperature,
                        _generator(seed, model.device), gumbel, rows)


# ==========================================================================
# Slot-granular decode: S independent sequences, each with its own cache
# row / position / sampling chain, through one batched decode a step.
# ==========================================================================


class LMSlotState(NamedTuple):
    """S decode lanes for the continuous-batching LM service.

    ``cache`` is a stack cache whose batch rows are the lanes, each with
    its own ``index``.  A FREE lane (``active`` False) still flows
    through every decode step, but only ``t`` is guarded by the mask: a
    frozen lane's cache and logits keep advancing harmlessly, because its
    tokens are already harvested and admission overwrites every field.
    ``generators`` are the per-lane sampling chains."""
    cache: dict
    last_logits: torch.Tensor     # (S, V) logits the next token samples from
    pos: torch.Tensor             # (S,) next position of each lane
    t: torch.Tensor               # (S,) tokens generated so far
    max_t: torch.Tensor           # (S,) per-lane token budget
    generators: tuple             # (S,) per-lane torch.Generator
    active: torch.Tensor          # (S,) bool lifecycle mask

    @property
    def num_slots(self) -> int:
        return self.last_logits.shape[0]


def init_lm_slot_state(prefill: ServeState, num_slots: int) -> LMSlotState:
    """An all-FREE lane table shaped like one prefilled lane's batch=1
    ``ServeState`` (cache capacity, cache dtype, vocabulary)."""
    def lanes(x):
        return x.new_zeros((num_slots,) + x.shape[1:])

    cache = {"layers": [{name: lanes(x) for name, x in layer.items()}
                        for layer in prefill.cache["layers"]],
             "index": lanes(prefill.cache["index"])}
    dev = prefill.last_logits.device
    zeros = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
    return LMSlotState(
        cache=cache, last_logits=lanes(prefill.last_logits),
        pos=zeros.clone(), t=zeros.clone(), max_t=zeros.clone(),
        generators=tuple(_generator(i, dev) for i in range(num_slots)),
        active=torch.zeros((num_slots,), dtype=torch.bool, device=dev))


def admit_lane(state: LMSlotState, lane: int, prefill: ServeState,
               seed: int, max_t: int) -> LMSlotState:
    """Admit a freshly prefilled sequence (a batch=1 ``ServeState``, its
    cache index already rewound to the true prompt length) into ``lane``.
    Every per-lane field is overwritten, in place: cache, index, last
    logits, position, token count, budget, sampling chain, active flag."""
    for dst, src in zip(state.cache["layers"], prefill.cache["layers"]):
        for name in dst:
            dst[name][lane] = src[name][0]
    state.cache["index"][lane] = prefill.cache["index"][0]
    state.last_logits[lane] = prefill.last_logits[0].to(
        state.last_logits.dtype)
    state.pos[lane] = prefill.pos[0]
    state.t[lane] = 0
    state.max_t[lane] = max_t
    state.active[lane] = True
    gens = list(state.generators)
    gens[lane] = _generator(seed, state.last_logits.device)
    return state._replace(generators=tuple(gens))


def deactivate_lane(state: LMSlotState, lane: int) -> LMSlotState:
    """Freeze one decode lane (the LM service's cancellation path); its
    cache is left as is: ``admit_lane`` overwrites every field."""
    state.active[lane] = False
    return state


def lm_slot_trace_key(name: str, num_slots: int, max_len: int,
                      chunk_steps: int, temperature: float) -> tuple:
    """The ``trace_counts`` key of one slot-decode chunk configuration."""
    return ("lm_slots", name, num_slots, max_len, chunk_steps,
            temperature)


def _lane_ok(logits: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(logits.float()).all(dim=-1)


@torch.no_grad()
def decode_chunk_slots(model, state: LMSlotState, *, chunk_steps: int,
                       temperature: float, max_len: int):
    """One slot-granular decode chunk: ``chunk_steps`` tokens for every
    lane, one batched single-token forward a step.

    Each step every lane samples its next token from its own
    ``last_logits`` with its own chain (one Gumbel row a token, as in
    ``generate``), then decodes it against its own cache at its own
    position.  The active mask guards only the token counter ``t``.
    ``max_len`` (implied by the cache) only keys ``trace_counts``.

    Lane health: a per-lane flag that the entry logits AND every step's
    logits are finite (a NaN that one sampling step consumes before a
    finite forward overwrites it is caught too).  Unhealthy lanes are
    deactivated; lanes decode independently, so a poisoned lane's
    batch-mates decode bit for bit as if it were healthy.  Free lanes
    hold zero logits and pass.

    Returns (state, toks (S, chunk_steps), healthy (S,) bool); per lane
    only the first ``t_after - t_before`` token columns are meaningful."""
    _tally(lm_slot_trace_key(model.cfg.name, state.num_slots, max_len,
                             chunk_steps, temperature))
    ok = _lane_ok(state.last_logits)
    toks = []
    for _ in range(chunk_steps):
        tok = sample(state.last_logits, temperature,
                     generators=state.generators)
        logits, _ = model(tok[:, None], cache=state.cache,
                          positions=state.pos[:, None])
        last = logits[:, -1]
        do = state.active & (state.t < state.max_t)
        state = state._replace(last_logits=last, pos=state.pos + 1,
                               t=torch.where(do, state.t + 1, state.t))
        ok = ok & _lane_ok(last)
        toks.append(tok)
    state = state._replace(
        active=state.active & (state.t < state.max_t) & ok)
    return state, torch.stack(toks, dim=1), ok
