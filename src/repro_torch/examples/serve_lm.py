"""LM serving walkthrough: continuous batching with MID-DECODE admission,
on the port (the counterpart of the JAX package's ``examples/serve_lm.py``).

Drives the slot-granular LM service (``repro_torch.serve.lm_service``):
requests arrive STAGGERED while earlier sequences are mid-decode, each is
admitted into a freed (or still-free) KV-cache lane between decode
chunks, and every result is checked TOKEN FOR TOKEN against a solo
``engine.generate`` at the same seed, the service's cache capacity and
decode rows: batching never changes what a request generates, only when
it runs.

Also shows the fallback path: a recurrent-cache arch
(recurrentgemma-2b: RG-LRU state and a local-attention ring) cannot share
decode lanes, since its state absorbs prompts order-dependently, so the
service routes its requests through exact solo generation while keeping
the same scheduler queue.

Both models are the reduced configs, random-initialised from a seed.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.serve import engine
from repro_torch.serve.lm_service import LMService

REQS = [(6, 20, 3), (7, 12, 5), (11, 10, 7), (5, 8, 9)]  # prompt, steps, seed


def _solo(model, prompt, steps, seed, **kw) -> np.ndarray:
    return engine.generate(model, np.asarray(prompt)[None], steps=steps,
                           seed=seed, **kw)[0].cpu().numpy()


def main(device: str | None = None) -> dict:
    """Runs both walkthroughs on ``device`` (the card by default); returns
    {"staggered": [(request id, admitted chunk, exact)], "fallback":
    (slot_mode, exact)}.  Raises RuntimeError if a result differs from
    its solo ``generate``."""
    cfg = get_config("gemma-7b").reduced()
    model = tf.init_lm(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, s), steps, seed)
            for s, steps, seed in REQS]

    svc = LMService(model, num_slots=2, chunk_steps=4, max_len=64)
    print(f"service: arch={cfg.name} slots=2 chunk=4 rows={svc.rows} "
          f"slot_mode={svc.slot_mode} device={model.device}")

    # staggered arrivals: submit two up front, the rest mid-decode
    t0 = time.perf_counter()
    rids = [svc.submit(p, steps=n, seed=s) for p, n, s in reqs[:2]]
    results = {}
    for p, n, s in reqs[2:]:
        for res in svc.step():            # decode chunks keep running...
            results[res.request_id] = res
        rids.append(svc.submit(p, steps=n, seed=s))   # ...as work arrives
    results.update(svc.run())
    dt = time.perf_counter() - t0

    print(f"\n{'req':>4} {'prompt':>7} {'bucket':>7} {'steps':>6} "
          f"{'admitted@chunk':>14}  solo-parity")
    staggered = []
    for rid, (p, n, s) in zip(rids, reqs):
        res = results[rid]
        solo = _solo(model, p, n, s, max_len=svc.max_len, rows=svc.rows)
        ok = bool(np.array_equal(res.tokens, solo))
        tag = "mid-decode" if res.admitted_chunk > 0 else "at start"
        print(f"{rid:>4} {res.prompt_len:>7} {res.bucket:>7} {n:>6} "
              f"{res.admitted_chunk:>4} ({tag:>10})  "
              f"{'EXACT' if ok else 'MISMATCH'}")
        staggered.append((rid, res.admitted_chunk, ok))
    tot = sum(n for _, n, _ in reqs)
    print(f"\n{tot} tokens across {len(reqs)} staggered requests in "
          f"{dt:.1f} s; stats={svc.stats}")
    for rid, lat in svc.latencies:
        print(f"  req {rid}: queue-to-result {lat * 1e3:.0f} ms")

    # ---- fallback: recurrent state cannot share decode lanes --------
    cfg_r = get_config("recurrentgemma-2b").reduced()
    model_r = tf.init_lm(cfg_r, seed=0, device=device)
    svc_r = LMService(model_r, num_slots=2, chunk_steps=4)
    prompt = rng.integers(0, cfg_r.vocab_size, 6)
    res = svc_r.generate(prompt, 6, seed=1)
    ok_r = bool(np.array_equal(res.tokens, _solo(model_r, prompt, 6, 1)))
    print(f"\nfallback: arch={cfg_r.name} slot_mode={svc_r.slot_mode} "
          f"solo-parity={'EXACT' if ok_r else 'MISMATCH'}")

    if not all(ok for _, _, ok in staggered) or not ok_r:
        raise RuntimeError("a served request differs from its solo generate")
    return {"staggered": staggered, "fallback": (svc_r.slot_mode, ok_r)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    main(parser.parse_args().device)
