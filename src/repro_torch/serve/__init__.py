"""Serving runtime of the port: the SVM fit endpoint and the LM
generation endpoint, on one scheduler.

* :mod:`repro_torch.serve.scheduler` -- the workload-agnostic
  continuous-batching core (a copy of the JAX package's): urgency-ordered
  request queues (arrival / priority / deadline), per-group slot tables,
  cross-group policy (latency-aware ``oldest`` default, ``round_robin``),
  admission into freed lanes, idle eviction, queue-to-result latency
  stamps and set-up accounting.
* :mod:`repro_torch.serve.solver_service` -- the SVM fit endpoint:
  continuous batching of independent fit requests through the
  slot-batched saddle engine (pow-2 shape buckets + mid-run admission),
  on the card by default.
* :mod:`repro_torch.serve.lm_service` -- the LM generation endpoint:
  slot-granular decode (a cache row, position and sampling chain a lane)
  with mid-decode admission of queued prompts into freed lanes, token
  for token equal to solo ``generate``; window configs fall back to solo
  generation.
* :mod:`repro_torch.serve.engine` -- the LM primitives: prefill, batched
  single-token decode over full and ring-buffer caches, pow-2
  prompt-length bucketing, and the lane helpers the LM service drives.
* :mod:`repro_torch.serve.faults` -- deterministic fault plans and the
  in-place lane poisons the quarantine tests use.
"""
