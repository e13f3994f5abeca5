"""Serving runtime of the port: the SVM fit endpoint.

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
* :mod:`repro_torch.serve.faults` -- deterministic fault plans and the
  in-place lane poison the quarantine tests use.

The JAX package's LM side (``engine``, ``lm_service``) is not ported.
"""
