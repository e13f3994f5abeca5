"""Static analysis of the hand kernels' launches and the hot paths.

Counterpart of ``repro.analysis``.  Two layers, one gate
(``python -m repro_torch.analysis.run``):

* :mod:`repro_torch.analysis.kernel_audit` -- Layer 1. A registry of every
  CUDA kernel's launch plan (built from the tuples the wrappers launch
  from), audited over the serving rungs, the wide and client shapes and
  the paths' shapes: block bounds (BLOCK-001), output coverage
  (COVER-001), freedom from write races across blocks (RACE-001), shared
  memory against the H100's 227 KB a block (SMEM-001) and the grid's
  limits (GRID-001). Needs no card.

* :mod:`repro_torch.analysis.lint` -- Layer 2.  Rules over what the hot
  paths dispatch when they run (``utils.dispatch_trace``): no host wait
  inside a chunk (SYNC-001), no f64 (DTYPE-001), collectives within the
  analytic ``CommModel`` budget (COMM-001), the same work every step
  (STEP-001), no second copy of the state (STATE-001).

Registry contract (how to add a kernel)
---------------------------------------

A kernel wrapper launches from a small tuple memoised by shape (the C
launcher's geometry arguments, the grid and shared memory it derives, the
workspace: ``saddle_update.Launch``, ``fwht.FwhtPlan``).  Add a
``<kernel>_plan(**shape) -> dict`` to :mod:`repro_torch.analysis.kernel_audit`
that builds its plan from THAT tuple plus each block's ranges, so the audit
checks what the launch uses; the keys are those of the module's docstring.
Register the function and its shape cases in ``kernel_audit.registry()`` /
``kernel_audit.audit_cases()``, and report the C side's grid and shared
memory through the library's geometry query, which ``chip_smoke.py`` holds
equal to every plan on the card.
"""
