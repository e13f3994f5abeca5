"""The analysis gate: both layers, failing on any unsuppressed finding.

    PYTHONPATH=src python -m repro_torch.analysis.run [--device cpu|cuda]
        [--json PATH] [--skip-lint]

Layer 1 (``kernel_audit``) sweeps every CUDA kernel's launch plan over its
shape cases: plain index arithmetic, no device.  Layer 2 (``lint``) runs
the hot paths on ``--device`` (the card unless ``cpu`` is asked for; no
card raises) and lints what they dispatch; on the CPU it also lints the
k = 8 targets over one spawn of 8 gloo ranks.  Exits 1 on any
unsuppressed finding.  The report's keys are the JAX gate's
(``repro.analysis.run``).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="kernel launch audit + hot-path lint gate")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: where the lint's targets "
                         "run")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write the full report to PATH")
    ap.add_argument("--skip-lint", action="store_true",
                    help="Layer 1 only (nothing runs)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import kernel_audit, lint
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    kernel_records, kernel_findings = kernel_audit.audit_all()
    print(f"[analysis] layer 1: {len(kernel_records)} kernel cases, "
          f"{len(kernel_findings)} findings")

    lint_records: list[dict] = []
    lint_findings: list[lint.Finding] = []
    if not args.skip_lint:
        targets = (lint.default_targets() if device.type == "cpu"
                   else lint.serial_targets())
        lint_records, lint_findings = lint.lint_all(targets, device)
        print(f"[analysis] layer 2: {len(lint_records)} lint records on "
              f"{device.type}, {len(lint_findings)} findings")

    all_findings = ([{"rule": f.rule, "target": f.kernel,
                      "case": f.case, "detail": f.detail}
                     for f in kernel_findings]
                    + [dict(f._asdict()) for f in lint_findings])
    live_lint, waived = lint.apply_suppressions(lint_findings)
    live = len(kernel_findings) + len(live_lint)

    report = {
        "rules": dict(lint.RULES, **kernel_audit.RULES),
        "kernel_cases": kernel_records,
        "hlo_targets": lint_records,
        "findings": all_findings,
        "suppressed": waived,
        "unsuppressed_count": live,
    }
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1, sort_keys=True, default=str)
        print(f"[analysis] report -> {args.json}")

    for f in kernel_findings:
        print(f"FINDING {f.rule} {f.kernel} [{f.case}]: {f.detail}")
    for f in live_lint:
        print(f"FINDING {f.rule} {f.target}: {f.detail}")
    for w in waived:
        print(f"suppressed {w['rule']} {w['target']}: "
              f"{w['justification']}")

    if live:
        print(f"[analysis] FAIL: {live} unsuppressed findings")
        return 1
    print("[analysis] OK: zero unsuppressed findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
