"""CLI of the port's contract linter.

Usage::

    python -m repro_torch.analysis                  # report all findings
    python -m repro_torch.analysis --check          # gate: exit 1 on any
    python -m repro_torch.analysis --check --baseline FILE
    python -m repro_torch.analysis --write-baseline FILE
    python -m repro_torch.analysis --json out.json path/to/file.py
    python -m repro_torch.analysis --list-rules
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from . import (RULES, apply_baseline, load_baseline, run_analysis,
               write_baseline)


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST contract linter of the PyTorch port (seeded "
                    "generators, no host sync on the device path, "
                    "deterministic accumulation, exports)")
    ap.add_argument("paths", nargs="*",
                    help="files to analyze, relative to --root (default: "
                         "src/repro_torch/**/*.py examples/*_torch.py "
                         "chip_smoke.py)")
    ap.add_argument("--root", default=".",
                    help="repository root (default: cwd)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when any unbaselined finding (or stale "
                         "baseline entry) remains")
    ap.add_argument("--baseline", metavar="FILE",
                    help="subtract the findings recorded in FILE")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="write the current findings to FILE (keeping its "
                         "justifications by fingerprint) and exit")
    ap.add_argument("--json", metavar="FILE", dest="json_out",
                    help="also write the findings as JSON to FILE")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    return ap


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        for rid in sorted(RULES):
            r = RULES[rid]
            print(f"{rid:8s} [{r.severity:7s}] {r.description}")
        return 0

    root = pathlib.Path(args.root).resolve()
    if not (root / "src" / "repro_torch").is_dir():
        print(f"error: {root} does not look like the repo root (no "
              "src/repro_torch); pass --root", file=sys.stderr)
        return 2

    result = run_analysis(root, files=args.paths or None)
    findings = result.findings

    if args.write_baseline:
        p = pathlib.Path(args.write_baseline)
        entries = write_baseline(p, findings,
                                 load_baseline(p) if p.is_file() else [])
        print(f"wrote {len(entries)} baseline entries to {p}")
        return 0

    stale = []
    if args.baseline:
        findings, stale = apply_baseline(findings,
                                         load_baseline(args.baseline))

    if args.json_out:
        out = pathlib.Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "root": str(root), "files": result.files,
            "findings": [f.to_json() for f in findings],
            "suppressed": [f.to_json() for f in result.suppressed],
            "stale_baseline_entries": stale}, indent=1) + "\n")

    for f in findings:
        print(f.format())
    for e in stale:
        print(f"{e['path']}: stale baseline entry for {e['rule']} "
              f"({e['fingerprint'][:60]!r}); prune it")
    n_err = sum(f.severity == "error" for f in findings)
    print(f"{len(result.files)} files, {len(findings)} finding(s) "
          f"({n_err} error, {len(findings) - n_err} warning), "
          f"{len(result.suppressed)} suppressed, {len(stale)} stale "
          "baseline entr(y/ies)")
    return 1 if args.check and (findings or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
