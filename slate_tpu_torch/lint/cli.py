"""slate-lint for the port: the robustness-contract packs (SEAM, CON,
OBS) over ``slate_tpu_torch/`` (port of tools/slate_lint/cli.py).

Usage::

    python -m slate_tpu_torch.lint [--root DIR] [--select RULES]
                                   [--format human|json] [--list-rules]

Exit codes: 0 clean, 1 findings, 2 usage error.

There is no baseline file: the tree is kept clean, and a tolerated site
carries an inline ``# slate-lint: disable=RULE -- reason`` that says why
(the reference's policy; its checked-in baseline is empty).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .loader import load_project
from .model import REGISTRY, Finding


def load_rules():
    from . import rules  # noqa: F401  (fills REGISTRY on import)
    return REGISTRY


def run_rules(project, select: set[str] | None = None) -> list[Finding]:
    findings: list[Finding] = []
    for rule_id, rule in load_rules().items():
        if select is not None and rule_id not in select:
            continue
        for f in rule.run(project):
            mod = project.module(f.path)
            if mod is not None and mod.suppressed(f.line, f.rule):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="slate-lint",
        description="AST lint of the port's robustness contract: policy "
                    "seams (SEAM), lock discipline (CON) and telemetry "
                    "(OBS).  Pure stdlib: it parses the tree, never "
                    "imports it.")
    ap.add_argument("--root", default=None,
                    help="project root holding slate_tpu_torch/ (default: "
                         "the root of this checkout)")
    ap.add_argument("--format", choices=("human", "json"), default="human")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    try:
        args = ap.parse_args(argv)
    except SystemExit as exc:           # argparse's usage errors exit 2
        return int(exc.code or 0)

    registry = load_rules()
    if args.list_rules:
        for rule_id, rule in sorted(registry.items()):
            print(f"{rule_id}  {rule.summary}")
        return 0

    root = Path(args.root) if args.root else \
        Path(__file__).resolve().parents[2]
    if not root.is_dir():
        print(f"slate-lint: no such directory: {root}", file=sys.stderr)
        return 2
    select = None
    if args.select:
        select = {s.strip() for s in args.select.split(",") if s.strip()}
        unknown = select - registry.keys()
        if unknown:
            print(f"unknown rule ids: {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    project = load_project(root)
    findings = run_rules(project, select)
    rule_ids = sorted(registry if select is None else select)

    if args.format == "json":
        print(json.dumps({"findings": [f.to_json() for f in findings],
                          "rules": rule_ids,
                          "files": len(project.modules)}, indent=1))
        return 1 if findings else 0

    for f in findings:
        print(f.render())
    if findings:
        print(f"\nslate-lint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print(f"slate-lint OK: {len(rule_ids)} rule(s), "
          f"{len(project.modules)} file(s)")
    return 0
