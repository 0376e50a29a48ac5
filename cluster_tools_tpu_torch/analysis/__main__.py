"""CLI: ``python -m cluster_tools_tpu_torch.analysis [paths...] [options]``.

Exit 0 when every finding is suppressed (with a reason), 1 otherwise
(2 for a usage error).  The tier-1 gate in
``tests/test_torch_analysis.py`` runs it.
"""

from __future__ import annotations

import argparse
import json
import sys

from .base import ALL_RULES, report_as_json, run_analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cluster_tools_tpu_torch.analysis",
        description="ctt-lint: invariant lint passes over the port")
    ap.add_argument("paths", nargs="*",
                    help="explicit files to lint (default: the whole "
                         "package + chip_smoke.py)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to keep "
                         "(default: all)")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="also write the machine-readable report here")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-finding lines, print only the "
                         "summary")
    args = ap.parse_args(argv)

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in ALL_RULES]
        if unknown:
            ap.error("unknown rule(s) %s; known: %s"
                     % (unknown, ", ".join(ALL_RULES)))

    report = run_analysis(files=args.paths or None, rules=rules)

    if not args.quiet:
        for f in report["findings"]:
            print(f.format())
        for f in report["suppressed"]:
            print(f.format())
    n, s = len(report["findings"]), len(report["suppressed"])
    print("ctt-lint: %d finding(s), %d suppressed, %d file(s) scanned"
          % (n, s, report["files_scanned"]))

    if args.json_path:
        from ..core import config as config_mod
        config_mod.write_config(args.json_path,
                                dict(report_as_json(report), cmd="lint"))
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
