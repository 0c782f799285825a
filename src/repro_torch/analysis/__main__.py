"""``python -m repro_torch.analysis`` — run the checkers against the tree.

Exit status 0 iff zero unbaselined findings (stale baseline entries are
reported but do not fail — they mean the tree got *better*).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis import core


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="domain-aware static analysis for the repro_torch "
                    "tree")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect)")
    ap.add_argument("--checker", action="append", default=None,
                    help="run only this checker (repeatable); default all")
    ap.add_argument("--json", action="store_true",
                    help="emit the findings JSON document to stdout")
    ap.add_argument("--output", default=None,
                    help="also write the JSON document to this path")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: the committed one)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(keeps existing reasons; new entries get TODO)")
    args = ap.parse_args(argv)

    root = args.root or core.find_repo_root()
    findings = core.run(root, args.checker)

    bpath = args.baseline or core.default_baseline_path()
    baseline = core.Baseline([]) if args.no_baseline \
        else core.Baseline.load(bpath)
    unbase, supp, stale = baseline.split(findings)

    if args.update_baseline:
        entries = [e for e in baseline.entries if e not in stale]
        have = {(e["checker"], e["path"], e["rule"], e["symbol"])
                for e in entries}
        for f in findings:
            if f.fingerprint not in have:
                entries.append({"checker": f.checker, "path": f.path,
                                "rule": f.rule, "symbol": f.symbol,
                                "reason": "TODO: justify or fix"})
        entries.sort(key=lambda e: (e["checker"], e["path"], e["rule"],
                                    e["symbol"]))
        with open(bpath, "w", encoding="utf-8") as f:
            json.dump(entries, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"baseline rewritten: {bpath} ({len(entries)} entries)")
        return 0

    doc = core.render_json(unbase, supp, stale)
    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(doc + "\n")
    if args.json:
        print(doc)
    else:
        print(core.render_text(unbase, supp, stale))
    return 1 if unbase else 0


if __name__ == "__main__":
    sys.exit(main())
