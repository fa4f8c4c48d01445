"""CLI for the static invariant checkers of the port.

::

    python -m raft_tpu_torch.analysis                      # check the package
    python -m raft_tpu_torch.analysis --rules HOSTSYNC,LOCKORDER
    python -m raft_tpu_torch.analysis --baseline analysis_baseline.json
    python -m raft_tpu_torch.analysis --write-baseline analysis_baseline.json
    python -m raft_tpu_torch.analysis --root path/to/pkg --json

Exit status 0 when every finding is suppressed or baselined, 1
otherwise (2 on usage errors) — cheap to wire into any CI gate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from raft_tpu_torch.analysis import (
    RULES,
    load_baseline,
    run_analysis,
    write_baseline,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--root", default=None,
                    help="package directory to scan (default: raft_tpu_torch)")
    ap.add_argument("--readme", default=None,
                    help="README whose port section holds the env table to "
                         "reconcile (default: autodetected next to the package)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rules to run")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON; findings whose IDs appear there "
                         "are reported but do not fail the run")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="record the current findings as the accepted "
                         "baseline and exit 0")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as a JSON document")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in RULES():
            print(r)
        return 0

    rules = None
    if args.rules:
        rules = [r.strip().upper() for r in args.rules.split(",") if r.strip()]

    t0 = time.perf_counter()
    try:
        result = run_analysis(root=args.root, rules=rules,
                              readme=args.readme)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - t0

    findings = result.sorted_findings()

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"wrote {len(findings)} finding IDs to {args.write_baseline}")
        return 0

    baseline = set()
    if args.baseline:
        baseline = load_baseline(args.baseline)
    fresh = [f for f in findings if f.id not in baseline]
    known = [f for f in findings if f.id in baseline]

    if args.json:
        print(json.dumps({
            "elapsed_s": round(elapsed, 3),
            "stats": result.stats,
            "findings": [f.to_dict() for f in fresh],
            "baselined": [f.to_dict() for f in known],
            "suppressed": len(result.suppressed),
        }, indent=2))
    else:
        for f in fresh:
            print(f.render())
        for f in known:
            print(f"{f.render()}  [baselined]")
        print(
            f"raft_tpu_torch.analysis: {len(fresh)} finding(s)"
            f"{f', {len(known)} baselined' if known else ''}"
            f", {len(result.suppressed)} suppressed, "
            f"{result.stats.get('modules', 0)} modules in {elapsed:.2f}s"
        )
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
