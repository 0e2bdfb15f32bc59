"""``python -m repro_torch.analysis``: the audit matrix over every training
schedule x use_kernel off/on (reference: ``python -m repro.analysis``).

    python -m repro_torch.analysis [--device cpu] [--out PATH] [--list-rules]

Prints one line per cell, writes the findings as JSON to ``--out``, and
exits non-zero when any error finding survives.  Runs on ``--device``
(``cuda`` unless the caller asks for ``cpu``; without a GPU the default
raises).
"""
import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description="runtime audits of the pipelined step")
    ap.add_argument("--schedules", nargs="*", default=None,
                    help="training schedules (default: all five)")
    ap.add_argument("--out", default=None, help="write the findings JSON here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)

    from repro_torch.analysis import audit, rules
    from repro_torch.device import resolve_device

    if args.list_rules:
        for rid, rule in sorted(rules.RULES.items()):
            print(f"{rid:22s} {rule.doc}")
        return 0
    device = resolve_device(args.device)
    cells = audit.default_cells(args.schedules)
    print(f"audit: {len(cells)} cells ({len({c.schedule for c in cells})} schedules x "
          f"kernel off/on) on {device}", flush=True)
    report = audit.run_matrix(cells, device=device, log=lambda m: print(m, flush=True))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"wrote {args.out}")
    errs = [(c["cell"], f) for c in report["cells"] for f in c["findings"]
            if f["severity"] == "error"]
    for cell, f in errs:
        print(f"ERROR {cell} {f['rule']}: {f['message']}", file=sys.stderr)
    print(f"audit: FAILED ({len(errs)} error findings)" if errs else "audit: OK",
          file=sys.stderr if errs else sys.stdout)
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
