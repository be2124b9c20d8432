"""``python -m repro_torch.analysis``: run every registered entry point once
on the device, evaluate its contract set, write ANALYSIS_torch_report.json,
exit nonzero on a violation.

The device defaults to ``cuda`` and the run raises without one: the
checker holds the kernels themselves only there (``--device cpu`` runs
their plain versions).  On the card each entry also gets the card's own
checks (``rules.card_checks``): each kernel launched once a call, and a
run under ``torch.cuda.set_sync_debug_mode("error")`` for an entry that
allows no sync site.  ``--entry-point`` filters the registry;
``--seed-violation`` adds a deliberately broken entry, so that a check of
the gate can assert that it fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from ..device import resolve_device
from .registry import entry_point_names, get_entry_points
from .rules import card_checks
from .tracer import count_kernel_calls


def analyze_entry(entry, device) -> dict:
    """Build, run and check one entry point; never raises (a broken entry
    is itself a reported violation of "this entry point runs")."""
    t0 = time.perf_counter()
    try:
        program, rules = entry.build(device)
        trace = program.trace
        rule_results = []
        n_viol = 0
        for rule in rules:
            viols = rule.check(program)
            n_viol += len(viols)
            rule_results.append({"rule": rule.describe(), "ok": not viols,
                                 "violations": [v.as_dict() for v in viols]})
        card = card_checks(program, rules)
        if card:
            n_viol += len(card)
            rule_results.append({"rule": "card", "ok": False,
                                 "violations": [v.as_dict() for v in card]})
        res = {"name": entry.name, "description": entry.description, "ok": n_viol == 0,
               "n_violations": n_viol, "rules": rule_results,
               "kernel_calls": dict(count_kernel_calls(trace)),
               "syncs": [{"op": s.op, "how": s.how, "path": list(s.path)}
                         for s in trace.syncs]}
        if program.device.type == "cuda":
            res["launches_calls"] = {k: list(v) for k, v in program.counts.items() if any(v)}
            res["peak_bytes"] = program.peak_bytes
        if program.error is not None:
            n_viol += 1
            res.update(ok=False, n_violations=n_viol, error="".join(
                traceback.format_exception(program.error, limit=8)))
    except Exception:
        res = {"name": entry.name, "description": entry.description, "ok": False,
               "n_violations": 1, "rules": [], "error": traceback.format_exc(limit=8)}
    res["seconds"] = time.perf_counter() - t0
    return res


def run(names=None, *, device="cuda", seed_violation: bool = False) -> dict:
    """The report of checking ``names`` (None: every entry) on ``device``."""
    dev = resolve_device(device)
    results = [analyze_entry(e, dev)
               for e in get_entry_points(names, include_seeded=seed_violation)]
    n_viol = sum(r["n_violations"] for r in results)
    return {"torch_version": torch.__version__, "device": dev.type,
            "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else "cpu"),
            "ok": n_viol == 0, "n_violations": n_viol, "entry_points": results}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Program-contract checker of the port (DESIGN.md §11), run on a device.")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the entries run (default: %(default)s)")
    parser.add_argument("--entry-point", action="append", default=None, metavar="NAME",
                        help="check only NAME (repeatable; default: all)")
    parser.add_argument("--out", default="ANALYSIS_torch_report.json",
                        help="report path (default: %(default)s)")
    parser.add_argument("--list", action="store_true",
                        help="list registered entry points and exit")
    parser.add_argument("--seed-violation", action="store_true",
                        help="add a deliberately violating entry point "
                             "(gate self-test: exit must be nonzero)")
    args = parser.parse_args(argv)

    if args.list:
        for name in entry_point_names():
            print(name)
        return 0

    report = run(args.entry_point, device=args.device, seed_violation=args.seed_violation)
    for res in report["entry_points"]:
        status = "ok" if res["ok"] else "FAIL"
        print(f"[{status}] {res['name']}: {len(res['rules'])} rules, "
              f"{res['n_violations']} violation(s)")
        if "error" in res:
            print(f"    run error:\n{res['error']}")
        for rr in res["rules"]:
            for v in rr["violations"]:
                where = "/".join(v.get("path", [])) or "<top>"
                print(f"    {v['rule']}: {v['message']}  [at {where}]")
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=2)
        fh.write("\n")
    print(f"{len(report['entry_points'])} entry point(s), {report['n_violations']} "
          f"violation(s) -> {args.out}")
    return 1 if report["n_violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
