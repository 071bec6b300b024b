"""CLI for the port's static guardrails (the port's
``poseidon_tpu/analysis/__main__.py``).

    python -m poseidon_tpu_torch.analysis                 # lints, baseline-aware
    python -m poseidon_tpu_torch.analysis path/to/file.py # lint specific targets
    python -m poseidon_tpu_torch.analysis --contracts all # step contract gates
    python -m poseidon_tpu_torch.analysis --refresh-contracts lenet,alexnet
    python -m poseidon_tpu_torch.analysis --protocols     # wire-schema lint + gate
    python -m poseidon_tpu_torch.analysis --refresh-schema
    python -m poseidon_tpu_torch.analysis --model-check smoke
    python -m poseidon_tpu_torch.analysis --collectives lenet
    python -m poseidon_tpu_torch.analysis --write-baseline

Exit codes: 0 clean; 1 NEW lint findings (not in baseline); 2 a contract
violation — a step contract diff, a protocol-schema regression vs
``analysis/protocol_schema.json``, a model-checker invariant violation
(or a seeded mutation the checker stopped catching), or a
cross-participant collective-schedule divergence; 3 usage error (e.g. an
unknown model name); 4 the gate itself failed to run (an error while
measuring — the findings report is still written). The default
invocation and ``--protocols``/``--model-check`` import neither torch nor
the linted code (pure AST / pure Python), so they are safe as pre-commit
hooks; ``--contracts`` and ``--collectives`` run real steps on the CPU —
seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import (BASELINE_PATH, filter_new, load_baseline, run_lints,
               save_baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m poseidon_tpu_torch.analysis",
        description="concurrency + step-hygiene lints, the protocol "
                    "gates and the step contract gates")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the package + the "
                         "instrumented scripts)")
    ap.add_argument("--baseline", default=BASELINE_PATH,
                    help="grandfather list (default: the checked-in one)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, grandfathered or not")
    ap.add_argument("--fail-on-new", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="exit 1 on findings not in the baseline (default; "
                         "kept explicit for CI readability — "
                         "--no-fail-on-new for a report-only survey)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline to grandfather the current "
                         "findings (carries over existing reasons)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to restrict to")
    ap.add_argument("--report", default=None,
                    help="write a JSON findings report here (CI artifact)")
    ap.add_argument("--contracts", default=None, metavar="MODELS",
                    help="verify step contracts: 'all' or a comma list of "
                         "lenet,alexnet,googlenet (imports torch)")
    ap.add_argument("--refresh-contracts", default=None, metavar="MODELS",
                    help="recompute + rewrite contract goldens, printing "
                         "the diff for review")
    ap.add_argument("--protocols", action="store_true",
                    help="wire-schema lint (PROTO2xx, baseline-aware) + "
                         "diff the extracted protocol schema against the "
                         "checked-in golden (exit 2 on schema drift)")
    ap.add_argument("--schema", default=None,
                    help="protocol-schema golden path (default: "
                         "poseidon_tpu_torch/analysis/protocol_schema.json)")
    ap.add_argument("--refresh-schema", action="store_true",
                    help="re-extract + rewrite the protocol schema "
                         "golden, printing old->new for review")
    ap.add_argument("--model-check", default=None, metavar="LEVEL",
                    choices=("tiny", "smoke", "full"),
                    help="exhaustively model-check the SSP/managed-comm "
                         "protocol (tiny|smoke|full); exit 2 on an "
                         "invariant violation or an uncaught seeded "
                         "mutation")
    ap.add_argument("--collectives", default=None, metavar="MODELS",
                    help="cross-participant collective-schedule gate: "
                         "run the sharded step twice independently and "
                         "require identical collective sequences "
                         "(imports torch); 'all' or a comma list")
    # ALL usage errors exit 3 — argparse's default of 2 collides with
    # the documented contract-violation code
    ap.error = lambda msg: ap.exit(3, f"{ap.prog}: error: {msg}\n")
    args = ap.parse_args(argv)

    # a typo'd target must not pass as "0 findings": a guardrail that
    # silently lints nothing is worse than none
    for p in args.paths:
        if not os.path.exists(p):
            ap.error(f"lint target does not exist: {p!r}")

    rules = args.rules.split(",") if args.rules else None
    findings = run_lints(args.paths or None, rules=rules)
    if args.paths and (args.protocols or args.refresh_schema):
        # run_lints skips the cross-file protocol lint when restricted
        # to explicit paths — but an invocation that ASKED for the
        # protocol gate must not read as a passed check that never ran
        # (the extraction memo makes this free for the default case)
        from . import protocol as PR0
        extra = PR0.run_protocol_lint()
        if rules:
            extra = [f for f in extra
                     if f.rule in set(rules) | {"CFG001", "THR000"}]
        findings = sorted(findings + extra,
                          key=lambda f: (f.path, f.line, f.rule))
    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    new = filter_new(findings, baseline)

    if args.write_baseline:
        # a restricted run sees only a subset of findings; rewriting the
        # whole grandfather list from it would delete every other curated
        # entry (and its written reason)
        if args.paths or args.rules:
            ap.exit(3, f"{ap.prog}: error: --write-baseline rewrites the "
                       f"WHOLE grandfather list; run it without path "
                       f"arguments or --rules\n")
        # carry reasons from the on-disk baseline even under
        # --no-baseline (that flag only widens REPORTING; rewriting the
        # grandfather list must never drop the curated justifications)
        path = save_baseline(findings, reasons=load_baseline(args.baseline),
                             path=args.baseline)
        print(f"baseline rewritten: {path} ({len(findings)} findings "
              f"grandfathered)")
        return 0

    for f in new:
        print(f.render())
    n_base = len(findings) - len(new)
    print(f"{len(new)} new finding(s), {n_base} baselined "
          f"({len(findings)} total)")

    report = {"findings": [vars(f) | {"fingerprint": f.fingerprint,
                                      "baselined": f.fingerprint in baseline}
                           for f in findings],
              "new": len(new), "baselined": n_base}
    rc = 1 if (new and args.fail_on_new) else 0

    from . import contracts as C

    def parse_models(spec: str):
        # validate BEFORE any golden is touched: a typo'd model in a
        # --refresh-contracts list must not leave the contract dir
        # half-rewritten
        models = (C.MODELS if spec == "all"
                  else tuple(m.strip() for m in spec.split(",") if m.strip()))
        bad = [m for m in models if m not in C.MODELS]
        if bad:
            # NOT ap.error: argparse exits 2, which the CLI contract
            # reserves for a real contract violation
            ap.exit(3, f"{ap.prog}: error: unknown model(s) {bad}; "
                       f"choose from {list(C.MODELS)} or 'all'\n")
        if not models:
            # a gate over zero models is vacuously "ok" — an unset CI
            # variable must not read as a passed contract check
            ap.exit(3, f"{ap.prog}: error: empty model list; choose from "
                       f"{list(C.MODELS)} or 'all'\n")
        return models

    try:
        if args.refresh_contracts is not None:
            C.refresh(parse_models(args.refresh_contracts))
        elif args.contracts is not None:
            ok, con_report = C.check_all(parse_models(args.contracts))
            report["contracts"] = con_report
            for m, r in con_report.items():
                status = "ok" if r["ok"] else "VIOLATED"
                print(f"contract {m}: {status}")
                for d in r["diffs"]:
                    print(f"  {d}")
            if not ok:
                rc = 2

        if args.refresh_schema:
            from . import protocol as PR
            schema, _ = PR.extract_schema()
            old = PR.load_schema(args.schema)
            if old is not None:
                for d in PR.diff_schema(old, schema):
                    print(f"  schema: {d}")
            path = PR.save_schema(schema, args.schema)
            print(f"protocol schema refreshed: {path}")
        elif args.protocols:
            # the PROTO findings themselves already rode the default lint
            # run above (baseline-aware, exit 1); this gate adds the
            # SCHEMA diff — vocabulary drift vs the checked-in golden is
            # a contract regression (exit 2), reviewed via
            # --refresh-schema exactly like --refresh-contracts
            from . import protocol as PR
            schema, _ = PR.extract_schema()
            golden = PR.load_schema(args.schema)
            if golden is None:
                print("protocol schema: no checked-in golden (run "
                      "--refresh-schema and commit it)")
                report["protocol_schema"] = {"ok": False,
                                             "diffs": ["missing golden"]}
                rc = 2
            else:
                sdiffs = PR.diff_schema(golden, schema)
                report["protocol_schema"] = {"ok": not sdiffs,
                                             "diffs": sdiffs}
                for d in sdiffs:
                    print(f"  schema drift: {d}")
                if sdiffs:
                    print("protocol schema: VIOLATED (extraction no "
                          "longer matches the golden; --refresh-schema "
                          "if the change is intended)")
                    rc = 2
                else:
                    print("protocol schema: ok")

        if args.model_check is not None:
            from . import model_check as MC
            results, caught = MC.run_level(args.model_check)
            report["model_check"] = {
                "level": args.model_check,
                "configs": [{
                    "name": r.config.name, "states": r.states,
                    "transitions": r.transitions, "ok": r.ok,
                    "violations": [{"invariant": v.invariant,
                                    "detail": v.detail,
                                    "trace": list(v.trace)}
                                   for v in r.violations],
                } for r in results],
                "mutations_caught": caught,
            }
            for r in results:
                print(r.render())
                for v in r.violations:
                    print(f"  trace: {' -> '.join(v.trace)}")
            for m, c in caught.items():
                print(f"mutation self-test {m}: "
                      f"{'caught' if c else 'NOT CAUGHT'}")
            if any(not r.ok for r in results) or \
                    not all(caught.values()):
                # a protocol invariant violated, or the checker stopped
                # catching a seeded bug — both are exit-2 regressions
                rc = 2

        if args.collectives is not None:
            ok, crep = C.collective_consistency(
                parse_models(args.collectives))
            report["collectives"] = crep
            for m, r in crep.items():
                status = ("skipped" if r.get("skipped")
                          else "ok" if r["ok"] else "DIVERGED")
                print(f"collective schedule {m}: {status} "
                      f"({r.get('sequence_len', 0)} collectives x "
                      f"{r.get('participants', 0)} participants)")
                for d in r["diffs"]:
                    print(f"  {d}")
            if not ok:
                rc = 2
    except Exception as e:   # infra failure (OOM, a process group up), NOT a lint
        # regression (1) or a measured violation (2)
        print(f"contract check failed to run: {type(e).__name__}: {e}",
              file=sys.stderr)
        report["contracts_error"] = f"{type(e).__name__}: {e}"
        rc = 4
    finally:
        # the lint half already completed — CI keeps its artifact even
        # when the contract half dies (or a usage error exits early)
        if args.report:
            with open(args.report, "w") as f:
                json.dump(report, f, indent=2)
            print(f"report written: {args.report}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
