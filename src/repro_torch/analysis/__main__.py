"""CLI: ``python -m repro_torch.analysis``: run all passes, print findings,
write the JSON report, gate the exit code.

Counterpart of ``python -m repro.analysis``, with its flags, plus
``--device`` (``cuda`` by default; ``cpu`` traces the cores on the plain
versions of the kernels). The exit code is 1 iff any unsuppressed finding
is at or above ``--fail-on`` (default ``warning``).
"""
from __future__ import annotations

import argparse
import sys

from .report import Severity
from .targets import (DEFAULT_MAC_CHUNKS, darknet_target, kws_target,
                      lm_target, run_analysis)


def build_targets(names, *, reduced: bool, device=None):
    # each conv stack is analyzed twice: int8 and its packed (auto-format)
    # twin; the transformer core once (int8 matmuls over the residual DAG)
    out = []
    for n in names:
        if n == "kws":
            out.append(kws_target(reduced=reduced, device=device))
            out.append(kws_target(reduced=reduced, weight_format="auto",
                                  device=device))
        elif n == "darknet":
            out.append(darknet_target(reduced=reduced, device=device))
            out.append(darknet_target(reduced=reduced, weight_format="auto",
                                      device=device))
        elif n == "lm":
            out.append(lm_target(reduced=reduced, device=device))
        else:
            raise SystemExit(f"unknown stack {n!r} (kws/darknet/lm)")
    return out


def main(argv=None, *, figures=None) -> int:
    """Run the CLI on ``argv``; ``figures`` (a dict) receives each trace's
    figures by subject."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static quantization-contract verifier for the "
                    "integer deployment path (intlint/planlint/kernellint)")
    ap.add_argument("--stack", action="append",
                    choices=["kws", "darknet", "lm"],
                    help="stack(s) to analyze (default: all)")
    ap.add_argument("--reduced", action="store_true",
                    help="analyze the reduced stacks (fast; the full-size "
                    "declared shapes are the default)")
    ap.add_argument("--mac-chunks", default=",".join(
        str(k) for k in DEFAULT_MAC_CHUNKS),
        help="comma-separated mac_chunks values to trace the noise model "
             "at (default %(default)s)")
    ap.add_argument("--impl", action="append", choices=["im2col", "fused"],
                    help="conv impl(s) to trace (default: both)")
    ap.add_argument("--table", metavar="PATH",
                    help="lint a candidate autotune table file instead of "
                    "the checked-in one")
    ap.add_argument("--json", metavar="PATH",
                    help="write the machine-readable report here")
    ap.add_argument("--fail-on", default="warning",
                    choices=["info", "warning", "error"],
                    help="lowest severity that fails the run "
                    "(default %(default)s)")
    ap.add_argument("--skip-intlint", action="store_true",
                    help="skip the fx traces (plan/kernel lints only)")
    ap.add_argument("--device", default="cuda",
                    help="device the stacks live and the cores are traced "
                    "on (default %(default)s; 'cpu' runs the kernels' "
                    "plain versions)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes to trace the cores in (default "
                    "%(default)s; each rebuilds its stacks)")
    args = ap.parse_args(argv)

    try:
        mac_chunks = tuple(int(s) for s in args.mac_chunks.split(",") if s)
    except ValueError:
        ap.error(f"--mac-chunks must be comma-separated ints, got "
                 f"{args.mac_chunks!r}")
    if not mac_chunks or any(k < 1 for k in mac_chunks):
        ap.error("--mac-chunks values must be >= 1")
    if args.jobs < 1:
        ap.error("--jobs must be >= 1")

    targets = build_targets(args.stack or ["kws", "darknet", "lm"],
                            reduced=args.reduced, device=args.device)
    report = run_analysis(
        targets, mac_chunks=mac_chunks,
        impls=tuple(args.impl) if args.impl else ("im2col", "fused"),
        table_path=args.table, skip_intlint=args.skip_intlint,
        figures=figures, jobs=args.jobs)

    print(report.render_text())
    if args.json:
        report.write_json(args.json)
        print(f"report written to {args.json}")
    return report.exit_code(Severity.parse(args.fail_on))


if __name__ == "__main__":
    sys.exit(main())
