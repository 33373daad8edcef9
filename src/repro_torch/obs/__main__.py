"""``python -m repro_torch.obs trace.jsonl`` — validate + pretty-print a trace.

Default mode renders the flamegraph-text span tree (after a schema check);
``--validate`` only checks the schema and exits 1 on any error. Traces are
in the reference's schema, so either package's CLI reads either's files.
"""

from __future__ import annotations

import argparse
import sys

from .export import read_trace_jsonl, render_rows, validate_trace_jsonl


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="validate and pretty-print a repro_torch.obs trace JSONL file")
    ap.add_argument("trace", help="trace JSONL file (obs.write_trace_jsonl)")
    ap.add_argument("--validate", action="store_true",
                    help="schema check only; exit 1 on any violation")
    args = ap.parse_args(argv)

    errors = validate_trace_jsonl(args.trace)
    for e in errors:
        print(f"schema: {e}", file=sys.stderr)
    if args.validate:
        status = "OK" if not errors else f"{len(errors)} schema error(s)"
        print(f"{args.trace}: {status}")
        return 1 if errors else 0
    if errors:
        print(f"{args.trace}: refusing to render an invalid trace "
              f"({len(errors)} schema error(s))", file=sys.stderr)
        return 1
    print(render_rows(read_trace_jsonl(args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
