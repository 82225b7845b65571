"""Trace viewer: summarize flight dumps and export Perfetto traces.

Port of tools/trace_view.py, over the port's flight recorder and spans.
Operator CLI over `adanet_tpu_torch.observability`. Input is either a flight
dump written by the crash flight recorder
(`<model_dir>/flightrec/flight-<pid>.json`) or a directory containing
one or more dumps (every `flight-*.json` is merged, newest last —
searcher and serving processes sharing a model dir each write their
own).

Usage:
    python -m adanet_tpu_torch.tools.trace_view PATH                 # text summary
    python -m adanet_tpu_torch.tools.trace_view PATH --json          # summary as JSON
    python -m adanet_tpu_torch.tools.trace_view PATH --export t.json # Perfetto trace

The text summary aggregates spans by name (count / total / mean / max
milliseconds), lists instants (fault trips, flips, rollbacks,
re-issues) with their correlation tags, and prints the dump's metric
counters. `--export` writes Chrome trace-event JSON loadable at
ui.perfetto.dev (Open trace file) or chrome://tracing. Each dump's
events keep their process in the export (its `pid` and a
`pid <n> (<reason>)` name), on one time axis: the spans' clock is the
host's monotonic clock, which every process of one host shares.

Exit status: 0 on success, 64 (EX_USAGE) on bad arguments or an
unreadable/empty input.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

EX_USAGE = 64


def discover_dumps(path: str) -> List[str]:
    """Flight dump files for `path` (a dump, a flightrec dir, or a
    model dir containing one), oldest first by mtime."""
    if os.path.isfile(path):
        return [path]
    candidates = []
    if os.path.isdir(path):
        candidates = glob.glob(os.path.join(path, "flight-*.json"))
        if not candidates:
            candidates = glob.glob(
                os.path.join(path, "flightrec", "flight-*.json")
            )
    return sorted(candidates, key=lambda p: (os.path.getmtime(p), p))


def load_events(paths: List[str]):
    """(events, dumps): merged SpanEvents plus the parsed dump docs."""
    from adanet_tpu_torch.observability.flightrec import load_dump
    from adanet_tpu_torch.observability.spans import SpanEvent

    events = []
    dumps = []
    for path in paths:
        doc = load_dump(path)
        dumps.append((path, doc))
        for obj in doc.get("events", []):
            events.append(SpanEvent.from_json(obj))
    return events, dumps


def write_process_trace(path: str, dumps) -> str:
    """Writes one Chrome trace of every dump's events, each dump under
    its own process (`pid`), rebased to the earliest event of all."""
    from adanet_tpu_torch.observability.export import chrome_trace
    from adanet_tpu_torch.observability.spans import SpanEvent

    per_dump = [
        (doc, [SpanEvent.from_json(obj) for obj in doc.get("events", [])])
        for _, doc in dumps
    ]
    base = min((e.start for _, events in per_dump for e in events), default=0.0)
    trace_events: List[dict] = []
    for index, (doc, events) in enumerate(per_dump):
        pid = doc.get("pid")
        pid = int(pid) if pid is not None else index + 1
        part = chrome_trace(events, pid=pid, process_name="pid %d (%s)" % (pid, doc.get("reason")))
        shift = (min((e.start for e in events), default=base) - base) * 1e6
        for record in part["traceEvents"]:
            if "ts" in record:
                record["ts"] += shift
            trace_events.append(record)
    with open(path, "w") as f:
        json.dump({"traceEvents": trace_events, "displayTimeUnit": "ms"}, f)
    return path


def summarize(events) -> dict:
    """Aggregate view: spans by name, instants, correlation census."""
    spans: Dict[str, Dict[str, float]] = {}
    instants: List[dict] = []
    for event in events:
        if event.is_instant:
            instants.append(
                {
                    "name": event.name,
                    "correlation": dict(event.correlation),
                    "attrs": dict(event.attrs),
                }
            )
            continue
        agg = spans.setdefault(
            event.name,
            {"count": 0, "total_ms": 0.0, "max_ms": 0.0},
        )
        ms = event.duration * 1e3
        agg["count"] += 1
        agg["total_ms"] += ms
        agg["max_ms"] = max(agg["max_ms"], ms)
    for agg in spans.values():
        agg["mean_ms"] = agg["total_ms"] / max(1, agg["count"])
        for key in ("total_ms", "max_ms", "mean_ms"):
            agg[key] = round(agg[key], 3)
    correlations: Dict[str, List] = {}
    for event in events:
        for key, value in event.correlation.items():
            bucket = correlations.setdefault(key, [])
            if value not in bucket:
                bucket.append(value)
    return {
        "num_events": len(events),
        "spans": {name: spans[name] for name in sorted(spans)},
        "instants": instants,
        "correlations": {
            key: correlations[key] for key in sorted(correlations)
        },
    }


def _print_text(summary: dict, dumps) -> None:
    for path, doc in dumps:
        print(
            "dump %s  reason=%s  pid=%s  events=%d"
            % (
                path,
                doc.get("reason"),
                doc.get("pid"),
                len(doc.get("events", [])),
            )
        )
    print()
    print(
        "%-28s %8s %12s %12s %12s"
        % ("span", "count", "total_ms", "mean_ms", "max_ms")
    )
    for name, agg in summary["spans"].items():
        print(
            "%-28s %8d %12.3f %12.3f %12.3f"
            % (
                name,
                agg["count"],
                agg["total_ms"],
                agg["mean_ms"],
                agg["max_ms"],
            )
        )
    if summary["instants"]:
        print()
        print("instants:")
        for instant in summary["instants"]:
            tags = dict(instant["correlation"])
            tags.update(instant["attrs"])
            print(
                "  %-24s %s"
                % (
                    instant["name"],
                    " ".join(
                        "%s=%s" % (k, tags[k]) for k in sorted(tags)
                    ),
                )
            )
    if summary["correlations"]:
        print()
        print("correlation census:")
        for key, values in summary["correlations"].items():
            shown = ", ".join(str(v) for v in values[:8])
            extra = "" if len(values) <= 8 else " (+%d)" % (len(values) - 8)
            print("  %-12s %s%s" % (key, shown, extra))


def _print_counters(dumps) -> None:
    # The NEWEST dump's snapshot is the authoritative end-state; older
    # dumps are intermediate.
    if not dumps:
        return
    _, doc = dumps[-1]
    counters = doc.get("metrics", {}).get("counters", {})
    if not counters:
        return
    print()
    print("counters (newest dump):")
    for name in sorted(counters):
        print("  %-40s %d" % (name, counters[name]))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="trace_view",
        description="Summarize adanet_tpu_torch flight dumps / export "
        "Perfetto traces.",
    )
    parser.add_argument(
        "path",
        help="a flight dump, a flightrec directory, or a model dir",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="print the summary as one JSON document",
    )
    parser.add_argument(
        "--export",
        metavar="OUT",
        help="write a Perfetto/Chrome trace-event JSON file",
    )
    try:
        args = parser.parse_args(argv)
    except SystemExit:
        return EX_USAGE
    paths = discover_dumps(args.path)
    if not paths:
        sys.stderr.write(
            "trace_view: no flight dumps under %s\n" % args.path
        )
        return EX_USAGE
    try:
        events, dumps = load_events(paths)
    except (OSError, ValueError) as exc:
        sys.stderr.write("trace_view: %s\n" % exc)
        return EX_USAGE
    summary = summarize(events)
    if args.export:
        write_process_trace(args.export, dumps)
        summary["exported"] = args.export
    if args.json:
        print(json.dumps(summary, sort_keys=True))
    else:
        _print_text(summary, dumps)
        _print_counters(dumps)
        if args.export:
            print()
            print(
                "exported %d events -> %s (load at ui.perfetto.dev)"
                % (summary["num_events"], args.export)
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
