"""Chrome-trace / Perfetto JSON export of recorded span events.

Perfetto (ui.perfetto.dev) and chrome://tracing both load the legacy
Chrome trace-event JSON format: a `traceEvents` list of complete-span
(`ph: "X"`) and instant (`ph: "i"`) events with microsecond timestamps,
plus metadata events naming processes and threads. The exporter maps:

- one span -> one `"X"` event (`dur` = span duration in us), `args`
  carrying the span's correlation tags and attributes;
- one instant -> one `"i"` event (scope `t`: thread-local);
- each recording thread -> one `tid` lane (named via `thread_name`
  metadata), so nested spans render as the familiar flame stack;
- correlation hierarchies stay queryable: Perfetto's `args.*` filters
  select e.g. all spans of one `iteration` or one `work_unit`.

Timestamps are rebased to the earliest event so traces from monotonic
clocks (which have an arbitrary epoch) start at t=0.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

from adanet_tpu_torch.observability.spans import SpanEvent

__all__ = ["chrome_trace", "write_chrome_trace"]


def chrome_trace(
    events: Sequence[SpanEvent],
    pid: Optional[int] = None,
    process_name: str = "adanet_tpu_torch",
) -> dict:
    """Builds the Chrome trace-event document for `events`."""
    pid = os.getpid() if pid is None else int(pid)
    base = min((e.start for e in events), default=0.0)
    tids: Dict[str, int] = {}
    trace_events: List[dict] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            "args": {"name": process_name},
        }
    ]
    for event in events:
        tid = tids.get(event.thread)
        if tid is None:
            tid = tids[event.thread] = len(tids) + 1
            trace_events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": event.thread},
                }
            )
        args = dict(event.correlation)
        args.update(event.attrs)
        record = {
            "name": event.name,
            "pid": pid,
            "tid": tid,
            "ts": (event.start - base) * 1e6,
            "args": args,
        }
        if event.is_instant:
            record["ph"] = "i"
            record["s"] = "t"
        else:
            record["ph"] = "X"
            record["dur"] = event.duration * 1e6
        trace_events.append(record)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(
    path: str,
    events: Iterable[SpanEvent],
    pid: Optional[int] = None,
    process_name: str = "adanet_tpu_torch",
) -> str:
    """Writes the Perfetto-loadable JSON for `events`; returns `path`."""
    doc = chrome_trace(list(events), pid=pid, process_name=process_name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
