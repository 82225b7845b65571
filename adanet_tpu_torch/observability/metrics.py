"""Process-wide metrics registry: counters, gauges, histograms.

One registry per process absorbs the accounting that used to live as
private attributes scattered across subsystems (`CompileCache.store_hits`,
the blobstore's heal/quarantine logging, the scheduler's lease churn,
the serving front-end's watermarks). Every instrument is:

- **cheap**: an `inc`/`set`/`observe` is a couple of attribute writes
  under a per-instrument lock (no global lock on the hot path);
- **shared**: `registry()` returns the process singleton, so one
  `snapshot()` sees every subsystem at once (the flight recorder embeds
  it in crash dumps, `bench.py` reports it);
- **scoped**: `Counter.child()` returns a per-consumer view whose
  increments propagate to the shared aggregate while keeping an exact
  local count — how `CompileCache`/`ArtifactStore` instances keep their
  old per-instance attribute API (`cache.store_hits`) as thin reads
  while the registry still sees fleet totals.

Snapshots are plain JSON-able dicts, deterministic key order.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
]

#: Default histogram boundaries (seconds-flavored: 1ms .. 100s), chosen
#: so latency EWMAs, batch execution, and span durations all land in
#: resolvable buckets without per-call configuration.
DEFAULT_BUCKETS = (
    0.001,
    0.005,
    0.01,
    0.05,
    0.1,
    0.5,
    1.0,
    5.0,
    10.0,
    100.0,
)


class Counter:
    """A monotonically increasing count.

    `child()` creates a scoped view: its `inc` adds to BOTH the child
    and this (parent) counter, so per-instance exactness and the
    process-wide aggregate come from one write path.
    """

    __slots__ = ("_lock", "_value", "_parent")

    def __init__(self, parent: Optional["Counter"] = None):
        self._lock = threading.Lock()
        self._value = 0
        self._parent = parent

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n
        if self._parent is not None:
            self._parent.inc(n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def child(self) -> "Counter":
        return Counter(parent=self)


class Gauge:
    """A point-in-time value (queue depth, EWMA, occupancy)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-boundary histogram: per-bucket counts + sum + count.

    `boundaries` are upper-inclusive bucket edges; an observation above
    the last edge lands in the implicit overflow bucket. Boundaries are
    fixed at creation so concurrent observers never disagree on the
    bucket layout.
    """

    __slots__ = ("_lock", "boundaries", "_counts", "_sum", "_count")

    def __init__(self, boundaries: Sequence[float] = DEFAULT_BUCKETS):
        edges = sorted(float(b) for b in boundaries)
        if not edges:
            raise ValueError("histogram needs at least one boundary")
        self._lock = threading.Lock()
        self.boundaries: List[float] = edges
        self._counts = [0] * (len(edges) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        # bisect_left: an observation equal to an edge lands in that
        # edge's bucket (upper-inclusive).
        index = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            self._counts[index] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def bucket_counts(self) -> List[int]:
        """Counts per bucket; the final entry is the overflow bucket."""
        with self._lock:
            return list(self._counts)


class MetricsRegistry:
    """Name -> instrument, get-or-create, process-shareable.

    Names are dotted paths (`store.blob.heals`,
    `serving.frontend.queue_depth`). Requesting an existing name with a
    different instrument kind raises — a registry where `snapshot()`
    silently changes shape between runs is worse than a crash.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _claim(self, name: str, kind: str) -> None:
        owners = {
            "counter": self._counters,
            "gauge": self._gauges,
            "histogram": self._histograms,
        }
        for other_kind, table in owners.items():
            if other_kind != kind and name in table:
                raise ValueError(
                    "metric %r already registered as a %s"
                    % (name, other_kind)
                )

    def counter(self, name: str) -> Counter:
        with self._lock:
            self._claim(name, "counter")
            if name not in self._counters:
                self._counters[name] = Counter()
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            self._claim(name, "gauge")
            if name not in self._gauges:
                self._gauges[name] = Gauge()
            return self._gauges[name]

    def histogram(
        self, name: str, boundaries: Sequence[float] = DEFAULT_BUCKETS
    ) -> Histogram:
        with self._lock:
            self._claim(name, "histogram")
            if name not in self._histograms:
                self._histograms[name] = Histogram(boundaries)
            return self._histograms[name]

    def snapshot(self) -> dict:
        """JSON-able view of every instrument, deterministic order."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {
                name: counters[name].value for name in sorted(counters)
            },
            "gauges": {
                name: gauges[name].value for name in sorted(gauges)
            },
            "histograms": {
                name: {
                    "boundaries": histograms[name].boundaries,
                    "bucket_counts": histograms[name].bucket_counts(),
                    "sum": histograms[name].sum,
                    "count": histograms[name].count,
                }
                for name in sorted(histograms)
            },
        }

    def reset(self) -> None:
        """Drops every instrument (tests only: consumers holding child
        counters keep propagating into orphaned parents, which is
        harmless — their aggregates just stop being visible)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry singleton."""
    return _REGISTRY
