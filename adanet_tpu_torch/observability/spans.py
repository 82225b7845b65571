"""Nestable spans with correlation IDs into a bounded ring buffer.

The span model (docs/observability.md):

- A **span** is a named interval with attributes, recorded when it
  CLOSES (complete spans only — a crash leaves the open span absent,
  and the flight recorder's instants narrate what was in flight).
- Spans **nest** per thread: a span opened while another is active
  becomes its child (`parent_id`), so one trace reconstructs the call
  tree without the caller threading IDs by hand.
- **Correlation IDs** are small key->value tags (`search_id`,
  `iteration`, `candidate`, `work_unit`, `request`, `batch`) that flow
  DOWN the stack: a child inherits every ancestor tag and may add its
  own, so a work-unit span deep in the scheduler still carries the
  search_id the Estimator opened three levels up.
- **Instants** are zero-duration point events (fault trips, lease
  re-issues, flips) sharing the same inheritance.

Cost model: recording is one clock read per edge plus a deque append
(the ring buffer is a `deque(maxlen=...)` — append is atomic under the
GIL, no lock on the hot path; snapshots copy under a lock). DISABLED
tracing is the contract the overhead gate in `tests/` enforces: zero
clock reads, zero allocations beyond returning a shared no-op span.

The clock is injected (`clock=`), monotonic by default, and must never
be read from jit-traced code — jaxlint JL016 enforces that repo-wide;
traced device timing belongs to `utils/device_timing.py`.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["SpanEvent", "Span", "Tracer", "tracer"]

#: Ring capacity of the default tracer (overridable at construction).
DEFAULT_CAPACITY = int(os.environ.get("ADANET_TRACE_CAPACITY", "4096"))


class SpanEvent:
    """One closed span (or instant) in the ring buffer."""

    __slots__ = (
        "name",
        "span_id",
        "parent_id",
        "start",
        "end",
        "correlation",
        "attrs",
        "thread",
    )

    def __init__(
        self,
        name: str,
        span_id: int,
        parent_id: Optional[int],
        start: float,
        end: float,
        correlation: Dict[str, Any],
        attrs: Dict[str, Any],
        thread: str,
    ):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end = end
        self.correlation = correlation
        self.attrs = attrs
        self.thread = thread

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def is_instant(self) -> bool:
        return self.end == self.start

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "correlation": dict(self.correlation),
            "attrs": dict(self.attrs),
            "thread": self.thread,
        }

    @staticmethod
    def from_json(obj: dict) -> "SpanEvent":
        return SpanEvent(
            name=str(obj["name"]),
            span_id=int(obj["span_id"]),
            parent_id=(
                None if obj.get("parent_id") is None else int(obj["parent_id"])
            ),
            start=float(obj["start"]),
            end=float(obj["end"]),
            correlation=dict(obj.get("correlation", {})),
            attrs=dict(obj.get("attrs", {})),
            thread=str(obj.get("thread", "")),
        )


class Span:
    """An OPEN span: a context manager that records itself on exit."""

    __slots__ = ("_tracer", "name", "span_id", "parent_id",
                 "correlation", "attrs", "_start")

    def __init__(self, tracer, name, span_id, parent_id, correlation, attrs):
        self._tracer = tracer
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.correlation = correlation
        self.attrs = attrs
        self._start = 0.0

    def set(self, **attrs) -> "Span":
        """Attaches attributes to an open span (e.g. a result count)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._start = self._tracer._now()
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._pop(self)


class _NoopSpan:
    """The shared disabled-path span: no clock, no ring, no state."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NOOP = _NoopSpan()


class Tracer:
    """Records spans into a bounded ring buffer.

    Thread-safe: each thread keeps its own open-span stack (nesting and
    correlation inheritance are per-thread); the ring is shared.
    `clock_reads` counts every clock access — the overhead gate asserts
    it stays at zero across an instrumented hot path with tracing
    disabled.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        clock=time.monotonic,
        enabled: bool = True,
    ):
        self.capacity = int(capacity)
        self._clock = clock
        self._enabled = bool(enabled)
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity
        )
        self._snapshot_lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._clock_reads = 0

    # ------------------------------------------------------------- state

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def clock_reads(self) -> int:
        return self._clock_reads

    def _now(self) -> float:
        # Plain int increment: a GIL-atomic-enough counter is fine here;
        # the gate asserts EXACT zero, which only needs "never called".
        self._clock_reads += 1
        return self._clock()

    # ----------------------------------------------------------- nesting

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        end = self._now()
        stack = self._stack()
        # Exits normally come in LIFO order; a span closed out of order
        # (generator lifetimes) just removes itself.
        if stack and stack[-1] is span:
            stack.pop()
        else:
            try:
                stack.remove(span)
            except ValueError:
                pass
        self._record(
            SpanEvent(
                name=span.name,
                span_id=span.span_id,
                parent_id=span.parent_id,
                start=span._start,
                end=end,
                correlation=span.correlation,
                attrs=span.attrs,
                thread=threading.current_thread().name,
            )
        )

    def _record(self, event: SpanEvent) -> None:
        # deque.append with maxlen is the lock-cheap ring write.
        self._ring.append(event)

    # --------------------------------------------------------------- API

    def span(self, name: str, correlation: Optional[dict] = None, **attrs):
        """Opens a nested span (use as a context manager).

        `correlation` tags merge OVER the ambient (inherited) tags;
        `attrs` are span-local and not inherited by children.
        """
        if not self._enabled:
            return _NOOP
        stack = self._stack()
        parent = stack[-1] if stack else None
        inherited = dict(parent.correlation) if parent is not None else {}
        if correlation:
            inherited.update(correlation)
        return Span(
            self,
            name,
            next(self._ids),
            parent.span_id if parent is not None else None,
            inherited,
            dict(attrs),
        )

    def instant(
        self, name: str, correlation: Optional[dict] = None, **attrs
    ) -> None:
        """Records a zero-duration point event at the current nesting."""
        if not self._enabled:
            return
        now = self._now()
        stack = self._stack()
        parent = stack[-1] if stack else None
        inherited = dict(parent.correlation) if parent is not None else {}
        if correlation:
            inherited.update(correlation)
        self._record(
            SpanEvent(
                name=name,
                span_id=next(self._ids),
                parent_id=parent.span_id if parent is not None else None,
                start=now,
                end=now,
                correlation=inherited,
                attrs=dict(attrs),
                thread=threading.current_thread().name,
            )
        )

    def current_correlation(self) -> Dict[str, Any]:
        """The ambient correlation tags on this thread (empty when no
        span is open) — for consumers that label metrics or log lines
        with the active trace position."""
        stack = self._stack()
        return dict(stack[-1].correlation) if stack else {}

    def events(self) -> List[SpanEvent]:
        """Snapshot of the ring, oldest first.

        On CPython `list(deque)` is GIL-atomic against the lock-free
        appends, but that is an implementation detail — retry on the
        mutated-during-iteration error so a flight dump can never be
        lost to a concurrent recorder on a non-GIL runtime.
        """
        with self._snapshot_lock:
            for _ in range(8):
                try:
                    return list(self._ring)
                except RuntimeError:  # pragma: no cover - non-GIL only
                    continue
            return list(self._ring)

    def clear(self) -> None:
        with self._snapshot_lock:
            self._ring.clear()


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-wide tracer singleton."""
    return _TRACER
