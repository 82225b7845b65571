"""Async serving front-end: bounded queue, admission control, drain.

The request path of the serving plane. Clients `submit()` feature
batches; a single executor thread forms continuous batches (up to the
batcher's largest bucket, waiting at most `batch_wait_secs` for
followers once a request is ready) and answers through the
health-gated `ModelPool` incumbent. Three protections keep the plane
standing under abuse:

- **bounded queue + load shedding.** Admission rejects with a
  `retry_after` hint (the 429/503 analogue, never a 5xx) once queue
  depth crosses the high watermark, and keeps shedding until depth
  falls below the LOW watermark — hysteresis, so the shed decision
  cannot flap once per request at the boundary. An optional queue-wait
  EWMA watermark sheds on latency even when depth looks healthy
  (slow-model mode).
- **per-request deadline budgets.** Every request carries an absolute
  deadline; at dequeue, a request whose remaining budget is smaller
  than the EWMA of recent batch execution times is answered
  `deadline_exceeded` immediately instead of burning device time on an
  answer the client already abandoned.
- **SIGTERM drain.** `install_sigterm_handler()` turns SIGTERM into:
  stop admitting (new requests shed with `retry_after`), finish every
  request already queued or in flight, then stop — a preempted server
  never drops accepted work.

Status taxonomy: `ok` (2xx),
`shed`/`deadline_exceeded`/`unavailable`/`draining`/`invalid_argument`
(4xx-or-503-with-Retry-After, the client's fault or a transient), and
`error` — the only 5xx-equivalent, which the chaos tests assert stays
at zero through bit-rot, searcher crashes, and queue saturation.

Host-only module: no device code here — execution belongs to
`serving.batcher`, policy to this file, so the whole admission path is
testable against a mocked clock.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from adanet_tpu_torch.observability import metrics as metrics_lib
from adanet_tpu_torch.observability import spans as spans_lib
from adanet_tpu_torch.observability import flightrec

_LOG = logging.getLogger("adanet_tpu_torch")

STATUS_OK = "ok"
STATUS_SHED = "shed"
STATUS_DEADLINE = "deadline_exceeded"
STATUS_UNAVAILABLE = "unavailable"
STATUS_DRAINING = "draining"
STATUS_INVALID = "invalid_argument"
STATUS_ERROR = "error"

#: Statuses that are the serving plane's own failure (the 5xx
#: analogue). Everything else is an orderly client-visible rejection.
ERROR_STATUSES = (STATUS_ERROR,)


@dataclasses.dataclass
class FrontendConfig:
    max_queue_depth: int = 256
    #: Shed when depth >= high * max_queue_depth; stop shedding only
    #: once depth <= low * max_queue_depth (hysteresis).
    shed_high_watermark: float = 0.75
    shed_low_watermark: float = 0.25
    #: Optional queue-wait EWMA watermarks (seconds); None disables.
    latency_high_watermark_secs: Optional[float] = None
    latency_low_watermark_secs: Optional[float] = None
    latency_decay: float = 0.8
    #: Default per-request deadline when the caller sets none.
    default_deadline_secs: float = 2.0
    #: How long the executor waits for followers after the first
    #: request of a batch is ready.
    batch_wait_secs: float = 0.002
    #: Retry-after hint attached to sheds/drains (seconds).
    retry_after_secs: float = 0.05
    #: EWMA decay for the batch-execution-time estimate feeding the
    #: deadline budget check.
    exec_decay: float = 0.8
    #: Generation-chain discovery period for the poller thread.
    poll_interval_secs: float = 0.25


@dataclasses.dataclass
class ServeResult:
    status: str
    outputs: Optional[Any] = None
    generation: Optional[int] = None
    retry_after: Optional[float] = None
    error: Optional[str] = None
    #: Which cascade tier answered: 0 = cheap member, 1 = full
    #: ensemble, None = the generation has no cascade.
    cascade_level: Optional[int] = None

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK


class AdmissionController:
    """Pure shed-state machine (mocked-clock testable, no threads).

    One boolean `shedding` state with two triggers: queue depth
    (enter at `high`, leave at `low`) and, when configured, the
    queue-wait EWMA (enter at `latency_high`, leave at
    `latency_low`). Recovery requires BOTH signals below their low
    watermarks, so a latency storm cannot be masked by a briefly
    shallow queue.
    """

    def __init__(self, config: FrontendConfig):
        self.config = config
        self.shedding = False
        self.wait_ewma = 0.0
        self._high = max(
            1, int(config.shed_high_watermark * config.max_queue_depth)
        )
        self._low = int(
            config.shed_low_watermark * config.max_queue_depth
        )

    def observe_wait(self, wait_secs: float) -> None:
        decay = self.config.latency_decay
        self.wait_ewma = decay * self.wait_ewma + (1.0 - decay) * float(
            wait_secs
        )

    def _latency_high(self) -> bool:
        high = self.config.latency_high_watermark_secs
        return high is not None and self.wait_ewma > high

    def _latency_recovered(self) -> bool:
        high = self.config.latency_high_watermark_secs
        if high is None:
            return True
        low = self.config.latency_low_watermark_secs
        return self.wait_ewma <= (high if low is None else low)

    def admit(self, queue_depth: int) -> bool:
        """Updates the shed state for the observed depth; True = admit."""
        if queue_depth >= self.config.max_queue_depth:
            self.shedding = True  # hard bound, watermarks aside
            return False
        if not self.shedding:
            if queue_depth >= self._high or self._latency_high():
                self.shedding = True
        elif queue_depth <= self._low and self._latency_recovered():
            self.shedding = False
        return not self.shedding


class ExecBudget:
    """EWMA of batch execution seconds -> the deadline-budget estimate."""

    def __init__(self, decay: float = 0.8):
        self._decay = decay
        self.estimate = 0.0

    def observe(self, exec_secs: float) -> None:
        if self.estimate == 0.0:
            self.estimate = float(exec_secs)
        else:
            self.estimate = self._decay * self.estimate + (
                1.0 - self._decay
            ) * float(exec_secs)

    def expired(self, deadline: float, now: float) -> bool:
        """True when the remaining budget cannot cover one execution."""
        return (deadline - now) < self.estimate


class _Request:
    __slots__ = (
        "features",
        "deadline",
        "enqueued_at",
        "done",
        "result",
        "rid",
    )

    def __init__(self, features, deadline, enqueued_at):
        self.features = features
        self.deadline = deadline
        self.enqueued_at = enqueued_at
        self.done = threading.Event()
        self.result: Optional[ServeResult] = None
        self.rid = 0

    def respond(self, result: ServeResult) -> None:
        self.result = result
        self.done.set()

    def wait(self, timeout: Optional[float] = None) -> ServeResult:
        if not self.done.wait(timeout):
            return ServeResult(
                status=STATUS_DEADLINE,
                error="client wait timed out before a response",
            )
        return self.result


class ServingFrontend:
    """The serving loop: admission -> queue -> batch -> respond."""

    def __init__(
        self,
        batcher,
        config: Optional[FrontendConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.batcher = batcher
        self.pool = batcher.pool
        self.config = config or FrontendConfig()
        self._clock = clock
        self.admission = AdmissionController(self.config)
        self.budget = ExecBudget(self.config.exec_decay)
        self._queue: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._started = False
        self._draining = False
        self._signal_drain = False
        self._stopped = threading.Event()
        self._drained = threading.Event()
        self._threads: List[threading.Thread] = []
        self.counters: Dict[str, int] = collections.Counter()
        self._request_ids = itertools.count(1)
        self._batch_ids = itertools.count(1)
        # Exported backpressure watermarks (ROADMAP item 2's replica
        # balancer consumes these): queue depth, queue-wait EWMA, the
        # batch-exec EWMA feeding deadline budgets, and per-status
        # counters (sheds included) — all on the process registry so a
        # balancer polls ONE snapshot instead of N private stats() APIs.
        reg = metrics_lib.registry()
        self._g_depth = reg.gauge("serving.frontend.queue_depth")
        self._g_wait_ewma = reg.gauge("serving.frontend.wait_ewma_secs")
        self._g_exec_ewma = reg.gauge("serving.frontend.exec_ewma_secs")
        self._g_shedding = reg.gauge("serving.frontend.shedding")
        self._m_status = {
            status: reg.counter("serving.frontend.status.%s" % status)
            for status in (
                STATUS_OK,
                STATUS_SHED,
                STATUS_DEADLINE,
                STATUS_UNAVAILABLE,
                STATUS_DRAINING,
                STATUS_INVALID,
                STATUS_ERROR,
            )
        }

    def _count(self, status: str) -> None:
        self.counters[status] += 1
        counter = self._m_status.get(status)
        if counter is not None:
            counter.inc()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ServingFrontend":
        if self._started:
            return self
        self._started = True
        worker = threading.Thread(
            target=self._run, name="serving-executor", daemon=True
        )
        poller = threading.Thread(
            target=self._poll_loop, name="serving-poller", daemon=True
        )
        self._threads = [worker, poller]
        for thread in self._threads:
            thread.start()
        return self

    def request_drain(self) -> None:
        """Stops admission; the executor finishes the queue then stops.

        Async-signal-safe: a bare attribute write, NO lock — a SIGTERM
        can land while the interrupted main thread holds `_cond` (e.g.
        inside `submit_async`), and a handler that locked it would
        deadlock the process it is trying to drain. The executor's
        bounded waits observe the flag within one timeout tick."""
        self._draining = True

    def drain(self, timeout: float = 30.0) -> bool:
        """Blocking drain: reject new work, answer everything accepted."""
        self.request_drain()
        drained = self._drained.wait(timeout)
        self._stopped.set()
        with self._cond:
            self._cond.notify_all()
        for thread in self._threads:
            thread.join(timeout=5.0)
        return drained

    def install_sigterm_handler(self) -> None:
        previous = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            _LOG.warning(
                "SIGTERM: draining the serving queue, then exiting."
            )
            # Bare attribute write, same async-signal-safety argument
            # as request_drain: marks this drain as signal-initiated so
            # the executor's tail dump carries an honest reason.
            self._signal_drain = True
            self.request_drain()
            if callable(previous) and previous not in (
                signal.SIG_IGN,
                signal.SIG_DFL,
            ):
                previous(signum, frame)

        signal.signal(signal.SIGTERM, handler)

    # ------------------------------------------------------------ admission

    def submit_async(
        self,
        features: Any,
        deadline_secs: Optional[float] = None,
    ) -> _Request:
        """Admission-checked enqueue; the returned handle resolves to a
        ServeResult (possibly an immediate rejection)."""
        now = self._clock()
        deadline = now + (
            deadline_secs
            if deadline_secs is not None
            else self.config.default_deadline_secs
        )
        request = _Request(features, deadline, now)
        request.rid = next(self._request_ids)
        retry = self.config.retry_after_secs
        # A request the batcher could never place (no feature leaves, or
        # more rows than the largest bucket) is the CLIENT's fault: an
        # orderly 4xx-equivalent at admission, never a mid-batch
        # STATUS_ERROR that would dirty the zero-5xx contract.
        try:
            from adanet_tpu_torch.serving.batcher import request_rows

            rows = request_rows(features)
        except Exception as exc:
            self._count(STATUS_INVALID)
            request.respond(
                ServeResult(
                    status=STATUS_INVALID,
                    error="unbatchable request: %s" % exc,
                )
            )
            return request
        if rows > self.batcher.max_batch:
            self._count(STATUS_INVALID)
            request.respond(
                ServeResult(
                    status=STATUS_INVALID,
                    error="request of %d rows exceeds the largest "
                    "bucket (%d)" % (rows, self.batcher.max_batch),
                )
            )
            return request
        if self.pool.active is None:
            self._count(STATUS_UNAVAILABLE)
            request.respond(
                ServeResult(
                    status=STATUS_UNAVAILABLE,
                    retry_after=retry,
                    error="no generation has passed the health gate yet",
                )
            )
            return request
        with self._cond:
            if self._draining:
                self._count(STATUS_DRAINING)
                request.respond(
                    ServeResult(
                        status=STATUS_DRAINING, retry_after=retry
                    )
                )
                return request
            if not self.admission.admit(len(self._queue)):
                self._count(STATUS_SHED)
                request.respond(
                    ServeResult(status=STATUS_SHED, retry_after=retry)
                )
                return request
            self._queue.append(request)
            self._g_depth.set(len(self._queue))
            self._cond.notify_all()
        return request

    def submit(
        self,
        features: Any,
        deadline_secs: Optional[float] = None,
        timeout: Optional[float] = None,
    ) -> ServeResult:
        request = self.submit_async(features, deadline_secs)
        if timeout is None:
            # Default the client wait to the REQUEST's own deadline
            # (plus slack for the executor's response) — keying it to
            # the config default would time out a long-deadline request
            # still legitimately queued.
            timeout = (
                deadline_secs
                if deadline_secs is not None
                else self.config.default_deadline_secs
            ) + 30.0
        return request.wait(timeout)

    def stats(self) -> Dict[str, Any]:
        """Machine-readable watermark snapshot (the replica-balancer
        heartbeat payload).

        Typed fields: `ts_monotonic` (this frontend's monotonic clock
        at snapshot time), `generation` (the incumbent's iteration
        number, None before the first flip), the backpressure
        watermarks (`queue_depth`, `wait_ewma_secs`, `exec_ewma_secs`,
        `shedding`, `draining`), and the per-status census under
        `statuses`. The pre-fleet mixed debug fields (bare status
        counts at the top level, `pool_*` keys) are kept as ALIASES
        for one release — new consumers read the typed fields only.
        """
        with self._cond:
            depth = len(self._queue)
        active = self.pool.active
        out: Dict[str, Any] = {
            "ts_monotonic": self._clock(),
            "generation": (
                active.iteration_number if active is not None else None
            ),
            "queue_depth": depth,
            "wait_ewma_secs": self.admission.wait_ewma,
            "exec_ewma_secs": self.budget.estimate,
            "shedding": self.admission.shedding,
            "draining": self._draining,
            "statuses": dict(self.counters),
        }
        # Cascade snapshot (threshold, per-row fallthrough, shadow
        # divergence, rollback state) rides the heartbeat so
        # `servectl cascade` sees the whole fleet without touching a
        # replica; duck-typed batcher stubs may predate it.
        cascade_stats = getattr(self.batcher, "cascade_stats", None)
        if cascade_stats is not None:
            try:
                out["cascade"] = cascade_stats()
            except Exception:
                _LOG.exception("Cascade stats snapshot failed.")
                out["cascade"] = None
        # Deprecated aliases (one release): bare status counts and the
        # pool's stats with a `pool_` prefix, exactly as before.
        for status, count in self.counters.items():
            out.setdefault(status, count)
        out.update(
            {
                "pool_" + key: value
                for key, value in self.pool.stats().items()
            }
        )
        return out

    # ------------------------------------------------------------- executor

    def _take_batch(self) -> Optional[List[_Request]]:
        """Blocks for the next batch; None once drained-and-stopped."""
        max_rows = self.batcher.max_batch
        with self._cond:
            while not self._queue:
                if self._draining:
                    self._drained.set()
                if self._stopped.is_set():
                    return None
                self._cond.wait(timeout=0.05)
        # Give followers one batching window to arrive (continuous
        # batching: the wait is bounded and only paid when the queue
        # went empty mid-accumulation).
        deadline = self._clock() + self.config.batch_wait_secs
        batch: List[_Request] = []
        rows = 0
        while True:
            with self._cond:
                while self._queue:
                    request = self._queue[0]
                    size = self._rows(request)
                    if batch and rows + size > max_rows:
                        return batch
                    self._queue.popleft()
                    batch.append(request)
                    rows += size
                    if rows >= max_rows:
                        return batch
            remaining = deadline - self._clock()
            if remaining <= 0 or self._draining:
                return batch
            time.sleep(min(remaining, 0.001))

    def _rows(self, request: _Request) -> int:
        from adanet_tpu_torch.serving.batcher import request_rows

        try:
            return request_rows(request.features)
        except Exception:
            return 1

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                # Drained-and-stopped after a SIGTERM: leave a trace of
                # the drain (the signal lifecycle's observable tail).
                # Runs on the executor thread, never in the signal
                # handler. Programmatic drain() — every test's and
                # orderly stop's clean-shutdown path — is not an
                # incident and writes no dump.
                if self._signal_drain:
                    flightrec.dump_installed("sigterm_drain")
                return
            self._g_depth.set(len(self._queue))
            now = self._clock()
            ready: List[_Request] = []
            for request in batch:
                self.admission.observe_wait(now - request.enqueued_at)
                if self.budget.expired(request.deadline, now):
                    self._count(STATUS_DEADLINE)
                    request.respond(
                        ServeResult(
                            status=STATUS_DEADLINE,
                            retry_after=self.config.retry_after_secs,
                        )
                    )
                else:
                    ready.append(request)
            self._g_wait_ewma.set(self.admission.wait_ewma)
            self._g_shedding.set(1.0 if self.admission.shedding else 0.0)
            if not ready:
                continue
            started = self._clock()
            span = spans_lib.tracer().span(
                "serving.batch",
                correlation={"batch": next(self._batch_ids)},
                requests=[request.rid for request in ready],
            )
            try:
                with span:
                    record, outputs = self.batcher.execute(
                        [request.features for request in ready]
                    )
                    span.set(generation=record.iteration_number)
                    cascade_level = getattr(
                        self.batcher, "last_cascade_level", None
                    )
                    row_fallthrough = getattr(
                        self.batcher, "last_row_fallthrough", None
                    )
                    if cascade_level is not None:
                        span.set(cascade_level=cascade_level)
            except Exception as exc:
                _LOG.exception("Serving batch failed.")
                for request in ready:
                    self._count(STATUS_ERROR)
                    request.respond(
                        ServeResult(
                            status=STATUS_ERROR,
                            error="%s: %s" % (type(exc).__name__, exc),
                        )
                    )
                continue
            self.budget.observe(self._clock() - started)
            self._g_exec_ewma.set(self.budget.estimate)
            # Per-REQUEST cascade level: with the batcher's per-row
            # fallthrough mask, a request whose rows all cleared is
            # level 0 even when a neighboring request in the same
            # padded batch fell through (the batch-level field stays
            # the dispatch summary on the span).
            offset = 0
            for request, out in zip(ready, outputs):
                level = cascade_level
                if row_fallthrough is not None:
                    rows = self._rows(request)
                    level = int(
                        bool(row_fallthrough[offset:offset + rows].any())
                    )
                    offset += rows
                self._count(STATUS_OK)
                request.respond(
                    ServeResult(
                        status=STATUS_OK,
                        outputs=out,
                        generation=record.iteration_number,
                        cascade_level=level,
                    )
                )

    # --------------------------------------------------------------- poller

    def _poll_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                self.pool.poll()
            except Exception:
                _LOG.exception("Generation poll failed; will retry.")
            self._stopped.wait(self.config.poll_interval_secs)
