"""Unified telemetry plane: spans, metrics, crash flight recorder.

Port of adanet_tpu/observability. `spans`, `metrics`, `flightrec` and
`export` are copies of the JAX package's modules (jax-free):

- `spans`: nestable spans with correlation IDs (search -> iteration ->
  window, checkpoint; request -> batch) in a bounded ring buffer of a
  process-wide `Tracer`; no clock read while disabled;
- `metrics`: a process-wide registry of counters, gauges and
  histograms, snapshotted to JSON;
- `flightrec`: a crash flight recorder that dumps the ring buffer and a
  metrics snapshot (staged, fsynced, renamed) on fault-site trips,
  SIGTERM stops and lost peers;
- `export`: Perfetto/Chrome-trace JSON (`adanet_tpu_torch.tools.
  trace_view` is the CLI).
"""

from adanet_tpu_torch.observability.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
)
from adanet_tpu_torch.observability.spans import (  # noqa: F401
    SpanEvent,
    Tracer,
    tracer,
)
from adanet_tpu_torch.observability.flightrec import (  # noqa: F401
    FlightRecorder,
    dump_installed,
    install,
    installed,
    install_default,
    uninstall,
)
from adanet_tpu_torch.observability.export import (  # noqa: F401
    chrome_trace,
    write_chrome_trace,
)
