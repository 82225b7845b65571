"""Device-clock step timing from a torch.profiler trace.

Port of adanet_tpu/utils/device_timing.py. A host clock around work on
the card measures the host's enqueue as much as the card; the profiler's
Chrome trace carries the card's own timeline, one event per kernel with
its duration on the device. Summing the kernel events gives the device's
busy time. The JAX package counts XLA dispatches (one executable a
step); the eager port launches thousands of kernels a step, so it counts
kernels.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import tempfile
from typing import Callable, Optional, Tuple

#: Chrome-trace category of a CUDA kernel in torch.profiler's export.
KERNEL_CATEGORY = "kernel"


def _load(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def trace_device_seconds(trace_dir: str) -> Tuple[float, int]:
    """(device-busy seconds, kernels) of the newest Chrome trace
    (`*.json` or `*.json.gz`, as `export_chrome_trace` writes it) under
    `trace_dir`: the sum of the durations of its CUDA kernel events."""
    paths = [
        p for pattern in ("*.json", "*.json.gz")
        for p in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)
    ]
    if not paths:
        raise FileNotFoundError("No Chrome trace under %s; the profiler produced no trace." % trace_dir)
    data = _load(max(paths, key=os.path.getmtime))
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    total_us = 0.0
    count = 0
    for event in events:
        if event.get("ph") == "X" and event.get("cat") == KERNEL_CATEGORY:
            total_us += float(event.get("dur", 0.0))
            count += 1
    return total_us * 1e-6, count


def time_steps_on_device(
    run_steps: Callable[[], None],
    expected_dispatches: Optional[int] = None,
) -> Tuple[float, int]:
    """Profiles `run_steps()` and returns (device seconds, kernels).

    The card is synchronized before the trace stops, so `run_steps` need
    not wait for its work. With `expected_dispatches`, a trace with
    another kernel count raises `ValueError` (stray work in the window).
    A trace without kernel events (the CPU, or a tracer that delivered
    none) raises `ValueError`: use CUDA events or a host clock instead."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    trace_dir = tempfile.mkdtemp(prefix="adanet_device_timing_")
    try:
        with torch.profiler.profile(activities=activities) as profile:
            run_steps()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        profile.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        seconds, count = trace_device_seconds(trace_dir)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    if count == 0 or seconds <= 0.0:
        raise ValueError(
            "The trace holds no CUDA kernel events (a CPU run, or a tracer that delivered none); "
            "time with CUDA events instead."
        )
    if expected_dispatches is not None and count != expected_dispatches:
        raise ValueError(
            "The profiled window launched %d kernels, expected %d; warm the work up before timing "
            "(first-call work pollutes the window)." % (count, expected_dispatches)
        )
    return seconds, count
