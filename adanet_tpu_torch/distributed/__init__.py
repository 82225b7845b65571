"""Distributed execution of the port: so far the lease-based work queue
and the callable drain behind ModelFlow's `ParallelScheduler`
(`scheduler.py`). Placement strategies, the elastic executor and the
multi-host paths come with ROADMAP item 8."""

from adanet_tpu_torch.distributed.scheduler import (  # noqa: F401
    InMemoryKV,
    LeaseLostError,
    LeaseRenewer,
    WorkQueue,
    WorkQueueConfig,
    WorkUnit,
    drain_callables,
    plan_windows,
)
