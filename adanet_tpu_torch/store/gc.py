"""Lease-guarded garbage collection for the artifact store.

Mark-and-sweep over one store root. A blob survives when ANY of:

1. a ref's closure mentions it (refs are the durable roots);
2. a LIVE lease pins it (`leases.py` — active searches and serving
   pools resolve their ref closure into the lease at acquire time, so
   even a deleted ref cannot unpin bytes a live consumer holds);
3. it is younger than the grace period (an in-flight put whose ref has
   not landed yet — the crash window between blob and ref writes).

Sweep order is derived from a single snapshot of (refs, leases) taken
BEFORE candidates are computed, and referenced/pinned blobs are never
candidates at all, so GC racing an active lease can never evict a
reachable blob (proven by the race test in tests/test_store.py).
Expired leases older than `expires_at + grace` are pruned; stray
staging files older than the grace period are removed.

The clock is injected (`now` parameter / the store's `clock`), so every
grace/expiry boundary is mocked-clock-testable with no sleeps.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional

from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.robustness.sched import sched_point
from adanet_tpu_torch.store import leases as leases_lib

_LOG = logging.getLogger("adanet_tpu_torch")


def default_grace_secs() -> float:
    """`ADANET_STORE_GC_GRACE_SECS` (default 3600): how long an
    unreferenced blob is presumed to be an in-flight publication."""
    raw = os.environ.get("ADANET_STORE_GC_GRACE_SECS", "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            _LOG.warning(
                "Ignoring non-numeric ADANET_STORE_GC_GRACE_SECS=%r.", raw
            )
    return 3600.0


@dataclasses.dataclass
class GCReport:
    """Outcome of one collection pass (dry or live)."""

    dry_run: bool = False
    scanned_blobs: int = 0
    referenced: int = 0
    pinned: int = 0
    in_grace: int = 0
    removed: List[str] = dataclasses.field(default_factory=list)
    would_remove: List[str] = dataclasses.field(default_factory=list)
    pruned_leases: List[str] = dataclasses.field(default_factory=list)
    pruned_staging: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def collect(
    store,
    grace_secs: Optional[float] = None,
    dry_run: bool = False,
    now: Optional[float] = None,
) -> GCReport:
    """One mark-and-sweep pass over `store`.

    `dry_run` computes the would-GC set without unlinking anything
    (the `ckpt_fsck --gc --dry-run` surface). `now` overrides the
    store clock for deterministic boundary tests.
    """
    faults.trip("store.gc")
    now = float(store.clock()) if now is None else float(now)
    grace = default_grace_secs() if grace_secs is None else float(grace_secs)
    report = GCReport(dry_run=dry_run)

    # ---- mark: one snapshot BEFORE any candidate is computed.
    referenced = set(store.referenced_digests())
    pinned = set()
    for lease in leases_lib.iter_leases(store):
        if lease.expires_at > now:
            pinned.update(lease.digests)
        elif lease.expires_at + grace <= now:
            report.pruned_leases.append(lease.lease_id)
            if not dry_run:
                leases_lib.release(store, lease)

    # ---- sweep blobs.
    # Race window: the mark snapshot above vs the sweep below — a lease
    # acquired/renewed in between must still protect its blobs (the
    # snapshot-before-sweep ordering plus the grace window make a stale
    # mark safe; schedcheck explores exactly this interleaving).
    sched_point("gc.mark_done")
    for digest, path in store.iter_blobs():
        report.scanned_blobs += 1
        if digest in referenced:
            report.referenced += 1
            continue
        if digest in pinned:
            report.pinned += 1
            continue
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue  # concurrently removed/quarantined
        if age < grace:
            report.in_grace += 1
            continue
        report.would_remove.append(digest)
        if not dry_run:
            sched_point("gc.before_unlink")
            # Re-check pins at the unlink: the mark snapshot can be
            # arbitrarily stale by now, and a lease (re-)acquired
            # mid-pass — a holder recovering from LeaseExpiredError —
            # must still protect its blobs. Lease files are few; the
            # re-read is cheap next to the unlink it guards.
            if any(
                digest in lease.digests
                for lease in leases_lib.iter_leases(store)
                if lease.expires_at > now
            ):
                report.would_remove.pop()
                report.pinned += 1
                continue
            try:
                os.unlink(path)
            except OSError:
                continue
            report.removed.append(digest)

    # ---- stray staging files (crashes between stage and rename).
    try:
        strays = sorted(os.listdir(store.staging_dir))
    except OSError:
        strays = []
    for name in strays:
        path = os.path.join(store.staging_dir, name)
        try:
            if now - os.path.getmtime(path) < grace:
                continue
        except OSError:
            continue
        if not dry_run:
            try:
                os.unlink(path)
            except OSError:
                continue
        report.pruned_staging += 1

    if report.removed or report.pruned_leases:
        _LOG.info(
            "Store GC: removed %d blobs, pruned %d expired leases "
            "(%d referenced, %d lease-pinned, %d in grace).",
            len(report.removed),
            len(report.pruned_leases),
            report.referenced,
            report.pinned,
            report.in_grace,
        )
    return report
