"""TTL leases pinning ref closures against garbage collection.

An active search or serving pool holds a lease on the blob digests it
is using (its *ref closure*, resolved at acquire time — so even a
concurrently deleted ref cannot unpin bytes a live consumer depends
on). Leases expire by wall clock: a SIGKILLed holder costs one TTL,
after which GC may reclaim — the same crash-recovery shape as the
work-queue leases in `distributed/scheduler.py`, applied to storage.

Lease files are single-writer (the holder owns its id); every write is
a staged atomic rename, so GC never observes a torn lease. The clock is
injected via the owning `ArtifactStore` so expiry/grace boundaries are
mocked-clock-testable (no sleeps).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import uuid
from typing import Iterable, List, Optional

from adanet_tpu_torch.robustness import sched

_LOG = logging.getLogger("adanet_tpu_torch")


class LeaseExpiredError(RuntimeError):
    """Raised on `renew` of a lease whose TTL has already elapsed.

    Once expired, GC is free to sweep the pinned blobs — silently
    extending the expiry would retroactively "un-expire" the lease and
    hide the protection gap from the holder. The holder must re-acquire
    (and may re-verify its artifacts) instead.
    """


@dataclasses.dataclass
class Lease:
    """One holder's pin on a set of blob digests until `expires_at`."""

    lease_id: str
    owner: str
    expires_at: float
    digests: List[str] = dataclasses.field(default_factory=list)
    created_at: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(obj: dict) -> "Lease":
        return Lease(
            lease_id=str(obj["lease_id"]),
            owner=str(obj.get("owner", "")),
            expires_at=float(obj.get("expires_at", 0.0)),
            digests=[str(d) for d in obj.get("digests", [])],
            created_at=float(obj.get("created_at", 0.0)),
        )


def _safe_id(text: str) -> str:
    return "".join(c if c.isalnum() or c in "_.-" else "_" for c in text)


def _lease_path(store, lease_id: str) -> str:
    return os.path.join(store.leases_dir, _safe_id(lease_id) + ".json")


def _write_lease(store, lease: Lease) -> None:
    path = _lease_path(store, lease.lease_id)
    fd, tmp = tempfile.mkstemp(dir=store.staging_dir)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(lease.to_json(), f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def acquire(
    store,
    owner: str,
    ttl_secs: float,
    digests: Iterable[str] = (),
    lease_id: Optional[str] = None,
) -> Lease:
    """Creates (or replaces) this holder's lease pinning `digests`."""
    now = float(store.clock())
    lease = Lease(
        lease_id=lease_id or "%s-%s" % (_safe_id(owner), uuid.uuid4().hex[:12]),
        owner=owner,
        expires_at=now + float(ttl_secs),
        digests=sorted(set(digests)),
        created_at=now,
    )
    _write_lease(store, lease)
    return lease


def renew(
    store,
    lease: Lease,
    ttl_secs: float,
    add_digests: Iterable[str] = (),
) -> Lease:
    """Extends the lease's expiry and optionally grows its closure.

    The closure only ever grows within one lease lifetime: dropping a
    pin is `release` + fresh `acquire`, so a renew racing GC can never
    shrink the protected set mid-scan.

    Raises `LeaseExpiredError` if the TTL already elapsed: GC may have
    swept the pinned blobs in the gap, so extending the expiry would
    resurrect a dead pin and hide the protection gap from the holder.
    """
    now = float(store.clock())
    if now > lease.expires_at:
        raise LeaseExpiredError(
            "Lease %s (owner %s) expired at %.3f (now %.3f); "
            "re-acquire instead of renewing — GC may have reclaimed "
            "its blobs." % (lease.lease_id, lease.owner, lease.expires_at, now)
        )
    lease.digests = sorted(set(lease.digests) | set(add_digests))
    lease.expires_at = now + float(ttl_secs)
    sched.sched_point("lease.renew_write")
    _write_lease(store, lease)
    return lease


def release(store, lease: Lease) -> None:
    try:
        os.unlink(_lease_path(store, lease.lease_id))
    except OSError:
        pass


def iter_leases(store) -> List[Lease]:
    """Every parseable lease on disk (live and expired)."""
    out = []
    try:
        names = sorted(os.listdir(store.leases_dir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(store.leases_dir, name)
        try:
            with open(path) as f:
                out.append(Lease.from_json(json.load(f)))
        except (OSError, ValueError, KeyError) as exc:
            _LOG.error("Unreadable lease %s: %s", path, exc)
    return out


def live_leases(store, now: Optional[float] = None) -> List[Lease]:
    now = float(store.clock()) if now is None else float(now)
    return [l for l in iter_leases(store) if l.expires_at > now]
