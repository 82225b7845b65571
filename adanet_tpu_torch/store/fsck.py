"""Store-wide verification: every blob re-hashed, every ref resolved.

The store half of the `ckpt_fsck` contract (the model-dir half lives in
`robustness/integrity.py`). Walks one store root and reports:

- blob census (count, bytes) with every blob re-hashed against its
  content-addressed name;
- corrupt blobs — with `repair=True` they are quarantined
  (`<digest>.corrupt`) and healed from any duplicate referencer (the
  `sources` recorded on refs), exactly the path a live `get` takes;
- dangling refs: a ref whose closure mentions a blob that is missing
  or stayed corrupt after the heal attempt;
- quarantined copies present, lease census (live/expired), stray
  staging files, and (on request) the would-GC set of a dry-run sweep.

`clean` means no unhealed corrupt blobs and no dangling refs; healed
quarantine copies are allowed — that is the store working as designed,
not damage (the chaos gate in tests/test_store.py asserts exactly
this distinction).
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

from adanet_tpu_torch.store import gc as gc_lib
from adanet_tpu_torch.store import keys
from adanet_tpu_torch.store import leases as leases_lib
from adanet_tpu_torch.store.blobstore import (
    ArtifactStore,
    BlobCorruptError,
    BlobMissingError,
)

_LOG = logging.getLogger("adanet_tpu_torch")


def _file_digest(path: str) -> Optional[str]:
    digest = hashlib.sha256()
    try:
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)
    except OSError:
        return None
    return digest.hexdigest()


def fsck_store(
    store: ArtifactStore,
    repair: bool = False,
    gc_dry_run: bool = False,
    grace_secs: Optional[float] = None,
    now: Optional[float] = None,
) -> dict:
    """Verifies `store`; with `repair`, quarantines + heals corruption.

    Returns a JSON-able report (the `store` section of
    `ckpt_fsck --json`). Deterministic given the store contents, so the
    verify-only and repair passes agree on what is wrong.
    """
    report = {
        "root": store.root,
        "blob_count": 0,
        "bytes": 0,
        "ref_count": 0,
        "corrupt_blobs": [],
        "healed_blobs": [],
        "dangling_refs": [],
        "quarantined_blobs": store.quarantined_blobs(),
        "staging_strays": 0,
        "leases": {"live": 0, "expired": 0},
    }

    # ---- blob census + verification.
    referenced = store.referenced_digests()
    corrupt = set()
    for digest, path in store.iter_blobs():
        report["blob_count"] += 1
        try:
            report["bytes"] += os.path.getsize(path)
        except OSError:
            pass
        actual = _file_digest(path)
        if actual == digest:
            continue
        if actual is None:
            continue  # concurrently removed (GC/quarantine race)
        corrupt.add(digest)
        report["corrupt_blobs"].append(digest)
        if repair:
            try:
                store.get(digest)  # quarantines + heals from sources
                report["healed_blobs"].append(digest)
                corrupt.discard(digest)
            except (BlobCorruptError, BlobMissingError) as exc:
                # `get` quarantined the corrupt copy. Unreferenced, it
                # was reachable by nobody — quarantine IS the repair
                # (e.g. the torn leftovers of a SIGKILLed publisher
                # whose ref never landed). Referenced, it stays a
                # defect and surfaces as a dangling ref below.
                if digest not in referenced:
                    corrupt.discard(digest)
                _LOG.error("Store fsck could not heal %s: %s", digest, exc)

    # ---- ref resolution.
    report["pruned_refs"] = []
    for kind, name, doc in store.iter_refs():
        report["ref_count"] += 1
        for digest in sorted(set(doc.get("blobs", {}).values())):
            if digest in corrupt or not store.has_blob(digest):
                healed = False
                if repair:
                    try:
                        store.get(digest)
                        healed = True
                        if digest in report["corrupt_blobs"]:
                            report["healed_blobs"].append(digest)
                            corrupt.discard(digest)
                    except (BlobCorruptError, BlobMissingError):
                        healed = False
                if healed:
                    continue
                if repair and doc.get("meta", {}).get("recreatable"):
                    # Pure-cache refs (e.g. serialized executables):
                    # the consumer republishes on its next miss, so
                    # dropping the ref IS the repair — a dangling
                    # verdict would otherwise persist forever (the
                    # set-once name cannot be rewritten with a
                    # different blob).
                    store.delete_ref(kind, name)
                    report["pruned_refs"].append(
                        "%s/%s" % (kind, name)
                    )
                    break
                report["dangling_refs"].append(
                    "%s/%s -> %s" % (kind, name, digest)
                )

    # ---- lease + staging census.
    now_val = float(store.clock()) if now is None else float(now)
    for lease in leases_lib.iter_leases(store):
        key = "live" if lease.expires_at > now_val else "expired"
        report["leases"][key] += 1
    try:
        report["staging_strays"] = len(os.listdir(store.staging_dir))
    except OSError:
        pass

    # The quarantine census reflects post-repair state (healing adds
    # quarantined copies of what it replaced).
    report["quarantined_blobs"] = store.quarantined_blobs()
    report["corrupt_blobs"] = sorted(corrupt)
    report["clean"] = not report["corrupt_blobs"] and not report[
        "dangling_refs"
    ]

    if gc_dry_run:
        report["would_gc"] = gc_lib.collect(
            store, grace_secs=grace_secs, dry_run=True, now=now
        ).would_remove
    return report
