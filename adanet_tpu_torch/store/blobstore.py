"""Crash-safe content-addressed blob + ref layers.

One store shared by a fleet of searches and serving pools. Two layers:

- **Blobs** (`blobs/<aa>/<sha256>`): immutable byte payloads named by
  their own SHA-256. Writes are staged (`staging/`), fsync'd, and
  renamed into place, so a reader can never observe a half-written
  blob; content addressing makes concurrent writers of the same bytes
  trivially idempotent. Reads verify the digest before returning;
  corruption is quarantined (`<digest>.corrupt`) and transparently
  healed from any duplicate referencer (the `sources` recorded on refs
  — a consumer's own on-disk copy of the same bytes).
- **Refs** (`refs/<kind>/<name>.json`): small JSON documents binding a
  semantic key — (architecture hash, spec fingerprint, env fingerprint)
  — to a closure of blob digests. Ref writes are SET-ONCE: the first
  writer wins via an atomic `os.link` claim (the filesystem analogue of
  the coordination-KV `set(overwrite=False)` claim in
  `distributed/scheduler.py`); losers adopt the winner's document.
  Artifacts here are immutable-by-construction (a frozen AdaNet member
  never changes), so "first writer wins" is also "everyone agrees".

Leases and GC live in `leases.py` / `gc.py`; store-wide verification in
`fsck.py`. See docs/artifact_store.md for the layout and lifecycle.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import tempfile
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from adanet_tpu_torch.observability import spans as spans_lib
from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.robustness.sched import sched_point
from adanet_tpu_torch.robustness.retry import with_retries
from adanet_tpu_torch.store import keys

_LOG = logging.getLogger("adanet_tpu_torch")

BLOBS_SUBDIR = "blobs"
REFS_SUBDIR = "refs"
LEASES_SUBDIR = "leases"
STAGING_SUBDIR = "staging"
QUARANTINE_SUFFIX = ".corrupt"


class StoreError(RuntimeError):
    """Base class for artifact-store failures."""


class BlobMissingError(StoreError):
    """A requested blob is absent and no heal source produced it."""


class BlobCorruptError(StoreError):
    """A blob failed digest verification and could not be healed."""


def _atomic_write_bytes(path: str, data: bytes, staging_dir: str) -> None:
    """Stage + fsync + rename; a crash can never leave partial bytes at
    `path` (stdlib-only twin of core/checkpoint.py's writer, staged in
    the store's own staging dir so strays are identifiable)."""
    fd, tmp = tempfile.mkstemp(dir=staging_dir)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    directory = os.path.dirname(path) or "."
    try:
        dir_fd = os.open(directory, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def _read_bytes(path: str, label: str) -> bytes:
    """Bounded-retry read (transient EIO must not kill a search)."""

    def read_once() -> bytes:
        with open(path, "rb") as f:
            return f.read()

    return with_retries(read_once, label=label)


class ArtifactStore:
    """A content-addressed artifact store rooted at one directory.

    `clock` is injectable for lease/GC tests (mocked-clock, no sleeps);
    production uses wall time. All methods are safe under concurrent
    multi-process use — every mutation is either an atomic rename of
    immutable content or a set-once link claim.
    """

    def __init__(self, root: str, clock=time.time):
        from adanet_tpu_torch.observability import metrics as metrics_lib

        self.root = os.path.abspath(root)
        self.clock = clock
        for sub in (
            BLOBS_SUBDIR,
            REFS_SUBDIR,
            LEASES_SUBDIR,
            STAGING_SUBDIR,
        ):
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)
        # Accounting on the process metrics registry (`store.*`
        # aggregates across instances for snapshots/flight dumps); the
        # instance keeps scoped child counters so fsck reports and tests
        # read exact per-store numbers via the properties below.
        reg = metrics_lib.registry()
        self._m_puts = reg.counter("store.blob.puts").child()
        self._m_gets = reg.counter("store.blob.gets").child()
        self._m_heals = reg.counter("store.blob.heals").child()
        self._m_quarantines = reg.counter("store.blob.quarantines").child()
        self._m_unrecoverable = reg.counter(
            "store.blob.unrecoverable"
        ).child()

    @property
    def puts(self) -> int:
        """Blob publications (including deduplicated re-puts)."""
        return self._m_puts.value

    @property
    def gets(self) -> int:
        """Blob reads (verified-on-read; healed reads count once)."""
        return self._m_gets.value

    @property
    def heals(self) -> int:
        """Blobs rewritten from a duplicate referencer or fresh put."""
        return self._m_heals.value

    @property
    def quarantines(self) -> int:
        """Corrupt blob copies moved aside as `*.corrupt`."""
        return self._m_quarantines.value

    @property
    def unrecoverable(self) -> int:
        """Reads that failed after exhausting every heal source."""
        return self._m_unrecoverable.value

    # ----------------------------------------------------------- paths

    @property
    def staging_dir(self) -> str:
        return os.path.join(self.root, STAGING_SUBDIR)

    @property
    def leases_dir(self) -> str:
        return os.path.join(self.root, LEASES_SUBDIR)

    def blob_path(self, digest: str) -> str:
        if not keys.is_digest(digest):
            raise ValueError("not a SHA-256 hex digest: %r" % (digest,))
        return os.path.join(
            self.root, BLOBS_SUBDIR, digest[:2], digest
        )

    def ref_path(self, kind: str, name: str) -> str:
        # All-dot components ("." / "..") resolve upward out of the
        # refs tree — reject them along with separators/specials.
        if (
            not kind
            or not kind.strip(".")
            or not all(c.isalnum() or c in "_." for c in kind)
        ):
            raise ValueError("ref kind %r is not filesystem-safe" % kind)
        # Names come from keys.ref_name: hyphen-joined safe parts.
        if (
            not name
            or not name.strip(".-")
            or not all(c.isalnum() or c in "_.-" for c in name)
        ):
            raise ValueError("ref name %r is not filesystem-safe" % name)
        return os.path.join(
            self.root, REFS_SUBDIR, kind, name + ".json"
        )

    # ----------------------------------------------------------- blobs

    def has_blob(self, digest: str) -> bool:
        return os.path.exists(self.blob_path(digest))

    def put(self, data: bytes) -> str:
        """Stores `data`; returns its SHA-256 digest (the blob name).

        Idempotent and concurrent-writer-safe: an existing intact blob
        is left alone; an existing MISMATCHED blob (a torn direct write
        from a crashed peer, or bit rot) is quarantined and replaced by
        the fresh bytes — put() doubles as the healing path.
        """

        def put_once() -> str:
            digest = keys.sha256_hex(data)
            final = self.blob_path(digest)
            os.makedirs(os.path.dirname(final), exist_ok=True)
            if os.path.exists(final):
                if keys.sha256_hex(
                    _read_bytes(final, "store blob recheck")
                ) != digest:
                    self._quarantine_blob(digest)
                    _atomic_write_bytes(final, data, self.staging_dir)
                    self._m_heals.inc()
                    _LOG.warning(
                        "Healed corrupt blob %s from a fresh put.",
                        digest[:12],
                    )
                else:
                    # Refresh the deduplicated blob's age: THIS put's
                    # ref may not have landed yet, and the GC grace
                    # window must cover the new publication too — an
                    # untouched mtime would let a concurrent sweep
                    # reclaim the blob between this put and its
                    # put_ref, stranding a dangling ref.
                    try:
                        os.utime(final, None)
                    except OSError:
                        pass
            else:
                _atomic_write_bytes(final, data, self.staging_dir)
            # The chaos seam fires AFTER the bytes are durable, so
            # `torn` (truncate at the final path + SIGKILL) and `rot`
            # (silent in-place bit flips) corrupt a REAL landed blob —
            # exactly the storage failures the verify-on-read and
            # heal-on-put machinery above must absorb.
            faults.trip("store.put", path=final, data=data)
            self._m_puts.inc()
            return digest

        with spans_lib.tracer().span("store.put", bytes=len(data)):
            return with_retries(put_once, label="store put")

    def get(
        self, digest: str, extra_sources: Sequence[str] = ()
    ) -> bytes:
        """Reads and digest-verifies a blob.

        On mismatch the corrupt copy is quarantined and the blob is
        transparently healed from any duplicate referencer: the
        `sources` paths recorded by every ref that mentions this digest
        (plus `extra_sources` from the caller) are tried in order until
        one yields bytes with the right digest. Raises
        `BlobCorruptError`/`BlobMissingError` when nothing can.
        """
        path = self.blob_path(digest)
        self._m_gets.inc()
        with spans_lib.tracer().span("store.get", digest=digest[:12]):
            return self._get_verified(digest, path, extra_sources)

    def _get_verified(
        self, digest: str, path: str, extra_sources: Sequence[str]
    ) -> bytes:
        faults.trip("store.get", path=path)
        try:
            data = _read_bytes(path, "store blob read")
        except FileNotFoundError:
            return self._heal(
                digest, extra_sources, reason="blob missing"
            )
        if keys.sha256_hex(data) != digest:
            quarantined = self._quarantine_blob(digest)
            _LOG.error(
                "Blob %s failed verification (quarantined as %s); "
                "attempting heal from referencers.",
                digest[:12],
                quarantined,
            )
            return self._heal(
                digest, extra_sources, reason="digest mismatch"
            )
        return data

    def _quarantine_blob(self, digest: str) -> Optional[str]:
        """Renames a corrupt blob to `<digest>.corrupt[.n]` (kept for
        post-mortems; never matches a digest name again)."""
        path = self.blob_path(digest)
        target = path + QUARANTINE_SUFFIX
        n = 0
        while os.path.exists(target):
            n += 1
            target = "%s%s.%d" % (path, QUARANTINE_SUFFIX, n)
        try:
            # jaxlint: disable=JL013(quarantine moves already-landed corrupt bytes aside; no payload is written, so there is nothing to stage or fsync)
            os.replace(path, target)
        except FileNotFoundError:
            # A concurrent healer won the rename; same outcome.
            return None
        self._m_quarantines.inc()
        return os.path.basename(target)

    def _heal(
        self,
        digest: str,
        extra_sources: Sequence[str],
        reason: str,
    ) -> bytes:
        """Rewrites a lost/corrupt blob from any intact duplicate."""
        candidates: List[str] = list(extra_sources)
        for _kind, _name, ref in self.iter_refs():
            if digest in ref.get("blobs", {}).values():
                candidates.extend(ref.get("sources", []))
        tried = 0
        for source in candidates:
            tried += 1
            try:
                data = _read_bytes(source, "store heal read")
            except OSError:
                continue
            if keys.sha256_hex(data) != digest:
                continue
            final = self.blob_path(digest)
            os.makedirs(os.path.dirname(final), exist_ok=True)
            _atomic_write_bytes(final, data, self.staging_dir)
            self._m_heals.inc()
            _LOG.warning(
                "Healed blob %s (%s) from duplicate referencer %s.",
                digest[:12],
                reason,
                source,
            )
            return data
        self._m_unrecoverable.inc()
        err = BlobMissingError if reason == "blob missing" else BlobCorruptError
        raise err(
            "blob %s unrecoverable (%s; %d heal sources tried)"
            % (digest, reason, tried)
        )

    def iter_blobs(self) -> Iterator[Tuple[str, str]]:
        """Yields (digest, path) for every clean-named blob on disk."""
        base = os.path.join(self.root, BLOBS_SUBDIR)
        try:
            shards = sorted(os.listdir(base))
        except OSError:
            return
        for shard in shards:
            shard_dir = os.path.join(base, shard)
            if not os.path.isdir(shard_dir):
                continue
            try:
                names = sorted(os.listdir(shard_dir))
            except OSError:
                continue
            for name in names:
                if keys.is_digest(name):
                    yield name, os.path.join(shard_dir, name)

    def quarantined_blobs(self) -> List[str]:
        """Basenames of quarantined (`*.corrupt`) blob copies."""
        out = []
        base = os.path.join(self.root, BLOBS_SUBDIR)
        try:
            shards = sorted(os.listdir(base))
        except OSError:
            return out
        for shard in shards:
            shard_dir = os.path.join(base, shard)
            if not os.path.isdir(shard_dir):
                continue
            out.extend(
                name
                for name in sorted(os.listdir(shard_dir))
                if QUARANTINE_SUFFIX in name
            )
        return out

    # ------------------------------------------------------------ refs

    def put_ref(
        self,
        kind: str,
        name: str,
        blobs: Dict[str, str],
        meta: Optional[dict] = None,
        sources: Sequence[str] = (),
    ) -> dict:
        """Publishes a ref binding `name` to a closure of blob digests.

        SET-ONCE: the first writer's document wins (atomic `os.link`
        claim — the filesystem twin of the scheduler's KV
        `set(overwrite=False)`); a lost race adopts and returns the
        winner's document, which for these deterministic artifacts
        holds the same digests. `sources` are absolute paths of
        duplicate copies (the writer's own on-disk files) used to heal
        corrupt blobs later.
        """
        for filename, digest in blobs.items():
            if not keys.is_digest(digest):
                raise ValueError(
                    "blob entry %r -> %r is not a digest"
                    % (filename, digest)
                )
        final = self.ref_path(kind, name)
        os.makedirs(os.path.dirname(final), exist_ok=True)
        existing = self.get_ref(kind, name)
        if existing is not None:
            return existing
        doc = {
            "kind": kind,
            "name": name,
            "blobs": dict(blobs),
            "meta": dict(meta or {}),
            "sources": [os.path.abspath(s) for s in sources],
            "created_at": float(self.clock()),
        }
        fd, tmp = tempfile.mkstemp(dir=self.staging_dir)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            # Race window: the absent-ref read above vs the claim below
            # — two writers both staged; the link must elect one doc.
            sched_point("ref.link_claim")
            try:
                os.link(tmp, final)  # the set-once claim
            except OSError as exc:
                if exc.errno != errno.EEXIST:
                    raise
                winner = self.get_ref(kind, name)
                if winner is not None:
                    return winner
                raise
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return doc

    def get_ref(self, kind: str, name: str) -> Optional[dict]:
        """The ref document, or None when unpublished/unparseable."""
        path = self.ref_path(kind, name)
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as exc:
            _LOG.error("Unreadable ref %s: %s", path, exc)
            return None
        return doc if isinstance(doc, dict) else None

    def wait_for_ref(
        self,
        kind: str,
        name: str,
        timeout_secs: float,
        poll_interval_secs: float = 0.05,
    ) -> dict:
        """Blocks (bounded — jaxlint JL009) until a ref is published.

        For cross-process handoffs: a warm-starting search waiting on a
        peer's in-flight publication. Raises TimeoutError at the
        deadline — a dead publisher costs one timeout, never a hang.
        """
        deadline = time.monotonic() + float(timeout_secs)
        while True:
            doc = self.get_ref(kind, name)
            if doc is not None:
                return doc
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    "ref %s/%s not published within %.1fs"
                    % (kind, name, timeout_secs)
                )
            time.sleep(poll_interval_secs)

    def delete_ref(self, kind: str, name: str) -> None:
        try:
            os.unlink(self.ref_path(kind, name))
        except OSError:
            pass

    def iter_refs(
        self, kind: Optional[str] = None
    ) -> Iterator[Tuple[str, str, dict]]:
        """Yields (kind, name, document) for every parseable ref."""
        base = os.path.join(self.root, REFS_SUBDIR)
        kinds = (
            [kind]
            if kind is not None
            else sorted(
                d
                for d in (
                    os.listdir(base) if os.path.isdir(base) else []
                )
                if os.path.isdir(os.path.join(base, d))
            )
        )
        for k in kinds:
            kind_dir = os.path.join(base, k)
            try:
                names = sorted(os.listdir(kind_dir))
            except OSError:
                continue
            for fname in names:
                if not fname.endswith(".json"):
                    continue
                doc = self.get_ref(k, fname[: -len(".json")])
                if doc is not None:
                    yield k, fname[: -len(".json")], doc

    def referenced_digests(self) -> Dict[str, List[str]]:
        """digest -> [ "<kind>/<name>" ] over every ref closure."""
        out: Dict[str, List[str]] = {}
        for kind, name, doc in self.iter_refs():
            for digest in doc.get("blobs", {}).values():
                out.setdefault(digest, []).append(
                    "%s/%s" % (kind, name)
                )
        return out
