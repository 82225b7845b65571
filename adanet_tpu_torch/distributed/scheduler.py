"""The lease-based work queue, its stores, and the elastic executor.

Port of adanet_tpu/distributed/scheduler.py. Units are claimed under TTL
leases in published order, renewed by a heartbeat thread, and settled
by a set-once `done/` marker, so a duplicate execution resolves to one
authoritative result (the JAX module's docstring and docs/scheduler.md
describe the lease state machine). The module holds:

- the stores behind the coordination surface (`set(key, value,
  overwrite)`, bounded `get`, `try_get`, `scan(prefix)`, `delete`):
  `InMemoryKV` in one process, `CoordinationKV` over the process
  group's store across processes (`coordination_kv`), and `FileKV`
  over a shared directory (the JAX class as it stands);
- `encode_tree`/`decode_tree`, the blob codec of state between
  processes, and `step_seed`, the seed of a unit's per-step draws;
- `WorkUnit`, `plan_windows`, `WorkQueueConfig`, `WorkQueue`,
  `LeaseRenewer`, the same code as the JAX package's;
- `drain_callables`, the engine behind ModelFlow's `ParallelScheduler`:
  zero-arg callables on a thread pool, each worker pinned to one device
  of the pool (a CUDA device is made the thread's current device, as
  the JAX version pins `jax.default_device`; a CPU device needs no
  pinning); the pool defaults to every visible card and raises without
  CUDA unless the caller names CPU devices;
- `ElasticWorkQueueExecutor`, which drives an AdaNet iteration by
  draining the queue (`ElasticWorkQueueStrategy`, `Estimator`).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.core import iteration as iteration_lib
from adanet_tpu_torch.distributed.executor import CANDIDATE_FAULTS, RoundRobinExecutor
from adanet_tpu_torch.observability import metrics as metrics_lib
from adanet_tpu_torch.observability import spans as spans_lib
from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.robustness.sched import sched_point

_LOG = logging.getLogger("adanet_tpu_torch")

#: gRPC caps messages at 4 MiB; state payloads are chunked below it
#: (same bound as multihost._KV_CHUNK_BYTES).
_KV_CHUNK_BYTES = 2 << 20

ENSEMBLE = "__ensemble__"

#: Lease TTL for same-process drains (`drain_callables`), where worker
#: "death" is impossible and lease expiry would only add failure modes.
_IN_PROCESS_LEASE_TTL = 24 * 3600.0


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        _LOG.warning("Ignoring non-numeric %s=%r.", name, raw)
        return default


class LeaseLostError(RuntimeError):
    """This worker's lease was re-issued to another worker."""


# --------------------------------------------------------------- KV stores


class InMemoryKV:
    """Thread-safe in-process KV store with the coordination surface.

    Serves single-process elastic runs and the `ParallelScheduler` shim
    (`experimental/phases.py`), and doubles as the deterministic test
    double for the coordination-service client. Values are arbitrary
    Python objects (no serialization round-trip in-process).
    """

    def __init__(self):
        self._store: Dict[str, Any] = {}
        self._cond = threading.Condition()

    def set(self, key: str, value, overwrite: bool = True) -> bool:
        """Stores `value`; returns False when `key` exists and
        `overwrite` is False (the set-once claim primitive)."""
        with self._cond:
            if not overwrite and key in self._store:
                return False
            self._store[key] = value
            self._cond.notify_all()
            return True

    def get(self, key: str, timeout_secs: float):
        """Blocking get bounded by `timeout_secs` (raises TimeoutError)."""
        deadline = time.monotonic() + timeout_secs
        with self._cond:
            while key not in self._store:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    if key in self._store:
                        break
                    raise TimeoutError(
                        "key %r not set within %.1fs" % (key, timeout_secs)
                    )
            return self._store[key]

    def try_get(self, key: str):
        with self._cond:
            return self._store.get(key)

    def scan(self, prefix: str) -> Dict[str, Any]:
        with self._cond:
            return {
                k: v for k, v in self._store.items() if k.startswith(prefix)
            }

    def delete(self, key: str) -> None:
        with self._cond:
            self._store.pop(key, None)


class CoordinationKV:
    """The process group's store behind the coordination surface.

    The port's counterpart of the JAX coordination-service client: the
    `torch.distributed` store (a TCP store served from the chief's
    process) reached through `_get_default_store()`, as
    `coordination.allgather_host` reaches it. Every wait is bounded: a
    dead chief costs one timeout, never a hang.

    - `set(overwrite=False)` is the store's `compare_set(key, "",
      value)`, which sets only when the key is absent and returns the
      value that stands; the writer won when that is its own value. Each
      value is framed with 8 random bytes before it is stored, so two
      writers of equal payloads never both believe they won. Nothing
      reads and then writes.
    - The store lists no keys, so `scan(prefix)` reads an index: a key
      with a segment in `_INDEXED` (the work queue scans only its
      set-once `done/` and `poison/` markers) is recorded under the
      prefix that ends at that segment, as `<prefix>#<n>` -> key, where
      `n` comes from the store's atomic `add(<prefix>#n, 1)`. The index
      entry is written before the value, so a writer that dies between
      the two leaves an entry whose key a scan skips until someone sets
      it. Indexed keys are set-once, so a scan reads each one's value
      once and keeps it (a `delete` here drops it).
    - `get` is `wait([key], timeout)` then `get`; `try_get` is
      `check([key])` then `get` and never waits for an absent key.
    """

    _FRAME = 8
    _INDEXED = frozenset(("done", "poison"))

    def __init__(self):
        import torch.distributed as dist

        self._store = dist.distributed_c10d._get_default_store()
        self._indexed_here: set = set()
        self._names: Dict[Tuple[str, int], str] = {}
        self._scanned: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def _frame(self, value) -> bytes:
        if isinstance(value, str):
            value = value.encode()
        return os.urandom(self._FRAME) + bytes(value)

    def _index_prefix(self, key: str) -> Optional[str]:
        parts = key.split("/")
        for i in range(len(parts) - 1):
            if parts[i] in self._INDEXED:
                return "/".join(parts[: i + 1])
        return None

    def _index(self, key: str) -> None:
        prefix = self._index_prefix(key)
        if prefix is None:
            return
        with self._lock:
            if key in self._indexed_here:
                return
            self._indexed_here.add(key)
        n = int(self._store.add(prefix + "#n", 1))
        self._store.set("%s#%d" % (prefix, n), key.encode())

    def set(self, key: str, value, overwrite: bool = True) -> bool:
        framed = self._frame(value)
        self._index(key)
        if overwrite:
            self._store.set(key, framed)
            return True
        return bytes(self._store.compare_set(key, "", framed)) == framed

    def get(self, key: str, timeout_secs: float) -> bytes:
        try:
            self._store.wait([key], datetime.timedelta(seconds=max(0.001, float(timeout_secs))))
            return bytes(self._store.get(key))[self._FRAME :]
        except RuntimeError as exc:  # the store's timeout, or a dead server
            raise TimeoutError("key %r not read within %.1fs: %s" % (key, timeout_secs, exc)) from exc

    def try_get(self, key: str) -> Optional[bytes]:
        try:
            if not self._store.check([key]):
                return None
            return bytes(self._store.get(key))[self._FRAME :]
        except RuntimeError:
            return None

    def scan(self, prefix: str) -> Dict[str, Any]:
        """Every indexed key under `prefix` that is set, with its value."""
        root = self._index_prefix(prefix.rstrip("/") + "/_") or prefix.rstrip("/")
        out: Dict[str, Any] = {}
        try:
            count = int(self._store.add(root + "#n", 0))
            for n in range(1, count + 1):
                name = self._names.get((root, n))
                if name is None:
                    entry = "%s#%d" % (root, n)
                    if not self._store.check([entry]):
                        continue
                    name = self._names[(root, n)] = bytes(self._store.get(entry)).decode()
                if name.startswith(prefix) and name not in out:
                    value = self._scanned.get(name)
                    if value is None:
                        value = self.try_get(name)
                        if value is not None:
                            self._scanned[name] = value
                    if value is not None:
                        out[name] = value
        except RuntimeError:
            return {}
        return out

    def delete(self, key: str) -> None:
        self._scanned.pop(key, None)
        try:
            self._store.delete_key(key)
        except RuntimeError:
            pass


class FileKV:
    """The coordination surface over a shared directory.

    Serves consumers that span PROCESSES but not a jax distributed
    runtime — the serving fleet's replicas and balancer
    (`serving/fleet/`) coordinate through one of these without paying
    for (or depending on) a coordination service. Semantics match the
    other two stores:

    - `set(overwrite=False)` is atomic insert-if-absent: the value is
      staged in a hidden temp file and `os.link`ed to the final name,
      the same set-once claim idiom as the artifact store's refs (one
      syscall either creates the complete file or fails EEXIST — a
      reader can never observe a torn set-once value, and two racing
      writers get exactly one winner).
    - `set(overwrite=True)` is stage + `os.replace` (atomic, last
      writer wins) — heartbeat records.
    - every `get` is bounded by `timeout_secs` (jaxlint JL009); the
      wait is a poll, sized for the fleet's human-scale key rates.

    Keys are arbitrary strings; they map to flat filenames via
    URL-style percent-encoding (UTF-8 byte-wise — `urllib.parse.quote`
    with nothing extra in `safe`, so `/` escapes too), so
    `scan(prefix)` is a directory listing plus a decoded prefix
    filter.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._counter = 0
        self._lock = threading.Lock()

    @staticmethod
    def _encode_key(key: str) -> str:
        import urllib.parse

        return urllib.parse.quote(key, safe="")

    @staticmethod
    def _decode_key(name: str) -> str:
        import urllib.parse

        return urllib.parse.unquote(name)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, self._encode_key(key))

    def _stage(self, value) -> str:
        if isinstance(value, str):
            value = value.encode()
        with self._lock:
            self._counter += 1
            n = self._counter
        tmp = os.path.join(
            self.root, ".tmp-%d-%d" % (os.getpid(), n)
        )
        with open(tmp, "wb") as f:
            f.write(value)
            f.flush()
            os.fsync(f.fileno())
        return tmp

    def set(self, key: str, value, overwrite: bool = True) -> bool:
        tmp = self._stage(value)
        try:
            if overwrite:
                os.replace(tmp, self._path(key))
                return True
            try:
                os.link(tmp, self._path(key))
                return True
            except FileExistsError:
                return False
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def get(self, key: str, timeout_secs: float) -> bytes:
        deadline = time.monotonic() + timeout_secs
        while True:
            value = self.try_get(key)
            if value is not None:
                return value
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    "key %r not set within %.1fs" % (key, timeout_secs)
                )
            time.sleep(min(0.02, max(0.0, deadline - time.monotonic())))

    def try_get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def scan(self, prefix: str) -> Dict[str, bytes]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return {}
        out: Dict[str, bytes] = {}
        for name in names:
            if name.startswith(".tmp-"):
                continue
            key = self._decode_key(name)
            if not key.startswith(prefix):
                continue
            value = self.try_get(key)
            if value is not None:
                out[key] = value
        return out

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass


def coordination_kv():
    """The process group's store as a KV (`CoordinationKV`) under a
    process group; an `InMemoryKV` in one process."""
    from adanet_tpu_torch.distributed import coordination

    return CoordinationKV() if coordination.process_count() > 1 else InMemoryKV()


# ---------------------------------------------------------- tree blob codec

#: A blob starts with this magic and the header's length (8 bytes, little
#: endian); each tensor's bytes start at a multiple of _ALIGN, so that a
#: decoded leaf is a view of the blob in its own dtype.
_MAGIC = b"ADNT"
_ALIGN = 8


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _describe(node, tensors: List[torch.Tensor], offset: List[int]):
    if isinstance(node, dict):
        return {"d": [[key, "i" if isinstance(key, int) else "s", _describe(value, tensors, offset)]
                      for key, value in node.items()]}
    if isinstance(node, (list, tuple)):
        return {"l" if isinstance(node, list) else "t": [_describe(value, tensors, offset) for value in node]}
    if torch.is_tensor(node):
        nbytes = node.numel() * node.element_size()
        entry = {"x": [_dtype_name(node.dtype), list(node.shape), offset[0], nbytes]}
        tensors.append(node)
        offset[0] += -(-nbytes // _ALIGN) * _ALIGN
        return entry
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"v": node}
    raise TypeError("encode_tree: unsupported leaf %r" % type(node).__name__)


def encode_tree(tree) -> bytes:
    """A tree of tensors (dicts, lists and tuples of tensors and Python
    scalars, e.g. a `state_dict` or an optimizer's) -> one byte blob.

    The blob carries its own structure: a JSON header with each node
    (dict keys with their type, since an optimizer's state is keyed by
    int) and each tensor's dtype, shape and offset, then the tensors' raw
    bytes. A bf16 tensor travels as its 16-bit patterns (numpy has no
    bf16) with its dtype named in the header. The structure travels
    because an optimizer's state grows on its first step: a receiver's
    template may lack leaves that the sender's state has. The tensors of
    each device are packed with one `torch.cat` there and copied to the
    host once."""
    tensors: List[torch.Tensor] = []
    offset = [0]
    header = json.dumps(_describe(tree, tensors, offset)).encode()
    body = torch.zeros(offset[0], dtype=torch.uint8)
    by_device: Dict[Any, List[Tuple[int, torch.Tensor]]] = {}
    position = 0
    for t in tensors:
        by_device.setdefault(t.device, []).append((position, t))
        position += -(-(t.numel() * t.element_size()) // _ALIGN) * _ALIGN
    for device, items in by_device.items():
        flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for _, t in items]).cpu()
        cursor = 0
        for start, t in items:
            n = t.numel() * t.element_size()
            body[start : start + n] = flat[cursor : cursor + n]
            cursor += n
    return _MAGIC + len(header).to_bytes(8, "little") + header + body.numpy().tobytes()


def _template_devices(template, path=()):
    if isinstance(template, dict):
        for key, value in template.items():
            yield from _template_devices(value, path + (key,))
    elif isinstance(template, (list, tuple)):
        for i, value in enumerate(template):
            yield from _template_devices(value, path + (i,))
    elif torch.is_tensor(template):
        yield path, template


def decode_tree(template, blob: bytes):
    """Rebuilds an `encode_tree` blob. Each tensor goes to the device of
    the template's tensor at the same path, and must have its dtype and
    shape (else `ValueError`); a tensor the template lacks goes to the
    template's first tensor's device (the CPU for a template without
    one). Decoded tensors do not share memory with the template."""
    if blob[:4] != _MAGIC:
        raise ValueError("decode_tree: not an encode_tree blob.")
    size = int.from_bytes(blob[4:12], "little")
    description = json.loads(blob[12 : 12 + size].decode())
    body = torch.frombuffer(bytearray(blob[12 + size :]), dtype=torch.uint8) if len(blob) > 12 + size else None
    known = dict(_template_devices(template))
    default = next(iter(known.values())).device if known else torch.device("cpu")
    on_device: Dict[Any, torch.Tensor] = {}

    def build(node, path):
        if "d" in node:
            return {key: build(value, path + (key,)) for key, _, value in
                    ((int(k) if kind == "i" else k, kind, v) for k, kind, v in node["d"])}
        if "l" in node or "t" in node:
            items = [build(value, path + (i,)) for i, value in enumerate(node.get("l", node.get("t")))]
            return items if "l" in node else tuple(items)
        if "v" in node:
            return node["v"]
        dtype_name, shape, start, nbytes = node["x"]
        dtype = getattr(torch, dtype_name)
        like = known.get(path)
        device = like.device if like is not None else default
        if like is not None and (like.dtype != dtype or list(like.shape) != list(shape)):
            raise ValueError("decode_tree: %s is %s%s in the blob but %s%s in the template"
                             % (path, dtype_name, shape, _dtype_name(like.dtype), list(like.shape)))
        if device not in on_device:
            on_device[device] = body.to(device) if body is not None else torch.zeros(0, dtype=torch.uint8)
        raw = on_device[device][start : start + nbytes]
        return raw.view(dtype).reshape(shape).clone()

    return build(description, ())


def step_seed(seed: int, spec_index: int, step: int) -> int:
    """The seed of one training step's draws for one candidate: the first
    8 bytes (little endian) of SHA-256 of "<seed>/<spec_index>/<step>",
    its top bit cleared. `seed` is the iteration generator's initial
    seed and `step` the iteration-local step index, so that a re-issued
    unit replays the same draws whatever the schedule and the world size
    (the JAX package's `fold_in(fold_in(rng, spec_index), step)`)."""
    digest = hashlib.sha256(b"%d/%d/%d" % (int(seed), int(spec_index), int(step))).digest()
    return int.from_bytes(digest[:8], "little") >> 1


# ---------------------------------------------------------------- work units


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """One schedulable unit: `num_steps` training steps of one candidate
    (or of the ensemble group) starting at iteration-local `start_step`."""

    kind: str  # "subnetwork" | "ensemble"
    name: str  # candidate name, or ENSEMBLE
    start_step: int
    num_steps: int

    @property
    def uid(self) -> str:
        return "%s/s%d+%d" % (self.name, self.start_step, self.num_steps)

    @property
    def end_step(self) -> int:
        return self.start_step + self.num_steps

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(obj: dict) -> "WorkUnit":
        return WorkUnit(**obj)


def plan_windows(
    start: int, stop: int, window_steps: int
) -> List[Tuple[int, int]]:
    """K-grid-aligned (start, num_steps) windows covering [start, stop).

    Windows break at multiples of `window_steps` regardless of `start`,
    so a run resumed from any checkpointed step re-joins the same global
    window grid (unit ids — and therefore re-issue bookkeeping and
    speculative warm-starts — stay stable across restarts).
    """
    if window_steps < 1:
        raise ValueError("window_steps must be >= 1.")
    windows = []
    s = start
    while s < stop:
        e = min(stop, (s // window_steps + 1) * window_steps)
        windows.append((s, e - s))
        s = e
    return windows


@dataclasses.dataclass
class WorkQueueConfig:
    """Queue tuning knobs (env-overridable where operators need them)."""

    window_steps: int = 4
    lease_ttl_secs: float = dataclasses.field(
        default_factory=lambda: _env_float("ADANET_LEASE_TTL_SECS", 15.0)
    )
    max_attempts: int = 3
    poll_interval_secs: float = 0.05
    #: No claimable unit AND no completion for this long => the queue is
    #: wedged (e.g. the chief holding the ensemble tail died): raise
    #: PeerLostError instead of polling forever.
    drain_timeout_secs: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "ADANET_DRAIN_TIMEOUT_SECS", 600.0
        )
    )

    @property
    def renew_interval_secs(self) -> float:
        return max(0.05, self.lease_ttl_secs / 3.0)


class WorkQueue:
    """Lease-based work queue over a KV store.

    Key layout under `namespace`:
      units                 JSON list of every unit (published once)
      claim/<uid>/<n>       set-once claim token for attempt n
      lease/<uid>           {owner, attempt, deadline} (renewed)
      done/<uid>            {owner, attempt} (set-once, terminal)
      state/...             completion payloads (written before done/)
      poison/<name>         candidate quarantined (attempts exhausted)
      final/<name>          last completed end_step of a poisoned candidate

    Lifecycle of a unit: pending -> claimed(n) -> done, or
    claimed(n) -> lease expired -> claimed(n+1) -> ... -> poison after
    `max_attempts`. `done/` is set-once so duplicate executions (an
    expired-but-alive worker racing the re-issue) resolve to exactly one
    authoritative result.
    """

    def __init__(
        self,
        kv,
        namespace: str,
        config: WorkQueueConfig,
        worker: str,
        clock: Callable[[], float] = time.time,
    ):
        self._kv = kv
        self._ns = namespace.rstrip("/")
        self.config = config
        self.worker = worker
        self._clock = clock
        self._units: List[WorkUnit] = []
        self._done_cache: Dict[str, dict] = {}
        self._poison_cache: Dict[str, str] = {}
        # Lease-churn accounting on the process registry: the scheduler's
        # recovery behavior used to be visible only in logs; these
        # counters make "how many units re-issued after worker deaths"
        # a snapshot read (flight dumps embed it).
        reg = metrics_lib.registry()
        self._m_claims = reg.counter("scheduler.lease.claims")
        self._m_expiries = reg.counter("scheduler.lease.expiries")
        # claim() observes the same expired lease on every poll until
        # someone wins the re-issue; count each (unit, lease-attempt)
        # expiry once or the counter inflates with poll frequency.
        self._expiries_seen: set = set()
        self._m_reissues = reg.counter("scheduler.lease.reissues")
        self._m_renewals = reg.counter("scheduler.lease.renewals")
        self._m_lost = reg.counter("scheduler.lease.lost")
        self._m_completions = reg.counter("scheduler.units.completions")
        self._m_poisoned = reg.counter("scheduler.units.poisoned")

    # ------------------------------------------------------------- keys

    def _key(self, *parts) -> str:
        return "/".join([self._ns] + [str(p) for p in parts])

    @property
    def namespace(self) -> str:
        return self._ns

    # ------------------------------------------------------ publish/load

    def publish(self, units: List[WorkUnit]) -> None:
        """Publishes the full unit list (chief-only, once per drain)."""
        payload = json.dumps([u.to_json() for u in units])
        self._kv.set(self._key("units"), payload, overwrite=False)
        self._units = list(units)

    def load(self, timeout_secs: float) -> List[WorkUnit]:
        """Blocks until the chief publishes, then caches the unit list."""
        raw = self._kv.get(self._key("units"), timeout_secs)
        if isinstance(raw, bytes):
            raw = raw.decode()
        self._units = [WorkUnit.from_json(o) for o in json.loads(raw)]
        return list(self._units)

    def attach(self, units: List[WorkUnit]) -> None:
        """Adopts an already-loaded unit list (same namespace)."""
        self._units = list(units)

    @property
    def units(self) -> List[WorkUnit]:
        return list(self._units)

    # ------------------------------------------------------------ status

    @staticmethod
    def _json_value(value):
        if value is None:
            return None
        if isinstance(value, bytes):
            value = value.decode()
        if isinstance(value, str):
            return json.loads(value)
        return value

    def refresh(self) -> None:
        """One scan per status prefix instead of a bounded-blocking get
        per key: done/poison markers are monotone, so the caches only
        ever grow and staleness is benign (a unit looks pending a beat
        longer, never done when it is not)."""
        done_prefix = self._key("done")
        for key, value in self._kv.scan(done_prefix).items():
            uid = key[len(done_prefix) + 1 :]
            if uid and uid not in self._done_cache:
                self._done_cache[uid] = self._json_value(value)
        poison_prefix = self._key("poison")
        for key, value in self._kv.scan(poison_prefix).items():
            name = key[len(poison_prefix) + 1 :]
            if isinstance(value, bytes):
                value = value.decode()
            if name:
                self._poison_cache[name] = value

    def is_done(self, unit: WorkUnit) -> bool:
        return unit.uid in self._done_cache

    def poisoned(self, name: str) -> Optional[str]:
        return self._poison_cache.get(name)

    def poison(self, name: str, reason: str, final_step: int) -> None:
        """Quarantines a candidate: its remaining units stop re-issuing
        and readers fall back to its last completed state."""
        self._poison_cache[name] = reason
        if self._kv.set(self._key("poison", name), reason, overwrite=False):
            self._kv.set(self._key("final", name), str(int(final_step)))
            self._m_poisoned.inc()
            spans_lib.tracer().instant(
                "scheduler.poison",
                correlation={"candidate": name},
                reason=str(reason),
            )
            _LOG.error(
                "Work-queue candidate %r poisoned after %d attempts: %s",
                name,
                self.config.max_attempts,
                reason,
            )

    def final_step(self, name: str, fallback: int) -> int:
        value = self._kv.try_get(self._key("final", name))
        if value is None:
            return fallback
        if isinstance(value, bytes):
            value = value.decode()
        return int(value)

    def last_completed_step(self, name: str, entry_step: int) -> int:
        """Largest end_step among this candidate's done units."""
        best = entry_step
        for unit in self._units:
            if unit.name == name and self.is_done(unit):
                best = max(best, unit.end_step)
        return best

    def settled(self, unit: WorkUnit) -> bool:
        """Done, or never coming (its candidate is poisoned)."""
        return self.is_done(unit) or (
            unit.kind == "subnetwork" and self.poisoned(unit.name) is not None
        )

    def drained(self) -> bool:
        self.refresh()
        return all(self.settled(u) for u in self._units)

    # ------------------------------------------------------------- claims

    def _lease(self, unit: WorkUnit) -> Optional[dict]:
        return self._json_value(self._kv.try_get(self._key("lease", unit.uid)))

    def claim(
        self, ready: Callable[[WorkUnit], bool], can_run: Callable[[WorkUnit], bool]
    ) -> Optional[Tuple[WorkUnit, int]]:
        """Claims the first pending-or-expired ready unit, in published
        order (deterministic). Returns (unit, attempt) or None."""
        self.refresh()
        now = self._clock()
        for unit in self._units:
            if self.settled(unit) or not can_run(unit):
                continue
            if not ready(unit):
                continue
            lease = self._lease(unit)
            if lease is None:
                attempt = 0
            elif float(lease["deadline"]) > now:
                continue  # live lease: someone is (believed) working on it
            else:
                expired = (unit.uid, int(lease["attempt"]))
                if expired not in self._expiries_seen:
                    self._expiries_seen.add(expired)
                    self._m_expiries.inc()
                attempt = int(lease["attempt"]) + 1
            won = self._claim_attempt(unit, attempt)
            if won is not None:
                self._m_claims.inc()
                if won > 0:
                    # Attempt > 0 means a prior holder's lease expired
                    # (or died mid-claim) and this unit re-issued.
                    self._m_reissues.inc()
                    spans_lib.tracer().instant(
                        "scheduler.reissue",
                        correlation={
                            "candidate": unit.name,
                            "work_unit": unit.uid,
                        },
                        attempt=won,
                    )
                return unit, won
        return None

    def _claim_token(self) -> str:
        return json.dumps(
            {
                "owner": self.worker,
                "deadline": self._clock() + self.config.lease_ttl_secs,
            }
        )

    def _claim_token_value(self, key: str) -> Optional[dict]:
        try:
            value = self._json_value(self._kv.try_get(key))
        except ValueError:
            return None
        return value if isinstance(value, dict) else None

    def _claim_attempt(self, unit: WorkUnit, attempt: int) -> Optional[int]:
        """Wins the set-once claim token for `attempt` — or a successor.

        The token carries its own deadline so the claim->lease window is
        crash-recoverable: a worker SIGKILLed after winning the token
        but before writing its lease would otherwise park the unit
        forever (every later claimant recomputes the same attempt from
        the absent lease and loses the same set-once race). Losing the
        race against a live token (or a lease at this attempt) means the
        unit is being worked on; losing against an EXPIRED token with no
        matching lease means the winner died mid-claim and the next
        attempt is free to take.
        """
        while True:
            if attempt >= self.config.max_attempts:
                if unit.kind != "ensemble":
                    self.poison(
                        unit.name,
                        "unit %s exhausted %d lease attempts (workers "
                        "died or hung mid-unit)" % (unit.uid, attempt),
                        final_step=self.last_completed_step(
                            unit.name, unit.start_step
                        ),
                    )
                    return None
                # The ensemble cannot be quarantined away (it IS the
                # selection state), and only the chief may run it: keep
                # re-claiming without bound. A stalled-but-alive chief
                # recovers, duplicate executions are arbitrated by the
                # set-once done/ marker, and a DEAD chief is the
                # workers' drain-timeout PeerLostError — not a poison.
            token_key = self._key("claim", unit.uid, attempt)
            if self._kv.set(token_key, self._claim_token(), overwrite=False):
                # Crash window: token won, lease not yet on record — the
                # token's own deadline is what makes a death here
                # recoverable (schedcheck crashes an actor exactly at
                # this point to prove it).
                sched_point("wq.claim_token_won")
                self._write_lease(unit, attempt)
                return attempt
            lease = self._lease(unit)
            if lease is not None and int(lease["attempt"]) >= attempt:
                return None  # the token winner wrote its lease: live
            token = self._claim_token_value(token_key)
            if token is None or float(token.get("deadline", 0.0)) > self._clock():
                return None  # winner presumed alive (mid claim->lease)
            attempt += 1

    def _write_lease(self, unit: WorkUnit, attempt: int, expired=False):
        deadline = 0.0 if expired else self._clock() + self.config.lease_ttl_secs
        self._kv.set(
            self._key("lease", unit.uid),
            json.dumps(
                {
                    "owner": self.worker,
                    "attempt": attempt,
                    "deadline": deadline,
                }
            ),
        )

    def renew(self, unit: WorkUnit, attempt: int) -> None:
        """Heartbeat: extends this worker's lease on `unit`.

        Raises `LeaseLostError` when the lease was re-issued to another
        worker (this worker was declared dead — its eventual result is
        discarded by the set-once `done/` marker anyway).
        """
        faults.trip("lease.renew")
        lease = self._lease(unit)
        if (
            lease is None
            or int(lease["attempt"]) != attempt
            or lease["owner"] != self.worker
        ):
            self._m_lost.inc()
            raise LeaseLostError(
                "lease on %s (attempt %d) re-issued to %s"
                % (unit.uid, attempt, lease and lease.get("owner"))
            )
        # Race window: the ownership check above against the write
        # below — a re-issue landing in between is legal (the set-once
        # done/ marker arbitrates) and schedcheck explores it.
        sched_point("wq.renew_checked")
        self._write_lease(unit, attempt)
        self._m_renewals.inc()

    def release(self, unit: WorkUnit, attempt: int) -> None:
        """Expires this worker's own lease so the unit re-issues
        immediately (used after a unit-scoped fault)."""
        lease = self._lease(unit)
        if lease and int(lease["attempt"]) == attempt:
            self._write_lease(unit, attempt, expired=True)

    # ------------------------------------------------------- completions

    def complete(self, unit: WorkUnit, attempt: int, blob: Optional[bytes]) -> bool:
        """Publishes a unit result; returns False when another execution
        already won (duplicate results are bit-identical by the
        determinism contract, so losing is harmless)."""
        if blob is not None:
            prefix = self._key("state", unit.uid, attempt)
            nchunks = max(1, -(-len(blob) // _KV_CHUNK_BYTES))
            for i in range(nchunks):
                self._kv.set(
                    "%s/%d" % (prefix, i),
                    blob[i * _KV_CHUNK_BYTES : (i + 1) * _KV_CHUNK_BYTES],
                )
            self._kv.set("%s/n" % prefix, str(nchunks))
        # Crash window: payload chunks on record, done/ marker not yet —
        # readers must never observe this as complete.
        sched_point("wq.complete_before_done")
        won = self._kv.set(
            self._key("done", unit.uid),
            json.dumps({"owner": self.worker, "attempt": attempt}),
            overwrite=False,
        )
        if won:
            self._m_completions.inc()
        return won

    def read_blob(self, unit: WorkUnit, timeout_secs: float) -> bytes:
        """The authoritative completion payload of a done unit."""
        record = self._json_value(
            self._kv.get(self._key("done", unit.uid), timeout_secs)
        )
        prefix = self._key("state", unit.uid, record["attempt"])
        raw_n = self._kv.get("%s/n" % prefix, timeout_secs)
        if isinstance(raw_n, bytes):
            raw_n = raw_n.decode()
        chunks = [
            self._kv.get("%s/%d" % (prefix, i), timeout_secs)
            for i in range(int(raw_n))
        ]
        return b"".join(chunks)


class LeaseRenewer:
    """Background heartbeat renewing one unit's lease during execution.

    The work-unit analogue of `watchdog.HeartbeatWriter`: training a
    window blocks the worker thread in device dispatch, so renewal runs
    on a daemon thread. A lost lease is recorded, not raised — the unit
    finishes and the set-once completion marker arbitrates.
    """

    def __init__(self, queue: WorkQueue, unit: WorkUnit, attempt: int):
        self._queue = queue
        self._unit = unit
        self._attempt = attempt
        self._stop = threading.Event()
        self.lost: Optional[LeaseLostError] = None
        self._thread: Optional[threading.Thread] = None

    def __enter__(self) -> "LeaseRenewer":
        def run():
            interval = self._queue.config.renew_interval_secs
            while not self._stop.wait(interval):
                try:
                    self._queue.renew(self._unit, self._attempt)
                except LeaseLostError as exc:
                    self.lost = exc
                    return
                except Exception as exc:  # renewal is best-effort
                    _LOG.warning(
                        "Lease renewal for %s failed: %s",
                        self._unit.uid,
                        exc,
                    )

        self._thread = threading.Thread(
            target=run, name="lease-%s" % self._unit.uid, daemon=True
        )
        self._thread.start()
        return self

    def __exit__(self, *exc_info) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self._queue.config.renew_interval_secs + 1.0)


# ------------------------------------------------ generic callable drain


def default_devices() -> List[torch.device]:
    """Every visible card; raises without CUDA (`resolve_device`)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _pinned(device):
    """The thread's current device for a unit: `torch.cuda.device(device)`
    for a card, nothing for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def drain_callables(
    make_units,
    num_workers: int,
    devices=None,
    config: Optional[WorkQueueConfig] = None,
    kv=None,
    labels: Optional[List[str]] = None,
    on_error: str = "raise",
) -> Dict[str, BaseException]:
    """Runs an iterator of zero-arg callables (with barrier sentinels)
    through the lease-based queue on a thread pool.

    The engine behind `experimental.ParallelScheduler` (a thin shim):
    units are claimed under leases in published order, each executing
    on a worker pinned to one device of the pool (`devices`, torch
    devices; by default every visible card, `_pinned`), and a `None`
    sentinel in the
    stream is a BARRIER — all in-flight units drain before later units
    publish (the phase-chaining contract).

    `labels` (aligned with the non-sentinel callables) name the units in
    spans and in the returned error map; unlabeled units are named by
    position. Labels should be unique — the error map is keyed by
    label, so duplicate labels collapse to the LAST failure recorded
    under that name. Failure policy is `on_error`:

    - `"raise"` (the default, the historic contract): the first
      exception aborts the remaining units of the phase and re-raises
      after the drain.
    - `"isolate"`: a failing unit is recorded and the OTHER units keep
      running — its freed worker slot immediately claims the next unit
      (the fleet needs this: one dead trial must not abort a rung).
      The collected `{label: exception}` map is returned.

    In-process threads cannot die independently of the process — every
    callable either completes or raises, and both paths publish the
    set-once done/ marker — so the lease TTL is pinned effectively
    eternal: expiry here could only ever DOUBLE-execute a non-idempotent
    callable (a GIL-starved renewal heartbeat) or silently poison-drop
    it after `max_attempts`, failure modes the cross-process queue needs
    and a same-process pool does not.
    """
    if on_error not in ("raise", "isolate"):
        raise ValueError(
            "on_error must be 'raise' or 'isolate', got %r" % (on_error,)
        )
    config = config or WorkQueueConfig()
    config = dataclasses.replace(
        config,
        lease_ttl_secs=max(config.lease_ttl_secs, _IN_PROCESS_LEASE_TTL),
    )
    kv = kv or InMemoryKV()
    devices = list(devices) if devices is not None else default_devices()
    labels = list(labels) if labels is not None else None
    errors: List[BaseException] = []
    failures: Dict[str, BaseException] = {}
    error_lock = threading.Lock()

    phase = [0]

    def run_phase(
        callables: List[Callable[[], None]], names: List[str]
    ) -> None:
        if not callables:
            return
        phase[0] += 1
        wq = WorkQueue(
            kv,
            "adanet/callables/%d" % phase[0],
            config,
            worker="pool",
        )
        wq.publish(
            [
                WorkUnit("subnetwork", "unit%d" % i, 0, 1)
                for i in range(len(callables))
            ]
        )

        def worker(worker_index: int) -> None:
            wq_local = WorkQueue(
                kv,
                wq.namespace,
                config,
                worker="w%d" % worker_index,
            )
            wq_local.attach(wq.units)
            device = devices[worker_index % len(devices)]
            while True:
                if on_error == "raise":
                    with error_lock:
                        if errors:
                            return
                claim = wq_local.claim(lambda u: True, lambda u: True)
                if claim is None:
                    if wq_local.drained():
                        return
                    time.sleep(config.poll_interval_secs)
                    continue
                unit, attempt = claim
                index = int(unit.name[len("unit"):])
                try:
                    with LeaseRenewer(wq_local, unit, attempt):
                        with _pinned(device):
                            with spans_lib.tracer().span(
                                "callable_unit", unit=names[index]
                            ):
                                callables[index]()
                except BaseException as exc:  # surfaced after the drain
                    with error_lock:
                        errors.append(exc)
                        failures[names[index]] = exc
                    wq_local.complete(unit, attempt, None)
                    if on_error == "raise":
                        return
                    continue
                wq_local.complete(unit, attempt, None)

        threads = [
            threading.Thread(target=worker, args=(i,), daemon=True)
            for i in range(min(num_workers, len(callables)))
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            # Bounded join (JL009) in a liveness loop: slow callables
            # hold their (eternal) lease, so the wait simply re-arms
            # until the worker thread exits — it cannot exit without
            # first publishing its unit's done/ marker.
            while thread.is_alive():
                thread.join(timeout=60.0)
        if errors and on_error == "raise":
            raise errors[0]

    def unit_name(index: int) -> str:
        if labels is not None and index < len(labels):
            return str(labels[index])
        return "unit%d" % index

    batch: List[Callable[[], None]] = []
    names: List[str] = []
    cursor = 0
    for item in make_units:
        if item is None:  # barrier
            run_phase(batch, names)
            batch, names = [], []
            continue
        batch.append(item)
        names.append(unit_name(cursor))
        cursor += 1
    run_phase(batch, names)
    return dict(failures)


# ------------------------------------------------------- elastic executor


@dataclasses.dataclass
class ElasticRunResult:
    """Outcome of one queue drain (chief fields None on workers)."""

    state: Optional[Any]  # the assembled IterationState (chief) / None (worker)
    steps_trained: int  # ensemble steps completed by THIS call
    completed: bool  # reached the planned target (False: stop request)
    dispatched_steps: int  # candidate+ensemble steps this process ran
    reused_steps: int  # speculative warm-start steps grafted in
    metrics: Dict[str, Any]
    #: Completed subnetwork window states this process holds, keyed
    #: {candidate: {end_step: snapshot}} — the speculation hand-off.
    window_states: Dict[str, Dict[int, Any]] = dataclasses.field(default_factory=dict)


class ElasticWorkQueueExecutor(RoundRobinExecutor):
    """Drives one iteration by draining the lease-based work queue.

    Port of the JAX package's executor of the same name
    (scheduler.py:882-1493). A subnetwork unit is a window of
    `Iteration.subnetwork_update`s of one candidate; an ensemble unit a
    window of every candidate's `Iteration.ensemble_update` (K1 with
    `use_fused_combine`) against the members' end-of-window states, run
    by the chief only. Units are pure functions of their inputs:

    - states between units are snapshots, CPU copies of a candidate's
      module `state_dict`, optimizer `state_dict`, `step` and `dead`
      (of the ensembles' params, optimizers and EMA states), loaded onto
      the iteration's modules on the unit's device when a unit claims
      them, and taken again at its end; across processes they travel as
      `encode_tree` blobs on the store, never by a device collective;
    - a step's batch is `batch_at(first_global_step + step)`;
    - a step's draws (dropout, stochastic depth) come from a generator
      on the unit's device seeded with `step_seed(iteration seed, spec
      index, step)`, so that a re-issued unit replays its draws.

    So a unit re-issued after a worker's death, or run in a world of
    another size, computes the same bits. Bagging (a builder with a
    `train_input_fn`) raises, as in the JAX package.
    """

    def __init__(self, iteration, strategy, kv=None):
        from adanet_tpu_torch.distributed import coordination
        from adanet_tpu_torch.distributed.placement import ElasticWorkQueueStrategy
        from adanet_tpu_torch.robustness.watchdog import collective_timeout_secs

        if not isinstance(strategy, ElasticWorkQueueStrategy):
            raise TypeError("ElasticWorkQueueExecutor needs an ElasticWorkQueueStrategy, got %r" % (strategy,))
        for spec in iteration.subnetwork_specs:
            if getattr(spec.builder, "train_input_fn", None) is not None:
                raise ValueError(
                    "Per-candidate input pipelines (bagging) are not "
                    "supported by the elastic work-queue scheduler yet; "
                    "use RoundRobinStrategy for builder %r." % spec.name
                )
        self.elastic_strategy = strategy
        self._clock = strategy.clock or time.time
        self._injected_kv = kv if kv is not None else strategy.kv
        self._process_index = coordination.process_index()
        self._process_count = coordination.process_count()
        super().__init__(iteration, None, sync_every=1)
        self._entry: Optional[Dict[Tuple[str, int], Any]] = None
        self._seed = 0
        self._batch_timeout = collective_timeout_secs() or 600.0

    # -------------------------------------------------------------- topology

    def _build_meshes(self) -> None:
        from adanet_tpu_torch.distributed.executor import _device_key

        self._unit_mesh = self.elastic_strategy.subnetwork_mesh(self._n, 0)
        if _device_key(self._unit_mesh.device) != _device_key(self.iteration.device):
            raise ValueError(
                "The elastic unit device is %s, but the iteration trains on %s: a unit runs on the iteration's "
                "device." % (self._unit_mesh.device, self.iteration.device)
            )
        self._sub_meshes = {spec.name: self._unit_mesh for spec in self.iteration.subnetwork_specs}
        self._ens_mesh = self._unit_mesh

    @property
    def is_chief(self) -> bool:
        return self._process_index == 0

    # --------------------------------------------------------------- state

    def place(self, state):
        """Elastic state lives in snapshots between units; the teachers
        (frozen members, the carried-over ensemble's params) are read in
        place, as in the one-process executor."""
        state = super().place(state)
        self._seed = int(state.generator.initial_seed())
        return state

    # ------------------------------------------------------------ planning

    def _candidate_caps(self, target_steps: int) -> Dict[str, int]:
        """Per-candidate training horizon: the iteration target capped by
        the builder's own budget (`train_steps_budget`) — the early-stop
        contract that frees capacity under heterogeneous budgets."""
        caps = {}
        for spec in self.iteration.subnetwork_specs:
            budget = getattr(spec.builder, "train_steps_budget", None)
            caps[spec.name] = int(min(target_steps, budget)) if budget is not None else int(target_steps)
        return caps

    def plan_units(self, state, target_steps: int, subnetworks_only: bool = False) -> List[WorkUnit]:
        """The deterministic unit list for this drain, in claim order:
        window by window, candidates before the window's ensemble unit —
        the pull-based analogue of the lockstep dispatch cadence."""
        k = self.elastic_strategy.window_steps
        caps = self._candidate_caps(target_steps)
        starts = {name: int(st.step) for name, st in state.subnetworks.items()}
        ens_start = int(state.iteration_step)
        per_name = {name: plan_windows(starts[name], caps[name], k) for name in starts}
        ens_windows = [] if subnetworks_only else plan_windows(ens_start, int(target_steps), k)
        boundaries = sorted({s + n for ws in per_name.values() for s, n in ws} | {s + n for s, n in ens_windows})
        units: List[WorkUnit] = []
        for boundary in boundaries:
            for spec in self.iteration.subnetwork_specs:
                for s, n in per_name[spec.name]:
                    if s + n == boundary:
                        units.append(WorkUnit("subnetwork", spec.name, s, n))
            for s, n in ens_windows:
                if s + n == boundary:
                    units.append(WorkUnit("ensemble", ENSEMBLE, s, n))
        return units

    # ----------------------------------------------------------- execution

    def _step_generator(self, spec_index: int, step: int) -> torch.Generator:
        return torch.Generator(device=self._unit_mesh.device).manual_seed(step_seed(self._seed, spec_index, step))

    def _run_subnetwork_unit(self, unit: WorkUnit, state_in, state, batch_at, first_global_step):
        """Executes one candidate window; returns (its end snapshot, the
        last step's metrics)."""
        from adanet_tpu_torch.ensemble.weighted import full_f32_matmul

        faults.trip("workunit.execute")
        it = self.iteration
        spec_index, spec = next((i, s) for i, s in enumerate(it.subnetwork_specs) if s.name == unit.name)
        st = state.subnetworks[unit.name]
        iteration_lib.load_subnetwork_snapshot(st, state_in)
        metrics: Dict[str, Any] = {}
        with full_f32_matmul():
            for step in range(unit.start_step, unit.end_step):
                features, weights, labels = it._step_inputs(batch_at(first_global_step + step))
                context = None
                if self._needs_context[unit.name]:
                    frozen, prev_params = self._teachers
                    context = it.build_loss_context(prev_params, it.frozen_outputs(frozen, features))
                generator = self._step_generator(spec_index, step) if spec.takes_generator else None
                loss, extra = self._sub_steps[unit.name](st, features, labels, weights, context, generator)
                metrics = {"subnetwork_loss/%s" % unit.name: loss, **extra}
        return iteration_lib.subnetwork_snapshot(st), metrics

    def _members(self, member_states: Dict[str, Any]) -> Dict[str, torch.nn.Module]:
        """The ensemble group's member copies holding `member_states`
        (eval-mode forwards, no gradients)."""
        if self._member_copies is None:
            self._member_copies = {
                name: copy.deepcopy(module).requires_grad_(False) for name, module in self._entry_modules.items()
            }
            self._loaded = {}
        for name, (end, snapshot) in member_states.items():
            if self._loaded.get(name) != end:
                self._member_copies[name].load_state_dict(snapshot["module"])
                self._loaded[name] = end
        return self._member_copies

    def _run_ensemble_unit(self, unit: WorkUnit, ens_in, member_states, state, batch_at, first_global_step):
        """One ensemble window: every candidate's mixture-weight and EMA
        update against fixed member states (the end-of-window states:
        staleness <= window_steps)."""
        from adanet_tpu_torch.ensemble.weighted import full_f32_matmul

        faults.trip("workunit.execute")
        iteration_lib.load_ensembles_snapshot(state, ens_in)
        self._members(member_states)
        metrics: Dict[str, Any] = {}
        with full_f32_matmul():
            for step in range(unit.start_step, unit.end_step):
                inputs = self.iteration._step_inputs(batch_at(first_global_step + step))
                self._train_ensembles(state, inputs, metrics)
        return iteration_lib.ensembles_snapshot(state), metrics

    # ------------------------------------------------------------ the drain

    def run_iteration(
        self,
        state,
        batch_at: Callable[[int], Any],
        first_global_step: int,
        target_steps: int,
        queue_namespace: str,
        should_stop: Optional[Callable[[], bool]] = None,
        warm_states: Optional[Dict[str, Dict[int, Any]]] = None,
        subnetworks_only: bool = False,
        kv=None,
        forget_below: Optional[Callable[[int], None]] = None,
    ) -> ElasticRunResult:
        """Drains the iteration's work queue; returns the assembled state
        on the chief.

        `state` must be identical on every process (deterministic init /
        checkpoint restore). `first_global_step` is the absolute batch
        index of this ITERATION's step 0, so re-issued units replay the
        exact batches their first execution consumed. The chief publishes
        units and owns the ensemble windows; every process (chief
        included) pulls candidate units. `warm_states` grafts
        speculatively pre-trained windows in as instant completions.
        `forget_below` (absolute step index) is called as the drain's
        re-issue floor rises, letting the caller's batch log drop
        batches no unsettled unit can ever replay.
        """
        from adanet_tpu_torch.robustness.watchdog import PeerLostError

        state = self.place(state)
        kv = kv or self._injected_kv or coordination_kv()
        config = self.elastic_strategy.queue_config()
        queue = WorkQueue(kv, queue_namespace, config, worker="p%d" % self._process_index, clock=self._clock)

        entry_steps = {name: int(st.step) for name, st in state.subnetworks.items()}
        ens_entry = int(state.iteration_step)
        caps = self._candidate_caps(target_steps)
        # Snapshot cache: (name, end_step) -> a subnetwork snapshot;
        # (ENSEMBLE, end_step) -> the ensembles' snapshot.
        states: Dict[Tuple[str, int], Any] = {
            (name, entry_steps[name]): iteration_lib.subnetwork_snapshot(st) for name, st in state.subnetworks.items()
        }
        states[(ENSEMBLE, ens_entry)] = iteration_lib.ensembles_snapshot(state)
        self._entry = dict(states)
        self._entry_modules = {name: st.module for name, st in state.subnetworks.items()}
        self._member_copies = None

        if self.is_chief:
            units = self.plan_units(state, target_steps, subnetworks_only=subnetworks_only)
            queue.publish(units)
            reused = self._graft_warm_states(queue, states, warm_states)
        else:
            queue.load(timeout_secs=self._batch_timeout)
            reused = 0

        unit_index = {(u.name, u.end_step): u for u in queue.units}

        def ready(unit: WorkUnit) -> bool:
            return self._unit_ready(unit, queue, unit_index, entry_steps, ens_entry, caps)

        def can_run(unit: WorkUnit) -> bool:
            # Ensemble windows are pinned to the chief: selection state
            # (EMAs, mixture weights) lives where bookkeeping happens.
            return unit.kind != "ensemble" or self.is_chief

        dispatched = 0
        metrics: Dict[str, Any] = {}
        completed = True
        stall_deadline = self._clock() + config.drain_timeout_secs
        while not queue.drained():
            if should_stop is not None and should_stop():
                completed = False
                break
            claim = queue.claim(ready, can_run)
            if claim is None:
                if self._clock() > stall_deadline:
                    raise PeerLostError(
                        "work-queue drain",
                        timeout_secs=config.drain_timeout_secs,
                        detail="no claimable unit and no completion in namespace %s (dead chief or wedged peer?)"
                        % queue.namespace,
                    )
                time.sleep(config.poll_interval_secs)
                continue
            unit, attempt = claim
            stall_deadline = self._clock() + config.drain_timeout_secs
            try:
                with spans_lib.tracer().span(
                    "scheduler.workunit",
                    correlation={"candidate": unit.name, "work_unit": unit.uid},
                    kind=unit.kind,
                    attempt=attempt,
                    steps=unit.num_steps,
                ), LeaseRenewer(queue, unit, attempt):
                    if unit.kind == "subnetwork":
                        state_in = self._input_state(unit, queue, states, unit_index)
                        out, unit_metrics = self._run_subnetwork_unit(
                            unit, state_in, state, batch_at, first_global_step
                        )
                        blob = encode_tree(out) if self._process_count > 1 else None
                    else:
                        ens_in = self._input_state(unit, queue, states, unit_index)
                        member_states = self._member_states_for(unit, queue, states, unit_index, entry_steps, caps)
                        out, unit_metrics = self._run_ensemble_unit(
                            unit, ens_in, member_states, state, batch_at, first_global_step
                        )
                        blob = None  # ensemble windows never leave the chief
            except CANDIDATE_FAULTS as exc:
                if unit.kind == "ensemble":
                    raise  # selection state cannot be quarantined away
                _LOG.error("Work unit %s faulted on attempt %d: %s", unit.uid, attempt, exc)
                queue.release(unit, attempt)
                continue
            dispatched += unit.num_steps
            states[(unit.name, unit.end_step)] = out
            queue.complete(unit, attempt, blob)
            metrics.update(unit_metrics)
            if forget_below is not None:
                # Only unsettled units can still be (re-)issued; batches
                # below the lowest unsettled start are dead weight.
                queue.refresh()
                live = [u.start_step for u in queue.units if not queue.settled(u)]
                forget_below(first_global_step + (min(live) if live else int(target_steps)))

        # ------------------------------------------------------- assembly
        if not self.is_chief:
            queue.refresh()
            return ElasticRunResult(
                state=None,
                steps_trained=self._ensemble_progress(queue, ens_entry) - ens_entry,
                completed=completed,
                dispatched_steps=dispatched,
                reused_steps=reused,
                metrics=metrics,
            )
        final = self._assemble(state, queue, states, unit_index, entry_steps, ens_entry)
        steps_trained = int(final.iteration_step) - ens_entry
        for name, reason in self._poisoned_now(queue).items():
            if name not in self._dead_subnetworks:
                self._mark_subnetwork_dead(name, RuntimeError(reason))
        window_states: Dict[str, Dict[int, Any]] = {}
        for (name, end), value in states.items():
            if name != ENSEMBLE and end > entry_steps.get(name, 0):
                window_states.setdefault(name, {})[end] = value
        return ElasticRunResult(
            state=final,
            steps_trained=steps_trained,
            completed=completed,
            dispatched_steps=dispatched,
            reused_steps=reused,
            metrics=metrics,
            window_states=window_states,
        )

    # ------------------------------------------------------- drain helpers

    def _graft_warm_states(self, queue, states, warm_states) -> int:
        """Marks speculatively pre-trained windows done (chief-only)."""
        if not warm_states:
            return 0
        reused = 0
        for unit in queue.units:
            if unit.kind != "subnetwork":
                continue
            warm = warm_states.get(unit.name, {})
            if unit.end_step in warm and not queue.is_done(unit):
                out = warm[unit.end_step]
                states[(unit.name, unit.end_step)] = out
                blob = encode_tree(out) if self._process_count > 1 else None
                # complete() needs a claim for bookkeeping symmetry.
                queue._kv.set(queue._key("claim", unit.uid, 0), queue._claim_token(), overwrite=False)
                queue.complete(unit, 0, blob)
                reused += unit.num_steps
        if reused:
            _LOG.info("Speculative warm start reused %d pre-trained steps.", reused)
        return reused

    @staticmethod
    def _ensemble_progress(queue, ens_entry: int) -> int:
        ens_end = ens_entry
        for unit in queue.units:
            if unit.kind == "ensemble" and queue.is_done(unit):
                ens_end = max(ens_end, unit.end_step)
        return ens_end

    def _poisoned_now(self, queue) -> Dict[str, str]:
        return {
            spec.name: queue.poisoned(spec.name)
            for spec in self.iteration.subnetwork_specs
            if queue.poisoned(spec.name) is not None
        }

    def _member_need(self, name, window_end, queue, unit_index, entry_steps, caps) -> Optional[int]:
        """The member end_step an ensemble window ending at `window_end`
        consumes for candidate `name`; None when not yet available."""
        target = min(caps[name], window_end)
        if target <= entry_steps[name]:
            return entry_steps[name]
        if queue.poisoned(name) is not None:
            return queue.final_step(name, entry_steps[name])
        unit = unit_index.get((name, target))
        if unit is None:  # resumed run: state restored beyond this point
            return entry_steps[name]
        return target if queue.is_done(unit) else None

    def _unit_ready(self, unit, queue, unit_index, entry_steps, ens_entry, caps) -> bool:
        if unit.kind == "subnetwork":
            if unit.start_step <= entry_steps[unit.name]:
                return True
            prev = unit_index.get((unit.name, unit.start_step))
            return prev is not None and queue.is_done(prev)
        # Ensemble window: its own predecessor plus every member state.
        if unit.start_step > ens_entry:
            prev = unit_index.get((ENSEMBLE, unit.start_step))
            if prev is None or not queue.is_done(prev):
                return False
        for spec in self.iteration.subnetwork_specs:
            if self._member_need(spec.name, unit.end_step, queue, unit_index, entry_steps, caps) is None:
                return False
        return True

    def _fetch(self, key, queue, states, unit_index):
        """The snapshot under `key` ((name, end_step)), read from the
        store when another process produced it."""
        if key not in states:
            template = self._entry[next(k for k in self._entry if k[0] == key[0])]
            blob = queue.read_blob(unit_index[key], timeout_secs=self._batch_timeout)
            states[key] = decode_tree(template, blob)
        return states[key]

    def _input_state(self, unit, queue, states, unit_index):
        """The unit's predecessor snapshot."""
        name = unit.name if unit.kind == "subnetwork" else ENSEMBLE
        return self._fetch((name, unit.start_step), queue, states, unit_index)

    def _member_states_for(self, unit, queue, states, unit_index, entry_steps, caps):
        """{member: (end_step, snapshot)} that an ensemble window reads."""
        out = {}
        for spec in self.iteration.subnetwork_specs:
            need = self._member_need(spec.name, unit.end_step, queue, unit_index, entry_steps, caps)
            out[spec.name] = (need, self._fetch((spec.name, need), queue, states, unit_index))
        return out

    def _assemble(self, state, queue, states, unit_index, entry_steps, ens_entry):
        """The iteration's state after the drain (chief-only): each
        candidate's last completed (or, poisoned, its final) snapshot and
        the last ensemble window's, loaded onto the live modules."""
        for spec in self.iteration.subnetwork_specs:
            name = spec.name
            if queue.poisoned(name) is not None:
                end = queue.final_step(name, entry_steps[name])
            else:
                end = queue.last_completed_step(name, entry_steps[name])
            iteration_lib.load_subnetwork_snapshot(state.subnetworks[name], self._fetch((name, end), queue, states, unit_index))
        ens_end = self._ensemble_progress(queue, ens_entry)
        # The chief executed every ensemble window itself, so the final
        # ensembles' snapshot is always in the local cache.
        iteration_lib.load_ensembles_snapshot(state, states[(ENSEMBLE, ens_end)])
        state.iteration_step = ens_end
        return state
