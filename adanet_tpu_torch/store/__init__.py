"""Content-addressed artifact store: shared warm starts, safe GC.

ROADMAP item 5. The search stack grows two kinds of immutable artifact
— AOT-compiled executables (`core/compile_cache.py`) and frozen
subnetwork checkpoint payloads (`core/checkpoint.py`) — and the
AdaNet freeze-and-grow structure makes both immutable-by-construction:
exactly the shape a content-addressed store exploits. This package is
that store:

- `ArtifactStore` (`blobstore.py`): SHA-256-named blobs with
  crash-safe staged writes, verify-on-read, quarantine, and
  transparent healing from duplicate referencers; set-once JSON refs
  keyed by (architecture hash, spec fingerprint, env fingerprint).
- `leases` / `gc`: TTL leases pin a consumer's ref closure; the
  mark-and-sweep collector honors refs, live leases, and a grace
  period, so concurrent reclamation can never delete a live artifact.
- `fsck_store`: the store section of `tools/ckpt_fsck.py --json`.
- `keys`: fingerprint/hash derivation shared by all consumers.

Consumers: `core/compile_cache.py` (persistent executable tier),
`core/estimator.py` (frozen payload publication + warm-start replay),
`serving/publisher.py` (generation ref closures), `adanet_tpu_torch.replay`
(zero-compile, zero-retrain search replay). See
docs/artifact_store.md.
"""

from adanet_tpu_torch.store import gc
from adanet_tpu_torch.store import keys
from adanet_tpu_torch.store import leases
from adanet_tpu_torch.store.blobstore import (
    ArtifactStore,
    BlobCorruptError,
    BlobMissingError,
    StoreError,
)
from adanet_tpu_torch.store.fsck import fsck_store
from adanet_tpu_torch.store.gc import GCReport, collect
from adanet_tpu_torch.store.leases import Lease

__all__ = [
    "ArtifactStore",
    "BlobCorruptError",
    "BlobMissingError",
    "GCReport",
    "Lease",
    "StoreError",
    "collect",
    "fsck_store",
    "gc",
    "keys",
    "leases",
]
