"""Key derivation for the content-addressed artifact store.

A copy of adanet_tpu/store/keys.py, except for `env_fingerprint` (and
this docstring), which the JAX package derives from jax's own versions.

Blobs are keyed by their own SHA-256 — nothing to derive. Refs need
stable, collision-resistant names built from three ingredients the
consumers share:

- the **architecture hash**: the structural identity of an ensemble —
  its member (iteration, builder) pairs, ensembler, and iteration
  number, with volatile bookkeeping (global step, replay indices)
  excluded;
- a **spec fingerprint**: whatever run configuration makes numerically
  different artifacts under the same structure — the caller declares it
  as a plain JSON-able dict (the same dict, hence the same fingerprint,
  as the JAX package's for one workload);
- the **env fingerprint**: (torch version, CUDA version, device name,
  device count) — a tile tuned on one card must never apply on another,
  nor a CPU proxy's on a card.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional

_HEX64 = frozenset("0123456789abcdef")


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def is_digest(text: str) -> bool:
    """True for a lowercase 64-char SHA-256 hex string."""
    return len(text) == 64 and set(text) <= _HEX64


def canonical_json(obj: Any) -> bytes:
    """The byte form every fingerprint hashes (sorted keys, no spaces)."""
    return json.dumps(
        obj, sort_keys=True, separators=(",", ":")
    ).encode()


def spec_fingerprint(spec: Dict[str, Any]) -> str:
    """Hash of a caller-declared configuration dict (JSON-able values)."""
    return sha256_hex(canonical_json(spec))


#: Length of the short spec fingerprint embedded in ref names.
SEARCH_SPEC_FINGERPRINT_LEN = 16


def search_spec_fingerprint(
    random_seed: int,
    max_iteration_steps: int,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """The short spec fingerprint a SEARCH keys its frozen refs by.

    One derivation shared by `Estimator._store_spec_fingerprint` and
    `fleet.TrialSpec.spec_fingerprint`, so "two searches share frozen
    payloads iff their fingerprints agree" is safe by construction: the
    base ingredients (seed, per-iteration step budget) plus whatever
    `extra` numeric-relevant configuration the caller declares (the
    fleet adds adanet lambda/beta and the generator identity — anything
    that makes the SAME architecture train to DIFFERENT numbers).
    `extra` keys may not shadow the base keys.
    """
    spec: Dict[str, Any] = {
        "random_seed": int(random_seed),
        "max_iteration_steps": int(max_iteration_steps),
    }
    for key, value in sorted((extra or {}).items()):
        if key in spec:
            raise ValueError(
                "spec extra key %r shadows a base spec ingredient" % key
            )
        spec[key] = value
    return spec_fingerprint(spec)[:SEARCH_SPEC_FINGERPRINT_LEN]


_env_fp_cache: Dict[str, str] = {}


def env_fingerprint(device=None) -> str:
    """Hash of (torch, CUDA, device name, device count) for `device`.

    `device` is "cuda" (or "cuda:<i>") or "cpu"; None means "cuda" when
    CUDA is available, else "cpu". A CPU environment names its device
    "cpu", so a CPU proxy's tuning never lands on a card's ref.
    """
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    key = str(dev)
    fp = _env_fp_cache.get(key)
    if fp is None:
        if dev.type == "cuda":
            name = torch.cuda.get_device_name(dev)
            count = torch.cuda.device_count()
        else:
            name, count = "cpu", 1
        fp = sha256_hex(
            canonical_json(
                {
                    "torch": torch.__version__,
                    "cuda": torch.version.cuda,
                    "device": name,
                    "count": count,
                }
            )
        )
        _env_fp_cache[key] = fp
    return fp


def architecture_hash(arch_obj: Dict[str, Any]) -> str:
    """Structural hash of a serialized `core.architecture.Architecture`.

    Keeps: iteration number, ensembler, candidate name, and the member
    (iteration, builder) pairs. Drops: `global_step` (a consequence of
    the step budget, not identity) and `replay_indices` (how the winner
    was picked, not what it is) — so an Evaluator-driven search and a
    replayed one hash the same ensemble identically.
    """
    members = [
        [int(entry["iteration_number"]), str(entry["builder_name"])]
        for entry in arch_obj.get("subnetworks", [])
    ]
    return sha256_hex(
        canonical_json(
            {
                "ensemble_candidate_name": arch_obj.get(
                    "ensemble_candidate_name"
                ),
                "ensembler_name": arch_obj.get("ensembler_name"),
                "iteration_number": int(
                    arch_obj.get("iteration_number", 0)
                ),
                "subnetworks": members,
            }
        )
    )


def architecture_hash_from_file(path: str) -> str:
    """`architecture_hash` of an `architecture-<t>.json` on disk."""
    with open(path) as f:
        return architecture_hash(json.load(f))


def ref_name(*parts: str) -> str:
    """Joins key ingredients into one filesystem-safe ref name.

    Parts are joined with `-`; each must already be filesystem-safe
    (hex digests from the helpers above, or short [A-Za-z0-9_]+ tags).
    """
    for part in parts:
        if (
            not part
            or not part.strip(".")  # "." / ".." resolve upward
            or not all(c.isalnum() or c in "_." for c in part)
        ):
            raise ValueError(
                "ref name part %r is not filesystem-safe" % (part,)
            )
    return "-".join(parts)
