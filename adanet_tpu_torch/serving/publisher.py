"""Generation publication: atomic, digest-sealed serving exports.

Port of adanet_tpu/serving/publisher.py for the port's generation
format (`core/export.py`):

    <model_dir>/serving/gen-<t>/
        architecture.json
        params.npz
        serving_signature.json
        generation.json          {iteration_number, digests, checksum}

The export lands in a hidden staging directory and is renamed into
place, so a reader never observes a half-written generation.
Publication is set-once per iteration. `generation.json` binds the
SHA-256 digest of every artifact to the iteration number with a
self-checksum, which `verify_generation` checks before a pool loads a
generation. Cascade programs and store ref closures come later.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

_LOG = logging.getLogger("adanet_tpu_torch")

#: Subdirectory of the model dir holding the generation chain.
SERVING_SUBDIR = "serving"
GENERATION_MANIFEST = "generation.json"

_GEN_RE = re.compile(r"^gen-(\d+)$")


def serving_root(model_dir: str) -> str:
    return os.path.join(model_dir, SERVING_SUBDIR)


def generation_dirname(iteration_number: int) -> str:
    return "gen-%d" % iteration_number


def generation_dir(model_dir: str, iteration_number: int) -> str:
    return os.path.join(serving_root(model_dir), generation_dirname(iteration_number))


def list_generations(model_dir: str) -> List[Tuple[int, str]]:
    """(iteration_number, absolute path) of published generations, sorted.

    Staging directories never match the `gen-<t>` pattern, so readers only
    ever see complete publications.
    """
    root = serving_root(model_dir)
    try:
        entries = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in entries:
        match = _GEN_RE.match(name)
        if match and os.path.isdir(os.path.join(root, name)):
            out.append((int(match.group(1)), os.path.join(root, name)))
    return sorted(out)


def _sha256_file(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _checksum(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def write_generation_manifest(gen_dir: str, iteration_number: int) -> None:
    """Records `generation.json` over the artifacts already in `gen_dir`."""
    from adanet_tpu_torch.core.export import REQUIRED_SERVING_FILES

    digests = {
        name: _sha256_file(os.path.join(gen_dir, name))
        for name in sorted(os.listdir(gen_dir))
        if name != GENERATION_MANIFEST and os.path.isfile(os.path.join(gen_dir, name))
    }
    missing = [name for name in REQUIRED_SERVING_FILES if name not in digests]
    if missing:
        raise ValueError("Serving export incomplete; missing %s in %s" % (missing, gen_dir))
    obj = {"iteration_number": int(iteration_number), "digests": digests}
    obj["checksum"] = _checksum(obj)
    with open(os.path.join(gen_dir, GENERATION_MANIFEST), "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())


def verify_generation(gen_dir: str) -> List[str]:
    """Problems with a published generation (empty when it is intact):
    a missing or self-inconsistent manifest, a missing artifact, or an
    artifact whose digest differs from the manifest's."""
    try:
        with open(os.path.join(gen_dir, GENERATION_MANIFEST)) as f:
            obj = json.load(f)
    except (OSError, ValueError) as exc:
        return ["manifest unreadable: %s" % exc]
    body = {k: v for k, v in obj.items() if k != "checksum"}
    if obj.get("checksum") != _checksum(body):
        return ["manifest checksum mismatch"]
    issues = []
    for name, digest in sorted(obj.get("digests", {}).items()):
        path = os.path.join(gen_dir, name)
        if not os.path.isfile(path):
            issues.append("%s missing" % name)
        elif _sha256_file(path) != digest:
            issues.append("%s digest mismatch" % name)
    return issues


def read_iteration_number(gen_dir: str) -> int:
    with open(os.path.join(gen_dir, GENERATION_MANIFEST)) as f:
        return int(json.load(f)["iteration_number"])


def publish_generation(
    model_dir: str,
    iteration_number: int,
    frozen,
    ensembler,
    head,
    sample_features: Any,
) -> Optional[str]:
    """Exports and atomically publishes one serving generation.

    Returns the published directory, or None when this generation was
    already published (set-once).
    """
    final = generation_dir(model_dir, iteration_number)
    if os.path.isdir(final):
        return None
    root = serving_root(model_dir)
    os.makedirs(root, exist_ok=True)
    from adanet_tpu_torch.core import export as export_lib

    staging = tempfile.mkdtemp(prefix=".stage-gen-", dir=root)
    try:
        export_lib.export_serving_program(staging, frozen, ensembler, head, sample_features)
        write_generation_manifest(staging, iteration_number)
        try:
            os.replace(staging, final)
        except OSError:
            # A concurrent publisher won the rename.
            if os.path.isdir(final):
                shutil.rmtree(staging, ignore_errors=True)
                return None
            raise
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    _LOG.info("Published serving generation %d at %s", iteration_number, final)
    return final
