"""Generation publication: atomic, digest-sealed serving exports.

Port of adanet_tpu/serving/publisher.py over the port's hermetic
programs (`core/export.py`):

    <model_dir>/serving/gen-<t>/
        serving.pt2              the ensemble's `torch.export` program
        serving_signature.json   its signature (and the cascade record)
        cascade.pt2              the cheap member's program (a cascade)
        generation.json          {iteration_number, digests, checksum}

The export lands in a hidden staging directory and is renamed into
place, so a reader never observes a half-written generation.
Publication is set-once per iteration. `generation.json` binds the
SHA-256 digest of every artifact (the programs included) to the
iteration number with a self-checksum, which `verify_generation` checks
before a pool loads a generation. With a cascade
(`serving.fleet.cascade.CascadeSpec`) the cheap member's program is
exported beside the ensemble's and calibrated on the spec's held-out
features inside the same staging directory, so program and policy land
in one digest-sealed unit. Store ref closures (`store=`) come with
ROADMAP item 10's second half.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Tuple

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
    predict_fn: Callable,
    sample_features: Any,
    store=None,
    cascade=None,
    device=None,
) -> Optional[str]:
    """Exports and atomically publishes one serving generation of
    `predict_fn(features) -> predictions` (its parameters on `device`,
    the card by default), with `cascade`'s cheap program and calibration
    when given.

    Returns the published directory, or None when this generation was
    already published (set-once).
    """
    if store is not None:
        raise NotImplementedError(
            "publishing a generation to an artifact store is not ported yet (ROADMAP item 10, part two)"
        )
    final = generation_dir(model_dir, iteration_number)
    if os.path.isdir(final):
        return None
    root = serving_root(model_dir)
    os.makedirs(root, exist_ok=True)
    from adanet_tpu_torch.core import export as export_lib

    staging = tempfile.mkdtemp(prefix=".stage-gen-", dir=root)
    try:
        export_lib.export_serving_program(staging, predict_fn, sample_features, device=device)
        if cascade is not None:
            _export_cascade(staging, predict_fn, sample_features, cascade, device)
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


def _export_cascade(staging: str, predict_fn: Callable, sample_features: Any, cascade, device) -> None:
    """Exports and calibrates the cheap member inside the staging
    directory, before the manifest and the rename, so the cascade rides
    the same atomic publication as the full program. A calibration
    failure aborts the whole publish: a generation never lands with a
    program but no threshold, or the reverse."""
    import numpy as np
    import torch

    from adanet_tpu_torch._device import resolve_device
    from adanet_tpu_torch.core import export as export_lib
    from adanet_tpu_torch.serving.fleet import cascade as cascade_lib
    from adanet_tpu_torch.serving.model_pool import to_host

    cheap_dir = tempfile.mkdtemp(prefix=".cascade-", dir=staging)
    try:
        export_lib.export_serving_program(cheap_dir, cascade.predict_fn, sample_features, device=device)
        os.replace(os.path.join(cheap_dir, export_lib.SERVING_FILE),
                   os.path.join(staging, export_lib.CASCADE_FILE))
    finally:
        shutil.rmtree(cheap_dir, ignore_errors=True)
    dev = resolve_device(device)
    features = export_lib._canonical(export_lib._map(lambda x: export_lib._tensor(x, dev),
                                                     cascade.calibration_features))
    with torch.inference_mode(), export_lib._serving_precision():
        cheap_out = to_host(cascade.predict_fn(features))
        full_out = to_host(predict_fn(features))

    def leaf(outputs):
        if isinstance(outputs, dict):
            return np.asarray(outputs[cascade.logits_key])
        return np.asarray(outputs)

    record = cascade_lib.calibrate(
        leaf(cheap_out),
        leaf(full_out),
        labels=cascade.calibration_labels,
        target_agreement=cascade.target_agreement,
        logits_key=cascade.logits_key,
        source=getattr(cascade, "source", "member"),
    )
    record["program"] = export_lib.CASCADE_FILE
    signature = export_lib.serving_signature(staging)
    signature[cascade_lib.SIGNATURE_KEY] = record
    with open(os.path.join(staging, export_lib.SIGNATURE_FILE), "w") as f:
        json.dump(signature, f, indent=2, sort_keys=True)


def read_digests(gen_dir: str) -> dict:
    """The artifact digests a generation's manifest records ({} when it
    is unreadable)."""
    try:
        with open(os.path.join(gen_dir, GENERATION_MANIFEST)) as f:
            return dict(json.load(f).get("digests", {}))
    except (OSError, ValueError):
        return {}
