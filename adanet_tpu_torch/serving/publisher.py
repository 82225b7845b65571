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
Publication is set-once per iteration; a quarantined `gen-<t>.corrupt`
does not block a fresh publish of iteration t. `generation.json` binds
the SHA-256 digest of every artifact (the programs included) to the
iteration number with a self-checksum, which
`robustness.integrity.verify_serving_generation` checks before a pool
loads a generation. With a cascade (`serving.fleet.cascade.CascadeSpec`)
the cheap member's program is exported beside the ensemble's and
calibrated on the spec's held-out features inside the same staging
directory, so program and policy land in one digest-sealed unit.

With an artifact store (`store=`), each generation is also published as
a ref closure (`serving/<dir-id>-gen<t>`): every artifact lands in the
content-addressed store with the generation directory recorded as its
heal source, so that a serving pool can lease the closure against GC.
The closure is set-once, failure-isolated, and attempted again when the
directory already exists but the ref does not (a publisher killed
between the two).
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

from adanet_tpu_torch.robustness import integrity

_LOG = logging.getLogger("adanet_tpu_torch")

#: Subdirectory of the model dir holding the generation chain.
SERVING_SUBDIR = "serving"
GENERATION_MANIFEST = integrity.GENERATION_MANIFEST

_GEN_RE = re.compile(r"^gen-(\d+)$")


def serving_root(model_dir: str) -> str:
    return os.path.join(model_dir, SERVING_SUBDIR)


def generation_dirname(iteration_number: int) -> str:
    return "gen-%d" % iteration_number


def generation_dir(model_dir: str, iteration_number: int) -> str:
    return os.path.join(serving_root(model_dir), generation_dirname(iteration_number))


def list_generations(model_dir: str) -> List[Tuple[int, str]]:
    """(iteration_number, absolute path) of published generations, sorted.

    Quarantined (`*.corrupt`) and staging directories never match the `gen-<t>` pattern, so readers only
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
    digests = {
        name: _sha256_file(os.path.join(gen_dir, name))
        for name in sorted(os.listdir(gen_dir))
        if name != GENERATION_MANIFEST and os.path.isfile(os.path.join(gen_dir, name))
    }
    missing = [name for name in integrity.REQUIRED_SERVING_FILES if name not in digests]
    if missing:
        raise ValueError("Serving export incomplete; missing %s in %s" % (missing, gen_dir))
    obj = {"iteration_number": int(iteration_number), "digests": digests}
    obj["checksum"] = _checksum(obj)
    with open(os.path.join(gen_dir, GENERATION_MANIFEST), "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())


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
    already published (set-once). With `store`, the generation's ref
    closure is published too, on both paths (`publish_ref_closure`).
    """
    final = generation_dir(model_dir, iteration_number)
    if os.path.isdir(final):
        if store is not None:
            publish_ref_closure(store, model_dir, iteration_number)
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
    if store is not None:
        publish_ref_closure(store, model_dir, iteration_number)
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


def serving_ref_name(model_dir: str, iteration_number: int) -> str:
    """Store ref name of one model dir's generation closure."""
    from adanet_tpu_torch.store import keys as store_keys

    dir_id = store_keys.sha256_hex(os.path.abspath(model_dir).encode())[:16]
    return store_keys.ref_name(dir_id, "gen%d" % int(iteration_number))


def publish_ref_closure(store, model_dir: str, iteration_number: int) -> Optional[dict]:
    """Publishes a generation's artifacts as a store ref closure.

    Failure-isolated: a store outage means "this generation is not
    shared or healable", never a dead searcher. Returns the ref document,
    or None when the closure already landed (set-once), publication
    failed, or the directory holds no artifact.
    """
    gen_dir = generation_dir(model_dir, iteration_number)
    name = serving_ref_name(model_dir, iteration_number)
    try:
        if store.get_ref("serving", name) is not None:
            return None
        blobs = {}
        sources = []
        for entry in sorted(os.listdir(gen_dir)):
            path = os.path.join(gen_dir, entry)
            if not os.path.isfile(path):
                continue
            with open(path, "rb") as f:
                blobs[entry] = store.put(f.read())
            sources.append(path)
        if not blobs:
            return None
        return store.put_ref(
            "serving",
            name,
            blobs,
            meta={"model_dir": os.path.abspath(model_dir), "iteration_number": int(iteration_number)},
            sources=sources,
        )
    except Exception:
        _LOG.exception(
            "Store closure publication for serving generation %d failed; the on-disk generation is unaffected.",
            iteration_number,
        )
        return None
