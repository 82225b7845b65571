"""Durable checkpointing for the AdaNet search loop.

Port of adanet_tpu/core/checkpoint.py. A checkpoint is a set of payloads
plus a JSON manifest, in the JAX package's layout:

- `frozen-<t>.pt`: the winning ensemble of iteration t (each member's
  `state_dict`, the mixture weights, complexity and `shared`, the final
  EMA, the name). Modules are not stored: the search rebuilds them by
  replaying the generator, and `payload_into_frozen` loads the numbers
  onto the rebuilt members.
- `ckpt-<step>.pt`: the whole mid-iteration `IterationState`
  (`core/iteration.py: state_payload`), so that a fresh process resumes
  from that step.
- `iteration-final-<t>.pt`: the same payload of every candidate at the
  end of iteration t, kept with `keep_candidate_states` for
  `evaluate_all_candidates`.
- `candidate-metrics-<t>.json`: every candidate's selection metrics at
  the end of iteration t, always written.
- `checkpoint.json`: the manifest (iteration number, global step, the
  current state file, digests, the generation chain), the JAX package's
  file byte for byte for the same `CheckpointInfo`.

Payloads go through `torch.save` into bytes, which are digested and
written atomically (temp file, fsync, rename, directory fsync) after a
`<file>.sha256` sidecar is dropped, and the sidecar follows. Reads
verify the digest before they decode, and decode with
`weights_only=True`: a checkpoint is data, not code. Corruption raises
`CheckpointCorruptionError`; `robustness/integrity.py` quarantines the
file (`*.corrupt`) and rolls back. The previous manifest stays at
`checkpoint.json.prev`, and a model dir whose manifests are both gone is
reconstructed from the architecture chain.

Manifest v3 carries the JAX package's `store_refs` map, always empty
here: publishing payloads to the artifact store comes with a later slice.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import io
import json
import logging
import os
import re
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.robustness.retry import retrying_open_read

_LOG = logging.getLogger("adanet_tpu_torch")

MANIFEST = "checkpoint.json"
MANIFEST_PREV = "checkpoint.json.prev"
DIGEST_SUFFIX = ".sha256"
QUARANTINE_SUFFIX = ".corrupt"
STATE_FILE_PATTERN = r"ckpt-(\d+)\.pt"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint artifact failed verification or deserialization.

    Never retried (retrying cannot un-corrupt bytes); the restore path
    catches it, quarantines the file, and rolls back.
    """

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__("%s: %s" % (path, reason))


@dataclasses.dataclass
class CheckpointInfo:
    """Parsed manifest contents.

    `generation` increments on every manifest write; `history` records
    one entry per completed iteration (`{"iteration_number",
    "global_step", "generation"}`) so rollback knows each iteration's end
    step; `digests` maps payload filenames to their SHA-256 hex digests
    (duplicated in sidecar files so either survives alone). `store_refs`
    is the v3 field of the JAX package, kept empty here.
    """

    iteration_number: int = 0
    global_step: int = 0
    iteration_state_file: Optional[str] = None
    replay_indices: List[int] = dataclasses.field(default_factory=list)
    generation: int = 0
    digests: Dict[str, str] = dataclasses.field(default_factory=dict)
    history: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    version: int = 3
    store_refs: Dict[str, str] = dataclasses.field(default_factory=dict)


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """Write-then-rename with fsync, so a host crash cannot leave the
    manifest pointing at a payload that never reached disk."""
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=directory)
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
    try:
        dir_fd = os.open(directory, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def _atomic_write_json(path: str, obj) -> None:
    _atomic_write_bytes(path, json.dumps(obj, sort_keys=True).encode())


def write_text(model_dir: str, filename: str, text: str) -> None:
    """Atomic (fsync'd) text artifact write under `model_dir`."""
    _atomic_write_bytes(os.path.join(model_dir, filename), text.encode())


# ------------------------------------------------------------- integrity ops


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def digest_path(model_dir: str, filename: str) -> str:
    return os.path.join(model_dir, filename + DIGEST_SUFFIX)


def read_digest(model_dir: str, filename: str) -> Optional[str]:
    """The recorded SHA-256 of a payload file; None when no sidecar."""
    path = digest_path(model_dir, filename)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError:
        return None
    return text if re.fullmatch(r"[0-9a-f]{64}", text) else None


def write_digest(model_dir: str, filename: str, data: bytes) -> str:
    """Writes `data`'s SHA-256 sidecar for `filename`; returns the hex."""
    digest = sha256_hex(data)
    _atomic_write_bytes(digest_path(model_dir, filename), digest.encode())
    return digest


def remove_digest(model_dir: str, filename: str) -> None:
    """Drops a payload's digest sidecar.

    Payload writes go remove-sidecar -> payload -> sidecar: a crash in
    either window leaves no sidecar (the decode check still validates
    the payload), never a stale digest that would falsely quarantine an
    intact file.
    """
    try:
        os.unlink(digest_path(model_dir, filename))
    except OSError:
        pass


def verify_file(model_dir: str, filename: str, expected: Optional[str] = None) -> Optional[bool]:
    """Checks a payload against its recorded digest.

    Returns True/False on a verdict, or None when the file exists but no
    digest is recorded (content checks must decide). A missing file is
    False.
    """
    path = os.path.join(model_dir, filename)
    expected = expected or read_digest(model_dir, filename)
    digest = hashlib.sha256()
    try:
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)
    except FileNotFoundError:
        return False
    if expected is None:
        return None
    return digest.hexdigest() == expected


def quarantine_file(model_dir: str, filename: str) -> Optional[str]:
    """Renames a corrupt artifact to `<name>.corrupt` (kept, diagnosable).

    Returns the quarantined name, or None when the file is absent. The
    digest sidecar rides along so post-mortems can see what was expected.
    """
    path = os.path.join(model_dir, filename)
    if not os.path.exists(path):
        return None
    target = filename + QUARANTINE_SUFFIX
    n = 0
    while os.path.exists(os.path.join(model_dir, target)):
        n += 1
        target = "%s%s.%d" % (filename, QUARANTINE_SUFFIX, n)
    try:
        os.replace(path, os.path.join(model_dir, target))
    except FileNotFoundError:
        return None
    try:
        os.replace(digest_path(model_dir, filename), os.path.join(model_dir, target + DIGEST_SUFFIX))
    except OSError:
        pass
    _LOG.error("Quarantined corrupt checkpoint artifact %s -> %s", filename, target)
    return target


# --------------------------------------------------------------- manifest IO


def _manifest_obj(info: CheckpointInfo) -> Dict[str, Any]:
    obj = {
        "iteration_number": info.iteration_number,
        "global_step": info.global_step,
        "iteration_state_file": info.iteration_state_file,
        "replay_indices": info.replay_indices,
        "generation": info.generation,
        "digests": info.digests,
        "history": info.history,
        "version": info.version,
        "store_refs": info.store_refs,
    }
    obj["checksum"] = sha256_hex(json.dumps(obj, sort_keys=True).encode())
    return obj


def _parse_manifest(data: bytes, path: str) -> CheckpointInfo:
    try:
        obj = json.loads(data)
    except ValueError as exc:
        raise CheckpointCorruptionError(path, "unparseable JSON: %s" % exc)
    if not isinstance(obj, dict) or "iteration_number" not in obj:
        raise CheckpointCorruptionError(path, "not a manifest object")
    checksum = obj.pop("checksum", None)
    if checksum is not None:
        expected = sha256_hex(json.dumps(obj, sort_keys=True).encode())
        if checksum != expected:
            raise CheckpointCorruptionError(path, "manifest checksum mismatch")
    return CheckpointInfo(
        iteration_number=int(obj["iteration_number"]),
        global_step=int(obj["global_step"]),
        iteration_state_file=obj.get("iteration_state_file"),
        replay_indices=list(obj.get("replay_indices", [])),
        generation=int(obj.get("generation", 0)),
        digests=dict(obj.get("digests", {})),
        history=list(obj.get("history", [])),
        version=int(obj.get("version", 2)),
        store_refs=dict(obj.get("store_refs", {})),
    )


def read_manifest(
    model_dir: str, quarantine: bool = True, reconstruct: bool = True
) -> Optional[CheckpointInfo]:
    """Reads the manifest, healing over a corrupt main copy.

    Order: `checkpoint.json` (checksum-verified) -> `checkpoint.json.prev`
    -> reconstruction from the architecture chain. A corrupt main
    manifest is quarantined unless `quarantine` is False (fsck's
    report-only mode). Without `reconstruct`, only a written manifest
    counts, and a dir without one reads as None: a reader racing the
    chief's bookkeeping would otherwise take `architecture-<t>.json`,
    written first, as iteration t complete before its frozen payload
    lands. Returns None only for a fresh model dir.
    """
    faults.trip("manifest.read")
    path = os.path.join(model_dir, MANIFEST)
    if os.path.exists(path):
        try:
            return _parse_manifest(retrying_open_read(path, label="manifest read"), path)
        except FileNotFoundError:
            pass
        except CheckpointCorruptionError as exc:
            _LOG.error("Manifest corrupt (%s); trying fallbacks.", exc)
            if quarantine:
                quarantine_file(model_dir, MANIFEST)
    prev = os.path.join(model_dir, MANIFEST_PREV)
    if os.path.exists(prev):
        try:
            info = _parse_manifest(retrying_open_read(prev, label="manifest.prev read"), prev)
            _LOG.warning("Recovered manifest from previous generation %d (checkpoint.json.prev).", info.generation)
            return info
        except FileNotFoundError:
            pass
        except CheckpointCorruptionError as exc:
            _LOG.error("Previous manifest also corrupt (%s).", exc)
            if quarantine:
                quarantine_file(model_dir, MANIFEST_PREV)
    return _reconstruct_manifest(model_dir) if reconstruct else None


def manifest_intact(model_dir: str) -> bool:
    """True when `checkpoint.json` exists and parses checksum-clean."""
    path = os.path.join(model_dir, MANIFEST)
    try:
        _parse_manifest(retrying_open_read(path, label="manifest check"), path)
        return True
    except (FileNotFoundError, CheckpointCorruptionError):
        return False


def _reconstruct_manifest(model_dir: str) -> Optional[CheckpointInfo]:
    """Last-resort manifest from the on-disk artifact chain: the longest
    contiguous prefix of parseable `architecture-<t>.json` files plus the
    newest digest-verified `ckpt-*.pt` beyond that step. None when the
    dir holds no artifacts at all (a fresh run)."""
    if not os.path.isdir(model_dir):
        return None
    t = 0
    last_arch = None
    while True:
        path = os.path.join(model_dir, architecture_filename(t))
        if not os.path.exists(path):
            break
        try:
            with open(path) as f:
                last_arch = json.load(f)
        except (OSError, ValueError):
            break
        t += 1
    state_file = None
    global_step = int(last_arch.get("global_step", 0)) if last_arch else 0
    best_step = global_step
    for name in os.listdir(model_dir):
        match = re.fullmatch(STATE_FILE_PATTERN, name)
        if not match:
            continue
        step = int(match.group(1))
        if step >= best_step and verify_file(model_dir, name):
            best_step = step
            state_file = name
    if t == 0 and state_file is None:
        return None
    info = CheckpointInfo(
        iteration_number=t,
        global_step=best_step if state_file else global_step,
        iteration_state_file=state_file,
        replay_indices=list(last_arch.get("replay_indices", [])) if last_arch else [],
    )
    _LOG.error(
        "Both manifests unusable; reconstructed from artifacts: iteration %d, global step %d, state file %s. "
        "Run `python -m adanet_tpu_torch.tools.ckpt_fsck --repair` to persist and verify.",
        info.iteration_number, info.global_step, info.iteration_state_file,
    )
    return info


def write_manifest(model_dir: str, info: CheckpointInfo) -> None:
    """Writes the manifest (atomic), retaining the previous generation at
    `checkpoint.json.prev`; bumps `info.generation` and drops the digests
    of files that no longer exist."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, MANIFEST)
    if os.path.exists(path):
        try:
            _atomic_write_bytes(
                os.path.join(model_dir, MANIFEST_PREV), retrying_open_read(path, label="manifest backup")
            )
        except OSError as exc:
            _LOG.warning("Could not retain previous manifest: %s", exc)
    info.generation += 1
    info.version = max(int(info.version), 3)
    info.digests = {
        name: digest for name, digest in info.digests.items() if os.path.exists(os.path.join(model_dir, name))
    }
    _atomic_write_json(path, _manifest_obj(info))


# ------------------------------------------------------------ payload IO


def plain(tree: Any) -> Any:
    """`tree` as checkpoint data that `torch.load(weights_only=True)`
    reads back: dicts, lists and tuples of tensors (copies, on the CPU)
    and Python scalars and strings; numpy arrays become tensors and numpy
    scalars Python numbers. Anything else raises.

    The tensors of one device and dtype are packed into one flat buffer
    (one `torch.cat` on their device, one copy to the host) and come
    back as views of it: `torch.save` then writes one storage per dtype
    instead of one per tensor, which is what a save of a NASNet's ~2,600
    tensors spends its time on."""
    groups: Dict[Any, List[torch.Tensor]] = {}

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(value) for value in node)
        if isinstance(node, np.ndarray):
            node = torch.from_numpy(np.ascontiguousarray(node))
        if torch.is_tensor(node):
            key = (node.device, node.dtype)
            group = groups.setdefault(key, [])
            group.append(node.detach())
            return _Slot(key, len(group) - 1)
        if isinstance(node, np.generic):
            return node.item()
        if node is None or isinstance(node, (bool, int, float, str)):
            return node
        raise TypeError("%r cannot be stored in a checkpoint payload" % (type(node).__name__,))

    out = walk(tree)
    views = {}
    for key, tensors in groups.items():
        flat = torch.cat([t.reshape(-1) for t in tensors]).cpu()
        views[key] = [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def fill(node):
        if isinstance(node, _Slot):
            return views[node.key][node.index]
        if isinstance(node, dict):
            return {key: fill(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(value) for value in node)
        return node

    return fill(out)


#: A tensor's place in `plain`'s flat buffers: its (device, dtype) and index.
_Slot = collections.namedtuple("_Slot", "key index")


def to_bytes(payload: Any) -> bytes:
    """The `torch.save` bytes of a payload of CPU tensors and plain data."""
    buffer = io.BytesIO()
    torch.save(payload, buffer)
    return buffer.getvalue()


def write_payload_bytes(model_dir: str, filename: str, data: bytes) -> str:
    """Lands serialized payload bytes with the full protocol (remove
    sidecar -> atomic write -> sidecar); returns the digest."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, filename)
    faults.trip("checkpoint.write", path=path, data=data)
    remove_digest(model_dir, filename)
    _atomic_write_bytes(path, data)
    return write_digest(model_dir, filename, data)


def save_payload(model_dir: str, filename: str, payload: Any) -> str:
    """Serializes a payload (`to_bytes`) and writes it atomically with
    its digest sidecar; returns the SHA-256 hex digest."""
    return write_payload_bytes(model_dir, filename, to_bytes(payload))


def _read_verified(model_dir: str, filename: str) -> bytes:
    path = os.path.join(model_dir, filename)
    data = retrying_open_read(path, label="checkpoint read")
    expected = read_digest(model_dir, filename)
    if expected is not None and sha256_hex(data) != expected:
        raise CheckpointCorruptionError(
            path,
            "SHA-256 mismatch (expected %s..., got %s...): torn write or bit rot"
            % (expected[:12], sha256_hex(data)[:12]),
        )
    return data


def restore_payload(model_dir: str, filename: str) -> Any:
    """Reads a payload written by `save_payload`: digest-verified, then
    decoded onto the CPU with `weights_only=True`. A decode failure
    raises `CheckpointCorruptionError`."""
    path = os.path.join(model_dir, filename)
    data = _read_verified(model_dir, filename)
    try:
        return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
    except Exception as exc:
        raise CheckpointCorruptionError(path, "undecodable payload: %s" % exc) from exc


# ------------------------------------------------------------- file naming


def frozen_filename(iteration_number: int) -> str:
    return "frozen-%d.pt" % iteration_number


def iteration_state_filename(global_step: int) -> str:
    return "ckpt-%d.pt" % global_step


def final_state_filename(iteration_number: int) -> str:
    """The retained end-of-iteration state of every candidate (not just
    the frozen winner), for per-candidate evaluation after the iteration
    completed. The JAX package's name ends in `.msgpack`; this payload
    is a torch one, so it ends in `.pt`, as `frozen-<t>.pt` does."""
    return "iteration-final-%d.pt" % iteration_number


def candidate_metrics_filename(iteration_number: int) -> str:
    """Every candidate's selection metrics of iteration t, written at
    every iteration's end (a few hundred bytes, no parameters)."""
    return "candidate-metrics-%d.json" % iteration_number


def write_json(model_dir: str, filename: str, obj) -> None:
    """Atomic (fsync'd) JSON artifact write under `model_dir`."""
    _atomic_write_json(os.path.join(model_dir, filename), obj)


def read_json(model_dir: str, filename: str):
    """A JSON artifact under `model_dir`, or None when it is absent."""
    path = os.path.join(model_dir, filename)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def architecture_filename(iteration_number: int) -> str:
    """`<model_dir>/architecture-<t>.json`, the JAX package's name."""
    return "architecture-%d.json" % iteration_number


# ------------------------------------------------------ frozen (de)serialize


def frozen_to_payload(frozen) -> Dict[str, Any]:
    """The numbers of a frozen winner, on the CPU, in the layout of the
    JAX package's payload ({} = unset): each member's `state_dict`,
    weight, complexity and `shared`; the ensembler params; the final
    EMA; the name. Modules are rebuilt from the generator."""
    members = []
    for ws in frozen.weighted_subnetworks:
        sub = ws.subnetwork
        members.append(
            {
                "params": plain(sub.module.state_dict()),
                "weight": {} if ws.weight is None else {"value": plain(ws.weight)},
                "complexity": float(sub.complexity),
                "shared": {} if sub.shared is None else {"value": plain(sub.shared)},
            }
        )
    return {
        "members": members,
        "ensembler_params": {} if frozen.ensembler_params is None else {"value": plain(frozen.ensembler_params)},
        "final_ema": {} if frozen.final_ema is None else {"value": float(frozen.final_ema)},
        "name": frozen.name,
    }


def payload_into_frozen(payload: Dict[str, Any], frozen, device) -> None:
    """Loads a restored payload onto a rebuilt `FrozenEnsemble` whose
    members' modules come from the replayed builders (same builders, same
    order): each module's `state_dict` (strict), then the module moves to
    `device`; the weights, complexity, `shared`, ensembler params and
    final EMA."""
    members = payload["members"]
    if len(members) != len(frozen.weighted_subnetworks):
        raise ValueError(
            "Checkpoint has %d members but rebuilt ensemble has %d. The generator is not deterministic or the "
            "model_dir is stale." % (len(members), len(frozen.weighted_subnetworks))
        )

    def on_device(tree):
        if isinstance(tree, dict):
            return {key: on_device(value) for key, value in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(on_device(value) for value in tree)
        return tree.to(device) if torch.is_tensor(tree) else tree

    for entry, ws in zip(members, frozen.weighted_subnetworks):
        sub = ws.subnetwork
        sub.module.load_state_dict(entry["params"])
        sub.module.to(device)
        ws.weight = on_device(entry["weight"].get("value"))
        sub.complexity = entry["complexity"]
        sub.shared = entry["shared"].get("value") if entry["shared"] else None
    frozen.ensembler_params = on_device(payload["ensembler_params"].get("value"))
    ema = payload["final_ema"]
    frozen.final_ema = float(ema["value"]) if "value" in ema else None
