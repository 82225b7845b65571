"""Checkpoint verification, quarantine, and rollback (`ckpt_fsck`).

Port of adanet_tpu/robustness/integrity.py, training chain only: `fsck`
walks a model dir's durable artifacts (the manifest chain, the
per-iteration `architecture-<t>.json` + `frozen-<t>.pt` pairs, the
mid-iteration `ckpt-<step>.pt`, the retained `iteration-final-<t>.pt`
states of `keep_candidate_states`) and verifies each against its
SHA-256 digest, or, for a file without one, a decode check. A corrupt
file degrades to "resume from the previous generation":

- corrupt mid-iteration state -> quarantined (`*.corrupt`); the run
  restarts the current iteration from its first step;
- corrupt frozen/architecture at iteration t -> quarantined; the
  manifest rolls back to iteration t, and the now-orphaned artifacts of
  later iterations are retired (`*.stale`) so that no reconstruction can
  mix two chains;
- orphaned `ckpt-*` payloads that fail verification (the torn leftovers
  of a crash mid-write) -> quarantined;
- a corrupt retained `iteration-final-<t>.pt` -> quarantined; it never
  blocks resume (it serves evaluation after the fact), and a missing one
  is no fault.

`Estimator.train` runs `fsck(repair=True)` before restoring;
`adanet_tpu_torch/tools/ckpt_fsck.py` is the operator CLI over it.

Beside the training chain, `verify_serving_generation` is the
verify-on-load check the serving pool runs before a flip, and
`serving_report` / `store_report` are `ckpt_fsck --json`'s `serving` and
`store` sections, so that fsck predicts what the pool will do.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from typing import List, Optional

from adanet_tpu_torch.core import checkpoint as ckpt

_LOG = logging.getLogger("adanet_tpu_torch")

STALE_SUFFIX = ".stale"

#: The serving-generation contract (mirrors `core/export.py`'s
#: SERVING_FILE and SIGNATURE_FILE, not imported: this layer loads
#: without the export stack). A published `serving/gen-<t>/` carries both
#: files and a checksummed `generation.json` binding their digests.
GENERATION_MANIFEST = "generation.json"
REQUIRED_SERVING_FILES = ("serving.pt2", "serving_signature.json")

#: Exit codes of `ckpt_fsck` (usage errors exit 64, EX_USAGE, so that 2
#: is unambiguous).
EXIT_CLEAN = 0
EXIT_HEALED = 1
EXIT_UNRECOVERABLE = 2


@dataclasses.dataclass
class FsckReport:
    """The outcome of one verification/heal pass."""

    ok: bool = True
    fresh: bool = False
    issues: List[str] = dataclasses.field(default_factory=list)
    quarantined: List[str] = dataclasses.field(default_factory=list)
    retired: List[str] = dataclasses.field(default_factory=list)
    rolled_back_to_iteration: Optional[int] = None
    rolled_back_global_step: Optional[int] = None
    manifest_rewritten: bool = False
    info: Optional[ckpt.CheckpointInfo] = None

    @property
    def verdict(self) -> str:
        """"clean" | "healed" | "unrecoverable", the same whether or not
        `repair` ran. "unrecoverable" means the heal rolls all the way
        back to iteration 0, global step 0: every trained generation was
        lost."""
        if self.ok or self.fresh:
            return "clean"
        if (
            self.rolled_back_to_iteration == 0
            and not self.rolled_back_global_step
            and self.info is not None
            and self.info.iteration_state_file is None
        ):
            return "unrecoverable"
        return "healed"

    @property
    def exit_code(self) -> int:
        return {"clean": EXIT_CLEAN, "healed": EXIT_HEALED, "unrecoverable": EXIT_UNRECOVERABLE}[self.verdict]

    def to_json(self) -> dict:
        obj = dataclasses.asdict(self)
        info = obj.pop("info")
        if info is not None:
            obj["iteration_number"] = info["iteration_number"]
            obj["global_step"] = info["global_step"]
            obj["generation"] = info["generation"]
        obj["verdict"] = self.verdict
        obj["exit_code"] = self.exit_code
        return obj


def _payload_intact(model_dir: str, filename: str, info: ckpt.CheckpointInfo) -> bool:
    """Digest verdict, falling back to a decode check for a file without
    a recorded digest."""
    verdict = ckpt.verify_file(model_dir, filename, expected=info.digests.get(filename))
    if verdict is not None:
        return verdict
    try:
        ckpt.restore_payload(model_dir, filename)
        return True
    except (ckpt.CheckpointCorruptionError, OSError):
        return False


def _arch_global_step(model_dir: str, iteration: int) -> Optional[int]:
    try:
        with open(os.path.join(model_dir, ckpt.architecture_filename(iteration))) as f:
            return int(json.load(f).get("global_step", 0))
    except (OSError, ValueError):
        return None


def end_step_of(info: ckpt.CheckpointInfo, model_dir: str, t: int) -> int:
    """Global step at the end of completed iteration t-1 (0 for t == 0);
    the estimator's restore-time rollback applies the same rule."""
    if t <= 0:
        return 0
    for entry in reversed(info.history):
        if int(entry.get("iteration_number", -1)) == t - 1:
            return int(entry.get("global_step", 0))
    step = _arch_global_step(model_dir, t - 1)
    return step if step is not None else 0


def _retire(model_dir: str, filename: str, report: FsckReport, repair: bool, reason: str = "orphaned by rollback"):
    """Renames an intact-but-orphaned artifact to `<name>.stale`."""
    path = os.path.join(model_dir, filename)
    if not os.path.exists(path):
        return
    report.issues.append("%s: %s" % (reason, filename))
    if not repair:
        return
    target = filename + STALE_SUFFIX
    n = 0
    while os.path.exists(os.path.join(model_dir, target)):
        n += 1
        target = "%s%s.%d" % (filename, STALE_SUFFIX, n)
    try:
        os.replace(path, os.path.join(model_dir, target))
    except FileNotFoundError:
        return
    try:
        os.replace(ckpt.digest_path(model_dir, filename), os.path.join(model_dir, target + ckpt.DIGEST_SUFFIX))
    except OSError:
        pass
    report.retired.append(target)


def _quarantine(model_dir: str, filename: str, report: FsckReport, repair: bool) -> None:
    if repair:
        name = ckpt.quarantine_file(model_dir, filename)
        if name:
            report.quarantined.append(name)
    else:
        report.issues.append("would quarantine: %s" % filename)


def fsck(model_dir: str, repair: bool = False) -> FsckReport:
    """Verifies a model dir; with `repair`, quarantines and rolls back.
    Deterministic given the dir's contents."""
    report = FsckReport()
    info = ckpt.read_manifest(model_dir, quarantine=repair)
    if info is None:
        report.fresh = True
        return report
    report.info = info
    dirty = False
    main = os.path.join(model_dir, ckpt.MANIFEST)
    if not os.path.exists(main):
        report.issues.append("main manifest missing/corrupt (recovered from fallback)")
        dirty = True
    elif not repair and not ckpt.manifest_intact(model_dir):
        report.issues.append("would quarantine: %s (corrupt; recovered from fallback)" % ckpt.MANIFEST)
        dirty = True

    # ------------------------- completed-iteration chain (frozen + arch)
    rollback: Optional[int] = None
    for t in range(info.iteration_number):
        arch_name = ckpt.architecture_filename(t)
        frozen_name = ckpt.frozen_filename(t)
        arch_ok = _arch_global_step(model_dir, t) is not None
        frozen_ok = os.path.exists(os.path.join(model_dir, frozen_name)) and _payload_intact(
            model_dir, frozen_name, info
        )
        if arch_ok and frozen_ok:
            continue
        rollback = t
        if not arch_ok:
            report.issues.append("architecture chain broken at iteration %d (%s)" % (t, arch_name))
            _quarantine(model_dir, arch_name, report, repair)
        if not frozen_ok:
            report.issues.append("frozen payload corrupt/missing at iteration %d (%s)" % (t, frozen_name))
            _quarantine(model_dir, frozen_name, report, repair)
        break

    if rollback is not None:
        for t in range(rollback, info.iteration_number):
            for name in (ckpt.architecture_filename(t), ckpt.frozen_filename(t), ckpt.final_state_filename(t)):
                _retire(model_dir, name, report, repair)
        if info.iteration_state_file:
            _retire(model_dir, info.iteration_state_file, report, repair)
            info.iteration_state_file = None
        info.iteration_number = rollback
        info.replay_indices = info.replay_indices[:rollback]
        info.history = [entry for entry in info.history if int(entry.get("iteration_number", -1)) < rollback]
        info.global_step = end_step_of(info, model_dir, rollback)
        report.rolled_back_to_iteration = rollback
        report.rolled_back_global_step = info.global_step
        dirty = True
        _LOG.error(
            "Checkpoint chain broken at iteration %d: rolled back to iteration %d, global step %d "
            "(corrupt files quarantined).", rollback, rollback, info.global_step,
        )

    # ------------------------------------------- mid-iteration state file
    if info.iteration_state_file:
        name = info.iteration_state_file
        if not _payload_intact(model_dir, name, info):
            report.issues.append("mid-iteration state corrupt (%s)" % name)
            _quarantine(model_dir, name, report, repair)
            info.iteration_state_file = None
            info.global_step = end_step_of(info, model_dir, info.iteration_number)
            if report.rolled_back_to_iteration is None:
                report.rolled_back_to_iteration = info.iteration_number
            report.rolled_back_global_step = info.global_step
            dirty = True
            _LOG.error(
                "Mid-iteration state %s corrupt: iteration %d restarts from global step %d.",
                name, info.iteration_number, info.global_step,
            )

    # -------------------------------------------------- orphaned payloads
    try:
        entries = sorted(os.listdir(model_dir))
    except OSError:
        entries = []
    for name in entries:
        if not re.fullmatch(ckpt.STATE_FILE_PATTERN, name) or name == info.iteration_state_file:
            continue
        if _payload_intact(model_dir, name, info):
            # Intact but unreferenced (a crash between the payload write
            # and the manifest update): retire it so that repeated repair
            # runs converge to a clean verdict.
            _retire(model_dir, name, report, repair, reason="intact orphan payload")
            continue
        report.issues.append("orphan payload failed verification (torn write?): %s" % name)
        _quarantine(model_dir, name, report, repair)

    # Retained final states: corruption never blocks the search, but a
    # corrupt one must not be evaluated.
    for t in range(info.iteration_number):
        name = ckpt.final_state_filename(t)
        if os.path.exists(os.path.join(model_dir, name)) and not _payload_intact(model_dir, name, info):
            report.issues.append("retained candidate state corrupt (%s)" % name)
            _quarantine(model_dir, name, report, repair)

    if dirty and repair:
        ckpt.write_manifest(model_dir, info)
        report.manifest_rewritten = True
    report.ok = not report.issues
    report.info = info
    return report


# ------------------------------------------------- serving generation audit


def verify_serving_generation(gen_dir: str) -> List[str]:
    """Verifies one published `serving/gen-<t>/` directory.

    Returns the list of issues; empty means the generation is eligible
    to serve. This is the verify-on-load check `serving.model_pool`
    runs before a flip, so `ckpt_fsck --json` audits the verdict the
    server would reach.
    """
    issues: List[str] = []
    manifest_path = os.path.join(gen_dir, GENERATION_MANIFEST)
    try:
        with open(manifest_path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as exc:
        return ["generation manifest unreadable: %s" % exc]
    if not isinstance(obj, dict) or "digests" not in obj:
        return ["generation manifest malformed (no digests map)"]
    # The self-checksum is required: the publisher always writes one, so
    # its absence means the manifest was rewritten, and accepting it
    # would let a rewritten digests map launder rotted artifacts.
    checksum = obj.pop("checksum", None)
    if checksum is None:
        return ["generation manifest missing checksum"]
    if checksum != ckpt.sha256_hex(json.dumps(obj, sort_keys=True).encode()):
        return ["generation manifest checksum mismatch"]
    digests = dict(obj.get("digests", {}))
    for name in REQUIRED_SERVING_FILES:
        if name not in digests:
            issues.append("required serving file not recorded: %s" % name)
    for name, digest in sorted(digests.items()):
        verdict = ckpt.verify_file(gen_dir, name, expected=digest)
        if verdict is not True:
            issues.append(
                "digest mismatch or missing file: %s" % name
                if verdict is False
                else "no digest verdict for: %s" % name
            )
    return issues


def serving_report(model_dir: str) -> dict:
    """Per-generation serving eligibility for a model dir.

    `selected_generation` is the generation a freshly started pool would
    serve: the newest eligible one (`ModelPool` skips to the newest
    generation and rejects what fails this same check).
    """
    from adanet_tpu_torch.serving import publisher

    generations = []
    selected = None
    for t, path in publisher.list_generations(model_dir):
        issues = verify_serving_generation(path)
        generations.append({"iteration_number": t, "serving_eligible": not issues, "issues": issues})
        if not issues:
            selected = t
    return {"generations": generations, "selected_generation": selected}


# --------------------------------------------------- artifact store audit


def store_report(store_root: str, repair: bool = False, gc_dry_run: bool = False) -> dict:
    """The `store` section of `ckpt_fsck --json`, over `store.fsck_store`:
    blob census, corrupt and quarantined blobs, dangling refs, the lease
    census and, under `--gc --dry-run`, the would-GC set. `repair`
    quarantines corrupt blobs and heals them from any duplicate
    referencer, the path a live `store.get` takes."""
    from adanet_tpu_torch.store import ArtifactStore, fsck_store

    return fsck_store(ArtifactStore(store_root), repair=repair, gc_dry_run=gc_dry_run)
