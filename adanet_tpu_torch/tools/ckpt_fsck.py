"""Checkpoint fsck: verify and repair a model directory of the port.

Operator CLI over `adanet_tpu_torch.robustness.integrity.fsck` (the same
engine `Estimator.train` runs before restoring), for the training chain:
the manifest chain, each iteration's architecture and frozen payload,
the mid-iteration state and orphaned `ckpt-*.pt` payloads, verified
against their SHA-256 digests. With `--repair` it quarantines corrupt
files (`*.corrupt`), retires artifacts orphaned by a rollback (`*.stale`)
and rewrites the manifest at the newest intact generation.

Usage:
    python -m adanet_tpu_torch.tools.ckpt_fsck MODEL_DIR            # verify
    python -m adanet_tpu_torch.tools.ckpt_fsck MODEL_DIR --repair   # heal
    python -m adanet_tpu_torch.tools.ckpt_fsck MODEL_DIR --json     # JSON

Exit status, the same with and without --repair:
    0  clean: nothing to do (also a fresh dir with no manifest)
    1  healed: issues found, but a usable resume point survives the
       (actual or would-be) repair
    2  unrecoverable: the heal rolls back to iteration 0, step 0
    64 usage errors (argparse's 2 would collide with "unrecoverable")

The --json report carries the same answer in `verdict` and `exit_code`,
and a `serving` section over the model dir's published generations:
`serving_eligible` per generation and `selected_generation`, the one a
freshly started `adanet_tpu_torch.serving.ModelPool` would serve (its
verify-on-load is the same function), so a flip can be vetted before it
happens.

With `--store PATH` (found at `<model_dir>/store` when that directory
exists), the report also has a `store` section over the shared artifact
store (`adanet_tpu_torch.store`): blob count and bytes, corrupt and
quarantined blobs, dangling refs, the lease census and, under
`--gc --dry-run`, the blobs a collection would remove. `--repair`
extends to the store (quarantine and heal from duplicate referencers);
`--gc` without `--dry-run` runs the lease-guarded collection. Neither the
serving nor the store section changes the exit code: both kinds of
artifact can be published again.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from adanet_tpu_torch.robustness import integrity


class _Parser(argparse.ArgumentParser):
    def error(self, message):
        self.print_usage(sys.stderr)
        self.exit(64, "%s: error: %s\n" % (self.prog, message))


def main(argv=None) -> int:
    parser = _Parser(prog="ckpt_fsck", description=__doc__.split("\n\n")[0])
    parser.add_argument("model_dir", help="AdaNet model directory")
    parser.add_argument(
        "--repair",
        action="store_true",
        help="quarantine corrupt files and roll the manifest back to the newest intact generation",
    )
    parser.add_argument("--json", action="store_true", help="emit the report as JSON")
    parser.add_argument(
        "--store", default=None,
        help="artifact store root to audit (default: <model_dir>/store when that directory exists)",
    )
    parser.add_argument("--gc", action="store_true", help="run a lease-guarded GC pass on the store")
    parser.add_argument("--dry-run", action="store_true", help="with --gc: compute the would-GC set only")
    args = parser.parse_args(argv)

    report = integrity.fsck(args.model_dir, repair=args.repair)
    serving = integrity.serving_report(args.model_dir)
    store_root = args.store
    if store_root is None and os.path.isdir(os.path.join(args.model_dir, "store")):
        store_root = os.path.join(args.model_dir, "store")
    store = None
    if store_root is not None:
        store = integrity.store_report(store_root, repair=args.repair, gc_dry_run=args.gc and args.dry_run)
        if args.gc and not args.dry_run:
            from adanet_tpu_torch.store import ArtifactStore, collect

            store["gc"] = collect(ArtifactStore(store_root)).to_json()
    if args.json:
        obj = report.to_json()
        obj["serving"] = serving
        if store is not None:
            obj["store"] = store
        print(json.dumps(obj, sort_keys=True))
        return report.exit_code
    if report.fresh:
        print("fresh model dir (no checkpoint manifest): nothing to do")
    elif report.ok:
        info = report.info
        print("clean: iteration %d, global step %d, generation %d"
              % (info.iteration_number, info.global_step, info.generation))
    for issue in report.issues:
        print("ISSUE: %s" % issue)
    for name in report.quarantined:
        print("quarantined: %s" % name)
    for name in report.retired:
        print("retired: %s" % name)
    if report.rolled_back_to_iteration is not None:
        print("rolled back to iteration %d (global step %d)%s" % (
            report.rolled_back_to_iteration, report.rolled_back_global_step,
            "" if report.manifest_rewritten else " [dry run]"))
    if report.manifest_rewritten:
        print("manifest rewritten")
    if not report.ok and not report.fresh:
        print("verdict: %s" % report.verdict)
    for gen in serving["generations"]:
        print("serving generation %d: %s" % (
            gen["iteration_number"],
            "eligible" if gen["serving_eligible"] else "INELIGIBLE (%s)" % "; ".join(gen["issues"])))
    if serving["generations"]:
        selected = serving["selected_generation"]
        print("serving plane would select: %s" % (
            "generation %d" % selected if selected is not None else "nothing (no eligible generation)"))
    if store is not None:
        print("store %s: %d blobs (%d bytes), %d refs, %s" % (
            store["root"], store["blob_count"], store["bytes"], store["ref_count"],
            "clean" if store["clean"] else "NOT CLEAN"))
        for digest in store["corrupt_blobs"]:
            print("store ISSUE: corrupt blob %s" % digest)
        for entry in store["dangling_refs"]:
            print("store ISSUE: dangling ref %s" % entry)
        for digest in store["healed_blobs"]:
            print("store healed: %s" % digest)
        if store["quarantined_blobs"]:
            print("store quarantined copies: %d" % len(store["quarantined_blobs"]))
        if "would_gc" in store:
            print("store GC dry run would remove %d blobs" % len(store["would_gc"]))
        if "gc" in store:
            print("store GC removed %d blobs, pruned %d leases" % (
                len(store["gc"]["removed"]), len(store["gc"]["pruned_leases"])))
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
