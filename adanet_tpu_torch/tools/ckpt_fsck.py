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

The --json report carries the same answer in `verdict` and `exit_code`.
"""

from __future__ import annotations

import argparse
import json
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
    args = parser.parse_args(argv)

    report = integrity.fsck(args.model_dir, repair=args.repair)
    if args.json:
        print(json.dumps(report.to_json(), sort_keys=True))
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
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
