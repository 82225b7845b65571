"""fleetctl: launch, inspect, and report on a fleet of AdaNet searches.

The port's counterpart of tools/fleetctl.py: an operator CLI over
`adanet_tpu_torch.fleet.FleetController`. A fleet lives in one work dir
(`fleet.json` + `trials/<id>/` + `champion/` + the shared `store/`), so
every subcommand takes the work dir:

    python -m adanet_tpu_torch.tools.fleetctl launch WORK_DIR --spec fleet_spec.json [--device cuda]
    python -m adanet_tpu_torch.tools.fleetctl status WORK_DIR [--json]
    python -m adanet_tpu_torch.tools.fleetctl report WORK_DIR [--json]

`launch` runs (or RESUMES — the state file makes relaunching after a
crash the recovery procedure) a fleet described by a JSON spec over the
built-in `examples/simple_dnn` search space and a deterministic
synthetic regression dataset, on the card unless `--device cpu` is
given (a CUDA request without CUDA raises):

    {
      "rungs": [1, 2],
      "max_iteration_steps": 8,
      "survivor_fraction": 0.5,
      "workers": 1,
      "eval_steps": 8,
      "comparator": {"adanet_lambda": 0.05, "adanet_beta": 0.01},
      "dataset": {"n": 512, "dim": 8, "batch_size": 64, "seed": 0},
      "trials": [
        {"id": "lam0", "adanet_lambda": 0.0, "adanet_beta": 0.0,
         "random_seed": 1, "layer_size": 16, "learning_rate": 0.02}
      ]
    }

The mixture weights train with SGD at 0.05 and combine through K1.

Exit status (shared contract with `ckpt_fsck`):
    0  fleet complete with a winner, no failed trials
    1  degraded: complete but with failed trial(s), or an in-progress /
       interrupted fleet (relaunch to resume)
    2  unusable: no state file / unreadable state / launch failed with
       no winner
    64 usage errors (EX_USAGE)
"""

from __future__ import annotations

import argparse
import json
import os
import sys


class _Parser(argparse.ArgumentParser):
    def error(self, message):
        self.print_usage(sys.stderr)
        self.exit(64, "%s: error: %s\n" % (self.prog, message))


def _sgd(learning_rate):
    """The port's optimizer factory: `params -> torch.optim.SGD`."""
    import torch

    return lambda params: torch.optim.SGD(params, lr=learning_rate)


def _build_trials(spec):
    """TrialSpecs over the simple_dnn space from the JSON spec."""
    from adanet_tpu_torch.core.heads import RegressionHead
    from adanet_tpu_torch.examples import simple_dnn
    from adanet_tpu_torch.fleet import TrialSpec

    trials = []
    for entry in spec.get("trials", []):
        layer_size = int(entry.get("layer_size", 16))
        learning_rate = float(entry.get("learning_rate", 0.02))

        def make_generator(
            layer_size=layer_size, learning_rate=learning_rate
        ):
            return simple_dnn.Generator(
                optimizer_fn=_sgd(learning_rate),
                layer_size=layer_size,
            )

        trials.append(
            TrialSpec(
                trial_id=str(entry["id"]),
                make_head=RegressionHead,
                make_generator=make_generator,
                generator_id="simple_dnn/layer_size=%d/lr=%g"
                % (layer_size, learning_rate),
                max_iteration_steps=int(
                    spec.get("max_iteration_steps", 8)
                ),
                random_seed=int(entry.get("random_seed", 42)),
                adanet_lambda=float(entry.get("adanet_lambda", 0.0)),
                adanet_beta=float(entry.get("adanet_beta", 0.0)),
                make_ensembler_optimizer=lambda: _sgd(0.05),
            )
        )
    return trials


def _dataset_input_fn(spec):
    """Deterministic synthetic linear-regression stream."""
    import numpy as np

    dataset = spec.get("dataset", {})
    n = int(dataset.get("n", 512))
    dim = int(dataset.get("dim", 8))
    batch_size = int(dataset.get("batch_size", 64))
    seed = int(dataset.get("seed", 0))
    rng = np.random.RandomState(seed)
    features = rng.randn(n, dim).astype(np.float32)
    weights = rng.randn(dim, 1).astype(np.float32)
    labels = features @ weights

    def input_fn():
        i = 0
        while True:
            lo = (i * batch_size) % n
            yield (
                features[lo : lo + batch_size],
                labels[lo : lo + batch_size],
            )
            i += 1

    return input_fn


def _cmd_launch(args) -> int:
    try:
        with open(args.spec) as f:
            spec = json.load(f)
    except (OSError, ValueError) as exc:
        print("cannot read --spec %s: %s" % (args.spec, exc), file=sys.stderr)
        return 2
    from adanet_tpu_torch.fleet import Comparator, FleetController

    try:
        trials = _build_trials(spec)
        if not trials:
            print("spec declares no trials", file=sys.stderr)
            return 2
        input_fn = _dataset_input_fn(spec)
        cmp_spec = spec.get("comparator") or {}
        comparator = Comparator(
            input_fn,
            eval_steps=int(spec.get("eval_steps", 8)),
            adanet_lambda=cmp_spec.get("adanet_lambda"),
            adanet_beta=cmp_spec.get("adanet_beta"),
        )
        controller = FleetController(
            trials,
            input_fn,
            work_dir=args.work_dir,
            rung_iterations=spec.get("rungs", [1, 2]),
            survivor_fraction=float(spec.get("survivor_fraction", 0.5)),
            comparator=comparator,
            workers=int(spec.get("workers", 1)),
            device=args.device,
        )
        report = controller.run()
    except (ValueError, KeyError, TypeError, OSError) as exc:
        # A malformed spec (missing trial id, bad comparator config),
        # a resume mismatch (changed schedule / foreign trials /
        # unsupported state version), or an unusable work dir: the
        # exit-2 "unusable" contract, not a traceback.
        print(
            "launch failed: %s: %s" % (type(exc).__name__, exc),
            file=sys.stderr,
        )
        return 2
    payload = report.to_json()
    print(json.dumps(payload, indent=None if args.json else 2, sort_keys=True))
    if report.winner_id is None:
        return 2
    failed = [
        trial_id
        for trial_id, entry in report.trials.items()
        if entry["state"] == "failed"
    ]
    return 1 if failed else 0


def _status_verdict(state) -> int:
    if state is None:
        return 2
    failed = [
        trial_id
        for trial_id, entry in state.get("trials", {}).items()
        if entry.get("state") == "failed"
    ]
    if state.get("complete") and state.get("winner") and not failed:
        return 0
    if state.get("complete") and state.get("winner"):
        return 1
    return 1 if state.get("trials") else 2


def _cmd_status(args) -> int:
    from adanet_tpu_torch.fleet import load_status

    state = load_status(args.work_dir)
    rc = _status_verdict(state)
    if state is None:
        print(
            "no readable fleet state at %s"
            % os.path.join(args.work_dir, "fleet.json"),
            file=sys.stderr,
        )
        return rc
    if args.json:
        state["exit_code"] = rc
        print(json.dumps(state, sort_keys=True))
        return rc
    print(
        "fleet %s  rung %s/%s  complete=%s  winner=%s"
        % (
            state.get("fleet_id"),
            state.get("next_rung"),
            len(state.get("rung_iterations", [])),
            state.get("complete"),
            state.get("winner"),
        )
    )
    rows = sorted(state.get("trials", {}).items())
    for trial_id, entry in rows:
        score = entry.get("score") or {}
        print(
            "  %-16s %-7s rung=%-2d iters=%-2d steps=%-5d F(w)=%s%s"
            % (
                trial_id,
                entry.get("state"),
                entry.get("rung", -1),
                entry.get("iterations", 0),
                entry.get("steps_trained", 0),
                "%.6f" % score["objective"]
                if score.get("objective") is not None
                else "n/a",
                "  [%s]" % entry["error"] if entry.get("error") else "",
            )
        )
    return rc


def _cmd_report(args) -> int:
    """Status plus store accounting: the shared-store reuse evidence."""
    from adanet_tpu_torch.fleet import load_status

    state = load_status(args.work_dir)
    rc = _status_verdict(state)
    if state is None:
        print(
            "no readable fleet state at %s"
            % os.path.join(args.work_dir, "fleet.json"),
            file=sys.stderr,
        )
        return rc
    report = dict(state)
    report["exit_code"] = rc
    store_root = os.path.join(args.work_dir, "store")
    if os.path.isdir(store_root):
        try:
            from adanet_tpu_torch.store import ArtifactStore, fsck_store

            audit = fsck_store(ArtifactStore(store_root))
            report["store"] = {
                "root": store_root,
                "blob_count": audit["blob_count"],
                "bytes": audit["bytes"],
                "ref_count": audit["ref_count"],
                "clean": audit["clean"],
            }
        except Exception as exc:
            report["store"] = {
                "root": store_root,
                "error": "%s: %s" % (type(exc).__name__, exc),
            }
    total_grafted = sum(
        entry.get("grafted_iterations", 0)
        for entry in report.get("trials", {}).values()
    )
    report["grafted_iterations_total"] = total_grafted
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(json.dumps(report, indent=2, sort_keys=True))
    return rc


def main(argv=None) -> int:
    parser = _Parser(
        prog="fleetctl",
        description=(
            "Launch, inspect, and report on a fleet of AdaNet searches."
        ),
    )
    sub = parser.add_subparsers(dest="command", required=True)
    launch = sub.add_parser("launch", help="run or resume a fleet")
    launch.add_argument("work_dir")
    launch.add_argument("--spec", required=True, help="fleet spec JSON")
    launch.add_argument("--json", action="store_true")
    launch.add_argument(
        "--device", default="cuda", help="where the trials train (default cuda)"
    )
    status = sub.add_parser("status", help="summarize fleet state")
    status.add_argument("work_dir")
    status.add_argument("--json", action="store_true")
    report = sub.add_parser(
        "report", help="full report with store accounting"
    )
    report.add_argument("work_dir")
    report.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)
    if args.command == "launch":
        return _cmd_launch(args)
    if args.command == "status":
        return _cmd_status(args)
    return _cmd_report(args)


if __name__ == "__main__":
    sys.exit(main())
