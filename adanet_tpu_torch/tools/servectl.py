"""servectl: launch, inspect, and drain a local serving-replica fleet.

Port of tools/servectl.py: the same subcommands, flags and exit
contract; its replicas are the port's (`--device`, default `cuda`,
passed through to each replica).

Operator CLI over `adanet_tpu_torch.serving.fleet`. A fleet lives in one
fleet dir (`kv/` coordination store + `fleet.json` + per-replica unix
sockets + optionally a shared artifact `store/`), serving one model
dir's generation chain:

    python -m adanet_tpu_torch.tools.servectl launch  FLEET_DIR --model-dir DIR --replicas 3 [--device cpu]
    python -m adanet_tpu_torch.tools.servectl status  FLEET_DIR [--json]
    python -m adanet_tpu_torch.tools.servectl cascade FLEET_DIR [--json]
    python -m adanet_tpu_torch.tools.servectl drain   FLEET_DIR [--json]

`launch` spawns replica processes
(`python -m adanet_tpu_torch.serving.fleet.replica`) detached with logs
under `FLEET_DIR/logs/`, records them in `fleet.json`, and waits for
their first heartbeats. `status` reads the heartbeat records the
balancer routes on. `cascade` renders each replica's cascade snapshot
from the same heartbeats (level-0 program digest, threshold, live
per-row fallthrough + shadow-divergence gauges, rollback state).
`drain` SIGTERMs every recorded replica and waits for the frontends'
drain contract (answer accepted work, then exit).

Exit status (shared contract with `ckpt_fsck`):
    0  healthy: every expected replica fresh, one consistent
       generation, nobody shedding (launch: all replicas heartbeating)
    1  degraded: stale/shedding/mixed-generation replicas, or a
       partial launch/drain
    2  unusable: no fleet state / no live replicas / launch failed
    64 usage errors (EX_USAGE)
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

FLEET_STATE = "fleet.json"


class _Parser(argparse.ArgumentParser):
    def error(self, message):
        self.print_usage(sys.stderr)
        self.exit(64, "%s: error: %s\n" % (self.prog, message))


# --------------------------------------------------------- spawn helpers
# Shared with chip_smoke.py and the chaos tests: one definition of "start a
# replica process" keeps the operator path and the tested path identical.


def replica_command(
    fleet_dir: str,
    model_dir: str,
    replica_id: str,
    buckets: str = "1,2,4,8",
    cascade: bool = True,
    cascade_mode: Optional[str] = None,
    heartbeat_interval: float = 0.2,
    heartbeat_stale: float = 2.0,
    taskset_cpu: Optional[int] = None,
    device: str = "cuda",
) -> List[str]:
    cmd = []
    if taskset_cpu is not None:
        # Fixed per-replica provisioning: pin the replica to one CPU.
        # A replica is the fleet's unit of scale; without pinning, one
        # replica's threads soak the whole host and "N replicas" stops
        # meaning "N units of capacity".
        cmd += ["taskset", "-c", str(taskset_cpu)]
    cmd += [
        sys.executable,
        "-m",
        "adanet_tpu_torch.serving.fleet.replica",
        "--fleet-dir",
        fleet_dir,
        "--model-dir",
        model_dir,
        "--replica-id",
        replica_id,
        "--buckets",
        buckets,
        "--heartbeat-interval",
        str(heartbeat_interval),
        "--heartbeat-stale",
        str(heartbeat_stale),
        "--device",
        device,
    ]
    if not cascade:
        cmd.append("--no-cascade")
    if cascade_mode is not None:
        cmd += ["--cascade-mode", cascade_mode]
    return cmd


def spawn_replica(
    fleet_dir: str,
    model_dir: str,
    replica_id: str,
    env: Optional[Dict[str, str]] = None,
    log_path: Optional[str] = None,
    **kwargs,
) -> subprocess.Popen:
    if log_path is None:
        logs = os.path.join(fleet_dir, "logs")
        os.makedirs(logs, exist_ok=True)
        log_path = os.path.join(logs, replica_id + ".log")
    log = open(log_path, "ab")
    try:
        return subprocess.Popen(
            replica_command(fleet_dir, model_dir, replica_id, **kwargs),
            stdout=log,
            stderr=subprocess.STDOUT,
            env=env if env is not None else dict(os.environ),
            start_new_session=True,
        )
    finally:
        log.close()


def read_fleet_heartbeats(fleet_dir: str) -> Dict[str, dict]:
    from adanet_tpu_torch.distributed.scheduler import FileKV
    from adanet_tpu_torch.serving import fleet as fleet_lib

    kv = FileKV(os.path.join(fleet_dir, fleet_lib.replica.KV_SUBDIR))
    return fleet_lib.read_heartbeats(kv, fleet_lib.NAMESPACE)


def wait_for_heartbeats(
    fleet_dir: str,
    replica_ids: List[str],
    timeout_secs: float = 60.0,
) -> List[str]:
    """Blocks (bounded) until each listed replica has beaten at least
    once AND reports a served generation; returns the ids still
    missing at timeout."""
    deadline = time.monotonic() + timeout_secs
    missing = list(replica_ids)
    while missing and time.monotonic() < deadline:
        beats = read_fleet_heartbeats(fleet_dir)
        missing = [
            rid
            for rid in replica_ids
            if rid not in beats or beats[rid].get("generation") is None
        ]
        if missing:
            time.sleep(0.1)
    return missing


# ------------------------------------------------------------ subcommands


def _cmd_launch(args) -> int:
    if not os.path.isdir(args.model_dir):
        print(
            "--model-dir %s does not exist" % args.model_dir,
            file=sys.stderr,
        )
        return 2
    os.makedirs(args.fleet_dir, exist_ok=True)
    replica_ids = ["r%d" % i for i in range(args.replicas)]
    procs = {}
    for rid in replica_ids:
        procs[rid] = spawn_replica(
            args.fleet_dir,
            args.model_dir,
            rid,
            buckets=args.buckets,
            cascade=not args.no_cascade,
            cascade_mode=args.cascade_mode,
            device=args.device,
        )
    state = {
        "model_dir": os.path.abspath(args.model_dir),
        "replicas": [
            {
                "id": rid,
                "pid": procs[rid].pid,
                "socket": os.path.join(args.fleet_dir, rid + ".sock"),
            }
            for rid in replica_ids
        ],
    }
    with open(os.path.join(args.fleet_dir, FLEET_STATE), "w") as f:
        json.dump(state, f, indent=2, sort_keys=True)
    missing = wait_for_heartbeats(
        args.fleet_dir, replica_ids, timeout_secs=args.timeout
    )
    report = dict(state, missing_heartbeats=missing)
    print(json.dumps(report, indent=None if args.json else 2, sort_keys=True))
    if not missing:
        return 0
    return 1 if len(missing) < len(replica_ids) else 2


def _load_state(fleet_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(fleet_dir, FLEET_STATE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _status_report(fleet_dir: str, stale_secs: float = 3.0) -> dict:
    state = _load_state(fleet_dir)
    try:
        beats = read_fleet_heartbeats(fleet_dir)
    except Exception as exc:
        return {
            "fleet_dir": fleet_dir,
            "error": "%s: %s" % (type(exc).__name__, exc),
            "exit_code": 2,
        }
    now = time.time()
    expected = [r["id"] for r in (state or {}).get("replicas", [])] or sorted(
        beats
    )
    replicas = {}
    generations = set()
    degraded = False
    for rid in expected:
        payload = beats.get(rid)
        if payload is None:
            replicas[rid] = {"state": "missing"}
            degraded = True
            continue
        age = now - float(payload.get("ts", 0.0))
        stale = age > stale_secs
        shedding = bool(payload.get("shedding"))
        if stale or shedding:
            degraded = True
        generations.add(payload.get("generation"))
        replicas[rid] = {
            "state": "stale" if stale else "serving",
            "generation": payload.get("generation"),
            "queue_depth": payload.get("queue_depth"),
            "wait_ewma_secs": payload.get("wait_ewma_secs"),
            "exec_ewma_secs": payload.get("exec_ewma_secs"),
            "shedding": shedding,
            "heartbeat_age_secs": round(age, 3),
            "pid": payload.get("pid"),
        }
    live = [r for r in replicas.values() if r.get("state") == "serving"]
    if len(generations) > 1:
        degraded = True
    if not replicas or not live:
        code = 2
    elif degraded:
        code = 1
    else:
        code = 0
    return {
        "fleet_dir": fleet_dir,
        "model_dir": (state or {}).get("model_dir"),
        "replicas": replicas,
        "generations": sorted(
            (g for g in generations if g is not None), reverse=True
        ),
        "consistent_generation": len(generations) <= 1,
        "exit_code": code,
    }


def _cmd_status(args) -> int:
    report = _status_report(args.fleet_dir, stale_secs=args.stale_secs)
    rc = report["exit_code"]
    if args.json:
        print(json.dumps(report, sort_keys=True))
        return rc
    print(
        "fleet %s  model=%s  consistent=%s"
        % (
            args.fleet_dir,
            report.get("model_dir"),
            report.get("consistent_generation"),
        )
    )
    for rid, entry in sorted(report.get("replicas", {}).items()):
        print(
            "  %-8s %-8s gen=%-4s depth=%-4s shed=%-5s hb_age=%ss"
            % (
                rid,
                entry.get("state"),
                entry.get("generation"),
                entry.get("queue_depth"),
                entry.get("shedding"),
                entry.get("heartbeat_age_secs"),
            )
        )
    return rc


def _cascade_report(fleet_dir: str, stale_secs: float = 3.0) -> dict:
    """Fleet-wide cascade census from the heartbeat snapshots.

    Exit semantics under the shared 0/1/2/64 contract:
        0  cascade live everywhere: every fresh replica serves a
           published cascade, no rollback of the generation it serves
        1  degraded: a rollback, a replica serving ensemble-only
           (disabled / nothing published / stale), or a mixed fleet
        2  no fleet state or no live replicas
    """
    state = _load_state(fleet_dir)
    try:
        beats = read_fleet_heartbeats(fleet_dir)
    except Exception as exc:
        return {
            "fleet_dir": fleet_dir,
            "error": "%s: %s" % (type(exc).__name__, exc),
            "exit_code": 2,
        }
    now = time.time()
    expected = [r["id"] for r in (state or {}).get("replicas", [])] or sorted(
        beats
    )
    replicas = {}
    live = 0
    degraded = False
    for rid in expected:
        payload = beats.get(rid)
        if payload is None:
            replicas[rid] = {"state": "missing"}
            degraded = True
            continue
        age = now - float(payload.get("ts", 0.0))
        if age > stale_secs:
            replicas[rid] = {
                "state": "stale",
                "heartbeat_age_secs": round(age, 3),
            }
            degraded = True
            continue
        live += 1
        cascade = payload.get("cascade")
        if not isinstance(cascade, dict):
            replicas[rid] = {"state": "no-cascade-stats"}
            degraded = True
            continue
        rollback = cascade.get("rollback")
        if isinstance(rollback, dict) and rollback.get(
            "generation"
        ) != cascade.get("generation"):
            # A batcher keeps a superseded generation's rollback until its
            # first level-0 dispatch of the next one; it does not bind the
            # generation the replica serves.
            rollback = None
        serving_cascade = (
            bool(cascade.get("enabled"))
            and bool(cascade.get("published"))
            and rollback is None
        )
        if not serving_cascade:
            degraded = True
        replicas[rid] = {
            "state": "cascade" if serving_cascade else "ensemble-only",
            "mode": cascade.get("mode"),
            "generation": cascade.get("generation"),
            "source": cascade.get("source"),
            "program_digest": cascade.get("program_digest"),
            "threshold": cascade.get("threshold"),
            "row_fallthrough_rate": cascade.get("row_fallthrough_rate"),
            "fallthrough_rate": cascade.get("fallthrough_rate"),
            "shadow_divergence": cascade.get("shadow_divergence"),
            "shadow_divergence_bound": cascade.get(
                "shadow_divergence_bound"
            ),
            "rollback": rollback,
        }
    if not replicas or not live:
        code = 2
    elif degraded:
        code = 1
    else:
        code = 0
    return {
        "fleet_dir": fleet_dir,
        "model_dir": (state or {}).get("model_dir"),
        "replicas": replicas,
        "exit_code": code,
    }


def _cmd_cascade(args) -> int:
    report = _cascade_report(args.fleet_dir, stale_secs=args.stale_secs)
    rc = report["exit_code"]
    if args.json:
        print(json.dumps(report, sort_keys=True))
        return rc
    print(
        "fleet %s  model=%s" % (args.fleet_dir, report.get("model_dir"))
    )
    for rid, entry in sorted(report.get("replicas", {}).items()):
        if entry.get("state") in ("missing", "stale", "no-cascade-stats"):
            print("  %-8s %s" % (rid, entry.get("state")))
            continue
        digest = entry.get("program_digest") or "-"
        rollback = entry.get("rollback")
        print(
            "  %-8s %-13s mode=%-5s gen=%-4s src=%-9s thr=%-7s "
            "row_fall=%-7s shadow=%-7s bound=%-7s level0=%.12s%s"
            % (
                rid,
                entry.get("state"),
                entry.get("mode"),
                entry.get("generation"),
                entry.get("source"),
                _fmt(entry.get("threshold")),
                _fmt(entry.get("row_fallthrough_rate")),
                _fmt(entry.get("shadow_divergence")),
                _fmt(entry.get("shadow_divergence_bound")),
                digest,
                "  ROLLBACK: %s" % rollback["reason"]
                if isinstance(rollback, dict)
                else "",
            )
        )
    return rc


def _fmt(value) -> str:
    return "%.4f" % value if isinstance(value, float) else str(value)


def _pid_running(pid: int) -> bool:
    """True while `pid` is alive and NOT a zombie.

    When launch and drain share one process (library use, tests), the
    exited replicas are this process's unreaped children: `kill(pid,
    0)` keeps succeeding on the zombies forever. Reap our own children
    opportunistically and read the process state for everyone else.
    """
    try:
        reaped, _ = os.waitpid(pid, os.WNOHANG)
        if reaped == pid:
            return False
    except (ChildProcessError, OSError):
        pass  # not our child (the CLI case) — fall through
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:
        with open("/proc/%d/stat" % pid) as f:
            # field 3 (after the parenthesized comm) is the state.
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except (OSError, IndexError):
        return True  # no procfs: the kill(0) verdict stands


def _cmd_drain(args) -> int:
    state = _load_state(args.fleet_dir)
    if state is None or not state.get("replicas"):
        print(
            "no readable fleet state at %s"
            % os.path.join(args.fleet_dir, FLEET_STATE),
            file=sys.stderr,
        )
        return 2
    pids = {r["id"]: int(r["pid"]) for r in state["replicas"]}
    signalled = {}
    for rid, pid in pids.items():
        try:
            os.kill(pid, signal.SIGTERM)
            signalled[rid] = True
        except OSError:
            signalled[rid] = False  # already gone counts as drained
    deadline = time.monotonic() + args.timeout
    remaining = dict(pids)
    while remaining and time.monotonic() < deadline:
        for rid, pid in list(remaining.items()):
            if not _pid_running(pid):
                del remaining[rid]
        if remaining:
            time.sleep(0.1)
    report = {
        "drained": sorted(set(pids) - set(remaining)),
        "still_running": sorted(remaining),
    }
    print(json.dumps(report, indent=None if args.json else 2, sort_keys=True))
    if not remaining:
        return 0
    return 1 if len(remaining) < len(pids) else 2


def main(argv=None) -> int:
    parser = _Parser(
        prog="servectl",
        description="Launch, inspect, and drain a serving-replica fleet.",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    launch = sub.add_parser("launch", help="spawn a replica fleet")
    launch.add_argument("fleet_dir")
    launch.add_argument("--model-dir", required=True)
    launch.add_argument("--replicas", type=int, default=3)
    launch.add_argument("--buckets", default="1,2,4,8")
    launch.add_argument("--no-cascade", action="store_true")
    launch.add_argument(
        "--cascade-mode",
        choices=("row", "batch", "off"),
        default=None,
        help="row = per-row split (replica default), batch = legacy "
        "whole-batch fallthrough, off = ensemble only",
    )
    launch.add_argument("--timeout", type=float, default=60.0)
    launch.add_argument(
        "--device", default="cuda", help="the replicas' device (cuda or cpu)"
    )
    launch.add_argument("--json", action="store_true")
    status = sub.add_parser("status", help="heartbeat census")
    status.add_argument("fleet_dir")
    status.add_argument("--json", action="store_true")
    status.add_argument(
        "--stale-secs",
        type=float,
        default=3.0,
        help="heartbeat age past which a replica reads as stale "
        "(match the fleet's --heartbeat-interval when launched slow)",
    )
    cascade = sub.add_parser(
        "cascade", help="per-replica cascade census"
    )
    cascade.add_argument("fleet_dir")
    cascade.add_argument("--json", action="store_true")
    cascade.add_argument("--stale-secs", type=float, default=3.0)
    drain = sub.add_parser("drain", help="SIGTERM + wait for the fleet")
    drain.add_argument("fleet_dir")
    drain.add_argument("--timeout", type=float, default=60.0)
    drain.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)
    if args.command == "launch":
        return _cmd_launch(args)
    if args.command == "status":
        return _cmd_status(args)
    if args.command == "cascade":
        return _cmd_cascade(args)
    return _cmd_drain(args)


if __name__ == "__main__":
    sys.exit(main())
