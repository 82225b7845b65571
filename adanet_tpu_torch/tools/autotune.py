"""Kernel autotuner: sweep tile sizes, persist winners in the artifact
store.

Port of tools/autotune.py, an operator CLI over
`adanet_tpu_torch.ops.tuning`. For each (kernel, shape) workload it
derives the set-once ref name `tune/<kernel>-<spec_fp>-<env_fp>`, and
either reports the existing winner (a *store hit*, no search) or sweeps
the candidate `tile_p` values (output pixels per block), timing the
kernel per candidate, and publishes the winner. The kernels' wrappers
(`ops/sepconv_kernels.py`, `ops/cell_kernels.py`) consult
`tuning.lookup` before their static heuristic, so a tuned tile applies
at the next launch in any process that shares the store, the device and
the versions (the env fingerprint).

Usage:
    python -m adanet_tpu_torch.tools.autotune --store PATH            # tune all
    python -m adanet_tpu_torch.tools.autotune --store PATH --kernel cell
    python -m adanet_tpu_torch.tools.autotune --store PATH --dry-run  # report only
    python -m adanet_tpu_torch.tools.autotune --store PATH --json     # machine-readable

`--device cuda` (the default) times the CUDA kernels by CUDA events,
on the card's own clock (`cuda_event_timer`), and raises without CUDA.
`--device cpu` times the plain versions as a proxy, by the host clock;
its winners record `"device": "cpu"` and land under the CPU's env
fingerprint, so they never apply on a card. K2's and K3's candidates
start with `AUTO`, the tiles they plan without a store, so a sweep never
stores a fixed tile that is slower than the plan.

Exit status (the ckpt_fsck/fleetctl/servectl contract):
    0  clean: every workload was already tuned (pure store hit, zero
       re-searches); also a --dry-run that found nothing pending
    1  tuned: at least one sweep ran and its winner was published
       (or, with --dry-run, would have run)
    2  unrecoverable: a sweep failed outright or the store is unusable
    64 usage errors (EX_USAGE; argparse's default of 2 would collide
       with "unrecoverable")
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List


class _Parser(argparse.ArgumentParser):
    def error(self, message):
        self.print_usage(sys.stderr)
        self.exit(64, "%s: error: %s\n" % (self.prog, message))


def cuda_event_timer(fn, calls: int = 5) -> float:
    """Seconds per call of `fn` on the card: CUDA events around `calls`
    calls queued behind a sleeping kernel, so that they run back to back
    on the device whatever the host's enqueue time."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(5e6))  # a few ms of device time, longer than the enqueue
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / calls


def _tiny_cell_spec():
    from adanet_tpu_torch.ops.cell_kernels import CellSpec

    # Two blocks exercising every branch kind cheaply: one separable,
    # one identity, one pool pair.
    return CellSpec(
        operations=(
            "separable_3x3_1",
            "none",
            "avg_pool_3x3",
            "none",
        ),
        hiddenstate_indices=(0, 1, 1, 0),
        used_hiddenstates=(1, 1, 0, 0),
        stride=1,
    )


def _sepconv_workloads(preset: str) -> List[Dict[str, Any]]:
    if preset == "tiny":
        return [
            {"shape": (4, 8, 8, 8), "kernel": 3, "filters": 8, "stride": 1}
        ]
    # "cifar": the flagship NASNet-A (CIFAR stem) hot shapes — one
    # normal-cell and one reduction-cell sep-conv signature.
    return [
        {"shape": (64, 32, 32, 32), "kernel": 5, "filters": 32, "stride": 1},
        {"shape": (64, 32, 32, 32), "kernel": 3, "filters": 64, "stride": 2},
    ]


def _cell_workloads(preset: str) -> List[Dict[str, Any]]:
    if preset == "tiny":
        return [
            {
                "shape": (4, 6, 6, 8),
                "filters": 8,
                "spec": "tiny",
            }
        ]
    return [
        {"shape": (64, 32, 32, 32), "filters": 32, "spec": "normal"},
        {"shape": (64, 32, 32, 32), "filters": 64, "spec": "reduction"},
    ]


def _resolve_cell_spec(name: str):
    from adanet_tpu_torch.ops import cell_kernels as ck

    return {
        "tiny": _tiny_cell_spec(),
        "normal": ck.NORMAL_CELL,
        "reduction": ck.REDUCTION_CELL,
    }[name]


def _tune_sepconv(workload, device):
    """Returns (tune_spec, candidates, run_fn) for one sep-conv shape."""
    import torch

    from adanet_tpu_torch.ops import sepconv_kernels as sk

    b, h, w, c = workload["shape"]
    k, f, stride = workload["kernel"], workload["filters"], workload["stride"]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((b, h, w, c), generator=gen).to(device)
    dw = torch.randn((c, 1, k, k), generator=gen).to(device)
    pw = torch.randn((f, c, 1, 1), generator=gen).to(device)
    spec = sk.tune_spec(x.shape, x.dtype, k, f, stride)
    candidates = [
        {"tile_p": tile} for tile in sk.tile_candidates(h, w, c, f, k, stride)
    ]

    def run(cand):
        if device.type == "cpu":
            sk.sep_conv_reference(x, dw, pw, stride)
        else:
            sk._launch(x, dw, pw, stride, sk.tiles(c, f, k, cand["tile_p"]))

    return spec, candidates, run


def _tune_cell(workload, device):
    """Returns (tune_spec, candidates, run_fn) for one cell shape."""
    import torch

    from adanet_tpu_torch.ops import cell_kernels as ck

    b, h, w, c = workload["shape"]
    filters = workload["filters"]
    spec = _resolve_cell_spec(workload["spec"])
    gen = torch.Generator().manual_seed(0)
    params = ck.init_cell_params(gen, spec, c, c, filters, device=device)
    prev = torch.randn((b, h, w, c), generator=gen).to(device)
    cur = torch.randn((b, h, w, c), generator=gen).to(device)
    tune_spec = ck.tune_spec(prev.shape, cur.shape, cur.dtype, filters, spec)
    candidates = [
        {"tile_p": tile} for tile in ck.tile_candidates(b, h, w, filters, spec)
    ]

    def run(cand):
        if device.type == "cpu":
            ck.cell_reference(prev, cur, params, spec)
        else:
            ck._launch(prev, cur, params, spec, cand["tile_p"])

    return tune_spec, candidates, run


def main(argv=None) -> int:
    parser = _Parser(
        prog="autotune", description=__doc__.split("\n\n")[0]
    )
    parser.add_argument(
        "--store", required=True, help="artifact store root"
    )
    parser.add_argument(
        "--kernel",
        choices=("sepconv", "cell", "all"),
        default="all",
        help="kernel family to tune (default: all)",
    )
    parser.add_argument(
        "--preset",
        choices=("tiny", "cifar"),
        default="cifar",
        help="workload shapes: 'cifar' = flagship NASNet-A signatures, "
        "'tiny' = seconds-scale smoke shapes",
    )
    parser.add_argument(
        "--dry-run",
        action="store_true",
        help="report hit/pending per workload without sweeping or writing",
    )
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where to time: the CUDA kernels (default) or, as a proxy, "
        "their plain versions on the CPU",
    )
    parser.add_argument(
        "--repeats",
        type=int,
        default=2,
        help="timed runs per candidate (best-of; default 2)",
    )
    parser.add_argument(
        "--json", action="store_true", help="emit the report as JSON"
    )
    args = parser.parse_args(argv)

    import torch

    from adanet_tpu_torch._device import resolve_device
    from adanet_tpu_torch.ops import tuning
    from adanet_tpu_torch.store import ArtifactStore

    device = resolve_device(args.device)
    try:
        store = ArtifactStore(args.store)
    except Exception as exc:
        sys.stderr.write("autotune: unusable store: %s\n" % exc)
        return 2

    on_card = device.type == "cuda"
    synchronize = torch.cuda.synchronize if on_card else None
    kernels = (
        ("sepconv", "cell") if args.kernel == "all" else (args.kernel,)
    )
    builders = {"sepconv": _tune_sepconv, "cell": _tune_cell}
    workload_lists = {
        "sepconv": _sepconv_workloads,
        "cell": _cell_workloads,
    }

    report: Dict[str, Any] = {
        "store": store.root,
        "preset": args.preset,
        "device": device.type,
        "dry_run": args.dry_run,
        "workloads": [],
    }
    searched = hits = pending = failed = 0
    for kernel in kernels:
        for workload in workload_lists[kernel](args.preset):
            entry: Dict[str, Any] = {
                "kernel": kernel,
                "workload": {
                    k: list(v) if isinstance(v, tuple) else v
                    for k, v in workload.items()
                },
            }
            try:
                spec, candidates, run = builders[kernel](workload, device)
                name = tuning.tune_ref_name(kernel, spec, device)
                entry["ref"] = name
                existing = store.get_ref(tuning.TUNE_REF_KIND, name)
                if existing is not None:
                    hits += 1
                    entry["status"] = "hit"
                    entry["winner"] = (existing.get("meta") or {}).get(
                        "winner"
                    )
                elif args.dry_run:
                    pending += 1
                    entry["status"] = "pending"
                    entry["candidates"] = [
                        c["tile_p"] for c in candidates
                    ]
                else:
                    winner, results = tuning.sweep(
                        run,
                        candidates,
                        repeats=args.repeats,
                        synchronize=synchronize,
                        timer=cuda_event_timer if on_card else None,
                    )
                    winner = dict(winner)
                    winner["device"] = device.type
                    tuning.record(store, kernel, spec, winner, results, device)
                    searched += 1
                    entry["status"] = "tuned"
                    entry["winner"] = winner
                    entry["candidates"] = results
            except Exception as exc:
                failed += 1
                entry["status"] = "failed"
                entry["error"] = "%s: %s" % (type(exc).__name__, exc)
            report["workloads"].append(entry)

    report["searched"] = searched
    report["hits"] = hits
    report["pending"] = pending
    report["failed"] = failed
    if failed:
        code = 2
    elif searched or pending:
        code = 1
    else:
        code = 0
    report["exit_code"] = code

    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        for entry in report["workloads"]:
            line = "%s %s: %s" % (
                entry["kernel"],
                entry.get("ref", "?"),
                entry["status"],
            )
            winner = entry.get("winner")
            if winner:
                line += " (tile_p=%s)" % winner.get("tile_p")
            if "error" in entry:
                line += " [%s]" % entry["error"]
            print(line)
        print(
            "searched=%d hits=%d pending=%d failed=%d"
            % (searched, hits, pending, failed)
        )
    return code


if __name__ == "__main__":
    sys.exit(main())
