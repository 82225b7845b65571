"""Chaos phase C for the port: a multi-host resume from a torn model
dir, with a peer that stops answering mid-iteration.

    python tests/torch_chaos_multihost_runner.py MODEL_DIR RANK WORLD PORT [DEVICE [BACKEND]]

The port's copy of tests/chaos_multihost_runner.py, without its
compile-cache fault site (the port has no compile cache yet). Spawned
(2 processes) by `test_torch_multihost.py` and by `chip_smoke.py` on the
model dir that `torch_chaos_ckpt_runner.py` tore. Both processes resume
the search under `RoundRobinStrategy` (owners [[0], [1], [0]]: "a" on
process 1, the ensembles and "b" on the chief). Process 1 is armed by
the parent with `ADANET_FAULTS="collective.entry:hang:after=2:delay=600"`:
at its third store broadcast (a member sync) it stops answering, as a
dead peer would. The chief's deadline (`ADANET_COLLECTIVE_TIMEOUT_SECS`,
set low by the parent) must turn the silence into `PeerLostError`,
quarantine "a", finish the iteration with "b", persist it, and stop.

The chief prints one `CHAOS CHIEF DONE <json>` line (wall seconds, the
iteration and step reached, whether a peer was lost, and the longest
agreement that returned within the deadline, against which a live
peer's lateness is measured) and exits 0; the hung peer never finishes,
and the parent kills it.
"""

import faulthandler
import json
import os
import signal
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

# Stack dumps on demand: this runner proves the absence of hangs, so a
# hang must be diagnosable from the parent.
faulthandler.register(signal.SIGUSR1)

import torch  # noqa: E402

from adanet_tpu_torch.distributed import coordination, multihost  # noqa: E402
from adanet_tpu_torch.distributed.placement import RoundRobinStrategy  # noqa: E402

from torch_chaos_ckpt_runner import build_estimator, input_fn  # noqa: E402


def main(argv):
    model_dir, rank, world, port = argv[0], int(argv[1]), int(argv[2]), argv[3]
    device = argv[4] if len(argv) > 4 else "cpu"
    backend = argv[5] if len(argv) > 5 else None
    torch.set_num_threads(1)
    coordination.initialize("localhost:%s" % port, world, rank, device=device, backend=backend)
    est = build_estimator(model_dir, device=device, placement_strategy=RoundRobinStrategy([torch.device(device)]))
    # The seconds of every agreement that returned within its deadline.
    agreements = []
    bounded = multihost.call_with_deadline

    def timed(fn, *args, **kwargs):
        t0 = time.monotonic()
        value = bounded(fn, *args, **kwargs)
        agreements.append(time.monotonic() - t0)
        return value

    multihost.call_with_deadline = timed
    start = time.monotonic()
    est.train(input_fn, max_steps=100)
    wall = time.monotonic() - start
    if rank == 0:
        record = {
            "wall_secs": round(wall, 2),
            "iteration_number": est.latest_iteration_number(),
            "global_step": est.latest_global_step(),
            "peer_lost": est._peer_lost is not None,
            "agreements": len(agreements),
            "max_agreement_secs": round(max(agreements, default=0.0), 3),
        }
        print("CHAOS CHIEF DONE %s" % json.dumps(record), flush=True)
    else:
        print("CHAOS PEER %d DONE" % rank, flush=True)
    # A lost peer: the process group is left without its teardown.
    coordination.shutdown(timeout_secs=10.0)
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1:])
