"""Chaos runner: one port fleet run, SIGKILLed at the promotion seam.

The port's counterpart of tests/fleet_chaos_runner.py. Spawned by
`test_torch_fleet.py` (and by `chip_smoke.py` on the card) with
`ADANET_FAULTS="fleet.promote:kill"`: the fleet trains rung 0 to
completion — durable trial checkpoints, per-iteration `replay.json`
records, published store refs — and is then SIGKILLed at the entry of
the promotion decision. The parent resumes the SAME work dir in-process
with no faults armed and asserts the fleet completes with the oracle
fleet's winner and an oracle-identical champion architecture, with the
shared store fsck-clean.

Usage: torch_fleet_chaos_runner.py WORK_DIR [DEVICE] (cpu by default).
Shares `torch_fleet_common.py` with the in-process oracle so the
comparison is meaningful.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from torch_fleet_common import build_fleet  # noqa: E402


def main():
    torch.set_num_threads(1)
    work_dir = sys.argv[1]
    device = sys.argv[2] if len(sys.argv) > 2 else "cpu"
    report = build_fleet(work_dir, device=device).run()
    print("DONE winner=%s" % report.winner_id, flush=True)


if __name__ == "__main__":
    main()
