"""One search of the port publishing into a shared artifact store (the
port's copy of tests/store_chaos_runner.py).

    python tests/torch_store_chaos_runner.py MODEL_DIR STORE_ROOT

Spawned, two at once, by `test_torch_store_search.py` with
`ADANET_FAULTS` arming `store.put` faults:

- `store.put:torn:after=3` tears the fourth blob publication (serving
  generation 0's program, mid-closure, before its ref) at its final
  content-addressed path and SIGKILLs the process: a crash mid-publish
  on a filesystem without atomic renames. The resumed run, or a sibling
  putting the same bytes, must heal it.
- `store.put:rot:after=6` flips bits of the seventh (iteration 1's
  frozen payload) and carries on: storage rot that a verified read or
  fsck must catch and heal from the ref's recorded sources.

The search is `torch_chaos_ckpt_runner.build_estimator`'s, with
`export_serving=True`, so that each completed iteration also publishes
a serving generation's closure. Prints `DONE` at the end.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from torch_chaos_ckpt_runner import build_estimator, input_fn  # noqa: E402


def main():
    model_dir, store_root = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    est = build_estimator(model_dir, artifact_store=store_root, export_serving=True)
    est.train(input_fn, max_steps=100)
    assert est.latest_iteration_number() == 2
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
