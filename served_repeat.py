"""Repeats `chip_smoke.py`'s served-program check in a process of its own:
the served ensemble (`served_ensemble`, seed 0) published as
`serving.pt2` (`publish`), loaded, and its logits held bitwise against
the in-process predict on random 1- and 7-row batches; each side called
again on the same rows; then with a thread entering and leaving the TF32
guard (`full_f32_matmul`) throughout, and with cuDNN held to its
deterministic algorithms. One line a condition: comparisons, mismatches,
the largest difference, each side's largest difference from its own
first answer. It needs the card; run it from the repo's root:

    python3 served_repeat.py
"""

import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from adanet_tpu_torch.core import export  # noqa: E402
from adanet_tpu_torch.ensemble.weighted import full_f32_matmul  # noqa: E402
from adanet_tpu_torch.ops import _build  # noqa: E402

print(cs.card_line(), flush=True)
t0 = time.perf_counter()
cs.build_kernels()
_build.self_test()
print("built %.1f" % (time.perf_counter() - t0), flush=True)
d = tempfile.mkdtemp()
_, _, predict = cs.served_ensemble(0, "cuda")
path, info = cs.publish(d, 0)
print("published %.1f" % (time.perf_counter() - t0), flush=True)
program = export.load_serving_program(path)
rng = torch.Generator().manual_seed(1)


def outs(img):
    got = program({"image": img.numpy()})["logits"].double()
    with torch.inference_mode(), export._serving_precision():
        want = predict({"image": img.cuda()})["logits"].double()
    return got, want


def experiment(name, n_inputs, rows=1, repeats=1):
    diffs, self_prog, self_pred, mags = [], 0.0, 0.0, 0.0
    t = time.perf_counter()
    for _ in range(n_inputs):
        img = torch.randn(rows, 32, 32, 3, generator=rng)
        first = None
        for _ in range(repeats):
            got, want = outs(img)
            diffs.append(float((got - want).abs().max()))
            mags = max(mags, float(want.abs().max()))
            if first is None:
                first = (got, want)
            else:
                self_prog = max(self_prog, float((got - first[0]).abs().max()))
                self_pred = max(self_pred, float((want - first[1]).abs().max()))
    bad = [x for x in diffs if x > 0]
    print(name + ": " + json.dumps(dict(comparisons=len(diffs), mismatches=len(bad), max_diff=max(diffs),
                                        some=sorted(bad)[-5:], program_self=self_prog, predict_self=self_pred,
                                        max_abs_logit=mags, secs=time.perf_counter() - t)), flush=True)


experiment("plain_rows1", 150)
experiment("plain_rows7", 30, rows=7)
experiment("repeat_rows1", 10, repeats=10)
stop = threading.Event()


def toggler():
    while not stop.is_set():
        with full_f32_matmul():
            time.sleep(0.0003)
        time.sleep(0.0002)


thread = threading.Thread(target=toggler, daemon=True)
thread.start()
experiment("tf32_toggler_rows1", 60)
stop.set()
thread.join()
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True
with cs.deterministic_cudnn():
    experiment("cudnn_deterministic_rows1", 60)
experiment("plain_again_rows1", 100)
print("total %.1f" % (time.perf_counter() - t0), flush=True)
