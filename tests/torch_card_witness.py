"""Two readings on the card that back claims of PERF.md, beside
`chip_smoke.py` (which this imports from the repository root):

1. `chip_smoke.traced_step` reads a profile from its Chrome trace
   (`trace_totals`). Here `train_nasnet` runs with its 3 traced steps,
   and each profile is read both that way and through torch's own
   `events()` / `key_averages()`: the `reader_compare:` line gives both
   readings and the seconds each reader took.
2. The ImageNet AutoEnsemble trainer CLI (ResNet-50 + EfficientNet-B0 at
   224, batch 64, fake data) at its defaults for 2 x 10 and 2 x 50 steps,
   and for 2 x 50 at the learning rates scaled linearly to batch 64
   (0.025, 0.004): an `imagenet_lr:` line each with the evaluation's
   metrics and each subnetwork's first, least and last training loss.

Run on one card (about 5 minutes):

    python3 tests/torch_card_witness.py
"""

import collections
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def torch_reader(prof, steps):
    """The readings of `traced_step` through torch's FunctionEvents."""
    kernels, launches = collections.Counter(), collections.Counter()
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA and not event.is_user_annotation:
            kernels[event.name] += event.device_time_total
            launches[event.name] += 1
    averages = prof.key_averages()
    host_ops = sorted(averages, key=lambda e: -e.self_cpu_time_total)[:8]
    backward_us = [e.device_time_total for e in averages if "FusedSepConvBackward" in e.key]
    return dict(busy_ms=sum(kernels.values()) / 1e3 / steps, kernels=sum(launches.values()) / steps,
                k2_ms=sum(us for k, us in kernels.items() if "sepconv_kernel" in k) / 1e3 / steps,
                k2_bwd_ms=max(backward_us) / 1e3 / steps if backward_us else None,
                host=[[e.key[:50], e.self_cpu_time_total / 1e3 / steps, e.count / steps] for e in host_ops])


def main():
    cs.build_kernels()
    from adanet_tpu_torch.ops import _build

    _build.self_test(torch.device("cuda", 0))
    root = tempfile.mkdtemp()
    chrome_reader = cs.traced_step

    def both(prof, host_ms, steps=cs.TRACED_STEPS):
        t0 = time.perf_counter()
        new = chrome_reader(prof, host_ms, steps)
        t1 = time.perf_counter()
        old = torch_reader(prof, steps)
        t2 = time.perf_counter()
        keys = ("device_busy_ms_per_step", "device_kernels_per_step", "k2_device_ms_per_step",
                "k2_backward_device_ms_per_step", "top_host_ms_per_step")
        print("reader_compare: " + json.dumps(dict(new_secs=t1 - t0, old_secs=t2 - t1,
                                                   new={k: new.get(k) for k in keys}, old=old)), flush=True)
        return new

    cs.traced_step = both
    cs.train_nasnet(os.path.join(root, "nasnet"))
    cs.traced_step = chrome_reader

    from adanet_tpu_torch.research.imagenet_autoensemble import trainer

    scaled = ["--resnet_lr=0.025", "--efficientnet_lr=0.004"]
    for extra, steps in (([], 20), ([], 100), (scaled, 100)):
        marks, losses = [], []
        argv = ["--dataset=fake", "--boosting_iterations=2", "--train_steps=%d" % steps, "--device=cuda",
                "--model_dir=%s" % tempfile.mkdtemp(dir=root)] + extra
        metrics, _, secs, _ = cs._run_cli(trainer, argv, marks, losses)
        print("imagenet_lr: " + json.dumps(dict(extra=extra, steps=steps, metrics=metrics,
                                                losses=cs.loss_summary(losses), secs=secs)), flush=True)
    print(cs.card_line())


if __name__ == "__main__":
    main()
