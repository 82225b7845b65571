"""Per-kernel device-time breakdown of the flagship NASNet-A train step.

Port of tools/profile_nasnet.py on `torch.profiler`. Builds the same
iteration (a `MultiClassHead(10)`, the complexity-regularized ensembler
with SGD 0.01 and lambda 0.001, `GrowStrategy`, one improve_nas NASNet-A
candidate with momentum SGD and no aux head), runs three warm-up steps,
then profiles `--steps` train steps and aggregates the CUDA kernel events
of the trace by category (the hand-written kernels by name, cuDNN
convolutions, GEMMs, PyTorch's elementwise and reduction kernels,
copies, ...) and by kernel, printing the top entries by device time a
step. `--pallas_sepconv` turns the fused sep-conv (K2,
`Hparams.use_pallas_sep_conv`) on. The tool needs a CUDA card and refuses
to profile the CPU.

Usage (on the card):
    python -m adanet_tpu_torch.tools.profile_nasnet [--steps 10] [--batch 128]
        [--filters 32] [--cells 18] [--top 25] [--pallas_sepconv] [--json]

With `--json` the last line is one JSON object: device ms a step, the
categories and kernels (us a step), the kernel launches a step, K2's
launches over the profiled steps and the sep-conv forwards the model made
in them (each `_SepConv` call times its launches a call).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import tempfile
from typing import List, Optional

#: Trace-event categories of work on the card.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: (category, pattern on the kernel name), first match wins.
_CATEGORY_PATTERNS = (
    ("K2 sepconv_kernel", r"\bsepconv_kernel[<(]"),
    ("K1 combine_kernel", r"\bcombine_kernel[<(]"),
    ("K3 cell kernels", r"\b(sep_layer_kernel|conv1x1_kernel|pool_kernel|cast_bf16_kernel)[<(]"),
    ("K0 copy_bytes_kernel", r"\bcopy_bytes_kernel\b"),
    ("memcpy", r"^Memcpy|memcpy"),
    ("memset", r"^Memset|memset"),
    ("convolution (cuDNN)", r"conv|cudnn|implicit_gemm|dgrad|wgrad|fprop"),
    ("gemm", r"gemm|cutlass|sm90_xmma|ampere_|gemv"),
    ("batch norm", r"batch_norm|batchnorm|bn_"),
    ("reduction", r"reduce|Reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"),
    ("pooling", r"pool"),
    ("softmax", r"softmax"),
    ("optimizer", r"multi_tensor|foreach|adam|sgd"),
)


def categorize(kernel_name: str) -> str:
    """The category of a CUDA kernel by its (demangled) name."""
    for category, pattern in _CATEGORY_PATTERNS:
        if re.search(pattern, kernel_name):
            return category
    return "other"


def aggregate_trace(path: str):
    """(total device us, {category: us}, {kernel: us}, {kernel: launches})
    over the device events of the Chrome trace `torch.profiler` wrote at
    `path`."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    by_cat, by_kernel, launches = collections.Counter(), collections.Counter(), collections.Counter()
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        dur = float(e.get("dur", 0.0))
        name = str(e.get("name", "?"))
        total += dur
        by_cat[categorize(name)] += dur
        by_kernel[name] += dur
        launches[name] += 1
    return total, by_cat, by_kernel, launches


def build_step(args, device="cuda"):
    """(one train step as a closure, the candidates' modules) at the
    flags' size, on `device`."""
    import numpy as np
    import torch

    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.core.iteration import IterationBuilder
    from adanet_tpu_torch.ensemble.strategy import GrowStrategy
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.research.improve_nas import improve_nas, optimizer

    factory = IterationBuilder(
        head=MultiClassHead(10),
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.01),
                                                   adanet_lambda=0.001)],
        ensemble_strategies=[GrowStrategy()],
        device=device,
    )
    builder = improve_nas.Builder(
        optimizer_fn=optimizer.fn_with_name("momentum"),
        hparams=improve_nas.Hparams(num_cells=args.cells, num_conv_filters=args.filters, use_aux_head=False,
                                    use_pallas_sep_conv=args.pallas_sepconv),
        seed=0,
    )
    iteration = factory.build_iteration(0, [builder], None, input_shape=(32, 32, 3))
    rng = np.random.RandomState(0)
    batch = ({"image": rng.randn(args.batch, 32, 32, 3).astype(np.float32)},
             rng.randint(0, 10, size=(args.batch,)))
    state = [iteration.init_state(torch.Generator().manual_seed(0), batch)]

    def step():
        state[0], metrics = iteration.train_step(state[0], batch)
        return metrics

    return step, [st.module for st in state[0].subnetworks.values()]


def sepconv_modules(modules):
    """Every `_SepConv` under `modules`."""
    from adanet_tpu_torch.models.nasnet import _SepConv

    return [m for root in modules for m in root.modules() if isinstance(m, _SepConv)]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m adanet_tpu_torch.tools.profile_nasnet")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--filters", type=int, default=32)
    parser.add_argument("--cells", type=int, default=18)
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--pallas_sepconv", action="store_true",
                        help="profile with the fused sep-conv kernel (K2, Hparams.use_pallas_sep_conv)")
    parser.add_argument("--json", action="store_true", help="end with the numbers as one JSON line")
    args = parser.parse_args(argv)

    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch._device import resolve_device

    resolve_device("cuda")  # raises without a card: the CPU is not profiled
    step, modules = build_step(args)
    calls = collections.Counter()
    for module in sepconv_modules(modules):
        module.register_forward_hook(lambda m, i, o: calls.update([m]))
    for _ in range(3):
        metrics = step()
    torch.cuda.synchronize()
    calls.clear()
    before = ops.launch_counts()["sepconv"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            metrics = step()
        torch.cuda.synchronize()
    k2_launches = ops.launch_counts()["sepconv"] - before
    sepconv_forwards = sum(n * len(m.launch_shapes()) for m, n in calls.items())
    del metrics
    trace_dir = tempfile.mkdtemp(prefix="nasnet_profile_")
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    total, by_cat, by_kernel, launches = aggregate_trace(path)
    steps = args.steps
    print("device time: %.3f ms/step over %d steps (batch %d, %d cells, %d filters, K2 %s)"
          % (total / steps / 1e3, steps, args.batch, args.cells, args.filters,
             "on" if args.pallas_sepconv else "off"))
    print("\n-- by category (us/step, % of device time) --")
    for cat, us in by_cat.most_common(args.top):
        print("%-28s %10.1f  %5.1f%%" % (cat, us / steps, 100.0 * us / max(total, 1e-9)))
    print("\n-- top kernels --")
    for name, us in by_kernel.most_common(args.top):
        print("%-48s %10.1f  %5.1f%%" % (name[:48], us / steps, 100.0 * us / max(total, 1e-9)))
    print("\nK2 launches %d over %d steps; sep-conv forwards %d" % (k2_launches, steps, sepconv_forwards))
    print("trace kept at %s" % path)
    if args.json:
        row = dict(
            steps=steps, batch=args.batch, cells=args.cells, filters=args.filters,
            pallas_sepconv=args.pallas_sepconv, device_ms_per_step=total / steps / 1e3,
            trace_delivered=total > 0,
            by_category_us_per_step={k: v / steps for k, v in by_cat.most_common(args.top)},
            top_kernels_us_per_step={k: v / steps for k, v in by_kernel.most_common(args.top)},
            kernel_launches_per_step=sum(launches.values()) / steps,
            k2_launches=k2_launches, sepconv_forwards=sepconv_forwards,
            k2_trace_launches=sum(n for k, n in launches.items() if categorize(k) == "K2 sepconv_kernel"),
            launches=ops.launch_counts(),
        )
        print("profile_nasnet: " + json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
