#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (`adanet_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

1. Fails unless CUDA is available; prints the card's name and power limit.
2. Builds every kernel from `adanet_tpu_torch/ops/csrc` (nvcc, in
   parallel) and launches K0, the copy self-test.
3. Holds each kernel against its plain PyTorch version on the card, at
   every distinct shape the serving path launches it at: K0 on [8] f32,
   K1 at [2, bucket, 10] f32 for each bucket, K2 at each of its 14
   (H, W, C, F, k, stride) signatures for each bucket, in bf16 and in
   f32 (cuDNN TF32 off for the f32 plain version).
4. Main path at full width: a two-member NASNet-A (6@768) CIFAR ensemble
   (18 cells, 32 filters, bf16, fused sep-conv, SCALAR fused combine),
   weights from a seeded `torch.Generator`, batch-norm statistics random
   with count 1, fixed mixture weights. It publishes `gen-1`, serves mixed
   requests of 1 to 32 rows through ServingFrontend -> Batcher ->
   ModelPool, checks every result is ok, finite and well formed, and
   checks the launch counts (zeroed just before): one K0 per gated
   generation, one K1 per executed program call, 400 K2 per K1.
5. Compares one bucket, loaded at f32 compute, on the card against the
   same generation loaded with device="cpu".
6. Times each kernel, its plain version and the library call that
   computes the same function (K0: `torch.clone`, K1: `torch.einsum`,
   K2: grouped plus 1x1 `F.conv2d`), with CUDA events, and computes each
   kernel's bound from its shapes.

Prints the per-shape K2 timings, the served latency and throughput, a
`kernels` JSON line, and as its last line `{"ok": true, "device":
{...}}`. Any failure raises and exits non-zero.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): device memory bytes/s and dense
# FLOP/s by the type the work is done in.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BUCKETS = (1, 2, 4, 8, 16, 32)
SERIAL_ROWS = (1, 3, 8, 17, 32, 2, 5, 12, 30, 1)
BURST_ROWS = (1, 7, 16, 32, 4, 24, 9, 2, 32, 13, 6, 19, 28, 3, 11, 32)
MIXTURE = (0.6, 0.4)
NUM_MEMBERS = 2


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, dtype_name):
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(byte_ms, flop_ms), ("bytes" if byte_ms >= flop_ms else "operations")


def check_close(name, got, want, atol):
    err = float((got.float() - want.float()).abs().max())
    if not err <= atol:
        raise AssertionError("%s: max abs err %g > %g" % (name, err, atol))
    return err


def build_kernels():
    from adanet_tpu_torch.ops import _build

    t0 = time.time()
    _build.build()
    print("build: %d kernels in %.1f s" % (len(_build.KERNELS), time.time() - t0))
    for name, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas[%s]: %s" % (name, line.strip()))


def member_module(seed, generator):
    import torch

    from adanet_tpu_torch.models import nasnet
    from adanet_tpu_torch.research.improve_nas import improve_nas

    builder = improve_nas.Builder(
        None,
        improve_nas.Hparams(use_pallas_sep_conv=True, compute_dtype=torch.bfloat16),
        seed=seed,
        num_classes=10,
    )
    module = builder.build_subnetwork(10, input_shape=(32, 32, 3))
    nasnet.init_parameters(module, generator)
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, nasnet._DebiasedBatchNorm):
                sub.mean.copy_(0.1 * torch.randn(sub.mean.shape, generator=generator))
                sub.var.copy_(0.5 + torch.rand(sub.var.shape, generator=generator))
                sub.count.fill_(1.0)
    return builder, module.eval()


def publish(model_dir, seed):
    import numpy as np
    import torch

    from adanet_tpu_torch.core.architecture import Architecture
    from adanet_tpu_torch.core.frozen import (
        FrozenEnsemble,
        FrozenSubnetwork,
        FrozenWeightedSubnetwork,
    )
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import (
        ComplexityRegularizedEnsembler,
        MixtureWeightType,
    )
    from adanet_tpu_torch.serving import publish_generation

    generator = torch.Generator().manual_seed(seed)
    architecture = Architecture("t1_nasnet_grow", "complexity_regularized", iteration_number=1)
    weights = [torch.tensor(w, dtype=torch.float32) for w in MIXTURE]
    members = []
    for t in range(NUM_MEMBERS):
        builder, module = member_module(seed + t, generator)
        architecture.add_subnetwork(t, builder.name)
        members.append(
            FrozenWeightedSubnetwork(
                FrozenSubnetwork(t, builder.name, module, 1.0, builder_spec=builder.to_spec()),
                weights[t],
            )
        )
    frozen = FrozenEnsemble(
        "t1_nasnet_grow",
        1,
        members,
        "complexity_regularized",
        {"weights": weights, "bias": None},
        architecture,
    )
    ensembler = ComplexityRegularizedEnsembler(
        mixture_weight_type=MixtureWeightType.SCALAR, use_fused_combine=True
    )
    sample = {"image": np.zeros((1, 32, 32, 3), np.float32)}
    path = publish_generation(model_dir, 1, frozen, ensembler, MultiClassHead(10), sample)
    return path, members[0].subnetwork.module.nasnet.sepconv_launch_shapes()


def check_kernels(sep_shapes, rng):
    """Each kernel against its plain version at every shape the serving
    path launches it at; returns the per-kernel worst errors."""
    import torch

    from adanet_tpu_torch.ops import _build, ensemble_kernels, sepconv_kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    errors = {}
    x = torch.randn(8, generator=rng).cuda()
    errors["copy"] = check_close("K0", _build.copy_tensor(x), _build.copy_reference(x), 0.0)
    worst = 0.0
    for b in BUCKETS:
        logits = torch.randn(NUM_MEMBERS, b, 10, generator=rng).cuda()
        w = torch.tensor(MIXTURE, dtype=torch.float32).cuda()
        got = ensemble_kernels.fused_weighted_combine(logits, w, None)
        want = ensemble_kernels.combine_reference(logits, w, None)
        worst = max(worst, check_close("K1 b=%d" % b, got, want, 1e-6))
    errors["combine"] = worst
    worst = {}
    for (h, w_, c), f, k, s in sorted(set(sep_shapes)):
        dw = (torch.randn(c, 1, k, k, generator=rng) / k).cuda()
        pw = (torch.randn(f, c, 1, 1, generator=rng) / c ** 0.5).cuda()
        for b in BUCKETS:
            x = torch.randn(b, h, w_, c, generator=rng).cuda()
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, None)):
                xd = x.to(dtype)
                got = sepconv_kernels.fused_sep_conv(xd, dw, pw, s)
                want = sepconv_kernels.sep_conv_reference(xd, dw, pw, s)
                if tol is None:
                    # bf16: both sum in f32 and round once; a sum near a
                    # rounding boundary may round either way (2^-8 relative).
                    tol = 2e-2 * float(want.float().abs().max())
                name = "K2 %s b=%d %s" % ((h, w_, c, f, k, s), b, dtype)
                worst[dtype] = max(worst.get(dtype, 0.0), check_close(name, got, want, tol))
    torch.cuda.synchronize()
    print("K2 worst abs err: f32 %g, bf16 %g" % (worst[torch.float32], worst[torch.bfloat16]))
    errors["sepconv"] = max(worst.values())
    return errors


def time_kernels(sep_shapes, rng):
    """Per-kernel times at the largest bucket: kernel, plain version,
    library call and bound. K2's numbers sum over the 200 launches of one
    member forward (each shape times its launch count)."""
    import torch
    import torch.nn.functional as F

    from adanet_tpu_torch.ops import _build, ensemble_kernels, sepconv_kernels

    b = max(BUCKETS)
    rows = {}
    x = torch.arange(8, dtype=torch.float32).cuda()
    t_bound, t_by = bound_ms(2 * x.numel() * 4, 0, "float32")
    rows["copy"] = dict(
        shapes="[8] f32",
        ms=cuda_time_ms(lambda: _build.copy_tensor(x), iters=100),
        plain_ms=cuda_time_ms(lambda: _build.copy_reference(x), iters=100),
        library_ms=cuda_time_ms(lambda: torch.clone(x), iters=100),
        bound_ms=t_bound,
        bound_by=t_by,
    )
    logits = torch.randn(NUM_MEMBERS, b, 10, generator=rng).cuda()
    w = torch.tensor(MIXTURE, dtype=torch.float32).cuda()
    n, c = NUM_MEMBERS, 10
    t_bound, t_by = bound_ms(4 * (n * b * c + n + b * c), 2 * n * b * c, "float32")
    rows["combine"] = dict(
        shapes="[%d, %d, %d] f32" % (n, b, c),
        ms=cuda_time_ms(lambda: ensemble_kernels.fused_weighted_combine(logits, w, None), iters=100),
        plain_ms=cuda_time_ms(lambda: ensemble_kernels.combine_reference(logits, w, None), iters=100),
        library_ms=cuda_time_ms(lambda: torch.einsum("nbc,n->bc", logits, w), iters=100),
        bound_ms=t_bound,
        bound_by=t_by,
    )
    counts = collections.Counter(sep_shapes)
    per_shape = []
    totals = collections.Counter()
    flops_total = bytes_total = 0
    for ((h, w_, c), f, k, s), count in sorted(counts.items()):
        dtype = torch.bfloat16
        x = torch.randn(b, h, w_, c, generator=rng).cuda().to(dtype)
        dw = (torch.randn(c, 1, k, k, generator=rng) / k).cuda()
        pw = (torch.randn(f, c, 1, 1, generator=rng) / c ** 0.5).cuda()
        dwb, pwb = dw.to(dtype), pw.to(dtype)
        ho, pt, pb = sepconv_kernels.same_pads(h, k, s)
        wo, pl, pr = sepconv_kernels.same_pads(w_, k, s)

        def library():
            y = F.pad(torch.relu(x).permute(0, 3, 1, 2), (pl, pr, pt, pb))
            y = F.conv2d(y, dwb, stride=s, groups=c)
            return F.conv2d(y, pwb)

        nbytes = 2 * b * h * w_ * c + 4 * (c * k * k + c * f) + 2 * b * ho * wo * f
        flops = 2 * b * ho * wo * (c * k * k + c * f)
        t_bound, _ = bound_ms(nbytes, flops, "bfloat16")
        row = dict(
            shape=[b, h, w_, c, f, k, s],
            launches_per_member_forward=count,
            ms=cuda_time_ms(lambda: sepconv_kernels.fused_sep_conv(x, dw, pw, s)),
            plain_ms=cuda_time_ms(lambda: sepconv_kernels.sep_conv_reference(x, dw, pw, s)),
            library_ms=cuda_time_ms(library),
            bound_ms=t_bound,
        )
        per_shape.append(row)
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            totals[key] += count * row[key]
        flops_total += count * flops
        bytes_total += count * nbytes
    byte_ms = bytes_total / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops_total / PEAK_FLOPS["bfloat16"] * 1e3
    rows["sepconv"] = dict(
        shapes="one member forward at bucket %d, bf16: %d launches over %d shapes"
        % (b, sum(counts.values()), len(counts)),
        ms=totals["ms"],
        plain_ms=totals["plain_ms"],
        library_ms=totals["library_ms"],
        bound_ms=totals["bound_ms"],
        bound_by="bytes" if byte_ms >= flop_ms else "operations",
    )
    return rows, per_shape


def serve(model_dir, sep_shapes, rng):
    """The main path: pool -> batcher -> frontend, with the launch
    counters zeroed just before and read just after."""
    import numpy as np
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.observability import metrics
    from adanet_tpu_torch.serving import Batcher, FrontendConfig, ModelPool, ServingFrontend

    def request(n):
        return {"image": torch.randn(n, 32, 32, 3, generator=rng).numpy()}

    serial = [request(n) for n in SERIAL_ROWS]
    burst = [request(n) for n in BURST_ROWS]
    dispatches = metrics.registry().counter("serving.batcher.dispatches")
    dispatched_before = dispatches.value
    ops.reset_launch_counts()
    pool = ModelPool(model_dir)
    if not pool.poll() or pool.active is None:
        raise AssertionError("the pool did not bring up gen-1: %s" % pool.events)
    batcher = Batcher(pool)
    frontend = ServingFrontend(batcher, FrontendConfig(default_deadline_secs=120.0)).start()
    latencies = []
    results = []
    try:
        for features in serial:
            t0 = time.perf_counter()
            results.append(frontend.submit(features))
            latencies.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        handles = [frontend.submit_async(f) for f in burst]
        results += [h.wait(300.0) for h in handles]
        burst_secs = time.perf_counter() - t0
    finally:
        drained = frontend.drain(timeout=120.0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    batches = int(dispatches.value - dispatched_before)
    if not drained:
        raise AssertionError("frontend did not drain")
    for features, result in zip(serial + burst, results):
        if not result.ok:
            raise AssertionError("request failed: %s %s" % (result.status, result.error))
        n = features["image"].shape[0]
        out = result.outputs
        if out["logits"].shape != (n, 10) or out["class_ids"].shape != (n,):
            raise AssertionError("bad output shapes %s" % {k: v.shape for k, v in out.items()})
        if not all(np.all(np.isfinite(v)) for v in out.values()):
            raise AssertionError("non-finite outputs")
        if not np.allclose(out["probabilities"].sum(-1), 1.0, atol=1e-4):
            raise AssertionError("probabilities do not sum to 1")
    programs = batches + 1  # + the gate's smoke sample
    per_program = NUM_MEMBERS * len(sep_shapes)  # 2 x 200 at full width
    expected = {"copy": 1, "combine": programs, "sepconv": per_program * programs}
    if counts != expected:
        raise AssertionError("launch counts %s, expected %s" % (counts, expected))
    print(
        "served: %d requests (%d serial, %d burst), %d batches, all ok; launches %s "
        "= 1 K0, 1 K1 and %d K2 per program call (%d batches + 1 smoke)"
        % (len(results), len(serial), len(burst), batches, counts, per_program, batches)
    )
    stats = {
        "p50_latency_ms": float(np.percentile(latencies, 50)) * 1e3,
        "serial_rows": int(sum(SERIAL_ROWS)),
        "burst_rows_per_s": float(sum(BURST_ROWS) / burst_secs),
        "burst_rows": int(sum(BURST_ROWS)),
        "batches": batches,
    }
    return counts, stats


def profile_batch(gen_dir, rng, batches=3):
    """Where a served batch's time goes: one bucket-32 program call (bf16)
    timed on the host clock without the profiler, then traced with
    torch.profiler: device busy time, kernel launches per batch, the
    device's idle share, and the kernels that take the most time."""
    import torch

    from adanet_tpu_torch.core import export
    from adanet_tpu_torch.serving.model_pool import to_host

    program = export.load_serving_program(gen_dir)
    features = {"image": torch.randn(max(BUCKETS), 32, 32, 3, generator=rng).numpy()}
    for _ in range(2):
        to_host(program(features))
    t0 = time.perf_counter()
    for _ in range(batches):
        to_host(program(features))
    wall_ms = (time.perf_counter() - t0) / batches * 1e3
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            to_host(program(features))
        traced_ms = (time.perf_counter() - t0) / batches * 1e3
    kernels = collections.Counter()
    launches = 0
    for event in prof.events():
        if getattr(event, "device_type", None) == torch.autograd.DeviceType.CUDA:
            # A device event's total is its own elapsed time (us); older
            # torch names it cuda_time_total.
            total = getattr(event, "device_time_total", None)
            kernels[event.name] += event.cuda_time_total if total is None else total
            launches += 1
    device_ms = sum(kernels.values()) / 1e3 / batches
    out = {
        "bucket": max(BUCKETS),
        "wall_ms_per_batch": wall_ms,
        "traced_wall_ms_per_batch": traced_ms,
        "device_busy_ms_per_batch": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "device_idle_share_traced": 1.0 - device_ms / traced_ms,
        "device_kernels_per_batch": launches / batches,
        "top_kernels_ms_per_batch": [
            [name[:80], us / 1e3 / batches] for name, us in kernels.most_common(8)
        ],
    }
    print("profile: " + json.dumps(out))
    return out


def compare_with_cpu(gen_dir, rng):
    """One bucket at f32 compute on the card against the CPU."""
    import torch

    from adanet_tpu_torch.core import export

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    features = {"image": torch.randn(2, 32, 32, 3, generator=rng).numpy()}
    gpu = export.load_serving_program(gen_dir, "cuda", compute_dtype=torch.float32)(features)
    cpu = export.load_serving_program(gen_dir, "cpu", compute_dtype=torch.float32)(features)
    scale = max(1.0, float(cpu["logits"].abs().max()))
    # f32 on both sides; sums in other orders through 20 cells.
    err = check_close("f32 logits card vs cpu", gpu["logits"].cpu(), cpu["logits"], 1e-3 * scale)
    check_close("f32 probabilities card vs cpu", gpu["probabilities"].cpu(), cpu["probabilities"], 1e-4)
    print("f32 bucket-2 logits, card vs cpu: max abs err %.3g (tolerance %.3g)" % (err, 1e-3 * scale))
    return err


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from adanet_tpu_torch.ops import _build

    print(card_line())
    build_kernels()
    _build.self_test()
    rng = torch.Generator().manual_seed(args.seed + 1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as model_dir:
        t0 = time.time()
        gen_dir, sep_shapes = publish(model_dir, args.seed)
        print("published %s in %.1f s" % (os.path.basename(gen_dir), time.time() - t0))
        errors = check_kernels(sep_shapes, rng)
        print("kernel checks passed: max abs err %s" % errors)
        counts, served = serve(model_dir, sep_shapes, rng)
        profile_batch(gen_dir, rng)
        compare_with_cpu(gen_dir, rng)
    rows, per_shape = time_kernels(sep_shapes, rng)
    replaces = {
        "copy": ("adanet_tpu_torch/ops/csrc/copy_kernel.cu", "adanet_tpu/ops/sepconv_kernels.py:68"),
        "combine": ("adanet_tpu_torch/ops/csrc/combine_kernel.cu", "adanet_tpu/ops/ensemble_kernels.py:69"),
        "sepconv": ("adanet_tpu_torch/ops/csrc/sepconv_kernel.cu", "adanet_tpu/ops/sepconv_kernels.py:189"),
    }
    kernels = []
    for name in ("copy", "combine", "sepconv"):
        row = rows[name]
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": replaces[name][0],
                "replaces": replaces[name][1],
                "launches": counts[name],
                "max_abs_err": errors[name],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "timed_at": row["shapes"],
            }
        )
    print("sepconv_shapes: " + json.dumps(per_shape))
    print("served: " + json.dumps(served))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
