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
6. Holds K3, the fused cell, against its plain version on the card, in
   f32 and bf16, at the two `cifar` autotuner cells (batch 64) and at
   every distinct cell signature of NASNet-A (6@768) CIFAR at bucket 32
   (derived from the served model and checked against `CELL_SIGNATURES`),
   with random folded affines; and once its gradients against plain
   autograd through `cell_reference` (f32, a normal and a reduction cell).
7. Second main path, the kernel autotuner: with the launch counts zeroed,
   `adanet_tpu_torch.tools.autotune.main` runs twice on a temporary store
   with `--preset cifar` and must return 1, then 0 with no search; K2 and
   K3 then run at the preset shapes with the stored `tile_p` (checked
   against their plain versions), and the counts must show K2 and K3.
8. Times each kernel, its plain version and the library call that
   computes the same function (K0: `torch.clone`, K1: `torch.einsum`,
   K2: grouped plus 1x1 `F.conv2d`; K3: none, no single PyTorch call
   computes a cell), with CUDA events, and computes each kernel's bound
   from its shapes. K3 per signature in bf16, with its device kernels per
   call, and at the preset cells with the tuned against the default tile.

Prints the per-shape K2 and K3 timings, the served latency and
throughput, a `kernels` JSON line, and as its last line `{"ok": true,
"device": {...}}`. Any failure raises and exits non-zero.
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
# K3: (C_prev, C_cur, filters, cell, H = W) -> cells of one NASNet-A
# (6@768) CIFAR forward with that signature, `prev` already at `cur`'s
# resolution (as the model's factorized reduction of prev leaves it).
CELL_SIGNATURES = {
    (96, 96, 32, "normal", 32): 1,
    (96, 192, 32, "normal", 32): 1,
    (192, 192, 32, "normal", 32): 4,
    (192, 192, 64, "reduction", 32): 1,
    (64, 256, 64, "normal", 16): 1,
    (256, 384, 64, "normal", 16): 1,
    (384, 384, 64, "normal", 16): 4,
    (384, 384, 128, "reduction", 16): 1,
    (128, 512, 128, "normal", 8): 1,
    (512, 768, 128, "normal", 8): 1,
    (768, 768, 128, "normal", 8): 4,
}
# The autotuner's `cifar` cells (prev = cur = [64, 32, 32, 32]).
CELL_PRESET = ((32, 32, 32, "normal", 32), (32, 32, 64, "reduction", 32))
CELL_PRESET_BATCH = 64


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
    nasnet = members[0].subnetwork.module.nasnet
    return path, nasnet.sepconv_launch_shapes(), model_cell_signatures(nasnet)


def model_cell_signatures(nasnet):
    """{(C_prev, C_cur, filters, cell, H): count} of the model's cells,
    with prev as the cell sees it after its own prev reduction."""
    stem = (32, 32, int(nasnet.stem_bn.scale.shape[0]))
    shapes = [None, stem]
    out = collections.Counter()
    for name in nasnet._cells:
        cell = getattr(nasnet, name)
        net, prev = shapes[-1], shapes[-2]
        if cell.prev_mode == "current":
            prev = net
        elif cell.prev_mode == "factorized":
            prev = (net[0], net[1], cell.filters)
        kind = "reduction" if name.startswith("reduction") else "normal"
        out[(prev[2], net[2], cell.filters, kind, net[0])] += 1
        shapes.append(cell.out_shape)
    return dict(out)


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


def make_cell(signature, batch, dtype, gen):
    """prev, cur, params and spec of one K3 signature on the card: inputs
    and weights from `gen`, folded affines scale ~ 1 + N(0, 0.1^2), bias
    ~ N(0, 0.1^2), weights in `dtype` and affines in f32."""
    import torch

    from adanet_tpu_torch.ops import cell_kernels as ck

    cp, cc, f, kind, hw = signature
    spec = {"normal": ck.NORMAL_CELL, "reduction": ck.REDUCTION_CELL}[kind]
    params = ck.init_cell_params(gen, spec, cp, cc, f, dtype=dtype, device="cuda")
    for path, leaf in ck._flatten(params):
        if path[-1] == "scale":
            leaf.copy_(1.0 + 0.1 * torch.randn(leaf.shape, generator=gen))
        elif path[-1] == "bias":
            leaf.copy_(0.1 * torch.randn(leaf.shape, generator=gen))
    prev = torch.randn(batch, hw, hw, cp, generator=gen).to("cuda", dtype)
    cur = torch.randn(batch, hw, hw, cc, generator=gen).to("cuda", dtype)
    return prev, cur, params, spec


def cell_cases():
    """(signature, batch) of every K3 shape the script checks and times."""
    model = [(sig, max(BUCKETS)) for sig in CELL_SIGNATURES]
    return [(sig, CELL_PRESET_BATCH) for sig in CELL_PRESET] + model


def check_cells(gen):
    """K3 against `cell_reference` on the card, f32 and bf16, at every
    case; then its gradients against plain autograd. Returns the worst
    absolute error."""
    import torch

    from adanet_tpu_torch.ops import cell_kernels as ck

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {}
    for signature, batch in cell_cases():
        for dtype in (torch.float32, torch.bfloat16):
            prev, cur, params, spec = make_cell(signature, batch, dtype, gen)
            got = ck.fused_cell(prev, cur, params, spec)
            want = ck.cell_reference(prev, cur, params, spec)
            scale = float(want.float().abs().max())
            if dtype == torch.float32:
                tol = 1e-4 * max(1.0, scale)
            else:
                # One bf16 ulp at the largest output: both sides sum in
                # f32 and round once, in other orders.
                tol = 2.0 ** -7 * scale
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError("K3 %s: %s %s vs %s %s" % (signature, got.shape, got.dtype, want.shape, want.dtype))
            if not torch.isfinite(got.float()).all():
                raise AssertionError("K3 %s %s: non-finite output" % (signature, dtype))
            name = "K3 %s b=%d %s" % (signature, batch, dtype)
            worst[dtype] = max(worst.get(dtype, 0.0), check_close(name, got, want, tol))
    torch.cuda.synchronize()
    print(
        "K3 checked at %d signatures x f32/bf16; worst abs err: f32 %g, bf16 %g"
        % (len(cell_cases()), worst[torch.float32], worst[torch.bfloat16])
    )
    check_cell_grads(gen)
    return max(worst.values())


def check_cell_grads(gen, batch=4):
    """Gradients through `fused_cell` (K3 forward, backward recomputed
    through `cell_reference`) against plain autograd, f32, rtol 1e-4."""
    import torch

    from adanet_tpu_torch.ops import cell_kernels as ck

    for signature in ((96, 96, 32, "normal", 32), (192, 192, 64, "reduction", 32)):
        prev, cur, params, spec = make_cell(signature, batch, torch.float32, gen)
        leaves = [leaf for _, leaf in ck._flatten(params)]
        cot = None
        grads = []
        for fn in (ck.fused_cell, ck.cell_reference):
            inputs = [t.detach().clone().requires_grad_(True) for t in (prev, cur, *leaves)]
            out = fn(inputs[0], inputs[1], ck._unflatten(params, inputs[2:]), spec)
            if cot is None:
                cot = torch.randn(out.shape, generator=gen).cuda()
            grads.append(torch.autograd.grad(out, inputs, cot))
        worst = 0.0
        for got, want in zip(*grads):
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * max(1.0, scale))
            worst = max(worst, float((got - want).abs().max()))
        print("K3 gradients %s: %d tensors match plain autograd (max abs diff %g)" % (signature, len(leaves) + 2, worst))


def cell_work(signature, batch, params, spec, elem_bytes):
    """(bytes, operations) one K3 call needs: prev, cur, the parameters
    and the output moved once each; the 1x1, depthwise and pointwise
    multiply-adds (2 operations each), 9 per pooled value and 1 per
    branch add."""
    from adanet_tpu_torch.ops import cell_kernels as ck

    cp, cc, f, _, hw = signature
    s = spec.stride
    full = batch * hw * hw
    reduced = batch * (-(-hw // s)) ** 2
    flops = 2 * full * cc * f + (2 * full * cp * f if cp != f else 0)
    for b in range(spec.num_blocks):
        for k in range(2):
            idx = spec.hiddenstate_indices[2 * b + k]
            op = spec.operations[2 * b + k]
            stride = s if idx < 2 else 1
            pixels = reduced if (idx >= 2 or stride > 1) else full
            if "separable" in op:
                kernel, layers = ck._parse_separable(op)
                flops += layers * 2 * pixels * (kernel * kernel * f + f * f)
            elif "pool" in op:
                flops += 9 * pixels * f
            elif stride > 1:
                flops += 2 * pixels * f * f
        flops += pixels * f
    for idx, used in enumerate(spec.used_hiddenstates):
        if not used and idx < 2 and s > 1:
            flops += 2 * reduced * f * f
    param_bytes = sum(leaf.numel() * leaf.element_size() for _, leaf in ck._flatten(params))
    num_unused = sum(1 for u in spec.used_hiddenstates if not u)
    nbytes = elem_bytes * full * (cp + cc) + param_bytes + elem_bytes * reduced * f * num_unused
    return nbytes, flops


def device_ms(fn, calls=3):
    """Device time per call of `fn` from a torch.profiler trace: the sum
    of its CUDA kernels' times, in all and by kernel name."""
    import torch

    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for event in prof.events():
        if getattr(event, "device_type", None) == torch.autograd.DeviceType.CUDA:
            total = getattr(event, "device_time_total", None)
            name = event.name.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0]
            by_name[name] += (event.cuda_time_total if total is None else total) / 1e3 / calls
    return sum(by_name.values()), dict(by_name.most_common(6))


def time_cells(gen):
    """K3 per case in bf16: ms per `fused_cell` call, the plain version's
    ms, device kernels per call and the bound; plus the sums over the 20
    cells of one NASNet-A (6@768) forward at bucket 32."""
    import torch

    from adanet_tpu_torch.ops import cell_kernels as ck

    rows = []
    totals = collections.Counter()
    for signature, batch in cell_cases():
        prev, cur, params, spec = make_cell(signature, batch, torch.bfloat16, gen)
        before = ck.fused_cell.device_kernels
        ck.fused_cell(prev, cur, params, spec)
        kernels = ck.fused_cell.device_kernels - before
        nbytes, flops = cell_work(signature, batch, params, spec, 2)
        t_bound, t_by = bound_ms(nbytes, flops, "bfloat16")
        row = dict(
            signature=list(signature),
            batch=batch,
            cells_per_forward=CELL_SIGNATURES.get(signature, 0) if batch == max(BUCKETS) else 0,
            device_kernels_per_call=kernels,
            ms=cuda_time_ms(lambda: ck.fused_cell(prev, cur, params, spec)),
            plain_ms=cuda_time_ms(lambda: ck.cell_reference(prev, cur, params, spec)),
            bound_ms=t_bound,
            bound_by=t_by,
            mbytes=nbytes / 1e6,
            gflop=flops / 1e9,
        )
        row["device_ms"], row["device_ms_by_kernel"] = device_ms(
            lambda: ck.fused_cell(prev, cur, params, spec)
        )
        rows.append(row)
        count = row["cells_per_forward"]
        for key in ("ms", "plain_ms", "bound_ms", "device_ms"):
            totals[key] += count * row[key]
        totals["bytes"] += count * nbytes
        totals["flops"] += count * flops
    byte_ms = totals["bytes"] / PEAK_BYTES_PER_S * 1e3
    flop_ms = totals["flops"] / PEAK_FLOPS["bfloat16"] * 1e3
    total = dict(
        shapes="one NASNet-A (6@768) forward's 20 cells at bucket %d, bf16, default tile"
        % max(BUCKETS),
        ms=totals["ms"],
        plain_ms=totals["plain_ms"],
        library_ms=None,
        bound_ms=totals["bound_ms"],
        bound_by="bytes" if byte_ms >= flop_ms else "operations",
        device_ms=totals["device_ms"],
    )
    return total, rows


def autotune_path(rng):
    """The second main path: the autotuner twice on a fresh store, then
    K2 and K3 at its `cifar` shapes with the stored tiles. Launch counts
    are zeroed just before and read just after. Returns (counts, the
    tuned cases for timing)."""
    import contextlib
    import io

    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.ops import cell_kernels as ck
    from adanet_tpu_torch.ops import sepconv_kernels as sk
    from adanet_tpu_torch.ops import tuning
    from adanet_tpu_torch.store import ArtifactStore
    from adanet_tpu_torch.tools import autotune

    tuned = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as store_dir:
        argv = ["--store", store_dir, "--preset", "cifar", "--json"]
        ops.reset_launch_counts()
        reports = []
        for _ in range(2):
            tuning.clear_cache()
            buf = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(buf):
                rc = autotune.main(argv)
            report = json.loads(buf.getvalue())
            report["secs"] = time.time() - t0
            reports.append((rc, report))
        (rc1, first), (rc2, second) = reports
        if rc1 != 1 or first["searched"] != 4 or first["failed"]:
            raise AssertionError("first autotune run: rc %d, %s" % (rc1, first))
        if rc2 != 0 or second["searched"] != 0 or second["hits"] != 4:
            raise AssertionError("second autotune run: rc %d, %s" % (rc2, second))
        print(
            "autotune: rc %d then %d; searched %d then %d, hits %d then %d; %.1f s then %.1f s"
            % (rc1, rc2, first["searched"], second["searched"], first["hits"], second["hits"],
               first["secs"], second["secs"])
        )
        for entry in first["workloads"]:
            print("autotune sweep %s %s: %s" % (
                entry["kernel"], json.dumps(entry["workload"]),
                json.dumps([[c["tile_p"], c.get("secs"), c.get("error")] for c in entry["candidates"]])))
        tuning.clear_cache()
        tuning.set_default_store(ArtifactStore(store_dir))
        try:
            for entry in second["workloads"]:
                stored = entry["winner"]["tile_p"]
                work = entry["workload"]
                if entry["kernel"] == "sepconv":
                    b, h, w, c = work["shape"]
                    k, f, stride = work["kernel"], work["filters"], work["stride"]
                    x = torch.randn(b, h, w, c, generator=rng).cuda()
                    dw = (torch.randn(c, 1, k, k, generator=rng) / k).cuda()
                    pw = (torch.randn(f, c, 1, 1, generator=rng) / c ** 0.5).cuda()
                    got = sk.fused_sep_conv(x, dw, pw, stride)
                    chose = sk.fused_sep_conv.last_tiles[0]
                    want = sk.sep_conv_reference(x, dw, pw, stride)
                    tuned.append(("sepconv", (x, dw, pw, stride), stored, entry["workload"]))
                else:
                    b, hw, _, c = work["shape"]
                    signature = (c, c, work["filters"], work["spec"], hw)
                    prev, cur, params, spec = make_cell(signature, b, torch.float32, rng)
                    got = ck.fused_cell(prev, cur, params, spec)
                    chose = ck.fused_cell.last_tile_p
                    want = ck.cell_reference(prev, cur, params, spec)
                    tuned.append(("cell", (prev, cur, params, spec), stored, entry["workload"]))
                err = check_close(
                    "%s at its tuned tile" % entry["kernel"], got, want,
                    1e-4 * max(1.0, float(want.abs().max())),
                )
                print("tuned %s %s: tile_p %d chosen, %d stored; max abs err %g"
                      % (entry["kernel"], json.dumps(work), chose, stored, err))
                if chose != stored:
                    raise AssertionError("%s ran with tile_p %d, the store holds %d" % (entry["kernel"], chose, stored))
        finally:
            tuning.set_default_store(None)
            tuning.clear_cache()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    if counts["cell"] < 1 or counts["sepconv"] < 1:
        raise AssertionError("the autotune path launched %s" % counts)
    print("autotune path launches: %s" % counts)
    return counts, tuned


def time_tuned(tuned):
    """At each preset shape: ms at the stored tile against the default."""
    from adanet_tpu_torch.ops import cell_kernels as ck
    from adanet_tpu_torch.ops import sepconv_kernels as sk

    rows = []
    for kernel, args, stored, workload in tuned:
        if kernel == "sepconv":
            x, dw, pw, stride = args
            c, f, k = x.shape[-1], pw.shape[0], dw.shape[-1]

            def run(tile_p):
                return lambda: sk._launch(x, dw, pw, stride, sk.tiles(c, f, k, tile_p))

            default = sk.DEFAULT_TILE_P
        else:
            prev, cur, params, spec = args

            def run(tile_p):
                return lambda: ck._launch(prev, cur, params, spec, tile_p)

            default = ck.DEFAULT_TILE_P
        rows.append(
            dict(
                kernel=kernel,
                workload=workload,
                tuned_tile_p=stored,
                tuned_ms=cuda_time_ms(run(stored)),
                default_tile_p=default,
                default_ms=cuda_time_ms(run(default)),
            )
        )
    print("tuned_vs_default: " + json.dumps(rows))
    return rows


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
    expected = {"copy": 1, "combine": programs, "sepconv": per_program * programs, "cell": 0}
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
        gen_dir, sep_shapes, cell_signatures = publish(model_dir, args.seed)
        print("published %s in %.1f s" % (os.path.basename(gen_dir), time.time() - t0))
        if cell_signatures != CELL_SIGNATURES:
            raise AssertionError("the model's cells %s differ from CELL_SIGNATURES" % cell_signatures)
        errors = check_kernels(sep_shapes, rng)
        errors["cell"] = check_cells(rng)
        print("kernel checks passed: max abs err %s" % errors)
        counts, served = serve(model_dir, sep_shapes, rng)
        tune_counts, tuned = autotune_path(rng)
        profile_batch(gen_dir, rng)
        compare_with_cpu(gen_dir, rng)
    rows, per_shape = time_kernels(sep_shapes, rng)
    rows["cell"], cell_rows = time_cells(rng)
    time_tuned(tuned)
    # Each kernel's launches on the main path that runs it: serving for
    # K0-K2, the autotuner for K3.
    counts = dict(counts, cell=tune_counts["cell"])
    replaces = {
        "copy": ("adanet_tpu_torch/ops/csrc/copy_kernel.cu", "adanet_tpu/ops/sepconv_kernels.py:68"),
        "combine": ("adanet_tpu_torch/ops/csrc/combine_kernel.cu", "adanet_tpu/ops/ensemble_kernels.py:69"),
        "sepconv": ("adanet_tpu_torch/ops/csrc/sepconv_kernel.cu", "adanet_tpu/ops/sepconv_kernels.py:189"),
        "cell": ("adanet_tpu_torch/ops/csrc/cell_kernel.cu", "adanet_tpu/ops/cell_kernels.py:519"),
    }
    kernels = []
    for name in ("copy", "combine", "sepconv", "cell"):
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
    print("cell_shapes: " + json.dumps(cell_rows))
    print("cell_forward: " + json.dumps(rows["cell"]))
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
