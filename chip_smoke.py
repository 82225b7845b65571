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
   f32 (cuDNN TF32 off for the f32 plain version). K1 also at N = 2 and
   8 for each bucket and at the byte-bound [4, 4096, 1001] f32 and
   [4, 8192, 1001] bf16: f32 and bf16 logits, scalar and vector weights,
   with and without bias, through both entry points (stacked, and the
   members as separate tensors); then a misaligned member and N = 500;
   and at the search's own [1, 128, 10] and [2, 128, 10] f32 with and
   without bias, through one 0-d weight a member and a stacked [N]
   weight tensor, and under autograd (`_CombineMembers`) with its
   gradients against autograd through `combine_reference`.
4. Main path at full width: a two-member NASNet-A (6@768) CIFAR ensemble
   (18 cells, 32 filters, bf16, fused sep-conv, SCALAR fused combine),
   weights from a seeded `torch.Generator`, batch-norm statistics random
   with count 1, fixed mixture weights. It publishes `gen-1`, serves mixed
   requests of 1 to 32 rows through ServingFrontend -> Batcher ->
   ModelPool, checks every result is ok, finite and well formed, and
   checks the launch counts (zeroed just before): one K0 per gated
   generation, one K1 per executed program call, 400 K2 per K1. A last
   burst runs twice with an empty tuning store registered (no serving
   winners), so that the tuning lookup's cost shows: one store read per
   K2 signature in the first, none for a signature already planned.
5. Compares one bucket, loaded at f32 compute, on the card against the
   same generation loaded with device="cpu".
6. Holds K3, the fused cell, against its plain version on the card, in
   f32 and bf16, at the two `cifar` autotuner cells (batch 64) and at
   every distinct cell signature of NASNet-A (6@768) CIFAR at bucket 32
   (derived from the served model and checked against `CELL_SIGNATURES`),
   with random folded affines, at two small cells that factorize-reduce
   an input (one at odd widths) and at a fixed tile; and once its
   gradients against plain autograd through `cell_reference` (f32, a
   normal and a reduction cell). Every K3 launch at the 13 cases has at
   least one block per SM (its planned schedule).
7. Second main path, the kernel autotuner: with the launch counts zeroed,
   `adanet_tpu_torch.tools.autotune.main` runs twice on a temporary store
   with `--preset cifar` and must return 1, then 0 with no search; K2 and
   K3 then run at the preset shapes with the stored `tile_p` (checked
   against their plain versions), and the counts must show K2 and K3.
8. Times each kernel, its plain version and the library call that
   computes the same function (K0: `torch.clone`, K1: `torch.einsum`,
   K2: grouped plus 1x1 `F.conv2d`; K3: none, no single PyTorch call
   computes a cell), with CUDA events, and computes each kernel's bound
   from its shapes. K2 per shape also with its device time from
   torch.profiler at buckets 32 and 1 and its grid's block count. The
   host's enqueue time per call (a host clock over 1000 calls, no
   synchronize) of K0, `torch.clone`, one K2 launch and one K3 call. K3
   per signature in bf16: CUDA-event and device ms, device ms by kernel
   (separable layer, 1x1, pool/copy, cast), launches and the fewest
   blocks a launch, host us per call, against the bound; a bf16 call's
   trace must hold K3's kernels only. The sum over one forward's 20
   cells is printed beside the first K3 design's (`FIRST_K3_FORWARD`).
   At the preset cells, the tuned against the default tile. K1 per
   shape (`combine_shapes:`), at buckets 32 and 1 as served and at the
   byte-bound shapes: CUDA-event ms, device us (torch.profiler), host
   enqueue us, plain and `torch.einsum` ms, bound and device / bound;
   K0's and `torch.clone`'s device us.
9. Traces one served `build_ensemble` on the served generation's member
   outputs: one K1 launch and no stack or cast kernel (the complexity
   term's zero fill may remain), no weight prepared.
10. Holds K2's gradients, through `fused_sep_conv` (K2 forward, backward
   recomputed through `sep_conv_reference`), against plain autograd at
   its 14 model shapes, f32 (`check_sepconv_grads`).
11. Third main path, the AdaNet search (`train_search`): the tier-1
   gate's configuration at full width (simple_dnn on the synthetic
   digits, 4096 training and 1024 test examples, batch 128, 128 wide,
   adam 1e-3 for the subnetworks and the mixture weights, 2 iterations x
   400 steps), through `Estimator.train` and `Estimator.evaluate` with
   `use_fused_combine=True`, launch counts zeroed just before and read
   just after: accuracy >= 0.88, both architectures written, and one K1
   launch per ensemble candidate a step plus one per eval batch. A
   window of the search's own iteration 1 is timed (host clock and CUDA
   events at the batch pulls of its input_fn), and five later steps of it
   traced (device busy, idle share, kernels and K1 launches a step).
12. `train_vs_cpu`: the same converted init (`initial_variables`) and
   batches through 2 iterations x 50 steps on the card (K1) and on the
   CPU (plain version), TF32 off: per-step losses and mixture weights
   within atol 1e-4 x max(1, |value|), the same best candidates.
13. Fourth main path, NASNet training (`train_nasnet`): NASNet-A (6@768)
   CIFAR at the improve_nas `Hparams()` defaults (aux head, drop-path
   0.6, label smoothing, weight decay, clipping, bf16, K2 on), ADAPTIVE
   distillation, momentum with a cosine schedule (`fn_with_name`), batch
   32 of fake 32 x 32 x 3 images, 2 iterations x 20 steps through
   `Estimator.train` with the `Generator`, then `evaluate`; launch counts
   zeroed just before and read just after must be exact (K2: 200 a
   member forward; K1: one an ensemble update, the teacher's, one an
   eval batch), every loss finite, both architectures written. Prints
   `train_nasnet:` (ms a step by the host clock and CUDA events over
   steps 24-33, device busy and idle share, kernels, K2 launches and
   K2's forward and `_FusedSepConv` backward device ms a step over 3
   traced steps, peak memory, the card line).
14. `nasnet_gate`: the flagship-family gate (tests/test_convergence.py:
   119-157, 3 cells, 8 filters, bf16, 300 steps of adam on 8192 digits)
   with K2 and K1 on: accuracy >= 0.88 and above 0.76, exact counts.
15. `nasnet_train_vs_cpu`: the gate model in f32 with the
   `DynamicGenerator` (widths that are not multiples of 8) on the card
   and on the CPU, 2 iterations x 4 steps with the trainer's momentum
   and one training step of each architecture. `replayed` (K2 off, the
   CPU's relu and max-pool switches taken on the card): losses and
   mixture weights within atol 1e-4 x max(1, |value|), the same
   selection, each gradient within 1e-5 of its norm. `as_run` (K2 on):
   within 5e-3 x max(1, |value|) and 5e-3 of the norm, the gap the
   switches make. Loss and logits of a step within atol 1e-5 x max(1,
   |value|). Then K2 forward and gradient against the plain version at
   every (shape, batch, dtype) phases 13-15 launch, and the trainer CLI
   on the card at a small size.
16. `resume_nasnet`, after phase 13 (its configuration, 2 iterations x
   10 steps, a checkpoint every 5, one fixed batch): a search stopped by
   max_steps at global step 13 is rebuilt and restored by a fresh
   Estimator, every tensor of the state bitwise equal to the live one
   (the CUDA generator's state included); two uninterrupted runs and
   the stopped one resumed: the same architecture files byte for byte,
   `frozen-1.pt` bitwise equal if the two uninterrupted runs are, else
   within twice their spread, the resumed run's K1 and K2 counts exact
   (zeroed just before its train(), read after its evaluate()); the
   trainer CLI in a subprocess, SIGTERMed inside iteration 1, exits 0
   with a mid-iteration checkpoint and a second run resumes it to the
   end. Prints `resume_nasnet:` (bytes of `ckpt-13.pt` and `frozen-0.pt`,
   ms a save split into device-to-host, serialise, digest and write
   with fsync, ms a restore, a save's share of a step, the deviations,
   the phase's seconds, the card line).
17. `windows_vs_steps`: the gate model (3 cells, 8 filters, bf16, K2
   on) over 2 iterations x 16 steps in windows of 8 with device prefetch
   (W), against two runs of single steps without prefetch (A, B): W's
   `frozen-1.pt` bitwise equal to A's if B's is, else within twice B's
   deviation; equal launch counts; ms a step of each. This phase and
   phase 16 run with cuDNN held to its deterministic algorithms
   (`deterministic_cudnn`), under which their runs are bitwise equal.
18. `nasnet_gate_bf16`: `nasnet_gate` under the bf16 step policy and
   device prefetch (tests/test_convergence.py::
   test_nasnet_family_converges_bf16_steps): accuracy >= 0.88, exact
   counts, no prefetcher left open.
19. Fifth main path, NASNet-A Mobile (`train_nasnet_mobile`): the
   ImageNet stem, 12 cells, 44 filters, 1001 classes, 224 x 224 x 3
   images from --seed, batch 32, through `TPUEstimator` (windows of 8,
   bf16 steps, device prefetch, a checkpoint every 8 steps), 2 x 16
   steps, then `evaluate` and `predict` of 32 + 32 + 7 rows padded to 32
   (against unpadded); exact K1 and K2 counts (160 K2 a member
   forward); `train_nasnet_mobile:` prints ms a step by the host clock
   and CUDA events over iteration 1's first window, device busy ms, the
   idle share and kernels a step over its second (`utils.device_timing`),
   the peak memory and a 224 x 224 batch's copy to the card, pinned and
   pageable. K1 is then held at [1|2, 32, 1001] forward and backward,
   and K2 forward and gradient at every (shape, batch) this path
   launches (batches 32 and 7, C = 11 to 176).

Prints the per-shape K2 and K3 timings, the served latency and
throughput, the `train:`, `train_nasnet:`, `resume_nasnet:` and
`nasnet_gate:` lines, a `kernels` JSON line (K1's row also with its
launches on the search paths, K2's with its launches on the NASNet
training paths, `train_launches`; both with `resume_launches`,
`nasnet_gate_bf16_launches` and `nasnet_mobile_launches`),
and as its last line `{"ok": true, "device": {...}}`. Any failure raises
and exits non-zero.
"""

import argparse
import collections
import contextlib
import json
import math
import os
import signal
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
# K1 beyond serving: the NASNet ImageNet head's 1001 classes at sizes
# whose 82 MB exceed the 50 MB L2, so that device memory bounds them:
# (members, rows, classes, logits dtype).
COMBINE_BYTE_BOUND = ((4, 4096, 1001, "float32"), (4, 8192, 1001, "bfloat16"))
# K1 member counts checked at each bucket; 500 is past the kernel's
# pointer table (448), where the members are stacked first.
COMBINE_MEMBERS = (2, 8)
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
# K3's CUDA kernels, as torch.profiler names them.
CELL_KERNELS = ("sep_layer_kernel", "conv1x1_kernel", "pool_kernel", "cast_bf16_kernel")
# The first K3 design (18 launches a cell on CUDA cores, 64-pixel tiles)
# over one forward's 20 cells at bucket 32, bf16, on an H100 80GB HBM3
# at 700 W (PERF.md, "K3 per signature"): the yardstick of this one.
FIRST_K3_FORWARD = {"ms": 23.73, "device_ms": 20.80}
# The search path: tests/test_convergence.py::test_search_beats_linear_baseline.
TRAIN_EXAMPLES, EVAL_EXAMPLES, TRAIN_BATCH = 4096, 1024, 128
TRAIN_STEPS, TRAIN_ITERATIONS, LAYER_SIZE = 400, 2, 128
GATE_ACCURACY, LINEAR_BASELINE_ACCURACY = 0.88, 0.76
# Steps of iteration 1 timed, and traced, on the card.
STEP_WINDOW, TRACED_STEPS = 100, 5
# train_vs_cpu: steps per iteration.
PARITY_STEPS = 50
# Member counts of the search's combines: the carried-over winner of a
# one-member iteration 0 (no grad) and a grown candidate (under autograd).
SEARCH_COMBINE_MEMBERS = (1, 2)
# NASNet-A (6@768) training, the flagship: research/improve_nas Hparams()
# defaults (drop-path over the run's 40 steps, as the trainer sets
# total_training_steps), ADAPTIVE distillation, momentum with a cosine
# schedule, batch 32 (trainer.py's --batch_size), fake 32 x 32 x 3 images.
NASNET_BATCH, NASNET_STEPS, NASNET_ITERATIONS, NASNET_EXAMPLES = 32, 20, 2, 256
NASNET_WINDOW, NASNET_TRACED = 10, 3
# resume_nasnet: train_nasnet's configuration, 2 iterations of
# RESUME_STEPS with a checkpoint every RESUME_SAVE_EVERY steps, stopped at
# global step RESUME_STOP (inside iteration 1); saves and restores timed
# RESUME_SAVES times (medians), steps over a window of RESUME_WINDOW.
RESUME_STEPS, RESUME_SAVE_EVERY, RESUME_STOP, RESUME_SAVES, RESUME_WINDOW = 10, 5, 13, 3, 3
# The trainer CLI's small size (trainer_on_card), and the steps of its
# SIGTERM run (two iterations of half as many).
TRAINER_SMALL = ["--dataset=fake", "--num_cells=3", "--num_conv_filters=4", "--batch_size=16"]
TRAINER_SIGTERM_STEPS = 200
# The flagship-family gate (tests/test_convergence.py:119-157): 3 cells,
# 8 filters, on the digits; adam 1e-3.
GATE_TRAIN, GATE_TEST, GATE_STEPS = 8192, 2048, 300
# nasnet_train_vs_cpu: the gate model (DynamicGenerator, f32, drop-path
# off), steps per iteration and batch.
NASNET_PARITY_STEPS, NASNET_PARITY_BATCH = 4, 32
# train_nasnet_mobile: NASNet-A Mobile (12 cells, 44 filters, the ImageNet
# stem, 1001 classes; the improve_nas defaults otherwise, ADAPTIVE) on
# 224 x 224 x 3 images drawn from --seed, batch 32, 2 iterations x 16
# steps through TPUEstimator in windows of 8, a checkpoint every 8, bf16
# steps and device prefetch; then predict over a ragged stream of
# 32 + 32 + 7 rows padded to 32. Iteration 1's first window is timed,
# its second traced (windows 2 and 3 of the run).
MOBILE_SIZE, MOBILE_CLASSES, MOBILE_BATCH, MOBILE_EXAMPLES = 224, 1001, 32, 128
MOBILE_STEPS, MOBILE_WINDOW, MOBILE_EVAL_BATCHES = 16, 8, 2
MOBILE_PREDICT_ROWS = (32, 32, 7)
MOBILE_TIMED_WINDOW, MOBILE_TRACED_WINDOW = 2, 3
# windows_vs_steps: the gate model, 2 iterations x WINDOWS_STEPS, windows
# of 8 with device prefetch against single steps without.
WINDOWS_STEPS = 16
# nasnet_train_vs_cpu: one step's gradient, card against CPU, in parts of
# its norm: as run (K2 on; measured up to 2.3e-3, the relu and max-pool
# switches), and with the CPU's switches replayed on the card (K2 off).
NASNET_AS_RUN_GRAD, NASNET_REPLAYED_GRAD = 5e-3, 1e-5


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


def host_enqueue_us(fn, calls=1000):
    """Host time per call to enqueue `fn`: a host clock over `calls`
    calls with no synchronize inside (the queue drained before)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


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


def combine_inputs(n, b, c, dtype, vector, use_bias, gen):
    """Member logits (separate tensors), one f32 weight tensor per member
    ([] or [C]) and a bias, on the card."""
    import torch

    members = [torch.randn(b, c, generator=gen).to("cuda", dtype) for _ in range(n)]
    weights = [torch.randn((c,) if vector else (), generator=gen).cuda() for _ in range(n)]
    bias = torch.randn(c, generator=gen).cuda() if use_bias else None
    return members, weights, bias


def combine_tolerance(want):
    """f32: atol 1e-5 x max(1, max|ref|) (the kernel's unfused products
    and sums are the plain version's; the bound allows for FMA
    contraction). bf16: one bf16 ulp of the largest output, 2^-7 x
    max|ref|: both sum in f32 and round once."""
    import torch

    scale = float(want.float().abs().max())
    return 1e-5 * max(1.0, scale) if want.dtype == torch.float32 else 2.0 ** -7 * scale


def check_combine(gen):
    """K1 against its plain version on the card: at each bucket for N = 2
    and 8, and at the byte-bound shapes; f32 and bf16 logits, scalar and
    vector weights, with and without bias; through both entry points
    (the stacked tensor with [N] / [N, C] weights, and the members as
    separate tensors with one weight tensor each, as the ensembler hands
    them). Then a member that is not 16-byte aligned (the scalar
    variant) and N = 500 (stacked past the pointer table). Returns the
    worst absolute error by dtype and the number of cases."""
    import torch

    from adanet_tpu_torch.ops import ensemble_kernels as ek

    shapes = [(n, b, 10, dtype) for b in BUCKETS for n in COMBINE_MEMBERS
              for dtype in ("float32", "bfloat16")]
    worst = collections.Counter()
    cases = 0
    for n, b, c, dtype_name in shapes + list(COMBINE_BYTE_BOUND):
        dtype = getattr(torch, dtype_name)
        for vector in (False, True):
            for use_bias in (False, True):
                members, weights, bias = combine_inputs(n, b, c, dtype, vector, use_bias, gen)
                stacked, w = torch.stack(members), torch.stack(weights)
                want = ek.combine_reference(stacked, w, bias)
                tol = combine_tolerance(want)
                for form, got in (
                    ("stacked", ek.fused_weighted_combine(stacked, w, bias)),
                    ("members", ek.fused_weighted_combine_members(members, weights, bias)),
                ):
                    name = "K1 %s [%d, %d, %d] %s vector=%s bias=%s" % (
                        form, n, b, c, dtype_name, vector, use_bias)
                    if got.dtype != dtype or got.shape != want.shape:
                        raise AssertionError("%s: %s %s" % (name, got.dtype, tuple(got.shape)))
                    worst[dtype_name] = max(worst[dtype_name], check_close(name, got, want, tol))
                    cases += 1
    for n, b, offset in ((2, 32, 1), (500, 3, 0)):
        for dtype in (torch.float32, torch.bfloat16):
            members, weights, bias = combine_inputs(n, b, 10, dtype, True, True, gen)
            if offset:
                buf = torch.empty(n, b * 10 + offset, dtype=dtype, device="cuda")
                for i, m in enumerate(members):
                    buf[i, offset:] = m.reshape(-1)
                members = [buf[i, offset:].view(b, 10) for i in range(n)]
            got = ek.fused_weighted_combine_members(members, weights, bias)
            want = ek.combine_reference(members, torch.stack(weights), bias)
            name = "K1 members [%d, %d, 10] %s at offset %d" % (n, b, dtype, offset)
            worst[str(dtype).replace("torch.", "")] = max(
                worst[str(dtype).replace("torch.", "")], check_close(name, got, want, combine_tolerance(want)))
            cases += 1
    grads = 0.0
    for batch in (TRAIN_BATCH, NASNET_BATCH):
        for n in SEARCH_COMBINE_MEMBERS:
            for use_bias in (False, True):
                err, grad_err = check_search_combine(n, use_bias, gen, batch)
                worst["float32"] = max(worst["float32"], err)
                grads = max(grads, grad_err)
                cases += 3
    torch.cuda.synchronize()
    print("K1 checked at %d cases (buckets x N %s, %s, a misaligned member, N = 500, the searches' "
          "[N %s, %d | %d, 10] forward and backward); worst abs err: %s, gradients %g"
          % (cases, COMBINE_MEMBERS, COMBINE_BYTE_BOUND, SEARCH_COMBINE_MEMBERS, TRAIN_BATCH, NASNET_BATCH,
             dict(worst), grads))
    return dict(worst), cases


def check_search_combine(n, use_bias, gen, batch=TRAIN_BATCH, classes=10):
    """K1 as the search's ensemble update calls it, at [N, batch, classes] f32
    with scalar weights: through the members form with one 0-d
    weight per member and with the stacked [N] weights that
    `_CombineMembers` hands on, then under autograd (weights, bias and
    members requiring grad, as `_CombineMembers.apply`) with its
    gradients held against autograd through `combine_reference`, each
    within `combine_tolerance` of its reference. Returns the worst
    forward and gradient errors."""
    import torch

    from adanet_tpu_torch.ops import ensemble_kernels as ek

    members, weights, bias = combine_inputs(n, batch, classes, torch.float32, False, use_bias, gen)
    stacked_w = torch.stack(weights)
    want = ek.combine_reference(torch.stack(members), stacked_w, bias)
    tol = combine_tolerance(want)
    name = "K1 search [%d, %d, %d] bias=%s" % (n, batch, classes, use_bias)
    err = 0.0
    for form, w in (("one weight a member", weights), ("stacked [N]", stacked_w)):
        got = ek.fused_weighted_combine_members(members, w, bias)
        err = max(err, check_close("%s, %s" % (name, form), got, want, tol))
    inputs = {}
    for side in ("kernel", "reference"):
        inputs[side] = [t.clone().requires_grad_(True) for t in members + weights + ([bias] if use_bias else [])]
    x = inputs["kernel"]
    before = ek.fused_weighted_combine.launches
    got = ek.fused_weighted_combine_members(x[:n], x[n:2 * n], x[2 * n] if use_bias else None)
    if ek.fused_weighted_combine.launches != before + 1 or type(got.grad_fn).__name__ != "_CombineMembersBackward":
        raise AssertionError("%s: no K1 launch through _CombineMembers (%s)" % (name, got.grad_fn))
    r = inputs["reference"]
    ref = ek.combine_reference(torch.stack(r[:n]), torch.stack(r[n:2 * n]), r[2 * n] if use_bias else None)
    err = max(err, check_close("%s under autograd" % name, got, ref, tol))
    cot = torch.randn(got.shape, generator=gen).cuda()
    grad_err = 0.0
    labels = ["d member %d" % i for i in range(n)] + ["d weight %d" % i for i in range(n)] + ["d bias"]
    for label, g, w in zip(labels, torch.autograd.grad(got, x, cot), torch.autograd.grad(ref, r, cot)):
        grad_err = max(grad_err, check_close("%s %s" % (name, label), g, w, combine_tolerance(w)))
    return err, grad_err


def combine_work(n, b, c, elem, vector, use_bias):
    """(bytes, operations) of one K1 call: the members read and the
    output written once, f32 weights and bias read once; a multiply and
    an add per member and element, an add per element for the bias."""
    nbytes = elem * (n + 1) * b * c + 4 * (n * c if vector else n) + (4 * c if use_bias else 0)
    return nbytes, 2 * n * b * c + (b * c if use_bias else 0)


def time_combine(gen):
    """K1 per shape: the served call ([2, 32, 10] and [2, 1, 10] f32,
    scalar weights, no bias, members as the ensembler hands them) and
    the byte-bound shapes (scalar weights without bias, and vector
    weights with bias). Per row: CUDA-event ms, device us from
    torch.profiler (queued-behind-a-sleep events where the tracer gives
    nothing), host enqueue us (also with the calls inside
    `torch.inference_mode`, as the served program makes them), the plain
    version's ms, `torch.einsum`'s ms on the stacked logits (weights in
    the logits' dtype: einsum takes one), the bound and device / bound,
    the plan's blocks, and the stacked form's CUDA-event ms."""
    import torch

    from adanet_tpu_torch.ops import ensemble_kernels as ek

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(NUM_MEMBERS, max(BUCKETS), 10, "float32", False, False),
             (NUM_MEMBERS, 1, 10, "float32", False, False),
             (NUM_MEMBERS, MOBILE_BATCH, MOBILE_CLASSES, "float32", False, False)]
    for n, b, c, dtype_name in COMBINE_BYTE_BOUND:
        cases += [(n, b, c, dtype_name, False, False), (n, b, c, dtype_name, True, True)]
    rows = []
    for n, b, c, dtype_name, vector, use_bias in cases:
        dtype = getattr(torch, dtype_name)
        members, weights, bias = combine_inputs(n, b, c, dtype, vector, use_bias, gen)
        stacked, w = torch.stack(members), torch.stack(weights)
        w_lib = w.to(dtype)
        big = b * c > 1 << 16
        iters = 50 if big else 100

        def kernel():
            return ek.fused_weighted_combine_members(members, weights, bias)

        def stacked_kernel():
            return ek.fused_weighted_combine(stacked, w, bias)

        def plain():
            return ek.combine_reference(stacked, w, bias)

        spec = "nbc,nc->bc" if vector else "nbc,n->bc"

        def library():
            return torch.einsum(spec, stacked, w_lib)

        # Kernel and library call in turns (kernel, library, library, kernel).
        first = cuda_time_ms(kernel, iters=iters)
        lib = [cuda_time_ms(library, iters=iters), cuda_time_ms(library, iters=iters)]
        ms = (first + cuda_time_ms(kernel, iters=iters)) / 2
        device, by_name, source = device_ms(kernel, calls=10, expect="combine_kernel")
        if set(by_name) - {"combine_kernel"}:
            raise AssertionError("a K1 call ran other kernels: %s" % by_name)
        with torch.inference_mode():  # as the served program calls it
            host_inference = host_enqueue_us(kernel, calls=200 if big else 1000)
        nbytes, flops = combine_work(n, b, c, 2 if dtype == torch.bfloat16 else 4, vector, use_bias)
        t_bound, t_by = bound_ms(nbytes, flops, "float32")
        plan = ek.launch_plan(n, b, c, dtype, vector, use_bias, False)
        rows.append(
            dict(
                shape=[n, b, c], dtype=dtype_name, weights="vector" if vector else "scalar",
                bias=use_bias, ms=ms, stacked_ms=cuda_time_ms(stacked_kernel, iters=iters),
                device_us=device * 1e3, device_source=source,
                queued_device_us=queued_device_ms(kernel) * 1e3,
                host_us=host_enqueue_us(kernel, calls=200 if big else 1000),
                host_us_inference=host_inference,
                plain_ms=cuda_time_ms(plain, iters=iters), einsum_ms=sum(lib) / 2,
                bound_ms=t_bound, bound_by=t_by, mbytes=nbytes / 1e6,
                device_over_bound=device / t_bound, blocks=plan.wide["blocks"],
            )
        )
    print("combine_shapes: " + json.dumps(rows))
    return rows


def make_cell(signature, batch, dtype, gen):
    """prev, cur, params and spec of one K3 signature on the card: inputs
    and weights from `gen`, folded affines scale ~ 1 + N(0, 0.1^2), bias
    ~ N(0, 0.1^2), weights in `dtype` and affines in f32."""
    import torch

    from adanet_tpu_torch.ops import cell_kernels as ck

    cp, cc, f, kind, hw = signature
    spec = {"normal": ck.NORMAL_CELL, "reduction": ck.REDUCTION_CELL}[kind]
    params = ck.init_cell_params(gen, spec, cp, cc, f, dtype=dtype, device="cuda")
    randomize_affines(params, gen)
    prev = torch.randn(batch, hw, hw, cp, generator=gen).to("cuda", dtype)
    cur = torch.randn(batch, hw, hw, cc, generator=gen).to("cuda", dtype)
    return prev, cur, params, spec


def randomize_affines(params, gen):
    """Folded affines of a K3 parameter tree: scale ~ 1 + N(0, 0.1^2),
    bias ~ N(0, 0.1^2)."""
    import torch

    from adanet_tpu_torch.ops import cell_kernels as ck

    for path, leaf in ck._flatten(params):
        if path[-1] == "scale":
            leaf.copy_(1.0 + 0.1 * torch.randn(leaf.shape, generator=gen))
        elif path[-1] == "bias":
            leaf.copy_(0.1 * torch.randn(leaf.shape, generator=gen))


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
    # Paths the model's cells do not take: a factorized reduction of an
    # unused input (shifted 1x1, half-F slots) on an odd 9x9 input, at
    # aligned widths and at widths that take the element-load paths.
    spec = ck.CellSpec(
        operations=("separable_3x3_1", "max_pool_3x3", "none", "avg_pool_3x3"),
        hiddenstate_indices=(0, 1, 0, 1),
        used_hiddenstates=(0, 1, 0, 0),
        stride=2,
    )
    for f, cp, cc in ((8, 6, 8), (6, 5, 7)):
        for dtype in (torch.float32, torch.bfloat16):
            params = ck.init_cell_params(gen, spec, cp, cc, f, dtype=dtype, device="cuda")
            randomize_affines(params, gen)
            prev = torch.randn(3, 9, 9, cp, generator=gen).to("cuda", dtype)
            cur = torch.randn(3, 9, 9, cc, generator=gen).to("cuda", dtype)
            got = ck.fused_cell(prev, cur, params, spec)
            want = ck.cell_reference(prev, cur, params, spec)
            scale = float(want.float().abs().max())
            tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2.0 ** -7 * scale
            name = "K3 factorized F=%d Cp=%d Cc=%d %s" % (f, cp, cc, dtype)
            worst[dtype] = max(worst[dtype], check_close(name, got, want, tol))
    # A fixed tile, as a tuned one is launched: the autotuner's smallest.
    for dtype in (torch.float32, torch.bfloat16):
        prev, cur, params, spec = make_cell(CELL_PRESET[1], CELL_PRESET_BATCH, dtype, gen)
        got = ck._launch(prev, cur, params, spec, 16)
        want = ck.cell_reference(prev, cur, params, spec)
        scale = float(want.float().abs().max())
        tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2.0 ** -7 * scale
        worst[dtype] = max(worst[dtype], check_close("K3 %s at tile_p 16 %s" % (CELL_PRESET[1], dtype), got, want, tol))
    torch.cuda.synchronize()
    print(
        "K3 checked at %d signatures x f32/bf16, 2 factorized cells and tile_p 16; "
        "worst abs err: f32 %g, bf16 %g"
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


def device_ms(fn, calls=3, expect=None, attempts=3):
    """Device time per call of `fn` from a torch.profiler trace: the sum
    of its CUDA kernels' times, in all and by kernel name, and the
    source "profiler". A trace that holds no kernel (of the name
    `expect`, if given) is taken again, up to `attempts` traces; if none
    holds one (the card's tracer delivered nothing), the time comes from
    `queued_device_ms` instead, with the source "queued events"."""
    import torch

    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
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
        if by_name and (expect is None or any(expect in name for name in by_name)):
            return sum(by_name.values()), dict(by_name.most_common()), "profiler"
    return queued_device_ms(fn), {}, "queued events"


def queued_device_ms(fn, calls=50):
    """Device time per call of `fn` from CUDA events around `calls`
    calls queued behind a sleeping kernel, so that they run back to back
    whatever the host's enqueue time (a cross-check of `device_ms`)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(5e6))  # a few ms of device time, longer than the enqueue
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def time_cells(gen):
    """K3 per case in bf16: ms per `fused_cell` call, the plain version's
    ms, device kernels per call, the fewest blocks a launch, host us per
    call and the bound; plus the sums over the 20 cells of one NASNet-A
    (6@768) forward at bucket 32. Returns (forward sums, rows, host us
    of one call at the widest 8x8 signature)."""
    import torch

    from adanet_tpu_torch.ops import cell_kernels as ck

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    totals = collections.Counter()
    by_kernel = collections.Counter()
    host = {}
    for signature, batch in cell_cases():
        prev, cur, params, spec = make_cell(signature, batch, torch.bfloat16, gen)

        def call():
            return ck.fused_cell(prev, cur, params, spec)

        before = ck.fused_cell.device_kernels
        call()
        kernels = ck.fused_cell.device_kernels - before
        sched = ck.schedule_for(prev, cur, params, spec)
        if sched.min_blocks < sms:
            raise AssertionError("K3 %s: a launch of %d blocks < %d SMs" % (signature, sched.min_blocks, sms))
        nbytes, flops = cell_work(signature, batch, params, spec, 2)
        t_bound, t_by = bound_ms(nbytes, flops, "bfloat16")
        row = dict(
            signature=list(signature),
            batch=batch,
            cells_per_forward=CELL_SIGNATURES.get(signature, 0) if batch == max(BUCKETS) else 0,
            device_kernels_per_call=kernels,
            min_blocks=sched.min_blocks,
            ms=cuda_time_ms(call),
            plain_ms=cuda_time_ms(lambda: ck.cell_reference(prev, cur, params, spec)),
            bound_ms=t_bound,
            bound_by=t_by,
            mbytes=nbytes / 1e6,
            gflop=flops / 1e9,
            host_us=host_enqueue_us(call, calls=200),
        )
        row["device_ms"], row["device_ms_by_kernel"], row["device_ms_source"] = device_ms(call)
        row["device_over_bound"] = row["device_ms"] / t_bound
        row["other_kernels"] = sorted(set(row["device_ms_by_kernel"]) - set(CELL_KERNELS))
        if row["other_kernels"]:
            raise AssertionError("a bf16 K3 call ran other kernels: %s" % row["other_kernels"])
        if signature == (768, 768, 128, "normal", 8):
            host = {"cell_us": row["host_us"], "cell_signature": list(signature) + [batch]}
        rows.append(row)
        count = row["cells_per_forward"]
        for key in ("ms", "plain_ms", "bound_ms", "device_ms", "host_us"):
            totals[key] += count * row[key]
        for name, ms in row["device_ms_by_kernel"].items():
            by_kernel[name] += count * ms
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
        device_ms_by_kernel=dict(by_kernel),
        host_ms=totals["host_us"] / 1e3,
        first_design=FIRST_K3_FORWARD,
    )
    return total, rows, host


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


def time_kernels(sep_shapes, combine_rows, rng):
    """Per-kernel times at the largest bucket: kernel, plain version,
    library call and bound; K0's and torch.clone's device time; K1's
    from its served row of `time_combine`. K2's numbers sum over the 200 launches of one
    member forward (each shape times its launch count); per shape also
    its device time (torch.profiler) at buckets 32 and 1, the library
    call's device time at bucket 32, and the planned grid's blocks.
    Returns (rows, K2 per shape, host enqueue times)."""
    import torch
    import torch.nn.functional as F

    from adanet_tpu_torch.ops import _build, sepconv_kernels

    b = max(BUCKETS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    x = torch.arange(8, dtype=torch.float32).cuda()
    t_bound, t_by = bound_ms(2 * x.numel() * 4, 0, "float32")
    # K0 and the library call in turns (kernel, library, library, kernel).
    copy_ms = [cuda_time_ms(lambda: _build.copy_tensor(x), iters=100)]
    clone_ms = [cuda_time_ms(lambda: torch.clone(x), iters=100)]
    clone_ms.append(cuda_time_ms(lambda: torch.clone(x), iters=100))
    copy_ms.append(cuda_time_ms(lambda: _build.copy_tensor(x), iters=100))
    rows["copy"] = dict(
        shapes="[8] f32",
        ms=sum(copy_ms) / 2,
        plain_ms=cuda_time_ms(lambda: _build.copy_reference(x), iters=100),
        library_ms=sum(clone_ms) / 2,
        bound_ms=t_bound,
        bound_by=t_by,
    )
    # Device time of K0 and of torch.clone, in turns: the launch's cost
    # on the card, without the host's.
    copy_dev = [device_ms(lambda: _build.copy_tensor(x), calls=10, expect="copy_bytes_kernel")]
    clone_dev = [device_ms(lambda: torch.clone(x), calls=10) for _ in range(2)]
    copy_dev.append(device_ms(lambda: _build.copy_tensor(x), calls=10, expect="copy_bytes_kernel"))
    rows["copy"]["device_us"] = sum(d[0] for d in copy_dev) / 2 * 1e3
    rows["copy"]["library_device_us"] = sum(d[0] for d in clone_dev) / 2 * 1e3
    rows["copy"]["device_sources"] = sorted({d[2] for d in copy_dev + clone_dev})
    rows["copy"]["library_device_kernels"] = sorted(clone_dev[0][1])
    served = combine_rows[0]
    rows["combine"] = dict(
        shapes="[%d, %d, %d] %s, %s weights, members as the ensembler hands them"
        % (*served["shape"], served["dtype"], served["weights"]),
        ms=served["ms"],
        plain_ms=served["plain_ms"],
        library_ms=served["einsum_ms"],
        bound_ms=served["bound_ms"],
        bound_by=served["bound_by"],
        device_us=served["device_us"],
        host_us=served["host_us"],
    )
    counts = collections.Counter(sep_shapes)
    per_shape = []
    totals = collections.Counter()
    flops_total = bytes_total = 0
    host = {}
    for ((h, w_, c), f, k, s), count in sorted(counts.items()):
        dtype = torch.bfloat16
        dw = (torch.randn(c, 1, k, k, generator=rng) / k).cuda()
        pw = (torch.randn(f, c, 1, 1, generator=rng) / c ** 0.5).cuda()
        dwb, pwb = dw.to(dtype), pw.to(dtype)
        ho, pt, pb = sepconv_kernels.same_pads(h, k, s)
        wo, pl, pr = sepconv_kernels.same_pads(w_, k, s)
        row = dict(shape=[b, h, w_, c, f, k, s], launches_per_member_forward=count)
        for bucket in (b, 1):
            x = torch.randn(bucket, h, w_, c, generator=rng).cuda().to(dtype)

            def kernel():
                return sepconv_kernels.fused_sep_conv(x, dw, pw, s)

            def library():
                y = F.pad(torch.relu(x).permute(0, 3, 1, 2), (pl, pr, pt, pb))
                y = F.conv2d(y, dwb, stride=s, groups=c)
                return F.conv2d(y, pwb)

            plan = sepconv_kernels.launch_plan(x.shape, dtype, f, k, s, sms=sms)
            suffix = "" if bucket == b else "_b1"
            row["blocks" + suffix] = plan.blocks
            # Kernel and library call in turns, CUDA events.
            first = cuda_time_ms(kernel)
            lib = [cuda_time_ms(library), cuda_time_ms(library)]
            row["ms" + suffix] = (first + cuda_time_ms(kernel)) / 2
            row["library_ms" + suffix] = sum(lib) / 2
            row["device_ms" + suffix], by_name, row["device_ms_source" + suffix] = device_ms(
                kernel, calls=10, expect="sepconv_kernel"
            )
            if len(by_name) > 1:
                raise AssertionError("K2 ran device kernels %s" % by_name)
            row["queued_device_ms" + suffix] = queued_device_ms(kernel)
            if bucket == b:
                if plan.blocks < sms:
                    raise AssertionError("K2 %s: %d blocks < %d SMs" % (row["shape"], plan.blocks, sms))
                row["plain_ms"] = cuda_time_ms(lambda: sepconv_kernels.sep_conv_reference(x, dw, pw, s))
                row["library_device_ms"], _, row["library_device_ms_source"] = device_ms(library)
                if (h, c, k) == (16, 64, 3):
                    host["sepconv_us"] = host_enqueue_us(kernel)
                    host["sepconv_shape"] = row["shape"]
        nbytes = 2 * b * h * w_ * c + 4 * (c * k * k + c * f) + 2 * b * ho * wo * f
        flops = 2 * b * ho * wo * (c * k * k + c * f)
        row["bound_ms"], _ = bound_ms(nbytes, flops, "bfloat16")
        per_shape.append(row)
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms", "library_device_ms"):
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
        device_ms=totals["device_ms"],
        library_device_ms=totals["library_device_ms"],
    )
    # Host enqueue per call, K0 and torch.clone in turns.
    x = torch.arange(8, dtype=torch.float32).cuda()
    copy_us = [host_enqueue_us(lambda: _build.copy_tensor(x))]
    clone_us = [host_enqueue_us(lambda: torch.clone(x)), host_enqueue_us(lambda: torch.clone(x))]
    copy_us.append(host_enqueue_us(lambda: _build.copy_tensor(x)))
    host["copy_us"] = sum(copy_us) / 2
    host["clone_us"] = sum(clone_us) / 2
    host["copy_us_runs"] = copy_us
    host["clone_us_runs"] = clone_us
    with torch.inference_mode():  # as the served program makes its calls
        host["copy_us_inference"] = host_enqueue_us(lambda: _build.copy_tensor(x))
    host["combine_us"] = combine_rows[0]["host_us"]
    host["combine_us_inference"] = combine_rows[0]["host_us_inference"]
    host["combine_shape"] = combine_rows[0]["shape"]
    rows["copy"]["host_us"] = host["copy_us"]
    rows["copy"]["library_host_us"] = host["clone_us"]
    return rows, per_shape, host


def serve(model_dir, sep_shapes, rng):
    """The main path: pool -> batcher -> frontend, with the launch
    counters zeroed just before and read just after."""
    import numpy as np
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.observability import metrics
    from adanet_tpu_torch.ops import tuning
    from adanet_tpu_torch.serving import Batcher, FrontendConfig, ModelPool, ServingFrontend
    from adanet_tpu_torch.store import ArtifactStore

    def request(n):
        return {"image": torch.randn(n, 32, 32, 3, generator=rng).numpy()}

    serial = [request(n) for n in SERIAL_ROWS]
    burst = [request(n) for n in BURST_ROWS]
    store_burst = [request(n) for n in BURST_ROWS]
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
        with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as store_dir:
            store = ArtifactStore(store_dir)
            reads = collections.Counter()
            get_ref = store.get_ref

            def counted_get_ref(kind, name):
                reads[kind] += 1
                return get_ref(kind, name)

            store.get_ref = counted_get_ref
            tuning.set_default_store(store)
            try:
                t0 = time.perf_counter()
                handles = [frontend.submit_async(f) for f in store_burst]
                results += [h.wait(300.0) for h in handles]
                store_burst_secs = time.perf_counter() - t0
                first_reads = reads["tune"]
                handles = [frontend.submit_async(f) for f in store_burst]
                again = [h.wait(300.0) for h in handles]
                results += again
            finally:
                tuning.set_default_store(None)
    finally:
        drained = frontend.drain(timeout=120.0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    batches = int(dispatches.value - dispatched_before)
    if not drained:
        raise AssertionError("frontend did not drain")
    for features, result in zip(serial + burst + store_burst + store_burst, results):
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
        "served: %d requests (%d serial, 3 x %d burst), %d batches, all ok; launches %s "
        "= 1 K0, 1 K1 and %d K2 per program call (%d batches + 1 smoke)"
        % (len(results), len(serial), len(burst), batches, counts, per_program, batches)
    )
    stats = {
        "p50_latency_ms": float(np.percentile(latencies, 50)) * 1e3,
        "serial_rows": int(sum(SERIAL_ROWS)),
        "burst_rows_per_s": float(sum(BURST_ROWS) / burst_secs),
        "burst_rows": int(sum(BURST_ROWS)),
        "store_burst_rows_per_s": float(sum(BURST_ROWS) / store_burst_secs),
        "store_reads_first_burst": first_reads,
        "store_reads_second_burst": reads["tune"] - first_reads,
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


def trace_served_combine(gen_dir, rng):
    """One served `build_ensemble` traced on the served generation's
    member outputs at bucket 32: it must launch K1 once and no stack or
    cast kernel (the zero fill of the complexity term may remain, and is
    named), prepare no weight, and agree with the plain version."""
    import torch

    from adanet_tpu_torch.core import export
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.ops import ensemble_kernels as ek
    from adanet_tpu_torch.ops import sepconv_kernels as sk

    frozen = export.load_frozen_ensemble(gen_dir)
    ensembler = ComplexityRegularizedEnsembler.from_spec(export.serving_signature(gen_dir)["ensembler"])
    params = frozen.ensembler_params
    features = {"image": torch.randn(max(BUCKETS), 32, 32, 3, generator=rng).cuda()}
    with torch.inference_mode():
        outs = frozen.member_outputs(features, training=False)
        ensembler.build_ensemble(params, outs)  # the first call prepares the weights
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # A trace that holds no device event at all (the card's tracer
    # delivered nothing, as `device_ms` allows for) is taken again.
    for _ in range(3):
        launches, made = ek.fused_weighted_combine.launches, sk.prepare.made
        with torch.profiler.profile(activities=activities) as prof:
            with torch.inference_mode():
                ensemble = ensembler.build_ensemble(params, outs)
            torch.cuda.synchronize()
        kernels = collections.Counter(
            event.name for event in prof.events()
            if getattr(event, "device_type", None) == torch.autograd.DeviceType.CUDA
        )
        if kernels:
            break
    k1 = sum(count for name, count in kernels.items() if "combine_kernel" in name)
    fills = sum(count for name, count in kernels.items() if "FillFunctor" in name)
    others = {name: count for name, count in kernels.items()
              if "combine_kernel" not in name and "FillFunctor" not in name}
    if k1 != 1 or others:
        raise AssertionError("a served combine ran %d K1 and other kernels %s" % (k1, others))
    if ek.fused_weighted_combine.launches != launches + 1 or sk.prepare.made != made:
        raise AssertionError("a served combine launched %d K1, prepared %d weights"
                             % (ek.fused_weighted_combine.launches - launches, sk.prepare.made - made))
    want = ek.combine_reference([o.logits for o in outs], torch.stack(params["weights"]), None)
    err = check_close("served combine", ensemble.logits, want, combine_tolerance(want))
    out = {"device_kernels": dict(kernels), "k1_launches": k1, "fill_kernels": fills,
           "other_kernels": others, "member_logits": [str(o.logits.dtype) for o in outs],
           "max_abs_err": err}
    print("served_combine_trace: " + json.dumps(out))
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


def check_sepconv_grads(sep_shapes, gen, batch=2):
    """Gradients of x, dw and pw through `fused_sep_conv` on the card
    (K2 forward, `_FusedSepConv` backward) against plain autograd through
    `sep_conv_reference`, f32 with TF32 off, at each distinct K2 shape of
    the model: atol 1e-4 x max(1, max|ref|)."""
    import torch

    from adanet_tpu_torch.ops import sepconv_kernels as sk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    shapes = sorted(set(sep_shapes))
    for (h, w, c), f, k, s in shapes:
        x = torch.randn(batch, h, w, c, generator=gen).cuda()
        dw = (torch.randn(c, 1, k, k, generator=gen) / k).cuda()
        pw = (torch.randn(f, c, 1, 1, generator=gen) / c ** 0.5).cuda()
        cot = None
        grads = []
        for fn in (sk.fused_sep_conv, sk.sep_conv_reference):
            inputs = [t.clone().requires_grad_(True) for t in (x, dw, pw)]
            before = sk.fused_sep_conv.launches
            out = fn(*inputs, s)
            if fn is sk.fused_sep_conv and (
                sk.fused_sep_conv.launches != before + 1 or type(out.grad_fn).__name__ != "_FusedSepConvBackward"
            ):
                raise AssertionError("K2 %s: no launch through _FusedSepConv (%s)" % ((h, w, c, f, k, s), out.grad_fn))
            if cot is None:
                cot = torch.randn(out.shape, generator=gen).cuda()
            grads.append(torch.autograd.grad(out, inputs, cot))
        for name, got, want in zip(("x", "dw", "pw"), *grads):
            tol = 1e-4 * max(1.0, float(want.abs().max()))
            worst = max(worst, check_close("K2 grad %s %s" % (name, (h, w, c, f, k, s)), got, want, tol))
    torch.cuda.synchronize()
    print("K2 gradients at %d shapes (batch %d, f32): x, dw and pw match plain autograd; max abs err %g"
          % (len(shapes), batch, worst))
    return worst


def search_parts():
    """(head, simple_dnn generator, ensembler) of the gate's
    configuration, the combine fused."""
    import torch

    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.examples import simple_dnn

    def adam(params):
        # torch's fused Adam, one arithmetic on the card and the CPU
        # (`train_vs_cpu`): the Iteration makes Adam capturable on the card,
        # whose foreach form computes the bias corrections in f32 there
        # where the CPU's computes them in f64 on the host.
        return torch.optim.Adam(params, lr=1e-3, eps=1e-8, fused=True)

    generator = simple_dnn.Generator(optimizer_fn=adam, layer_size=LAYER_SIZE, initial_num_layers=1, seed=0)
    ensembler = ComplexityRegularizedEnsembler(optimizer=adam, use_fused_combine=True)
    return MultiClassHead(10), generator, ensembler


class _StepClock:
    """Wraps the search's `input_fn`. The Estimator pulls one batch a
    global step, just before the step (an iteration's first batch before
    the iteration is built), so pull p + 1 closes step p. Steps
    [first, first + window) are timed at their pulls by the host clock
    and CUDA events, and steps [traced, traced + traced_steps) run under
    torch.profiler, started and stopped at their pulls."""

    def __init__(self, input_fn, first, traced, window=STEP_WINDOW, traced_steps=TRACED_STEPS):
        self._input_fn = input_fn
        self._first, self._traced = first, traced
        self.window, self.traced_steps = window, traced_steps
        self.pulls = 0
        self.marks = []
        self.profile = None

    def __call__(self):
        for batch in self._input_fn():
            self.pulls += 1
            self._mark(self.pulls)
            yield batch

    def _mark(self, pull):
        import torch

        if pull in (self._first, self._first + self.window):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((time.perf_counter(), event))
        if pull == self._traced:
            activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self.profile = torch.profiler.profile(activities=activities)
            self.profile.start()
        elif pull == self._traced + self.traced_steps:
            torch.cuda.synchronize()
            self.profile.stop()


def train_search(model_dir):
    """The search path: `Estimator.train` and `Estimator.evaluate` at the
    gate's configuration on the card, launch counts zeroed just before
    and read just after. A window of the search's own iteration 1 is
    timed, and a few later steps traced, through its input_fn
    (`_StepClock`). Returns (launch counts, the `train:` numbers)."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset

    head, generator, ensembler = search_parts()
    builders = {}
    generate = generator.generate_candidates

    def recorded(previous_ensemble, iteration_number, *args, **kwargs):
        out = generate(previous_ensemble, iteration_number, *args, **kwargs)
        builders[iteration_number] = [b.name for b in out]
        return out

    generator.generate_candidates = recorded
    xtr, ytr = make_dataset(TRAIN_EXAMPLES, seed=7)
    xte, yte = make_dataset(EVAL_EXAMPLES, seed=8)
    search_dir = os.path.join(model_dir, "search")
    estimator = Estimator(
        head, generator, max_iteration_steps=TRAIN_STEPS, max_iterations=TRAIN_ITERATIONS,
        ensemblers=[ensembler], model_dir=search_dir, log_every_steps=0, device="cuda",
    )
    # Iteration 1 runs global steps TRAIN_STEPS + 1 ... 2 x TRAIN_STEPS.
    clock = _StepClock(input_fn(xtr, ytr, TRAIN_BATCH), first=TRAIN_STEPS + 11,
                       traced=TRAIN_STEPS + 21 + STEP_WINDOW)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    estimator.train(clock, max_steps=10**6)
    torch.cuda.synchronize()
    train_secs = time.perf_counter() - t0
    metrics = estimator.evaluate(input_fn(xte, yte, TRAIN_BATCH))
    torch.cuda.synchronize()
    search_secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = estimator.latest_global_step()
    # GrowStrategy over two builders: 2 candidates at t = 0, and at t = 1
    # those 2 and the carried-over winner; each combines once a step
    # (its ensemble update), and evaluate once a batch.
    candidates = (2, 3)
    eval_batches = -(-EVAL_EXAMPLES // TRAIN_BATCH)
    expected = dict(copy=0, sepconv=0, cell=0, combine=TRAIN_STEPS * sum(candidates) + eval_batches)
    if steps != TRAIN_STEPS * TRAIN_ITERATIONS or counts != expected or clock.pulls != steps:
        raise AssertionError("search: %d steps, %d pulls, launches %s, expected %s"
                             % (steps, clock.pulls, counts, expected))
    if not (metrics["accuracy"] >= GATE_ACCURACY and metrics["accuracy"] > LINEAR_BASELINE_ACCURACY):
        raise AssertionError("search accuracy %s below the gate %s" % (metrics, GATE_ACCURACY))
    for t in range(TRAIN_ITERATIONS):
        if not os.path.exists(os.path.join(search_dir, "architecture-%d.json" % t)):
            raise AssertionError("architecture-%d.json was not written" % t)
    (host0, event0), (host1, event1) = clock.marks
    host_ms = (host1 - host0) / STEP_WINDOW * 1e3
    stats = dict(
        steps=steps,
        builders=builders,
        search_ms_per_step=train_secs / steps * 1e3,
        search_secs=search_secs,
        k1_launches=counts["combine"],
        k1_launches_per_step=(counts["combine"] - eval_batches) / steps,
        accuracy=metrics["accuracy"],
        top_5_accuracy=metrics["top_5_accuracy"],
        loss=metrics["loss"],
        best_ensemble=metrics["best_ensemble"],
        window_steps=[clock._first, clock._first + STEP_WINDOW - 1],
        window_candidates=len(builders[1]) + 1,
        window_host_ms_per_step=host_ms,
        window_event_ms_per_step=event0.elapsed_time(event1) / STEP_WINDOW,
    )
    stats.update(traced_step(clock.profile, host_ms))
    stats["card"] = card_line()
    print("train: " + json.dumps(stats))
    return counts, stats


def traced_step(prof, host_ms, steps=TRACED_STEPS):
    """From `steps` traced search steps: device busy ms a step, the idle
    share against the untraced host time a step, kernels, K1 and K2
    launches a step, K2's forward device ms a step, the top kernels and
    the host's self time by op."""
    import torch

    kernels = collections.Counter()
    launches = collections.Counter()
    for event in prof.events():
        # The device's kernels and copies; not the optimizers' annotation
        # ranges, which span kernels of their own.
        if getattr(event, "device_type", None) == torch.autograd.DeviceType.CUDA and not getattr(
            event, "is_user_annotation", False
        ):
            total = getattr(event, "device_time_total", None)
            kernels[event.name] += event.cuda_time_total if total is None else total
            launches[event.name] += 1
    if not kernels:
        # The card's tracer delivered no device event: not measured.
        return dict(traced_steps=steps, trace_delivered=False)
    busy_ms = sum(kernels.values()) / 1e3 / steps
    k1 = sum(n for k, n in launches.items() if "combine_kernel" in k)
    k2 = sum(n for k, n in launches.items() if "sepconv_kernel" in k)
    averages = prof.key_averages()
    host_ops = sorted(averages, key=lambda e: -e.self_cpu_time_total)[:8]
    # K2's backward: the device time under its autograd node (the plain
    # version's kernels); the node and its engine frame nest, so the max.
    backward_us = [getattr(e, "device_time_total", None) or e.cuda_time_total
                   for e in averages if "FusedSepConvBackward" in e.key]
    return dict(
        traced_steps=steps,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1.0 - busy_ms / host_ms,
        device_kernels_per_step=sum(launches.values()) / steps,
        k1_launches_per_traced_step=k1 / steps,
        k1_device_us=sum(us for k, us in kernels.items() if "combine_kernel" in k) / max(1, k1),
        k2_launches_per_traced_step=k2 / steps,
        k2_device_ms_per_step=sum(us for k, us in kernels.items() if "sepconv_kernel" in k) / 1e3 / steps,
        k2_backward_device_ms_per_step=max(backward_us) / 1e3 / steps if backward_us else None,
        top_kernels_ms_per_step=[[name[:60], us / 1e3 / steps] for name, us in kernels.most_common(6)],
        top_kernels_by_launches=[[name[:60], n / steps] for name, n in launches.most_common(8)],
        # Host time by operation (self time, traced, so inflated).
        top_host_ms_per_step=[[e.key[:50], e.self_cpu_time_total / 1e3 / steps, e.count / steps]
                              for e in host_ops],
    )


def train_vs_cpu():
    """The same search steps on the card (K1) and on the CPU (plain
    version): 2 iterations x PARITY_STEPS from the same converted init
    and batches. Per-step adanet and subnetwork losses and mixture
    weights within atol 1e-4 x max(1, |value|); the same best index."""
    import torch

    from adanet_tpu_torch.core.iteration import IterationBuilder
    from adanet_tpu_torch.ensemble.strategy import GrowStrategy
    from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset
    from adanet_tpu_torch.utils.convert import WithInitialVariables

    x, y = make_dataset(TRAIN_BATCH * PARITY_STEPS * TRAIN_ITERATIONS, seed=7)
    batches = list(input_fn(x, y, TRAIN_BATCH)())
    runs = []
    for device in ("cuda", "cpu"):
        head, generator, ensembler = search_parts()
        generator = WithInitialVariables(generator, x[0].size, 10)
        factory = IterationBuilder(head, [ensembler], [GrowStrategy()], device=device)
        trace, best, previous = [], [], None
        for t in range(TRAIN_ITERATIONS):
            sample = batches[t * PARITY_STEPS]
            iteration = factory.build_iteration(
                t, generator.generate_candidates(previous, t, [], []), previous, input_shape=(x[0].size,)
            )
            state = iteration.init_state(torch.Generator().manual_seed(t), sample)
            for i in range(PARITY_STEPS):
                state, metrics = iteration.train_step(state, batches[t * PARITY_STEPS + i])
                row = {k: float(v) for k, v in metrics.items()}
                for name, est in state.ensembles.items():
                    for j, w in enumerate(est.params["weights"]):
                        row["weight/%s/%d" % (name, j)] = float(w.detach())
                trace.append(row)
            best.append(iteration.best_candidate_index(state))
            previous = iteration.freeze_candidate(state, iteration.ensemble_specs[best[-1]].name, sample)
        runs.append((trace, best))
    (card, card_best), (cpu, cpu_best) = runs
    worst = 0.0
    for step, (got, want) in enumerate(zip(card, cpu)):
        if sorted(got) != sorted(want):
            raise AssertionError("train_vs_cpu step %d: metrics %s vs %s" % (step, sorted(got), sorted(want)))
        for key, value in want.items():
            err = abs(got[key] - value)
            if not err <= 1e-4 * max(1.0, abs(value)):
                raise AssertionError("train_vs_cpu step %d %s: card %r, cpu %r" % (step, key, got[key], value))
            worst = max(worst, err)
    if card_best != cpu_best:
        raise AssertionError("train_vs_cpu: best candidates %s on the card, %s on the CPU" % (card_best, cpu_best))
    out = dict(steps=len(card), values_per_step=len(card[0]), best=card_best, max_abs_err=worst)
    print("train_vs_cpu: " + json.dumps(out))
    return out


def nasnet_gate_hparams(**overrides):
    """The gate's improve_nas Hparams (tests/test_convergence.py:119-157),
    K2 on."""
    from adanet_tpu_torch.research.improve_nas import improve_nas

    base = dict(num_cells=3, num_conv_filters=8, use_aux_head=False, drop_path_keep_prob=1.0,
                dense_dropout_keep_prob=1.0, clip_gradients=5.0, weight_decay=1e-4,
                initial_learning_rate=1e-3, use_pallas_sep_conv=True)
    base.update(overrides)
    return improve_nas.Hparams(**base)


def _recording(estimator_cls):
    """An Estimator that keeps every step's metrics (0-d tensors on the
    card, read once at the end)."""

    class Recording(estimator_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.metrics = []

        def _build_iteration(self, iteration_number, sample_batch):
            iteration = super()._build_iteration(iteration_number, sample_batch)
            step = iteration.train_step

            def recorded(state, batch):
                state, metrics = step(state, batch)
                self.metrics.append(metrics)
                return state, metrics

            iteration.train_step = recorded
            return iteration

    return Recording


def _member_forwards(iterations, steps, eval_batches, eval_members):
    """Member forwards of a search with one candidate builder per
    iteration and force_grow (a chain of members): per iteration, the
    init's eval forward of the new subnetwork and of the frozen members,
    a training forward of the new one and a forward of each frozen
    member per step, and the freeze's forward; then each eval batch's
    forward of every member of the winner."""
    total = 0
    for t in range(iterations):
        total += (1 + t) + steps * (1 + t) + 1
    return total + eval_batches * eval_members


def train_nasnet(model_dir):
    """The flagship at full width on the card: `Estimator.train` with the
    improve_nas `Generator` over NASNet-A (6@768), 2 iterations x 20
    steps, then `evaluate`. Launch counts zeroed just before and read
    just after; a window of iteration 1 timed at the batch pulls and 3
    steps traced. Returns (launch counts, the `train_nasnet:` numbers)."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.research.improve_nas import fake_data, improve_nas, optimizer

    hparams = improve_nas.Hparams(
        knowledge_distillation=improve_nas.KnowledgeDistillation.ADAPTIVE,
        use_pallas_sep_conv=True,
        total_training_steps=NASNET_STEPS * NASNET_ITERATIONS,
    )
    generator = improve_nas.Generator(
        optimizer.fn_with_name("momentum", "cosine", cosine_decay_steps=NASNET_STEPS), hparams, seed=0, num_classes=10
    )
    provider = fake_data.FakeImageProvider(
        num_examples=NASNET_EXAMPLES, image_size=32, num_classes=10, batch_size=NASNET_BATCH, seed=0
    )

    def sgd(params):
        return torch.optim.SGD(params, lr=0.01)

    estimator = _recording(Estimator)(
        MultiClassHead(10), generator, max_iteration_steps=NASNET_STEPS, max_iterations=NASNET_ITERATIONS,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=sgd, use_fused_combine=True)], force_grow=True,
        model_dir=os.path.join(model_dir, "nasnet"), log_every_steps=0, device="cuda",
    )
    # Iteration 1 runs global steps NASNET_STEPS + 1 ... 2 x NASNET_STEPS.
    first = NASNET_STEPS + 4
    clock = _StepClock(provider.get_input_fn("train"), first=first, traced=first + NASNET_WINDOW + 1,
                       window=NASNET_WINDOW, traced_steps=NASNET_TRACED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    estimator.train(clock, max_steps=10**6)
    torch.cuda.synchronize()
    train_secs = time.perf_counter() - t0
    metrics = estimator.evaluate(provider.get_input_fn("test"))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = estimator.latest_global_step()
    losses = torch.stack([v.float() for m in estimator.metrics for k, v in sorted(m.items())
                          if "loss" in k]).tolist()
    if not all(map(math.isfinite, losses)):
        raise AssertionError("train_nasnet: non-finite losses %s" % losses)
    per_forward = len(improve_nas.Builder(None, hparams).build_subnetwork(
        10, input_shape=(32, 32, 3)).nasnet.sepconv_launch_shapes())
    eval_batches = NASNET_EXAMPLES // NASNET_BATCH
    forwards = _member_forwards(NASNET_ITERATIONS, NASNET_STEPS, eval_batches, NASNET_ITERATIONS)
    # K1: one ensemble update a candidate a step (1 at t = 0; the
    # carried-over winner and the grown one at t = 1) plus the ADAPTIVE
    # teacher at t = 1, and one a eval batch.
    expected = dict(copy=0, cell=0, sepconv=forwards * per_forward,
                    combine=NASNET_STEPS * (1 + 3) + eval_batches)
    if steps != NASNET_STEPS * NASNET_ITERATIONS or counts != expected or clock.pulls != steps:
        raise AssertionError("train_nasnet: %d steps, %d pulls, launches %s, expected %s"
                             % (steps, clock.pulls, counts, expected))
    for t in range(NASNET_ITERATIONS):
        if not os.path.exists(os.path.join(estimator.model_dir, "architecture-%d.json" % t)):
            raise AssertionError("train_nasnet: architecture-%d.json was not written" % t)
    (host0, event0), (host1, event1) = clock.marks
    host_ms = (host1 - host0) / NASNET_WINDOW * 1e3
    stats = dict(
        steps=steps,
        k2_launches_per_member_forward=per_forward,
        search_ms_per_step=train_secs / steps * 1e3,
        train_secs=train_secs,
        window_steps=[first, first + NASNET_WINDOW - 1],
        window_host_ms_per_step=host_ms,
        window_event_ms_per_step=event0.elapsed_time(event1) / NASNET_WINDOW,
        max_memory_allocated_bytes=peak,
        first_losses=losses[:4],
        last_losses=losses[-4:],
        accuracy=metrics["accuracy"],
        best_ensemble=metrics["best_ensemble"],
        launches=counts,
    )
    stats.update(traced_step(clock.profile, host_ms, NASNET_TRACED))
    stats["card"] = card_line()
    print("train_nasnet: " + json.dumps(stats))
    return counts, stats


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms within the block.
    The phases that hold runs against each other (`resume_nasnet`,
    `windows_vs_steps`) run under it, and their runs are then bitwise
    equal: with cuDNN free to pick an algorithm that sums with atomics,
    two uninterrupted NASNet runs part by 0.086-0.236 in a frozen
    parameter (H100 80GB HBM3, 700 W), and a third run can land past
    twice that by chance."""
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _tree_deviation(got, want, path=""):
    """Max |got - want| over the tensors and floats of two payload trees
    (0.0 when bitwise equal); a difference of structure, dtype, or of
    any other value raises."""
    import torch

    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError("%s: keys %s != %s" % (path, sorted(got), sorted(want)))
        return max([_tree_deviation(got[k], want[k], "%s/%s" % (path, k)) for k in want] or [0.0])
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError("%s: %d items != %d" % (path, len(got), len(want)))
        return max([_tree_deviation(g, w, "%s/%d" % (path, i)) for i, (g, w) in enumerate(zip(got, want))] or [0.0])
    if torch.is_tensor(want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError("%s: %s %s != %s %s" % (path, got.dtype, got.shape, want.dtype, want.shape))
        if torch.equal(got, want):
            return 0.0
        if not want.is_floating_point():
            raise AssertionError("%s: integer tensors differ" % path)
        return float((got.double() - want.double()).abs().max())
    if isinstance(want, float) and isinstance(got, float):
        return abs(got - want)
    if got != want:
        raise AssertionError("%s: %r != %r" % (path, got, want))
    return 0.0


def resume_nasnet(model_dir):
    """Checkpoint and resume of the flagship at full width on the card
    (`train_nasnet`'s configuration, 2 iterations x RESUME_STEPS, a
    checkpoint every RESUME_SAVE_EVERY steps, one fixed batch forever):

    1. a search stopped by max_steps inside iteration 1 keeps its live
       `IterationState`; a fresh Estimator over its dir rebuilds the
       iteration and restores it, and every tensor of the restored state
       (parameters, buffers, optimizer slots and counts, mixture weights,
       EMAs, step counters, the CUDA generator's state) must equal the
       live one bitwise; saves and restores are timed;
    2. two uninterrupted runs U1, U2 and the stopped one resumed (R):
       R's architecture files equal U1's byte for byte; R's `frozen-1.pt`
       equals U1's bitwise if U2's does, else deviates from it by at most
       twice U2's deviation; R's launch counts, zeroed just before its
       train() and read after its evaluate(), are exact;
    3. the trainer CLI in a subprocess, SIGTERMed inside iteration 1, exits
       0 with a mid-iteration state in the manifest, and a second run over
       its --model_dir resumes from that step and finishes.
    Returns (R's launch counts, the `resume_nasnet:` numbers)."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core import checkpoint as ckpt
    from adanet_tpu_torch.core import iteration as iteration_lib
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.research.improve_nas import fake_data, improve_nas, optimizer

    t_phase = time.perf_counter()
    hparams = improve_nas.Hparams(
        knowledge_distillation=improve_nas.KnowledgeDistillation.ADAPTIVE,
        use_pallas_sep_conv=True,
        total_training_steps=2 * RESUME_STEPS,
    )
    provider = fake_data.FakeImageProvider(
        num_examples=NASNET_BATCH, image_size=32, num_classes=10, batch_size=NASNET_BATCH, seed=0
    )
    batch = next(iter(provider.get_input_fn("train")()))

    def fixed():
        while True:
            yield batch

    def sgd(params):
        return torch.optim.SGD(params, lr=0.01)

    class Keeping(Estimator):
        """Keeps the live state of its last checkpoint."""

        def _save_iteration_state(self, info, iteration_number, state):
            super()._save_iteration_state(info, iteration_number, state)
            self.live = state

    def estimator(name, cls=Estimator):
        generator = improve_nas.Generator(
            optimizer.fn_with_name("momentum", "cosine", cosine_decay_steps=RESUME_STEPS), hparams, seed=0,
            num_classes=10,
        )
        return cls(
            MultiClassHead(10), generator, max_iteration_steps=RESUME_STEPS, max_iterations=2,
            ensemblers=[ComplexityRegularizedEnsembler(optimizer=sgd, use_fused_combine=True)], force_grow=True,
            model_dir=os.path.join(model_dir, "resume", name), log_every_steps=0,
            save_checkpoint_steps=RESUME_SAVE_EVERY, device="cuda",
        )

    # 1. Exact restore.
    stopped = estimator("stopped", Keeping)
    stopped.train(fixed, max_steps=RESUME_STOP)
    live = iteration_lib.state_payload(stopped.live)
    info = ckpt.read_manifest(stopped.model_dir)
    if (info.iteration_number, info.global_step, info.iteration_state_file) != (
            1, RESUME_STOP, "ckpt-%d.pt" % RESUME_STOP):
        raise AssertionError("resume_nasnet: stopped at %s" % info)
    fresh = estimator("stopped")
    iteration = fresh._build_iteration(1, batch)
    restored = fresh._init_or_restore_state(iteration, batch, info)
    deviation = _tree_deviation(iteration_lib.state_payload(restored), live)
    tensors = sum(1 for _ in _payload_tensors(live))
    if deviation != 0.0 or restored.iteration_step != RESUME_STOP - RESUME_STEPS:
        raise AssertionError("resume_nasnet: restore deviates by %g" % deviation)

    scratch = os.path.join(model_dir, "resume", "saves")
    parts = collections.defaultdict(list)
    for _ in range(RESUME_SAVES):
        t0 = time.perf_counter()
        payload = iteration_lib.state_payload(stopped.live)
        t1 = time.perf_counter()
        data = ckpt.to_bytes(payload)
        t2 = time.perf_counter()
        ckpt.sha256_hex(data)
        t3 = time.perf_counter()
        ckpt.write_payload_bytes(scratch, "ckpt-%d.pt" % RESUME_STOP, data)
        t4 = time.perf_counter()
        # write_payload_bytes digests again for the sidecar.
        parts["device_to_host"].append((t1 - t0) * 1e3)
        parts["serialise"].append((t2 - t1) * 1e3)
        parts["digest"].append((t3 - t2) * 1e3)
        parts["write_fsync"].append((t4 - t3 - (t3 - t2)) * 1e3)
        t0 = time.perf_counter()
        stopped._save_iteration_state(ckpt.read_manifest(stopped.model_dir), 1, stopped.live)
        parts["save"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        payload = ckpt.restore_payload(stopped.model_dir, info.iteration_state_file)
        t1 = time.perf_counter()
        iteration_lib.restore_state(restored, payload)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        parts["restore_read_verify_decode"].append((t1 - t0) * 1e3)
        parts["restore_load"].append((t2 - t1) * 1e3)
        parts["restore"].append((t2 - t0) * 1e3)
    if _tree_deviation(iteration_lib.state_payload(restored), live) != 0.0:
        raise AssertionError("resume_nasnet: a repeated restore deviates")
    ms = {key: sorted(values)[len(values) // 2] for key, values in parts.items()}
    sizes = {name: os.path.getsize(os.path.join(stopped.model_dir, name))
             for name in ("ckpt-%d.pt" % RESUME_STOP, "frozen-0.pt")}
    del stopped, fresh, iteration, restored, payload, data
    torch.cuda.empty_cache()

    # 2. Resume against two uninterrupted runs.
    first = RESUME_STEPS + 2
    clock = _StepClock(fixed, first=first, traced=10**9, window=RESUME_WINDOW)
    u1, u2 = estimator("u1"), estimator("u2")
    u1.train(fixed, max_steps=10**6)
    u2.train(clock, max_steps=10**6)
    (host0, event0), (host1, event1) = clock.marks
    step_ms = (host1 - host0) / RESUME_WINDOW * 1e3
    resumed = estimator("stopped")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    resumed.train(fixed, max_steps=10**6)
    metrics = resumed.evaluate(lambda: iter([batch]))
    torch.cuda.synchronize()
    resume_secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    per_forward = len(improve_nas.Builder(None, hparams).build_subnetwork(
        10, input_shape=(32, 32, 3)).nasnet.sepconv_launch_shapes())
    remaining = 2 * RESUME_STEPS - RESUME_STOP
    # Iteration 1 from its checkpoint: the init's forward of the new
    # member and of the frozen one, two member forwards a step, the
    # freeze's forward; the eval batch through both members. K1: three a
    # step (the carried-over ensemble, the grown one, the teacher), one
    # the eval batch.
    expected = dict(copy=0, cell=0, sepconv=per_forward * (2 + 2 * remaining + 1 + 2), combine=3 * remaining + 1)
    if counts != expected or resumed.latest_global_step() != 2 * RESUME_STEPS:
        raise AssertionError("resume_nasnet: launches %s, expected %s, step %d"
                             % (counts, expected, resumed.latest_global_step()))
    if not math.isfinite(metrics["loss"]):
        raise AssertionError("resume_nasnet: evaluate %s" % metrics)
    runs = {name: est.model_dir for name, est in (("u1", u1), ("u2", u2), ("r", resumed))}
    for t in range(2):
        name = "architecture-%d.json" % t
        texts = {key: open(os.path.join(d, name), "rb").read() for key, d in runs.items()}
        if texts["r"] != texts["u1"]:
            raise AssertionError("resume_nasnet: %s differs from the uninterrupted run's" % name)
    frozen = {key: ckpt.restore_payload(d, "frozen-1.pt") for key, d in runs.items()}
    spread = _tree_deviation(frozen["u2"], frozen["u1"])
    resume_dev = _tree_deviation(frozen["r"], frozen["u1"])
    if resume_dev > 2 * spread:
        raise AssertionError("resume_nasnet: frozen-1 deviates by %g from U1, U2 by %g" % (resume_dev, spread))

    # 3. SIGTERM through the trainer CLI.
    trainer = _trainer_sigterm(os.path.join(model_dir, "resume", "trainer"))

    out = dict(
        steps=[RESUME_STEPS, RESUME_STEPS],
        stop=RESUME_STOP,
        save_checkpoint_steps=RESUME_SAVE_EVERY,
        restore_bitwise_tensors=tensors,
        bytes=sizes,
        ms=ms,
        ms_samples=parts,
        step_ms=step_ms,
        step_event_ms=event0.elapsed_time(event1) / RESUME_WINDOW,
        window_steps=[first, first + RESUME_WINDOW - 1],
        save_share_of_a_step=ms["save"] / step_ms,
        save_share_amortised=ms["save"] / (step_ms * RESUME_SAVE_EVERY),
        frozen_1_u2_vs_u1=spread,
        frozen_1_r_vs_u1=resume_dev,
        resume_secs=resume_secs,
        launches=counts,
        best_ensemble=metrics["best_ensemble"],
        trainer=trainer,
        seconds=time.perf_counter() - t_phase,
        card=card_line(),
    )
    print("resume_nasnet: " + json.dumps(out))
    return counts, out


def _payload_tensors(tree):
    import torch

    if isinstance(tree, dict):
        for value in tree.values():
            yield from _payload_tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _payload_tensors(value)
    elif torch.is_tensor(tree):
        yield tree


def _trainer_sigterm(model_dir):
    """The trainer CLI on the card at the `trainer_on_card` size, in a
    subprocess: SIGTERM once iteration 0 is complete on disk (its
    architecture file and the manifest of iteration 1) and iteration 1
    has had a second to start; it must exit 0 with a mid-iteration state
    in the manifest. A second run over the same --model_dir must restore
    that state and finish. Returns its numbers."""
    from adanet_tpu_torch.core import checkpoint as ckpt

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    argv = [sys.executable, "-m", "adanet_tpu_torch.research.improve_nas.trainer", *TRAINER_SMALL,
            "--boosting_iterations=2", "--train_steps=%d" % TRAINER_SIGTERM_STEPS, "--model_dir=" + model_dir]
    os.makedirs(model_dir, exist_ok=True)

    def run(name, signal_at_iteration_1):
        with open(os.path.join(model_dir, name + ".out"), "w") as out, \
                open(os.path.join(model_dir, name + ".err"), "w") as err:
            t0 = time.perf_counter()
            proc = subprocess.Popen(argv, cwd=root, env=env, stdout=out, stderr=err)
            try:
                deadline = time.time() + 600
                while signal_at_iteration_1 and proc.poll() is None and time.time() < deadline:
                    # The manifest is written atomically, after the
                    # iteration's architecture and frozen payload.
                    manifest = os.path.join(model_dir, ckpt.MANIFEST)
                    if os.path.exists(manifest) and json.load(open(manifest))["iteration_number"] >= 1:
                        time.sleep(1.0)
                        proc.send_signal(signal.SIGTERM)
                        break
                    time.sleep(0.05)
                rc = proc.wait(timeout=max(1.0, deadline - time.time()))
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        text = {key: open(os.path.join(model_dir, "%s.%s" % (name, key))).read() for key in ("out", "err")}
        if rc != 0:
            raise AssertionError("trainer %s: rc %r\n%s" % (name, rc, text["err"][-3000:]))
        return time.perf_counter() - t0, text

    first_secs, _ = run("sigterm", True)
    info = ckpt.read_manifest(model_dir)
    if info.iteration_number != 1 or info.iteration_state_file != "ckpt-%d.pt" % info.global_step:
        raise AssertionError("trainer: SIGTERM left %s" % info)
    stopped_at = info.global_step
    second_secs, text = run("resume", False)
    info = ckpt.read_manifest(model_dir)
    if "Restored mid-iteration state from ckpt-%d.pt" % stopped_at not in text["err"]:
        raise AssertionError("trainer: the second run did not restore ckpt-%d.pt" % stopped_at)
    if (info.iteration_number, info.global_step, info.iteration_state_file) != (2, TRAINER_SIGTERM_STEPS, None):
        raise AssertionError("trainer: the second run ended at %s" % info)
    return dict(stopped_at=stopped_at, steps=TRAINER_SIGTERM_STEPS, first_secs=first_secs,
                second_secs=second_secs, metrics=json.loads(text["out"].strip().splitlines()[-1]))


def nasnet_gate(model_dir, label="nasnet_gate", **estimator_kwargs):
    """The flagship-family gate on the card: the gate's NASNet (3 cells, 8
    filters, bf16, K2 and K1 on) on 8192 digits for 300 steps, evaluated
    on 2048: accuracy >= 0.88 and above the linear baseline; the launch
    counts exact. `estimator_kwargs` go to the Estimator (the
    `nasnet_gate_bf16` phase: the bf16 step policy and device prefetch,
    tests/test_convergence.py::test_nasnet_family_converges_bf16_steps).
    Returns (counts, numbers, K2's shapes a forward)."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.examples.synthetic_digits import image_input_fn, make_dataset
    from adanet_tpu_torch.research.improve_nas import improve_nas, optimizer
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3, eps=1e-8)

    builder = improve_nas.Builder(optimizer.fn_with_name("adam"), nasnet_gate_hparams(), seed=0)
    xtr, ytr = make_dataset(GATE_TRAIN, seed=7)
    xte, yte = make_dataset(GATE_TEST, seed=8)
    estimator = Estimator(
        MultiClassHead(10), SimpleGenerator([builder]), max_iteration_steps=GATE_STEPS, max_iterations=1,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=adam, use_fused_combine=True)],
        model_dir=os.path.join(model_dir, label), log_every_steps=0, device="cuda", **estimator_kwargs,
    )
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    estimator.train(image_input_fn(xtr, ytr, TRAIN_BATCH), max_steps=10**6)
    torch.cuda.synchronize()
    train_secs = time.perf_counter() - t0
    metrics = estimator.evaluate(image_input_fn(xte, yte, TRAIN_BATCH))
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    shapes = builder.build_subnetwork(10, input_shape=xtr.shape[1:]).nasnet.sepconv_launch_shapes()
    eval_batches = -(-GATE_TEST // TRAIN_BATCH)
    expected = dict(copy=0, cell=0, sepconv=_member_forwards(1, GATE_STEPS, eval_batches, 1) * len(shapes),
                    combine=GATE_STEPS + eval_batches)
    if counts != expected:
        raise AssertionError("%s: launches %s, expected %s" % (label, counts, expected))
    if not (metrics["accuracy"] >= GATE_ACCURACY and metrics["accuracy"] > LINEAR_BASELINE_ACCURACY):
        raise AssertionError("%s: accuracy %s below the gate %s" % (label, metrics, GATE_ACCURACY))
    if estimator._open_prefetchers:
        raise AssertionError("%s: prefetchers left open" % label)
    out = dict(accuracy=metrics["accuracy"], top_5_accuracy=metrics["top_5_accuracy"], loss=metrics["loss"],
               steps=estimator.latest_global_step(), ms_per_step=train_secs / GATE_STEPS * 1e3, seconds=secs,
               launches=counts, estimator=sorted(estimator_kwargs), card=card_line())
    print("%s: %s" % (label, json.dumps(out)))
    return counts, out, shapes


def train_nasnet_mobile(model_dir, seed):
    """NASNet-A Mobile at full width on the card under the throughput
    configuration: `TPUEstimator` (windows of 8, bf16 steps, device
    prefetch, a checkpoint every 8 steps) over 2 iterations x 16 steps of
    224 x 224 x 3 images, 1001 classes, then `evaluate` and `predict` of
    a ragged stream padded to 32 (and unpadded, to compare). Launch
    counts zeroed just before and read just after must be exact.
    Iteration 1's first window is timed (host clock and CUDA events) and
    its second profiled (`utils.device_timing`). Returns (launch counts,
    the `train_nasnet_mobile:` numbers, K2's (shape, batch) cases)."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core import TPUEstimator
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.models import mobile_imagenet_config
    from adanet_tpu_torch.research.improve_nas import fake_data, improve_nas, optimizer
    from adanet_tpu_torch.utils import device_timing

    # NASNet-A Mobile (checked against `mobile_imagenet_config` below),
    # ADAPTIVE, K2 on, the improve_nas defaults otherwise.
    hparams = improve_nas.Hparams(
        num_cells=12, num_conv_filters=44, stem_multiplier=1.0, drop_path_keep_prob=1.0,
        dense_dropout_keep_prob=0.5, use_aux_head=True, stem_type="imagenet", use_pallas_sep_conv=True,
        knowledge_distillation=improve_nas.KnowledgeDistillation.ADAPTIVE,
        total_training_steps=2 * MOBILE_STEPS,
    )
    generator = improve_nas.Generator(
        optimizer.fn_with_name("momentum", "cosine", cosine_decay_steps=MOBILE_STEPS), hparams, seed=seed,
        num_classes=MOBILE_CLASSES,
    )
    shape = (MOBILE_SIZE, MOBILE_SIZE, 3)
    module = improve_nas.Builder(None, hparams).build_subnetwork(MOBILE_CLASSES, input_shape=shape)
    preset = mobile_imagenet_config(total_training_steps=2 * MOBILE_STEPS, use_pallas_sep_conv=True)
    if module.config != preset:
        raise AssertionError("train_nasnet_mobile: %s is not the preset %s" % (module.config, preset))
    sep_shapes = module.nasnet.sepconv_launch_shapes()
    provider = fake_data.FakeImageProvider(
        num_examples=MOBILE_EXAMPLES, image_size=MOBILE_SIZE, num_classes=MOBILE_CLASSES, batch_size=MOBILE_BATCH,
        seed=seed,
    )
    windows = []

    class Timed(TPUEstimator):
        def _build_iteration(self, iteration_number, sample_batch):
            iteration = super()._build_iteration(iteration_number, sample_batch)
            run = iteration.train_steps

            def timed(state, batches):
                record = dict(iteration=iteration_number, steps=len(batches))
                index = len(windows)
                windows.append(record)
                if index == MOBILE_TRACED_WINDOW:
                    out = {}
                    secs, kernels = device_timing.time_steps_on_device(
                        lambda: out.update(result=run(state, batches)))
                    record.update(device_busy_ms=secs * 1e3, kernels=kernels)
                    result = out["result"]
                else:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    host0 = time.perf_counter()
                    start.record()
                    result = run(state, batches)
                    end.record()
                    torch.cuda.synchronize()
                    record.update(host_ms=(time.perf_counter() - host0) * 1e3, event_ms=start.elapsed_time(end))
                record["losses"] = {k: v for k, v in result[1].items() if "loss" in k}
                return result

            iteration.train_steps = timed
            return iteration

    def sgd(params):
        return torch.optim.SGD(params, lr=0.01)

    estimator = Timed(
        MultiClassHead(MOBILE_CLASSES), generator, max_iteration_steps=MOBILE_STEPS, max_iterations=2,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=sgd, use_fused_combine=True)], force_grow=True,
        model_dir=os.path.join(model_dir, "mobile"), log_every_steps=0, random_seed=seed, device="cuda",
        iterations_per_loop=MOBILE_WINDOW, step_compute_dtype="bfloat16", prefetch_buffer=2,
        prefetch_to_device=True, save_checkpoint_steps=MOBILE_WINDOW, predict_batch_size=MOBILE_BATCH,
    )
    images, labels = provider._images, provider._labels

    def ragged():
        start = 0
        for rows in MOBILE_PREDICT_ROWS:
            yield {"image": images[start:start + rows]}, labels[start:start + rows]
            start += rows

    def test_input_fn():
        for i in range(MOBILE_EVAL_BATCHES):
            rows = slice(i * MOBILE_BATCH, (i + 1) * MOBILE_BATCH)
            yield {"image": images[rows]}, labels[rows]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    estimator.train(provider.get_input_fn("train"), max_steps=10**6)
    torch.cuda.synchronize()
    train_secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    metrics = estimator.evaluate(test_input_fn)
    padded = list(estimator.predict(ragged))
    plain = list(estimator.predict(ragged, predict_batch_size=0))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if estimator._open_prefetchers:
        raise AssertionError("train_nasnet_mobile: prefetchers left open")
    steps = estimator.latest_global_step()
    losses = torch.stack([v.float() for w in windows for v in w.pop("losses").values()]).tolist()
    if not all(map(math.isfinite, losses)) or not math.isfinite(metrics["loss"]):
        raise AssertionError("train_nasnet_mobile: non-finite losses %s, %s" % (losses, metrics))
    predict_forwards = 2 * len(MOBILE_PREDICT_ROWS) * 2  # padded and plain, two members
    forwards = _member_forwards(2, MOBILE_STEPS, MOBILE_EVAL_BATCHES, 2) + predict_forwards
    # K1: one an ensemble update a candidate a step (1 at t = 0; the
    # carried-over winner and the grown one at t = 1) and the ADAPTIVE
    # teacher at t = 1; one an eval batch and a predict batch.
    expected = dict(copy=0, cell=0, sepconv=forwards * len(sep_shapes),
                    combine=MOBILE_STEPS * (1 + 3) + MOBILE_EVAL_BATCHES + 2 * len(MOBILE_PREDICT_ROWS))
    if steps != 2 * MOBILE_STEPS or counts != expected or len(windows) != 2 * MOBILE_STEPS // MOBILE_WINDOW:
        raise AssertionError("train_nasnet_mobile: %d steps, %d windows, launches %s, expected %s"
                             % (steps, len(windows), counts, expected))
    predict_err = 0.0
    for rows, a, b in zip(MOBILE_PREDICT_ROWS, padded, plain):
        if a["logits"].shape != (rows, MOBILE_CLASSES) or b["logits"].shape != a["logits"].shape:
            raise AssertionError("train_nasnet_mobile: predict rows %s / %s, expected %d"
                                 % (a["logits"].shape, b["logits"].shape, rows))
        # Other batch sizes may take other cuDNN algorithms: bf16 sums in
        # another order, so at a tolerance of the logits' scale.
        predict_err = max(predict_err, check_close("padded predict", a["logits"], b["logits"],
                                                   2e-2 * max(1.0, float(b["logits"].abs().max()))))
    for t in range(2):
        if not os.path.exists(os.path.join(estimator.model_dir, "architecture-%d.json" % t)):
            raise AssertionError("train_nasnet_mobile: architecture-%d.json was not written" % t)
    timed, traced = windows[MOBILE_TIMED_WINDOW], windows[MOBILE_TRACED_WINDOW]
    host_ms = timed["host_ms"] / MOBILE_WINDOW
    busy_ms = traced["device_busy_ms"] / MOBILE_WINDOW
    batch = torch.from_numpy(images[:MOBILE_BATCH])
    pinned = batch.pin_memory()
    stats = dict(
        steps=steps,
        k2_launches_per_member_forward=len(sep_shapes),
        search_ms_per_step=train_secs / steps * 1e3,
        train_secs=train_secs,
        window_host_ms_per_step=host_ms,
        window_event_ms_per_step=timed["event_ms"] / MOBILE_WINDOW,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1.0 - busy_ms / host_ms,
        kernels_per_step=traced["kernels"] / MOBILE_WINDOW,
        windows=windows,
        max_memory_allocated_bytes=peak,
        h2d_batch_ms_pinned=cuda_time_ms(lambda: pinned.to("cuda", non_blocking=True), iters=10),
        h2d_batch_ms_pageable=cuda_time_ms(lambda: batch.to("cuda"), iters=10),
        h2d_batch_mbytes=batch.numel() * 4 / 1e6,
        first_losses=losses[:4],
        last_losses=losses[-4:],
        accuracy=metrics["accuracy"],
        loss=metrics["loss"],
        best_ensemble=metrics["best_ensemble"],
        padded_predict_max_abs_err=predict_err,
        launches=counts,
        card=card_line(),
    )
    print("train_nasnet_mobile: " + json.dumps(stats))
    cases = {(s, MOBILE_BATCH) for s in sep_shapes} | {(s, MOBILE_PREDICT_ROWS[-1]) for s in sep_shapes}
    return counts, stats, cases


def windows_vs_steps(model_dir):
    """Windows leave results as they are, on the card: the gate's NASNet
    model (3 cells, 8 filters, bf16, K2 on) over 2 iterations x 16 steps
    with `iterations_per_loop=8` and device prefetch (W), against two runs
    of single steps without prefetch (A, B). W's `frozen-1.pt` equals
    A's bitwise if B's does, else deviates from it by at most twice B's
    deviation (`resume_nasnet`'s reckoning); the launch counts of all
    three are equal. Prints ms a step of each (a reading, not a claim).
    Returns the numbers."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core import checkpoint as ckpt
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.examples.synthetic_digits import image_input_fn, make_dataset
    from adanet_tpu_torch.research.improve_nas import improve_nas, optimizer

    xtr, ytr = make_dataset(TRAIN_BATCH * WINDOWS_STEPS, seed=7)

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3, eps=1e-8)

    def run(name, **kwargs):
        estimator = Estimator(
            MultiClassHead(10), improve_nas.Generator(optimizer.fn_with_name("adam"), nasnet_gate_hparams(), seed=0),
            max_iteration_steps=WINDOWS_STEPS, max_iterations=2,
            ensemblers=[ComplexityRegularizedEnsembler(optimizer=adam, use_fused_combine=True)], force_grow=True,
            model_dir=os.path.join(model_dir, "windows", name), log_every_steps=0, device="cuda", **kwargs,
        )
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        estimator.train(image_input_fn(xtr, ytr, TRAIN_BATCH), max_steps=10**6)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (ops.launch_counts(), ckpt.restore_payload(estimator.model_dir, "frozen-1.pt"),
                secs / (2 * WINDOWS_STEPS) * 1e3)

    single_a = run("single_a")
    windowed = run("windowed", iterations_per_loop=8, prefetch_buffer=2, prefetch_to_device=True)
    single_b = run("single_b")
    spread = _tree_deviation(single_b[1], single_a[1])
    deviation = _tree_deviation(windowed[1], single_a[1])
    if single_a[0] != windowed[0] or single_b[0] != windowed[0]:
        raise AssertionError("windows_vs_steps: launches %s, %s, %s" % (single_a[0], windowed[0], single_b[0]))
    if deviation > 2 * spread:
        raise AssertionError("windows_vs_steps: windows deviate by %g from single steps, whose spread is %g"
                             % (deviation, spread))
    out = dict(steps=2 * WINDOWS_STEPS, launches=windowed[0], single_steps_spread=spread,
               windows_deviation=deviation, windows_deviation_from_second=_tree_deviation(windowed[1], single_b[1]),
               bitwise=deviation == 0.0,
               single_ms_per_step=[single_a[2], single_b[2]], windowed_ms_per_step=windowed[2], card=card_line())
    print("windows_vs_steps: " + json.dumps(out))
    return out


def check_train_sepconv(cases, gen):
    """K2 forward and its gradient through `_FusedSepConv` against the
    plain version at every (shape, batch, dtype) the training phases
    launch: the forward within `check_kernels`' tolerances (f32 atol
    1e-4, TF32 off; bf16 2e-2 x max|ref|), the gradients of x, dw and pw
    against plain autograd within `check_sepconv_grads`' atol 1e-4 x
    max(1, max|ref|) in f32, one bf16 ulp of the largest (2^-7 x
    max|ref|) in bf16. Returns the worst errors."""
    import torch

    from adanet_tpu_torch.ops import sepconv_kernels as sk

    torch.backends.cudnn.allow_tf32 = False
    worst = collections.Counter()
    for ((h, w, c), f, k, s), batch, dtype_name in sorted(cases):
        dtype = getattr(torch, dtype_name)
        name = "K2 train %s b=%d %s" % ((h, w, c, f, k, s), batch, dtype_name)
        x = torch.randn(batch, h, w, c, generator=gen).cuda().to(dtype)
        dw = (torch.randn(c, 1, k, k, generator=gen) / k).cuda()
        pw = (torch.randn(f, c, 1, 1, generator=gen) / c ** 0.5).cuda()
        results = []
        for fn in (sk.fused_sep_conv, sk.sep_conv_reference):
            inputs = [t.clone().requires_grad_(True) for t in (x, dw, pw)]
            before = sk.fused_sep_conv.launches
            out = fn(*inputs, s)
            if fn is sk.fused_sep_conv and sk.fused_sep_conv.launches != before + 1:
                raise AssertionError("%s: not launched" % name)
            results.append((out, inputs))
        (got, got_in), (want, want_in) = results
        scale = float(want.detach().float().abs().max())
        tol = 1e-4 if dtype is torch.float32 else 2e-2 * scale
        worst["forward_" + dtype_name] = max(worst["forward_" + dtype_name], check_close(name, got, want, tol))
        cot = torch.randn(got.shape, generator=gen).cuda().to(dtype)
        for label, g, r in zip(("x", "dw", "pw"), torch.autograd.grad(got, got_in, cot),
                               torch.autograd.grad(want, want_in, cot)):
            scale = float(r.float().abs().max())
            # bf16: the gradients are rounded to bf16 (the weights' casts),
            # after sums in an order cuDNN may change from call to call.
            tol = 1e-4 * max(1.0, scale) if dtype is torch.float32 else 2.0 ** -7 * scale
            worst["grad_" + dtype_name] = max(worst["grad_" + dtype_name],
                                              check_close("%s d%s" % (name, label), g, r, tol))
    torch.cuda.synchronize()
    print("K2 at the training paths' %d (shape, batch, dtype) cases: forward and gradients match; worst %s"
          % (len(cases), dict(worst)))
    return dict(worst)


@contextlib.contextmanager
def relu_and_max_pool_switches(log, replay):
    """Within the block, each `torch.relu` and `F.max_pool2d` call appends
    to `log` where its relu passes and which input each max-pool window
    takes (`replay=False`), or takes them from `log` in call order
    (`replay=True`). A replayed call whose own switches differ from the
    record computes with the record's (relu as x * mask, the max pool as
    a gather at the recorded indices); the others are the plain calls.
    Yields {"relu": n, "max_pool": n}, the replayed calls that differed.
    Run on the CPU and then on the card over the same code, it removes
    the only non-smooth steps of a NASNet forward, so that what is left
    between the devices is summation order."""
    import torch
    import torch.nn.functional as F

    relu, max_pool2d = torch.relu, F.max_pool2d
    recorded = iter(list(log))
    switched = {"relu": 0, "max_pool": 0}

    def take(kind, own):
        got_kind, value = next(recorded)
        if got_kind != kind or value.shape != own.shape:
            raise AssertionError("replayed %s %s where the record has %s %s"
                                 % (kind, tuple(own.shape), got_kind, tuple(value.shape)))
        value = value.to(own.device)
        if torch.equal(value, own):
            return None
        switched[kind] += 1
        return value

    def switched_relu(x):
        mask = x > 0
        if not replay:
            log.append(("relu", mask.cpu()))
        elif (mask := take("relu", mask)) is not None:
            return x * mask.to(x.dtype)
        return relu(x)

    def switched_max_pool2d(x, kernel_size, stride):
        y, index = max_pool2d(x, kernel_size, stride, return_indices=True)
        if not replay:
            log.append(("max_pool", index.cpu()))
        elif (index := take("max_pool", index)) is not None:
            return torch.empty_like(y).copy_(x.flatten(2).gather(2, index.flatten(2)).view(y.shape))
        return y

    torch.relu, F.max_pool2d = switched_relu, switched_max_pool2d
    try:
        yield switched
    finally:
        torch.relu, F.max_pool2d = relu, max_pool2d
    if replay and next(recorded, None) is not None:
        raise AssertionError("the replay left recorded switches unused")


def _nasnet_step_grads(builder, batch, device):
    """One training forward of `builder`'s subnetwork (initialised from a
    fixed CPU generator) on `batch`: (loss, logits, gradients) on the
    CPU."""
    import torch

    from adanet_tpu_torch.core.heads import MultiClassHead

    module = builder.build_subnetwork(10, input_shape=batch[0]["image"].shape[1:])
    module.init_parameters(torch.Generator().manual_seed(3))
    module.to(device)
    features, labels = ({"image": torch.from_numpy(batch[0]["image"]).to(device)},
                        torch.from_numpy(batch[1]).to(device))
    out = module(features, training=True)
    loss = builder.build_subnetwork_loss(out, labels, MultiClassHead(10), None)
    grads = torch.autograd.grad(loss, list(module.parameters()))
    return float(loss.detach()), out.logits.detach().cpu(), torch.cat([g.reshape(-1).cpu() for g in grads])


def _nasnet_parity_run(device, batches, input_shape, use_pallas_sep_conv):
    """2 iterations x NASNET_PARITY_STEPS `Iteration` steps of the gate
    model (`DynamicGenerator`, f32, the trainer's momentum and cosine)
    on `device`: (each step's metrics and mixture weights, the best
    index of each iteration, iteration 1's builder names, {name: builder},
    the K2 (shape, batch) pairs)."""
    import torch

    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.core.iteration import IterationBuilder
    from adanet_tpu_torch.ensemble.strategy import GrowStrategy
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.research.improve_nas import improve_nas, optimizer

    def adam(params):
        # Fused: one arithmetic on the card and the CPU (see `search_parts`).
        return torch.optim.Adam(params, lr=1e-3, eps=1e-8, fused=True)

    generator = improve_nas.DynamicGenerator(
        optimizer.fn_with_name("momentum", "cosine", cosine_decay_steps=NASNET_PARITY_STEPS),
        nasnet_gate_hparams(compute_dtype=torch.float32, initial_learning_rate=0.025,
                            use_pallas_sep_conv=use_pallas_sep_conv), seed=0)
    factory = IterationBuilder(MultiClassHead(10), [ComplexityRegularizedEnsembler(
        optimizer=adam, use_fused_combine=True)], [GrowStrategy()], device=device)
    trace, best, previous, architectures, shapes = [], [], None, {}, set()
    for t in range(2):
        sample = batches[t * NASNET_PARITY_STEPS]
        builders = generator.generate_candidates(previous, t, [], [])
        iteration = factory.build_iteration(t, builders, previous, input_shape=input_shape)
        for builder, spec in zip(builders, iteration.subnetwork_specs):
            architectures[builder.name] = builder
            shapes.update((shape, NASNET_PARITY_BATCH) for shape in spec.module.nasnet.sepconv_launch_shapes())
        state = iteration.init_state(torch.Generator().manual_seed(t), sample)
        for i in range(NASNET_PARITY_STEPS):
            state, metrics = iteration.train_step(state, batches[t * NASNET_PARITY_STEPS + i])
            row = {k: float(v) for k, v in metrics.items()}
            for name, est in state.ensembles.items():
                for j, w in enumerate(est.params["weights"]):
                    row["weight/%s/%d" % (name, j)] = float(w.detach())
            trace.append(row)
        best.append(iteration.best_candidate_index(state))
        previous = iteration.freeze_candidate(state, iteration.ensemble_specs[best[-1]].name, sample)
    return trace, best, [b.name for b in builders], architectures, shapes


def _compare_traces(what, card, cpu, card_best, cpu_best, atol):
    """Max abs difference of two runs' per-step values; raises past
    `atol` x max(1, |value|) or on another selection."""
    worst = 0.0
    for step, (got, want) in enumerate(zip(card, cpu)):
        if sorted(got) != sorted(want):
            raise AssertionError("%s step %d: metrics %s vs %s" % (what, step, sorted(got), sorted(want)))
        for key, value in want.items():
            err = abs(got[key] - value)
            if not err <= atol * max(1.0, abs(value)):
                raise AssertionError("%s step %d %s: card %r, cpu %r" % (what, step, key, got[key], value))
            worst = max(worst, err)
    if card_best != cpu_best:
        raise AssertionError("%s: best %s on the card, %s on the CPU" % (what, card_best, cpu_best))
    return worst


def _compare_step_grads(what, card, cpu, grad_rel):
    """One training step's (loss, logits, gradient) on the card against
    the CPU: loss and logits within atol 1e-5 x max(1, |value|), the
    gradient within `grad_rel` of its norm."""
    (loss_c, logits_c, grads_c), (loss_p, logits_p, grads_p) = card, cpu
    if not abs(loss_c - loss_p) <= 1e-5 * max(1.0, abs(loss_p)):
        raise AssertionError("%s: loss %r on the card, %r on the CPU" % (what, loss_c, loss_p))
    check_close(what + " logits", logits_c, logits_p, 1e-5 * max(1.0, float(logits_p.abs().max())))
    rel = float((grads_c - grads_p).norm() / grads_p.norm())
    if not rel <= grad_rel:
        raise AssertionError("%s: gradient off by %g of its norm" % (what, rel))
    return dict(loss=abs(loss_c - loss_p), logits=float((logits_c - logits_p).abs().max()), grad_rel_norm=rel)


def nasnet_train_vs_cpu():
    """The gate model on the card and on the CPU, f32, drop-path off, TF32
    off, with the `DynamicGenerator` (iteration 1 at 6 x 8 and 3 x 18
    from a 3 x 8 winner, or 6 x 18 and 3 x 28 from a 3 x 18 one: widths
    that are not multiples of 8), from the same init (the iteration's CPU
    generator) and batches, with the trainer's optimizer (momentum,
    cosine).

    A NASNet gradient is not smooth at f32 rounding: a relu input within
    rounding of 0, or a max-pool window whose two largest inputs are
    within rounding of each other, switches where the gradient goes, and
    the card and the CPU round differently. So the phase runs twice:

    - `replayed`: K2 off (the plain layers, the same torch calls on both
      devices), the CPU first, recording each relu's and max pool's
      switches (`relu_and_max_pool_switches`), then the card taking
      them. 2 x NASNET_PARITY_STEPS steps: per-step losses and mixture
      weights within `train_vs_cpu`'s atol 1e-4 x max(1, |value|), the
      same selection; one step of every architecture: the gradient
      within NASNET_REPLAYED_GRAD of its norm. Measured 4.8e-7 and
      6.5e-7 to 1.1e-6, with 46 to 49 of 2447 calls switched (44-45
      relu, 2-4 max pool; H100 80GB HBM3, 700 W).
    - `as_run`: K2 on, nothing replayed. The switches part the runs:
      one step's gradient by 1.0e-6 to 2.3e-3 of its norm by
      architecture, the losses by up to 1.4e-3 within 3 steps (H100
      80GB HBM3, 700 W). Checked at NASNET_AS_RUN_GRAD of the
      gradient's norm and atol 5e-3 x max(1, |value|) over the steps.

    Returns (numbers, the K2 shapes launched with their batch)."""
    import torch

    from adanet_tpu_torch.examples.synthetic_digits import image_input_fn, make_dataset

    x, y = make_dataset(NASNET_PARITY_BATCH * NASNET_PARITY_STEPS * 2, seed=7)
    batches = list(image_input_fn(x, y, NASNET_PARITY_BATCH)())
    previous_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        card, cpu = (_nasnet_parity_run(device, batches, x.shape[1:], True) for device in ("cuda", "cpu"))
        shapes = card[4]
        as_run = dict(max_abs_err=_compare_traces("nasnet_train_vs_cpu as_run", card[0], cpu[0], card[1], cpu[1],
                                                  5e-3), tolerance="5e-3 x max(1, |value|)", one_step={})
        for name, builder in sorted(card[3].items()):
            as_run["one_step"][name] = _compare_step_grads(
                "nasnet_train_vs_cpu as_run %s" % name,
                *(_nasnet_step_grads(builder, batches[0], device) for device in ("cuda", "cpu")),
                grad_rel=NASNET_AS_RUN_GRAD)
        out["as_run"] = as_run
        switches = []
        with relu_and_max_pool_switches(switches, replay=False):
            cpu = _nasnet_parity_run("cpu", batches, x.shape[1:], False)
            cpu_steps = {name: _nasnet_step_grads(b, batches[0], "cpu") for name, b in sorted(cpu[3].items())}
        with relu_and_max_pool_switches(switches, replay=True) as switched:
            card = _nasnet_parity_run("cuda", batches, x.shape[1:], False)
            card_steps = {name: _nasnet_step_grads(b, batches[0], "cuda") for name, b in sorted(card[3].items())}
        replayed = dict(max_abs_err=_compare_traces("nasnet_train_vs_cpu replayed", card[0], cpu[0], card[1], cpu[1],
                                                    1e-4), tolerance="1e-4 x max(1, |value|)",
                        calls=len(switches), switched=switched, one_step={})
        for name in sorted(cpu_steps):
            replayed["one_step"][name] = _compare_step_grads(
                "nasnet_train_vs_cpu replayed %s" % name, card_steps[name], cpu_steps[name],
                grad_rel=NASNET_REPLAYED_GRAD)
        out["replayed"] = replayed
    finally:
        torch.backends.cudnn.allow_tf32 = previous_tf32
    out.update(steps=len(card[0]), values_per_step=len(card[0][-1]), best=card[1], builders_t1=card[2])
    print("nasnet_train_vs_cpu: " + json.dumps(out))
    return out, shapes


def trainer_on_card():
    """The trainer CLI on the card, on fake data, at a small size."""
    from adanet_tpu_torch.research.improve_nas import trainer

    t0 = time.perf_counter()
    rc = trainer.main([*TRAINER_SMALL, "--boosting_iterations=2", "--train_steps=8", "--device=cuda"])
    if rc != 0:
        raise AssertionError("trainer returned %r" % rc)
    print("trainer: rc %d in %.1f s" % (rc, time.perf_counter() - t0))


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
        combine_errors, _ = check_combine(rng)
        errors["combine"] = max([errors["combine"]] + list(combine_errors.values()))
        errors["cell"] = check_cells(rng)
        print("kernel checks passed: max abs err %s" % errors)
        counts, served = serve(model_dir, sep_shapes, rng)
        tune_counts, tuned = autotune_path(rng)
        # The single-kernel traces come before the batch's large one
        # (23,000 kernels), after which the tracer has been seen to
        # deliver no kernels; device_ms then falls back to queued events.
        combine_rows = time_combine(rng)
        rows, per_shape, host = time_kernels(sep_shapes, combine_rows, rng)
        rows["cell"], cell_rows, cell_host = time_cells(rng)
        host.update(cell_host)
        time_tuned(tuned)
        trace_served_combine(gen_dir, rng)
        check_sepconv_grads(sep_shapes, rng)
        train_counts, _ = train_search(model_dir)
        train_vs_cpu()
        nasnet_counts, _ = train_nasnet(model_dir)
        with deterministic_cudnn():
            resume_counts, _ = resume_nasnet(model_dir)
        gate_counts, _, gate_shapes = nasnet_gate(model_dir)
        _, parity_cases = nasnet_train_vs_cpu()
        with deterministic_cudnn():
            windows_vs_steps(model_dir)
        gate_bf16_counts, _, _ = nasnet_gate(model_dir, "nasnet_gate_bf16", step_compute_dtype="bfloat16",
                                             prefetch_buffer=2, prefetch_to_device=True)
        mobile_counts, _, mobile_cases = train_nasnet_mobile(model_dir, args.seed)
        for n in SEARCH_COMBINE_MEMBERS:
            check_search_combine(n, False, rng, batch=MOBILE_BATCH, classes=MOBILE_CLASSES)
        train_cases = (
            {(shape, NASNET_BATCH, "bfloat16") for shape in sep_shapes}
            | {(shape, TRAIN_BATCH, "bfloat16") for shape in gate_shapes}
            | {(shape, batch, "float32") for shape, batch in parity_cases}
            | {(shape, batch, "bfloat16") for shape, batch in mobile_cases}
        )
        train_errors = check_train_sepconv(train_cases, rng)
        errors["sepconv"] = max(errors["sepconv"], train_errors["forward_float32"], train_errors["forward_bfloat16"])
        trainer_on_card()
        profile_batch(gen_dir, rng)
        compare_with_cpu(gen_dir, rng)
    # Each kernel's launches on the main path that runs it: serving for
    # K0-K2, the autotuner for K3; K1's on the search path beside them.
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
        if name == "combine":
            kernels[-1]["train_launches"] = train_counts["combine"]
            kernels[-1]["nasnet_train_launches"] = nasnet_counts["combine"]
            kernels[-1]["nasnet_gate_launches"] = gate_counts["combine"]
            kernels[-1]["resume_launches"] = resume_counts["combine"]
            kernels[-1]["nasnet_gate_bf16_launches"] = gate_bf16_counts["combine"]
            kernels[-1]["nasnet_mobile_launches"] = mobile_counts["combine"]
        if name == "sepconv":
            kernels[-1]["train_launches"] = nasnet_counts["sepconv"]
            kernels[-1]["nasnet_gate_launches"] = gate_counts["sepconv"]
            kernels[-1]["resume_launches"] = resume_counts["sepconv"]
            kernels[-1]["nasnet_gate_bf16_launches"] = gate_bf16_counts["sepconv"]
            kernels[-1]["nasnet_mobile_launches"] = mobile_counts["sepconv"]
            kernels[-1]["train_grad_max_abs_err"] = {
                k: v for k, v in train_errors.items() if k.startswith("grad")}
    print("copy_vs_clone: " + json.dumps({key: rows["copy"][key] for key in (
        "ms", "library_ms", "device_us", "library_device_us", "device_sources", "library_device_kernels",
        "host_us", "library_host_us")}))
    print("sepconv_shapes: " + json.dumps(per_shape))
    print("sepconv_forward: " + json.dumps(rows["sepconv"]))
    print("host_enqueue: " + json.dumps(host))
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
