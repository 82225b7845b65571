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
   with count 1, fixed mixture weights. It publishes `gen-0`, serves mixed
   requests of 1 to 32 rows through ServingFrontend -> Batcher ->
   ModelPool, checks every result is ok, finite and well formed, and
   checks the launch counts (zeroed just before): one K0 per gated
   generation, one K1 per executed program call, 400 K2 per K1. A last
   burst runs twice with an empty tuning store registered (no serving
   winners), so that the tuning lookup's cost shows: one store read per
   K2 signature in the first, none for a signature already planned.
   Then the pool's program, at 1, 7 and 32 rows, bitwise the in-process
   predict of the same ensemble (built from the same seed here).
5. Compares one bucket of the ensemble at f32 compute on the card
   against the same ensemble on the CPU.
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
   32 of fake 32 x 32 x 3 images, 2 iterations x 14 steps through
   `Estimator.train` with the `Generator`, then `evaluate`; launch counts
   zeroed just before and read just after must be exact (K2: 200 a
   member forward; K1: one an ensemble update, the teacher's, one an
   eval batch), every loss finite, both architectures written. Prints
   `train_nasnet:` (ms a step by the host clock and CUDA events over
   steps 18-22, device busy and idle share, kernels, K2 launches and
   K2's forward and `_FusedSepConv` backward device ms a step over 3
   traced steps, peak memory, the card line).
14. `nasnet_gate`: the flagship-family gate (tests/test_convergence.py:
   119-157, 3 cells, 8 filters, bf16, 300 steps of adam on 8192 digits)
   with K2 and K1 on: accuracy >= 0.88 and above 0.76, exact counts.
15. `nasnet_train_vs_cpu`: the gate model in f32 with the
   `DynamicGenerator` (widths that are not multiples of 8) on the card
   and on the CPU, 2 iterations x 2 steps with the trainer's momentum
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
   6 steps, a checkpoint every 3, one fixed batch): a search stopped by
   max_steps at global step 8 is rebuilt and restored by a fresh
   Estimator, every tensor of the state bitwise equal to the live one
   (the CUDA generator's state included); two uninterrupted runs and
   the stopped one resumed: the same architecture files byte for byte,
   `frozen-1.pt` bitwise equal if the two uninterrupted runs are, else
   within twice their spread, the resumed run's K1 and K2 counts exact
   (zeroed just before its train(), read after its evaluate()); the
   trainer CLI in a subprocess, SIGTERMed inside iteration 1, exits 0
   with a mid-iteration checkpoint and a second run resumes it to the
   end (2 x 10 steps). Prints `resume_nasnet:` (bytes of `ckpt-8.pt` and `frozen-0.pt`,
   ms a save split into device-to-host, serialise, digest and write
   with fsync, ms a restore, a save's share of a step, the deviations,
   the phase's seconds, the card line).
17. `windows_vs_steps`: the gate model (3 cells, 8 filters, bf16, K2
   on) over 2 iterations x 8 steps in windows of 8 with device prefetch
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
   (bitwise the same rows inside unpadded batches of 32; against the
   rows at their own batch size, the same ensemble rebuilt at f32 within
   2e-2 x max(1, |logits|), bf16 within its own distance from f32 at those
   rows); exact K1 and K2 counts (160 K2 a member
   forward); `train_nasnet_mobile:` prints ms a step by the host clock
   and CUDA events over iteration 1's first window, device busy ms, the
   idle share and kernels a step over its second (`utils.device_timing`),
   the peak memory and a 224 x 224 batch's copy to the card, pinned and
   pageable. K1 is then held at [1|2, 32, 1001] forward and backward,
   and K2 forward and gradient at every (shape, batch) this path
   launches (batches 32 and 7, C = 11 to 176).

20. Sixth main path, selection (`search_selection`, after phase 12): the
   gate's search at full width with an Evaluator on 1024 held-out digits
   (seed 9; adanet_loss, minimized), a ReportMaterializer over 8 training
   batches, a weighted (K1) and a mean ensembler under GrowStrategy,
   example weights in [0.5, 1.5] from --seed (unit weights on the test
   and validation digits) and every candidate's final state kept:
   accuracy >= 0.88 and above 0.76; each iteration's winner the nanargmin
   of the Evaluator values in `candidate-metrics-<t>.json` and named by
   `architecture-<t>.json`; `evaluate_all_candidates(t)` on the retained
   state within 1e-5 x max(1, |value|) of those values; every subnetwork
   in `iteration_reports.json`, exactly the winner's new members
   included, and the generator at t = 1 given iteration 0's included
   reports; K1's launches exact (one a weighted candidate's step,
   Evaluator batch and `evaluate_all_candidates` batch, one a test batch
   of a weighted winner; none for a mean candidate). `selection:` prints
   ms a step (host clock, CUDA events), a traced step's kernels, the
   Evaluator's, the reports' and `evaluate_all_candidates`' seconds, the
   bytes and save ms of `iteration-final-<t>.pt`, the launches.
21. `selection_vs_cpu`: that search at 2 x 50 steps on the card and the
   CPU from one converted init (fused Adam on both): Evaluator values,
   candidate losses and the final metrics within 1e-4 x max(1, |value|),
   the same winner wherever the CPU's two best are further apart.
22. `multi_head_search`: simple_dnn (128 wide) on the digits under a
   MultiHead (digit, even, value) and under a MultiLabelHead over the
   digit's four-bit code, 2 x 100 steps through train, evaluate and
   predict; K1 launches 0 on the multi-head path (dict logits never
   fuse) and exact on the multi-label one; the multi-head search stopped
   at step 150 restored bitwise by a fresh Estimator and resumed; card
   against CPU at 2 x 20 steps within 1e-4 x max(1, |value|).
23. `heads_vs_cpu`: the five heads' losses, metrics (1e-5 x max(1,
   |value|)) and predictions (1e-6; class ids equal) at batch 4096 on
   the card against the CPU, with and without weights, with forced ties.
   Phases 20-23's command time is printed on `selection_phases:`.
24. `full_dnn_gate`: tests/test_convergence.py::
   test_search_converges_to_target_accuracy (8192 digits, simple_dnn 256
   wide with dropout 0.1, 3 x 800 steps, K1 fused): accuracy >= 0.94,
   top-5 >= 0.99, K1 exact (one a candidate a step, one a test batch);
   ms a step by the host clock and CUDA events over 100 steps of the
   last iteration, and 5 traced steps (kernels and K1 a step).
25. `cnn_search`: tests/test_convergence.py::test_cnn_family_converges
   (CNNBuilder 1 and 2 blocks, 32 channels, bf16 convolutions, 2 x 400
   steps): accuracy >= 0.89, K1 exact, the same timing fields;
   `cnn_vs_cpu`: 2 x 20 steps of it on the card and the CPU from one
   init, losses within (2 x 2 + 1) x 2^-8 x max(1, |value|), accuracy
   within one example of a batch, beside the CPU's bf16 against f32.
26. `autoensemble`: the bagging gate (three bootstrap-bagged MLPs, mean
   ensemble, 150 steps; bagged >= the best single member, K1 0), again
   with device prefetch (bagged streams closed at iteration end),
   transfer_learning at its defaults with cuDNN's TF32 at torch's default
   (accuracy > 0.3, TF32 off inside every step, the frozen member bitwise
   the pretrained one, K1 exact) and boston_housing (finite, K1 exact).
27. `replay_search`: the selection search at 2 x 50 steps, then replayed
   from its `replay.json`: written after each iteration, no Evaluator
   call, equal architecture files, K1 exact.
28. `tutorials`: adanet_objective at its slow test's settings (lambda 0
   grows a deeper member, lambda 1 keeps 1-layer ones), mnist_simple_dnn
   and cifar10_cnn at 150 steps. 29. `predict_debug`: predict and
   TPUEstimator.predict under debug=True raise on a NaN feature.
   Phases 24-29's command time is printed on
   `gates_autoensemble_replay_phases:`.
30. `cifar_trainer`: the improve_nas trainer CLI (`trainer.main`, K2 and
   K1 on) on synthetic archives in the published layouts written here
   (CIFAR-10: 5 x 10,000 training images; CIFAR-100: 50,000, fine
   labels; each test file 512 images, cut from 10,000 for the time
   limit) at its full width (NASNet-A 6@768, batch 32), 2 x 5 and
   2 x 3 steps and the evaluation over the test images: the native augment library loaded and its output bitwise
   numpy's on a batch of the archive, K1 and K2 launches exact (zeroed
   just before, read just after), finite metrics. `cifar_trainer:` prints
   each archive's write and load seconds, augment ms a batch (native,
   numpy, native again), ms a step over iteration 1 (host clock and CUDA
   events), peak memory, the metrics and launches.
31. `imagenet_autoensemble`: the ImageNet AutoEnsemble trainer CLI at its
   defaults (ResNet-50 width 64 + EfficientNet-B0, 224 x 224, batch 64,
   replication, K1 on) on its fake data, 2 x 10 steps: K1 exact, finite
   metrics, each subnetwork's training loss falling within its
   iteration (each step's kept for phase 33); ResNet-18 (width 8) and
   B0 with small inputs, f32, card against CPU from the same weights
   within 1e-5. Prints ms a step, a window's and a traced step's numbers (device
   busy, idle share, kernels), peak memory, the metrics. K1 is then held
   at the slice's shapes, [1|2, 32, 100] and [1|2, 64, 8] (`check_slice_
   combines`).
32. `modelflow`: the ModelFlow search of tests/test_experimental.py::
   test_parallel_scheduler_matches_sequential on the card, sequentially
   and under ParallelScheduler (three workers on the card), the best
   eval losses within rtol 1e-5; a weighted-ensembler search on the card
   and the CPU within 1e-5. Phases 30-32's command time is printed on
   `cifar_imagenet_modelflow_phases:`.
33. Placement (`placement_phases:` prints the group's command time).
   `imagenet_round_robin`: phase 31's CLI with `--placement=round_robin`
   (RoundRobinExecutor: each subnetwork in its group, the mixture
   weights in the ensemble group on eval-mode forwards of member copies
   synced every step; every group on the card): K1 exact, finite
   metrics, falling training losses, each step's training losses within
   IMAGENET_RR_LOSS_BOUND of phase 31's; ms a step, a window and a
   traced step, peak memory.
34. `round_robin_search`: phase 11's search under `RoundRobinStrategy()`:
   accuracy >= 0.88 and above 0.76, K1 exact, the subnetworks within
   1e-5 of phase 11's wherever both trained the same builders from the
   same winner; the fused-divergence bound of tests/test_distributed.py
   on the card (`round_robin_divergence`).
35. `round_robin_gate`: tests/test_imagenet_pipeline.py's ImageNet
   convergence gate under RoundRobin (image 32, ResNet-18 width 8 + B0,
   60 steps, batch 32): accuracy >= 0.5, K1 exact.
36. `spmd_two_process`: tests/torch_spmd_runner.py's search in two
   processes on the card (gloo, each feeding half of every batch, with
   a collective Evaluator and ReportMaterializer): the ranks' winners
   bitwise equal, within rtol 2e-4, atol 1e-5 of a one-process oracle
   on the card, each rank's K1 launches exact; one NCCL all-reduce of
   world size 1. 37. `chief_worker`: tests/torch_distributed_runner.py's
   chief and worker on the card sharing a model dir, and a lone worker's
   WorkerWaitTimeout inside train(); their processes start together with
   phase 36's, while phase 35 trains. K1 is then held at [1|2, 32, 8], [1|2, 8, 1] and [1|2,
   16, 1] (`check_placement_combines`).
38-41. Distributed placement, part two (`elastic_multihost_phases:`
   prints the group's command time). Phase 38 trains alone in this
   process; then phases 39-41's processes start together, four chains
   on threads (`start_elastic_multihost`). 38. `elastic_search`: phase 11's
   search under `ElasticWorkQueueStrategy(window_steps=8,
   speculate_steps=8)` (the lease-based work queue's drain, one process):
   accuracy >= 0.88 and above 0.76, K1 exact (one a candidate a step and
   one a test batch), the speculation's K1 launches 0 and its 16 steps
   grafted in; ms a step beside phase 11's, each drain's dispatched and
   reused steps. 39. `multihost_round_robin`: the ImageNet trainer's
   `build_estimator` at its defaults with `--placement=round_robin` in
   two processes on the card (gloo; owners [[0], [1], [0]], members
   synced through the store every step), both feeding the same batches,
   2 x 5 steps: iteration 0's training losses within
   IMAGENET_RR_LOSS_BOUND of phase 33's at the same steps, K1 exact on
   the chief (none on process 1), finite metrics; ms a step (host clock,
   CUDA events), ms and bytes a member sync, peak memory and the store's
   retained bytes a process. 40. `elastic_two_process`: phase 38's search
   in two processes over the process group's store, the selection and
   every frozen parameter bitwise phase 38's, the worker having run
   units; again with the worker SIGKILLed at its second unit
   (`workunit.execute`, lease TTL 2 s): the chief finishes alone, bitwise
   the same. 41. `multihost_peer_death`: tests/torch_chaos_multihost_runner.py
   on the card: a checkpoint torn on the card, then two processes resume
   it under multi-host RoundRobin and the peer is SIGKILLed at its third
   broadcast; the chief declares it lost (deadline 5 s), finishes the
   iteration with the survivor, persists it (the torn file quarantined,
   the dead candidate marked in the metrics file) and exits 0. Their K1
   shapes ([1|2, 128, 10], [1|2, 64, 8]) are held by `check_combine` and
   `check_slice_combines`; the peer-death search has no K1 (unfused).

42-48. Long context and export (`long_context_export_phases:` prints
   the group's command time). 42. `ring_attention`: q, k, v [8, 2048, 4,
   32] (the head shape of `TransformerConfig`'s defaults at sequence
   2048), f32 and bf16, causal and not: ring attention over 8 shards in
   this process against full attention, outputs and gradients (f32
   within the JAX tests' 2e-4 and 1e-3; bf16 within twice full
   attention's own bf16 distance from f32), ms and peak MB of each. 43.
   `ring_two_process`: the same f32 causal inputs over two processes on
   the card (gloo, blocks staged through the host; started after 42)
   against 2 shards in this process: within 1e-6; ms and bytes
   staged a step. 44. `long_context_search`: the tutorial at its
   defaults (seq 512, batch 16, 2 x 30 steps, 8 shards): accuracy, loss,
   best ensemble, ms a step, K1 exact; its first LONG_CONTEXT_CPU_STEPS
   steps on the CPU within LONG_CONTEXT_LOSS_BOUND, and the same steps
   at bf16 compute on the CPU (the control) outside it. 45.
   `transformer_full_width`: `TransformerConfig()` (vocab 32,000, 2
   layers, dim 128, seq 2048, bf16), batch 8, ring over 8 shards, 10
   steps: ms a step, device ms, peak GB, K1 exact. 46. `export_programs`:
   the long-context, simple_dnn (phase 11's) and a multi-head winner with
   member outputs exported; each served by a fresh process that imports
   only torch, numpy and `adanet_tpu_torch.ops` at 1, 7 and every bucket
   (bitwise `predict`, K1 exact inside it), and on the CPU at 1 and 7
   rows (EXPORT_CPU_BOUND); their processes run while 47 does. 47.
   `serve_while_search`, the chaos gate of tests/test_serving.py: phase
   11's search at 3 x SWS_STEPS with `export_serving` and the default
   cascade in a process of its own (`--sws-search`), SIGKILLed by a torn
   write of iteration 1's frozen payload and started again, while a
   frontend serves the same model dir under `PoolConfig(canary_requests=
   2)` with its second flip (gen-1's) rotted at `serving.flip`: every
   request ok, also while the searcher is dead, >= 2 flips (the last by
   its canary window), gen-1 rolled back and quarantined, the last
   generation's answers bitwise the offline programs'; K1 exact in this
   process (one a served program call, the canary mirror's included, for
   each K1 in that program) and in the restarted searcher (iterations
   1-2's steps, the publications' sample and calibration calls, read off
   each program at its flip); level-0 share and agreement. 48.
   `serving_example`: the tutorial on the card (no K1: dict logits),
   in a process of its own beside 46-47. Then K1 at every shape the
   group launched it at (`check_group_combines`). Phases 42-45 have the
   card to themselves.
   The serving path (phases 4-5) publishes the hermetic program
   (`serving.pt2`) from a process of its own (`--publish-only`, at a
   lower priority), started after the kernel timings (phase 9) and
   collected after phase 32 (phases 10-32 share the host with it); the
   serving phase then follows. It prints `serve_nasnet_program:`
   (export and gate seconds, the program's operations, p50 beside PR
   6's).
   `store_warm_start` (after phase 11, whose search publishes both
   iterations to `<dir>/store`): a second Estimator in a fresh process
   (`--graft-only`) and model dir, given phase 11's `replay.json` and the
   store, grafts both iterations: zero training steps, batches, launches
   and nvcc builds, phase 11's payloads byte for byte, its predictions
   bitwise; `ckpt_fsck --json --store --gc --dry-run` with the closure
   leased: clean, nothing to collect. Prints the graft's seconds against
   phase 11's.
   `canary_flip` (after phase 4, on its pool, `PoolConfig(canary_
   requests=8)`, serving gen-0): CANARY_REQUESTS unmirrored bucket-32
   batches; gen-1 (gen-0's artifacts copied byte for byte under a
   manifest of its own) staged as the canary and promoted after
   CANARY_REQUESTS mirrored batches, divergence 0, K1 and K2 exactly
   twice the incumbent's in the window; gen-2 (its program rotted after
   its manifest) rejected before load, quarantined, not retried; a fixed
   request bitwise alike before and after; fsck selects generation 1.
   Prints the mirrored and unmirrored batch ms, the gate's load s and the
   launch counts.

Cut for the long-context and export phases' time (PR 15):
`nasnet_train_vs_cpu` 2 x 2 -> 2 x 1 steps, the SIGTERMed trainer 2 x 10
-> 2 x 4 steps, `tutorials`' mnist_simple_dnn and cifar10_cnn 150 -> 100
steps, `cifar_trainer` 2 x 5 -> 2 x 3 (CIFAR-10) and 2 x 3 -> 2 x 2
(CIFAR-100) steps and its test files 512 -> 128 images. No gate and no
kernel check was cut.

Cut for the placement phases' time (PR 13): `train_nasnet` 2 x 20 ->
2 x 14 steps (its timed window 10 -> 5 steps), `resume_nasnet` 2 x 10 ->
2 x 6 steps (checkpoints every 5 -> 3, the stop at 13 -> 8) and its
SIGTERMed trainer 2 x 50 -> 2 x 10, `windows_vs_steps` 2 x 16 -> 2 x 8,
`cifar_trainer` 2 x 20 -> 2 x 10 (CIFAR-10) and 2 x 10 -> 2 x 5
(CIFAR-100) steps and its test files 2,048 -> 1,024 images, the
SIGTERMed trainer 2 x 10. No gate and no kernel check was cut.

Cut for the elastic and multi-host phases' time:
`nasnet_train_vs_cpu` 2 x 4 -> 2 x 2 steps, `cifar_trainer` 2 x 10 -> 2 x
5 (CIFAR-10) and 2 x 5 -> 2 x 3 (CIFAR-100) steps and its test files
1,024 -> 512 images, `tutorials`' mnist_simple_dnn and cifar10_cnn 300 ->
150 steps. No gate and no kernel check was cut.

Prints the per-shape K2 and K3 timings, the served latency and
throughput, the `train:`, `train_nasnet:`, `resume_nasnet:`,
`nasnet_gate:`, `selection:`, `multi_head:`, `cifar_trainer:`,
`imagenet_autoensemble:` and `modelflow:` lines, `phase_secs:` (the
command time of each group of phases and the total), a `kernels` JSON
line (K1's row also with its launches on the search paths, K2's with its
launches on the NASNet training paths, `train_launches`; both with
`resume_launches`, `nasnet_gate_bf16_launches` and
`nasnet_mobile_launches`; K1's with `selection_launches`,
`multi_head_launches` (0), `multi_label_launches`, `full_gate_launches`,
`cnn_launches`, `bagging_launches` (0), `transfer_launches`,
`boston_launches` and `replay_launches`; K1's and K2's with
`cifar10_launches` and `cifar100_launches`, K1's with
`imagenet_ae_launches`, `imagenet_round_robin_launches`,
`round_robin_search_launches`, `round_robin_gate_launches` and
`spmd_two_process_launches` (one a rank), `multihost_round_robin_launches`
and `elastic_two_process_launches` (chief, worker), `elastic_search_launches`
and `speculation_launches` (0), `serve_while_search_searcher_launches` and
`store_warm_start_launches` (0); K0's, K1's and K2's with
`canary_flip_launches` and `canary_window_launches`), the
`store_warm_start:`, `canary_flip:`, `imagenet_round_robin:`,
`round_robin_search:`, `round_robin_gate:`, `spmd_two_process:`,
`chief_worker:`, `elastic_search:`, `multihost_round_robin:`,
`elastic_two_process:` and `multihost_peer_death:` lines,
and as its last line `{"ok": true, "device": {...}}`. Any failure raises
and exits non-zero.
"""

import argparse
import collections
import contextlib
import itertools
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
# The served program against the in-process predict: 1 and 7 rows and
# the largest bucket, bitwise.
SERVED_CHECK_ROWS = (1, 7, max(BUCKETS))
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
# The combines that the three-iteration searches (the full simple_dnn
# gate, replay) and AutoEnsemble add, as [N, batch, classes]: N = 3 and 4
# at [128, 10] (the full gate's t = 2, transfer_learning's grown
# ensembles) and boston_housing's regression logits, N = 1-3 at [32, 1].
SLICE_COMBINE_SHAPES = ((3, 128, 10), (4, 128, 10), (1, 32, 1), (2, 32, 1), (3, 32, 1))
# search_selection: the gate's search with a held-out validation set for
# the Evaluator (digits from seed 9), reports over this many training
# batches, and selection_vs_cpu's steps per iteration.
SELECTION_VALID, SELECTION_REPORT_STEPS, SELECTION_PARITY_STEPS = 1024, 8, 50
# multi_head_search: steps per iteration, the stop of its resumed run
# (inside iteration 1) and the card-against-CPU steps per iteration;
# heads_vs_cpu's batch.
MULTI_HEAD_STEPS, MULTI_HEAD_STOP, MULTI_HEAD_PARITY_STEPS = 100, 150, 20
# full_dnn_gate: tests/test_convergence.py::test_search_converges_to_target_accuracy
# (8192 and 2048 digits, simple_dnn 256 wide with dropout 0.1, 3 x 800 steps).
FULL_GATE_TRAIN, FULL_GATE_TEST, FULL_GATE_LAYER, FULL_GATE_DROPOUT = 8192, 2048, 256, 0.1
FULL_GATE_STEPS, FULL_GATE_ITERATIONS, FULL_GATE_ACCURACY, FULL_GATE_TOP5 = 800, 3, 0.94, 0.99
# cnn_search: tests/test_convergence.py::test_cnn_family_converges (CNNBuilder
# 1 and 2 blocks, 32 channels, lr 0.02, 2 x 400 steps); cnn_vs_cpu's steps.
CNN_TRAIN, CNN_TEST, CNN_CHANNELS, CNN_LR, CNN_STEPS, CNN_ACCURACY = 8192, 2048, 32, 0.02, 400, 0.89
CNN_PARITY_STEPS = 20
# cnn_vs_cpu's bound on losses, relative to max(1, |value|): twice the
# largest reading of the bf16 CPU search against itself with its
# parameters moved by 1e-7 (2.19e-4 on the H100 host's CPU), rounded up;
# each run asserts that its moved readings stay below it.
CNN_PARITY_BOUND = 5e-4
# autoensemble: tests/test_autoensemble.py::test_bagging_improves_accuracy
# (2048 noisy digits, 1024 test digits, 150 steps); transfer_learning's and
# boston_housing's steps an iteration at their defaults, and the transfer
# test digits; the reduced steps of mnist_simple_dnn and cifar10_cnn.
BAGGING_TRAIN, BAGGING_TEST, BAGGING_STEPS = 2048, 1024, 150
TRANSFER_STEPS, TRANSFER_TEST, BOSTON_STEPS, TUTORIAL_STEPS = 200, 1024, 200, 100
# The seeds of the CPU runs whose initial parameters are moved by 1e-7.
MOVED_SEEDS = (5, 11, 17)
HEADS_BATCH = 4096
# NASNet-A (6@768) training, the flagship: research/improve_nas Hparams()
# defaults (drop-path over the run's 40 steps, as the trainer sets
# total_training_steps), ADAPTIVE distillation, momentum with a cosine
# schedule, batch 32 (trainer.py's --batch_size), fake 32 x 32 x 3 images.
NASNET_BATCH, NASNET_STEPS, NASNET_ITERATIONS, NASNET_EXAMPLES = 32, 14, 2, 256
NASNET_WINDOW, NASNET_TRACED = 5, 3
# resume_nasnet: train_nasnet's configuration, 2 iterations of
# RESUME_STEPS with a checkpoint every RESUME_SAVE_EVERY steps, stopped at
# global step RESUME_STOP (inside iteration 1); saves and restores timed
# RESUME_SAVES times (medians), steps over a window of RESUME_WINDOW.
RESUME_STEPS, RESUME_SAVE_EVERY, RESUME_STOP, RESUME_SAVES, RESUME_WINDOW = 6, 3, 8, 3, 3
# The trainer CLI's small size (trainer_on_card), and the steps of its
# SIGTERM run (two iterations of half as many; the SIGTERM lands at
# iteration 1's start, so its first step ends the run).
TRAINER_SMALL = ["--dataset=fake", "--num_cells=3", "--num_conv_filters=4", "--batch_size=16"]
TRAINER_SIGTERM_STEPS = 8
# The flagship-family gate (tests/test_convergence.py:119-157): 3 cells,
# 8 filters, on the digits; adam 1e-3.
GATE_TRAIN, GATE_TEST, GATE_STEPS = 8192, 2048, 300
# nasnet_train_vs_cpu: the gate model (DynamicGenerator, f32, drop-path
# off), steps per iteration and batch.
NASNET_PARITY_STEPS, NASNET_PARITY_BATCH = 1, 32
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
WINDOWS_STEPS = 8
# cifar_trainer: the improve_nas trainer CLI on synthetic archives in the
# published layouts (CIFAR-10: 5 x 10,000 training images; CIFAR-100:
# 50,000 with fine labels) at its full width (NASNet-A 6@768), batch 32,
# 2 iterations of CIFAR10_STEPS // 2 steps (of CIFAR100_STEPS // 2 on
# CIFAR-100); the augment timing's repeats. The test files hold 512
# images of the published 10,000 (2,048 until the placement phases, 1,024
# until the elastic and multi-host phases needed the time): the trainer
# evaluates all of them, and the full 312 batches, twice, cost the
# script up to 150 s of its time limit on a slow host.
CIFAR_TRAIN, CIFAR_TEST, CIFAR_BATCH, CIFAR_ITERATIONS = 50000, 128, 32, 2
CIFAR10_STEPS, CIFAR100_STEPS, AUGMENT_REPEATS = 6, 4, 50
# imagenet_autoensemble: the ImageNet trainer at its defaults (ResNet-50
# width 64 + EfficientNet-B0, 224 x 224, batch 64, replication) on its fake
# data (8 classes), 2 iterations x 10 steps; card/CPU forwards of ResNet-18
# (width 8) and B0 with small inputs on a batch of 8 32 x 32 images.
IMAGENET_STEPS, IMAGENET_ITERATIONS, IMAGENET_BATCH, IMAGENET_CLASSES = 20, 2, 64, 8
# Its timed window and traced step in iteration 1 (pulls, `_StepClock`):
# first timed step, first traced step, window, traced steps.
IMAGENET_TIMED = (12, 17, 4, 1)
# imagenet_round_robin: each step's subnetwork training losses against the
# replication run's, in parts of max(1, |loss|). Two replication runs were
# bitwise equal on the H100 (PERF.md, PR 13), and RoundRobin trains the
# subnetworks with the same kernels in the same order; the bound leaves
# room for a host whose cuDNN picks nondeterministic algorithms (NASNet
# runs part there, PERF.md section 7) and stays far below the 25% the
# losses fall in 10 steps, so a training divergence would show.
IMAGENET_RR_LOSS_BOUND = 1e-2
# round_robin_gate: tests/test_imagenet_pipeline.py::test_imagenet_autoensemble_convergence_gate
# (image 32, ResNet-18 width 8 + B0, 60 steps of batch 32, resnet_lr 0.05,
# 256 synthetic images from seed 11, RoundRobin): accuracy >= 0.5.
RR_GATE_STEPS, RR_GATE_BATCH, RR_GATE_EXAMPLES, RR_GATE_ACCURACY = 60, 32, 256, 0.5
# process_phases: each subprocess's time limit, seconds.
PROCESS_TIMEOUT = 300
# elastic_multihost_phases: the multi-host ImageNet run's steps
# (2 iterations x 5); the elastic search's window (and speculation)
# steps; the SIGKILL run's lease TTL, s; the peer-death run's collective
# deadline, s.
MHRR_STEPS, MHRR_ITERATIONS = 10, 2
ELASTIC_WINDOW, ELASTIC_LEASE_TTL, CHAOS_DEADLINE = 8, 2, 5
# modelflow: tests/test_experimental.py::test_parallel_scheduler_matches_sequential
# (three MLPs, 3 epochs, mean ensembles under Grow and All) with three
# workers on the card's pool, and one weighted-ensembler search, card/CPU.
MODELFLOW_WORKERS = 3
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


def member_module(seed, generator, compute_dtype=None):
    import torch

    from adanet_tpu_torch.models import nasnet
    from adanet_tpu_torch.research.improve_nas import improve_nas

    builder = improve_nas.Builder(
        None,
        improve_nas.Hparams(use_pallas_sep_conv=True, compute_dtype=compute_dtype or torch.bfloat16),
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


def served_ensemble(seed, device, compute_dtype=None):
    """The serving generation's ensemble on `device`: two NASNet-A
    (6@768) members from `seed` (bf16 compute unless `compute_dtype`),
    SCALAR mixture weights, and the fused-combine ensembler. Returns
    (frozen ensemble, ensembler, its `features -> predictions`, the
    function `publish` exports)."""
    import torch

    from adanet_tpu_torch.core import export
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

    generator = torch.Generator().manual_seed(seed)
    architecture = Architecture("t1_nasnet_grow", "complexity_regularized", iteration_number=1)
    weights = [torch.tensor(w, dtype=torch.float32) for w in MIXTURE]
    members = []
    for t in range(NUM_MEMBERS):
        builder, module = member_module(seed + t, generator, compute_dtype)
        architecture.add_subnetwork(t, builder.name)
        members.append(
            FrozenWeightedSubnetwork(
                FrozenSubnetwork(t, builder.name, module.to(device), 1.0, builder_spec=builder.to_spec()),
                weights[t].to(device),
            )
        )
    frozen = FrozenEnsemble(
        "t1_nasnet_grow",
        1,
        members,
        "complexity_regularized",
        {"weights": [ws.weight for ws in members], "bias": None},
        architecture,
    )
    ensembler = ComplexityRegularizedEnsembler(
        mixture_weight_type=MixtureWeightType.SCALAR, use_fused_combine=True
    )
    return frozen, ensembler, export.frozen_predict_fn(frozen, ensembler, MultiClassHead(10))


def publish(model_dir, seed):
    """The serving generation: the served ensemble on the card, published
    as a hermetic program (`serving.pt2`, K1 and K2 as custom ops).
    Returns (generation dir, the export's numbers)."""
    import numpy as np

    from adanet_tpu_torch.core import export
    from adanet_tpu_torch.serving import publish_generation

    _, _, predict_fn = served_ensemble(seed, "cuda")
    sample = {"image": np.zeros((1, 32, 32, 3), np.float32)}
    t0 = time.perf_counter()
    path = publish_generation(model_dir, 0, predict_fn, sample, device="cuda")
    info = dict(
        publish_secs=time.perf_counter() - t0,
        program_bytes=os.path.getsize(os.path.join(path, export.SERVING_FILE)),
        signature={k: v for k, v in export.serving_signature(path).items() if k not in ("inputs", "outputs")},
    )
    return path, info


def start_publisher(model_dir, seed):
    """`publish` in a process of its own (`--publish-only`), so that the
    export's host work runs beside the phases between the kernel timings
    and the serving phase; its result lands in
    `<model_dir>/publish.json`."""
    environ = dict(os.environ, OMP_NUM_THREADS="1")
    log = open(os.path.join(model_dir, "publish.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed", str(seed), "--publish-only",
                             model_dir], stdout=log, stderr=subprocess.STDOUT, env=environ,
                            preexec_fn=lambda: os.nice(10))
    return proc, log, time.perf_counter()


def wait_publisher(started, model_dir):
    proc, log, t0 = started
    rc = proc.wait(timeout=PROCESS_TIMEOUT * 2)
    log.close()
    if rc != 0:
        with open(log.name) as f:
            raise AssertionError("publish: rc %d\n%s" % (rc, f.read()[-6000:]))
    with open(os.path.join(model_dir, "publish.json")) as f:
        published = json.load(f)
    info = dict(published["info"], publish_process_secs=time.perf_counter() - t0)
    return published["path"], info


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
    variant) and N = 500 (stacked past the pointer table). Last, each
    search's and AutoEnsemble's own shapes (`check_search_combine`).
    Returns the worst absolute error by dtype and the number of cases."""
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
    search_shapes = [(n, batch, 10) for batch in (TRAIN_BATCH, NASNET_BATCH) for n in SEARCH_COMBINE_MEMBERS]
    for n, batch, classes in search_shapes + list(SLICE_COMBINE_SHAPES):
        for use_bias in (False, True):
            err, grad_err = check_search_combine(n, use_bias, gen, batch, classes)
            worst["float32"] = max(worst["float32"], err)
            grads = max(grads, grad_err)
            cases += 3
    torch.cuda.synchronize()
    print("K1 checked at %d cases (buckets x N %s, %s, a misaligned member, N = 500, the searches' "
          "[N %s, %d | %d, 10] and %s forward and backward); worst abs err: %s, gradients %g"
          % (cases, COMBINE_MEMBERS, COMBINE_BYTE_BOUND, SEARCH_COMBINE_MEMBERS, TRAIN_BATCH, NASNET_BATCH,
             SLICE_COMBINE_SHAPES, dict(worst), grads))
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


def check_slice_combines(gen):
    """K1 at the shapes the twelfth slice's paths add, as the ensemble
    update and evaluation call it (`check_search_combine`): the CIFAR-100
    trainer's [1|2, 32, 100] and the ImageNet AutoEnsemble's [1|2, 64, 8].
    Returns the worst forward or gradient error."""
    worst = 0.0
    for batch, classes in ((CIFAR_BATCH, 100), (IMAGENET_BATCH, IMAGENET_CLASSES)):
        for n in SEARCH_COMBINE_MEMBERS:
            worst = max(worst, *check_search_combine(n, False, gen, batch=batch, classes=classes))
    return worst


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


def check_served_program(program, predict_fn, rng):
    """The served program (the pool's, loaded from `serving.pt2`) bitwise
    the in-process predict of the same ensemble (`predict_fn`, built from
    the same seed in this process) on the card, at SERVED_CHECK_ROWS
    rows. Returns the rows checked."""
    import torch

    from adanet_tpu_torch.core import export

    for n in SERVED_CHECK_ROWS:
        image = torch.randn(n, 32, 32, 3, generator=rng)
        got = program({"image": image.numpy()})
        with torch.inference_mode(), export._serving_precision():
            want = predict_fn({"image": image.cuda()})
        if sorted(got) != sorted(want):
            raise AssertionError("served program outputs %s, in-process %s" % (sorted(got), sorted(want)))
        for key in want:
            if not torch.equal(got[key], want[key]):
                err = float((got[key].double() - want[key].double()).abs().max())
                raise AssertionError("served program %s at %d rows differs from the in-process predict: max abs "
                                     "diff %g" % (key, n, err))
    return list(SERVED_CHECK_ROWS)


def serve(model_dir, sep_shapes, rng, predict_fn, published=None):
    """The main path: pool -> batcher -> frontend over the hermetic
    program (`serve_nasnet_program`), with the launch counters zeroed
    just before and read just after; then the pool's program against
    the in-process predict (`check_served_program`). Returns (the counts,
    the numbers, the served program, the pool, which `canary_flip` takes
    over)."""
    import numpy as np
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.observability import metrics
    from adanet_tpu_torch.ops import tuning
    from adanet_tpu_torch.serving import Batcher, FrontendConfig, ModelPool, PoolConfig, ServingFrontend
    from adanet_tpu_torch.store import ArtifactStore

    def request(n):
        return {"image": torch.randn(n, 32, 32, 3, generator=rng).numpy()}

    serial = [request(n) for n in SERIAL_ROWS]
    burst = [request(n) for n in BURST_ROWS]
    store_burst = [request(n) for n in BURST_ROWS]
    dispatches = metrics.registry().counter("serving.batcher.dispatches")
    dispatched_before = dispatches.value
    ops.reset_launch_counts()
    t_pool = time.monotonic()
    pool = ModelPool(model_dir, PoolConfig(canary_requests=CANARY_REQUESTS))
    if not pool.poll() or pool.active is None:
        raise AssertionError("the pool did not bring up gen-0: %s" % pool.events)
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
    gate_secs = pool.events[0]["at"] - t_pool if pool.events else None
    program = pool.active.program
    bitwise_rows = check_served_program(program, predict_fn, rng)
    nodes = collections.Counter(
        str(node.target) for node in program.module.graph.nodes if node.op == "call_function"
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
    print("serve_nasnet_program: " + json.dumps(dict(
        published or {}, graph_operations=sum(nodes.values()),
        custom_ops={k: v for k, v in nodes.items() if k.startswith("adanet_tpu_torch")},
        gate_load_smoke_secs=gate_secs, bitwise_vs_in_process_predict_rows=bitwise_rows,
        p50_latency_ms=stats["p50_latency_ms"],
        pr6_p50_latency_ms="131.68-212.10", launches=counts, card=card_line())))
    return counts, stats, program, pool


def profile_batch(program, rng, batches=3):
    """Where a served batch's time goes: one bucket-32 program call (bf16)
    timed on the host clock without the profiler, then traced with
    torch.profiler: device busy time, kernel launches per batch, the
    device's idle share, and the kernels that take the most time."""
    import torch

    from adanet_tpu_torch.serving.model_pool import to_host

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


def trace_served_combine(frozen, ensembler, rng):
    """One served `build_ensemble` traced on the served ensemble's member
    outputs at bucket 32 (`served_ensemble` on the card): it must launch
    K1 once and no stack or cast kernel (the zero fill of the complexity
    term may remain, and is named), prepare no weight, and agree with
    the plain version."""
    import torch

    from adanet_tpu_torch.ops import ensemble_kernels as ek
    from adanet_tpu_torch.ops import sepconv_kernels as sk

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


def compare_with_cpu(seed, rng):
    """One bucket of the served ensemble at f32 compute on the card
    against the CPU (`served_ensemble` from the same seed on each)."""
    import torch

    from adanet_tpu_torch.core import export

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    image = torch.randn(2, 32, 32, 3, generator=rng)
    outs = {}
    for device in ("cuda", "cpu"):
        _, _, predict_fn = served_ensemble(seed, device, torch.float32)
        with torch.inference_mode(), export._serving_precision():
            outs[device] = predict_fn({"image": image.to(device)})
    gpu, cpu = outs["cuda"], outs["cpu"]
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


def fused_adam(params):
    """Adam 1e-3, torch's fused form: one arithmetic on the card and the
    CPU (`train_vs_cpu`): the Iteration makes Adam capturable on the card,
    whose foreach form computes the bias corrections in f32 there where
    the CPU's computes them in f64 on the host."""
    import torch

    return torch.optim.Adam(params, lr=1e-3, eps=1e-8, fused=True)


def search_parts():
    """(head, simple_dnn generator, ensembler) of the gate's
    configuration, the combine fused."""
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.examples import simple_dnn

    generator = simple_dnn.Generator(optimizer_fn=fused_adam, layer_size=LAYER_SIZE, initial_num_layers=1, seed=0)
    ensembler = ComplexityRegularizedEnsembler(optimizer=fused_adam, use_fused_combine=True)
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


def _probing(estimator_cls, probes):
    """An Estimator class that records, as each iteration completes,
    every subnetwork's variables (`t<t>/<name>/<key>`, on the CPU) and
    the winner's name (`winner/<t>`)."""

    class Probing(estimator_cls):
        def _complete_iteration(self, iteration, state, *args, **kwargs):
            t = iteration.iteration_number
            for name, st in state.subnetworks.items():
                for key, value in st.module.state_dict().items():
                    probes["t%d/%s/%s" % (t, name, key)] = value.detach().cpu().clone()
            frozen = super()._complete_iteration(iteration, state, *args, **kwargs)
            probes["winner/%d" % t] = frozen.name
            return frozen

    return Probing


def train_search(model_dir, probes=None):
    """The search path: `Estimator.train` and `Estimator.evaluate` at the
    gate's configuration on the card, launch counts zeroed just before
    and read just after. A window of the search's own iteration 1 is
    timed, and a few later steps traced, through its input_fn
    (`_StepClock`); each iteration's subnetworks go into `probes`
    (`_probing`). Returns (launch counts, the `train:` numbers)."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset

    head, generator, ensembler = search_parts()
    seen = _recording_generator(generator)
    xtr, ytr = make_dataset(TRAIN_EXAMPLES, seed=7)
    xte, yte = make_dataset(EVAL_EXAMPLES, seed=8)
    search_dir = os.path.join(model_dir, "search")
    estimator = _probing(Estimator, {} if probes is None else probes)(
        head, generator, max_iteration_steps=TRAIN_STEPS, max_iterations=TRAIN_ITERATIONS,
        ensemblers=[ensembler], model_dir=search_dir, log_every_steps=0, device="cuda",
        artifact_store=os.path.join(model_dir, "store"),
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
    builders = {t: record["builders"] for t, record in seen.items()}
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


# A trace's device events (kernels and copies) and its host events, by
# their Chrome-trace categories.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def _trace_events(prof):
    """A stopped profiler's events, as its Chrome trace lists them. The
    profiler's C++ side writes the trace and `json` parses it: building
    torch's FunctionEvent tree (`events()`, `key_averages()`) in Python
    took about 20 s of the script's time for each traced NASNet step."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]


def trace_totals(events):
    """From a trace's complete events: device us and launches by kernel
    name; and by host event name, self us (its time less its children's
    on the same thread, nested as torch's `key_averages` nests them),
    count, and the device us of the kernels launched under it."""
    device_us, launches, by_launch = collections.Counter(), collections.Counter(), collections.Counter()
    threads = collections.defaultdict(list)
    for e in events:
        cat = e.get("cat")
        if cat in _DEVICE_CATEGORIES:
            device_us[e["name"]] += e.get("dur", 0)
            launches[e["name"]] += 1
            by_launch[e.get("args", {}).get("correlation")] += e.get("dur", 0)
        elif cat in _HOST_CATEGORIES:
            threads[(e.get("pid"), e.get("tid"))].append(e)
    self_us, count, under_us = collections.Counter(), collections.Counter(), collections.Counter()

    def close(stack):
        # A frame: [event, end, children's us, device us under it, its
        # children, its last child's (name, device us)]. An only child of
        # the same name is one event to torch (`_remove_dup_nodes`).
        event, _, children_us, frame_device_us, children, last = stack.pop()
        name = event["name"]
        self_us[name] += event.get("dur", 0) - children_us
        count[name] += 1
        under_us[name] += frame_device_us
        if children == 1 and last[0] == name:
            count[name] -= 1
            under_us[name] -= last[1]
        if stack:
            stack[-1][3] += frame_device_us
            stack[-1][5] = (name, frame_device_us)

    for thread in threads.values():
        thread.sort(key=lambda e: (e["ts"], -(e["ts"] + e.get("dur", 0))))
        stack = []
        for e in thread:
            end = e["ts"] + e.get("dur", 0)
            while stack and (e["ts"] >= stack[-1][1] or end > stack[-1][1]):
                close(stack)
            if stack:
                stack[-1][2] += e.get("dur", 0)
                stack[-1][4] += 1
            launched = by_launch[e.get("args", {}).get("correlation")] if e.get("cat") in _LAUNCH_CATEGORIES else 0
            stack.append([e, end, 0.0, launched, 0, None])
        while stack:
            close(stack)
    return device_us, launches, self_us, count, under_us


def traced_step(prof, host_ms, steps=TRACED_STEPS):
    """From `steps` traced search steps: device busy ms a step, the idle
    share against the untraced host time a step, kernels, K1 and K2
    launches a step, K2's forward device ms a step, the top kernels and
    the host's self time by op."""
    kernels, launches, self_us, count, under_us = trace_totals(_trace_events(prof))
    if not kernels:
        # The card's tracer delivered no device event: not measured.
        return dict(traced_steps=steps, trace_delivered=False)
    busy_ms = sum(kernels.values()) / 1e3 / steps
    k1 = sum(n for k, n in launches.items() if "combine_kernel" in k)
    k2 = sum(n for k, n in launches.items() if "sepconv_kernel" in k)
    host_ops = sorted(self_us, key=lambda k: -self_us[k])[:8]
    # K2's backward: the device time under its autograd node (the plain
    # version's kernels); the node and its engine frame nest, so the max.
    backward_us = [us for k, us in under_us.items() if "FusedSepConvBackward" in k]
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
        top_host_ms_per_step=[[k[:50], self_us[k] / 1e3 / steps, count[k] / steps] for k in host_ops],
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


def _weighted_fn(x, y, w=None, batch=TRAIN_BATCH, labels=None, weighted=True):
    """input_fn of ({"x", "w"}, labels) batches (without "w" unless
    `weighted`); unit weights when `w` is None; `labels(y)` maps the
    digits to another head's labels."""
    import numpy as np

    def fn():
        for start in range(0, len(x), batch):
            rows = slice(start, start + batch)
            features = {"x": x[rows]}
            if weighted:
                features["w"] = w[rows] if w is not None else np.ones(len(y[rows]), np.float32)
            yield features, (y[rows] if labels is None else labels(y[rows]))

    return fn


class _Timed:
    """Wraps `obj.method` to add its seconds (after a synchronize) to
    `self.secs` and count its calls; `restore()` puts it back."""

    def __init__(self, obj, method):
        import torch

        self.secs, self.calls = 0.0, 0
        self._obj, self._method = obj, method
        self._inner = inner = getattr(obj, method)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.secs += time.perf_counter() - t0
            self.calls += 1
            return out

        setattr(obj, method, timed)

    def restore(self):
        setattr(self._obj, self._method, self._inner)


def _recording_generator(generator):
    """`generator` whose `generate_candidates` records, per iteration, the
    builders it returned and the reports it was given."""
    seen = {}
    generate = generator.generate_candidates

    def recorded(previous_ensemble, iteration_number, previous_ensemble_reports, all_reports, config=None):
        out = generate(previous_ensemble, iteration_number, previous_ensemble_reports, all_reports, config)
        seen[iteration_number] = dict(
            builders=[b.name for b in out],
            previous_reports=sorted(r.name for r in previous_ensemble_reports),
            all_reports=len(all_reports),
        )
        return out

    generator.generate_candidates = recorded
    return seen


def _selection_estimator(model_dir, device, steps, seed, generator_wrap=None, **kwargs):
    """The search_selection configuration: the gate's simple_dnn search
    with a weighted (K1) and a mean ensembler under GrowStrategy, an
    Evaluator on SELECTION_VALID held-out digits (adanet_loss, minimized),
    a ReportMaterializer over the training digits, example weights from
    `seed` and every candidate's final state kept; `kwargs` go to the
    Estimator. Returns (estimator,
    training input_fn, test input_fn, validation input_fn, generator
    record)."""
    import numpy as np

    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.evaluator import Evaluator, Objective
    from adanet_tpu_torch.core.report_materializer import ReportMaterializer
    from adanet_tpu_torch.ensemble.mean import MeanEnsembler
    from adanet_tpu_torch.examples.synthetic_digits import make_dataset

    head, generator, ensembler = search_parts()
    if generator_wrap is not None:
        generator = generator_wrap(generator)
    seen = _recording_generator(generator)
    xtr, ytr = make_dataset(TRAIN_EXAMPLES, seed=7)
    xte, yte = make_dataset(EVAL_EXAMPLES, seed=8)
    xva, yva = make_dataset(SELECTION_VALID, seed=9)
    weights = np.random.RandomState(seed).uniform(0.5, 1.5, len(ytr)).astype(np.float32)
    train_fn, test_fn, valid_fn = _weighted_fn(xtr, ytr, weights), _weighted_fn(xte, yte), _weighted_fn(xva, yva)
    estimator = Estimator(
        head, generator, max_iteration_steps=steps, max_iterations=TRAIN_ITERATIONS,
        ensemblers=[ensembler, MeanEnsembler()],
        evaluator=Evaluator(valid_fn, metric_name="adanet_loss", objective=Objective.MINIMIZE),
        report_materializer=ReportMaterializer(_weighted_fn(xtr, ytr, weights), steps=SELECTION_REPORT_STEPS),
        weight_key="w", keep_candidate_states=True, model_dir=model_dir, log_every_steps=0, device=device, **kwargs,
    )
    return estimator, train_fn, test_fn, valid_fn, seen


def _read_json(model_dir, name):
    with open(os.path.join(model_dir, name)) as f:
        return json.load(f)


def _winner(record):
    """(name of the `best` entry, its Evaluator value, every value) of a
    candidate-metrics record; exactly one entry is best."""
    best = [name for name, entry in record.items() if entry["best"]]
    if len(best) != 1:
        raise AssertionError("candidate metrics with %d winners: %s" % (len(best), record))
    return best[0], record[best[0]]["evaluator_objective"], [e["evaluator_objective"] for e in record.values()]


def _is_weighted(name):
    return name.endswith("_complexity_regularized")


#: Metrics that count examples (or, AUC, pairs) on either side of a
#: threshold or a rank: a logit that moves across it by a rounding moves
#: the metric by a whole step, so card and CPU are held to one example of
#: a batch; every other value to 1e-4 x max(1, |value|).
COUNTED_METRICS = ("accuracy", "auc", "precision", "recall")


def _parity_bound(key, value):
    if key.rsplit("/", 1)[-1].startswith(COUNTED_METRICS):
        return 1.0 / TRAIN_BATCH
    return 1e-4 * max(1.0, abs(value))


def search_selection(model_dir, seed):
    """The search with Evaluator selection, reports, mean candidates,
    example weights and retained states at the gate's full width on the
    card; launch counts zeroed just before train() and read after the
    last evaluate_all_candidates(). Returns (launch counts, the
    `selection:` numbers)."""
    import numpy as np
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core import checkpoint as ckpt
    from adanet_tpu_torch.core import iteration as iteration_lib

    t_phase = time.perf_counter()
    search_dir = os.path.join(model_dir, "selection")
    estimator, train_fn, test_fn, valid_fn, seen = _selection_estimator(search_dir, "cuda", TRAIN_STEPS, seed)
    evaluator = _Timed(estimator._evaluator, "evaluate")
    reports = _Timed(estimator._report_materializer, "materialize_subnetwork_reports")
    payloads = _Timed(iteration_lib, "state_payload")
    saves = {}
    save_payload = ckpt.save_payload

    def timed_save(directory, filename, payload):
        t0 = time.perf_counter()
        digest = save_payload(directory, filename, payload)
        saves[filename] = (time.perf_counter() - t0) * 1e3
        return digest

    ckpt.save_payload = timed_save
    clock = _StepClock(train_fn, first=TRAIN_STEPS + 11, traced=TRAIN_STEPS + 21 + STEP_WINDOW)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        estimator.train(clock, max_steps=10**6)
        torch.cuda.synchronize()
        train_secs = time.perf_counter() - t0
        metrics = estimator.evaluate(test_fn)
        all_secs, retained = [], []
        for t in range(TRAIN_ITERATIONS):
            t1 = time.perf_counter()
            retained.append(estimator.evaluate_all_candidates(valid_fn, iteration_number=t))
            torch.cuda.synchronize()
            all_secs.append(time.perf_counter() - t1)
        counts = ops.launch_counts()
    finally:
        ckpt.save_payload = save_payload
        payloads.restore()
    if not (metrics["accuracy"] >= GATE_ACCURACY and metrics["accuracy"] > LINEAR_BASELINE_ACCURACY):
        raise AssertionError("search_selection accuracy %s below the gate %s" % (metrics, GATE_ACCURACY))
    steps = estimator.latest_global_step()
    if steps != TRAIN_STEPS * TRAIN_ITERATIONS or clock.pulls != steps:
        raise AssertionError("search_selection: %d steps, %d pulls" % (steps, clock.pulls))
    valid_batches = -(-SELECTION_VALID // TRAIN_BATCH)
    eval_batches = -(-EVAL_EXAMPLES // TRAIN_BATCH)
    weighted, winners, worst = [], [], 0.0
    with open(os.path.join(search_dir, "report", "iteration_reports.json")) as f:
        iteration_reports = json.load(f)
    for t in range(TRAIN_ITERATIONS):
        record = _read_json(search_dir, ckpt.candidate_metrics_filename(t))
        arch = _read_json(search_dir, ckpt.architecture_filename(t))
        name, value, values = _winner(record)
        if not value == np.nanmin(np.asarray(values, np.float64)):
            raise AssertionError("iteration %d: winner %s at %r is not nanargmin of %s" % (t, name, value, values))
        arch_name = "t%d_%s_%s" % (arch["iteration_number"], arch["ensemble_candidate_name"], arch["ensembler_name"])
        if arch_name != name:
            raise AssertionError("iteration %d: architecture %s, candidate metrics %s" % (t, arch_name, name))
        winners.append(name)
        weighted.append(sum(_is_weighted(n) for n in record))
        # The retained state, the same validation data, the same card.
        for n, entry in record.items():
            got, want = retained[t][n]["adanet_loss"], entry["evaluator_objective"]
            err = abs(got - want)
            if not err <= 1e-5 * max(1.0, abs(want)):
                raise AssertionError("evaluate_all_candidates(%d) %s: %r, Evaluator %r" % (t, n, got, want))
            worst = max(worst, err)
        # Reports: every subnetwork, the winner's new members included.
        new_members = sorted(s["builder_name"] for s in arch["subnetworks"] if s["iteration_number"] == t)
        listed = iteration_reports[str(t)]
        if sorted(r["name"] for r in listed) != sorted(seen[t]["builders"]):
            raise AssertionError("iteration %d reports %s, builders %s" % (t, listed, seen[t]["builders"]))
        included = sorted(r["name"] for r in listed if r["included_in_final_ensemble"])
        if included != new_members:
            raise AssertionError("iteration %d: included %s, the winner's new members %s" % (t, included, new_members))
        if t + 1 < TRAIN_ITERATIONS and (seen[t + 1]["previous_reports"] != included
                                         or seen[t + 1]["all_reports"] != len(listed)):
            raise AssertionError("the generator at t=%d got %s" % (t + 1, seen[t + 1]))
    # K1: one launch a weighted candidate (the carried-over winner too, when
    # weighted) a training step and an Evaluator batch, as many again in
    # evaluate_all_candidates, and one a test batch when the final winner
    # is weighted; a mean candidate none.
    final_weighted = _is_weighted(winners[-1])
    expected = dict(copy=0, sepconv=0, cell=0, combine=(TRAIN_STEPS + 2 * valid_batches) * sum(weighted)
                    + eval_batches * final_weighted)
    if counts != expected:
        raise AssertionError("search_selection: launches %s, expected %s (weighted candidates %s, winners %s)"
                             % (counts, expected, weighted, winners))
    (host0, event0), (host1, event1) = clock.marks
    host_ms = (host1 - host0) / STEP_WINDOW * 1e3
    final_files = {t: ckpt.final_state_filename(t) for t in range(TRAIN_ITERATIONS)}
    stats = dict(
        steps=steps,
        candidates=[len(_read_json(search_dir, ckpt.candidate_metrics_filename(t))) for t in range(TRAIN_ITERATIONS)],
        weighted_candidates=weighted,
        winners=winners,
        accuracy=metrics["accuracy"],
        loss=metrics["loss"],
        search_secs=train_secs,
        search_ms_per_step=train_secs / steps * 1e3,
        window_steps=[clock._first, clock._first + STEP_WINDOW - 1],
        window_host_ms_per_step=host_ms,
        window_event_ms_per_step=event0.elapsed_time(event1) / STEP_WINDOW,
        evaluator_secs=evaluator.secs,
        evaluator_calls=evaluator.calls,
        report_secs=reports.secs,
        evaluate_all_candidates_secs=all_secs,
        evaluate_all_candidates_max_abs_err=worst,
        final_state_bytes=[os.path.getsize(os.path.join(search_dir, f)) for f in final_files.values()],
        final_state_save_ms=[saves[f] for f in final_files.values()],
        final_state_payload_ms=payloads.secs * 1e3 / max(1, payloads.calls),
        k1_launches=counts["combine"],
        phase_secs=time.perf_counter() - t_phase,
    )
    stats.update(traced_step(clock.profile, host_ms))
    stats["card"] = card_line()
    print("selection: " + json.dumps(stats))
    return counts, stats


def selection_vs_cpu(seed):
    """search_selection's configuration at 2 x SELECTION_PARITY_STEPS on
    the card and on the CPU (fused Adam on both) from the same converted
    init: Evaluator values, candidate-metrics losses and the final
    metrics within 1e-4 x max(1, |value|) (counted metrics within one
    example of a batch, `_parity_bound`); the same winner wherever the
    CPU's two best are further apart than that."""
    from adanet_tpu_torch.utils.convert import WithInitialVariables

    runs = {}
    with tempfile.TemporaryDirectory(prefix="selection_vs_cpu_") as root:
        for device in ("cuda", "cpu"):
            model_dir = os.path.join(root, device)
            estimator, train_fn, test_fn, _, _ = _selection_estimator(
                model_dir, device, SELECTION_PARITY_STEPS, seed,
                generator_wrap=lambda g: WithInitialVariables(g, 256, 10))
            estimator.train(train_fn, max_steps=10**6)
            runs[device] = dict(
                records=[_read_json(model_dir, "candidate-metrics-%d.json" % t) for t in range(TRAIN_ITERATIONS)],
                metrics=estimator.evaluate(test_fn),
            )
    worst, compared, tied = 0.0, 0, []

    def close(what, got, want, bound=None):
        nonlocal worst
        err = abs(got - want)
        if not err <= (1e-4 * max(1.0, abs(want)) if bound is None else bound):
            raise AssertionError("selection_vs_cpu %s: card %r, cpu %r" % (what, got, want))
        worst = max(worst, err)

    same = True
    for t in range(TRAIN_ITERATIONS):
        card, cpu = runs["cuda"]["records"][t], runs["cpu"]["records"][t]
        if sorted(card) != sorted(cpu):
            raise AssertionError("selection_vs_cpu t=%d: candidates %s vs %s" % (t, sorted(card), sorted(cpu)))
        for name in cpu:
            for key in ("evaluator_objective", "adanet_loss", "adanet_loss_ema"):
                close("t=%d %s %s" % (t, name, key), card[name][key], cpu[name][key])
        compared += 1
        ordered = sorted(e["evaluator_objective"] for e in cpu.values())
        gap = ordered[1] - ordered[0]
        if _winner(card)[0] != _winner(cpu)[0]:
            if gap > 1e-4 * max(1.0, abs(ordered[0])):
                raise AssertionError("selection_vs_cpu t=%d: winner %s on the card, %s on the CPU (gap %g)"
                                     % (t, _winner(card)[0], _winner(cpu)[0], gap))
            tied.append(t)
            same = False
            break
    if same:
        for key, value in runs["cpu"]["metrics"].items():
            if isinstance(value, float):
                close("final %s" % key, runs["cuda"]["metrics"][key], value, _parity_bound(key, value))
    out = dict(steps=SELECTION_PARITY_STEPS * TRAIN_ITERATIONS, iterations_compared=compared,
               winners=[_winner(r)[0] for r in runs["cuda"]["records"]], near_tie_flips=tied,
               final_metrics_compared=same, max_abs_err=worst)
    print("selection_vs_cpu: " + json.dumps(out))
    return out


def _multi_head_parts(kind):
    """(head, labels(digits)) of the multi-head search's configurations:
    "multi_head", the digit (10 classes), whether it is even and its value;
    "multi_label", the digit's four-bit binary code."""
    import numpy as np

    from adanet_tpu_torch.core.heads import (
        BinaryClassificationHead,
        MultiClassHead,
        MultiHead,
        MultiLabelHead,
        RegressionHead,
    )

    if kind == "multi_head":
        head = MultiHead([MultiClassHead(10, name="digit"), BinaryClassificationHead(name="even"),
                          RegressionHead(name="value")])

        def labels(y):
            return {"digit": y, "even": (y % 2 == 0).astype(np.float32), "value": y.astype(np.float32)}
    else:
        head = MultiLabelHead(4, name="bits")

        def labels(y):
            return ((y[:, None] >> np.arange(4)) & 1).astype(np.float32)
    return head, labels


def _multi_head_estimator(model_dir, device, kind, steps, cls=None, wrap=None):
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.ensemble.mean import MeanEnsembler

    head, labels = _multi_head_parts(kind)
    _, generator, ensembler = search_parts()
    if wrap is not None:
        generator = wrap(generator, head)
    return (cls or Estimator)(
        head, generator, max_iteration_steps=steps, max_iterations=TRAIN_ITERATIONS,
        ensemblers=[ensembler, MeanEnsembler()], model_dir=model_dir, log_every_steps=0, device=device,
    ), labels


def multi_head_search(model_dir):
    """simple_dnn at 128 wide on the digits under a MultiHead (digit, even,
    value) and, second, a MultiLabelHead over the digit's four-bit code,
    2 x MULTI_HEAD_STEPS each through train, evaluate and predict (launch
    counts zeroed just before train and read after predict: K1 none on the
    multi-head path; on the multi-label one, one a weighted candidate's
    step and one a test batch of a weighted winner). The multi-head search
    stopped by max_steps at MULTI_HEAD_STOP is restored by a fresh
    Estimator bitwise, and resumed on the uninterrupted run's batches to
    the end: the same architectures and `frozen-1.pt`. Then card against
    CPU at 2 x MULTI_HEAD_PARITY_STEPS from the same converted init:
    candidate losses and the final metrics within 1e-4 x max(1, |value|)
    (counted metrics within one example of a batch), the same winners
    where the CPU's two best EMAs are further apart; printed beside the
    CPU's own response to a relative 1e-7 move of the initial
    parameters. Returns ({kind: launch counts}, the `multi_head:`
    numbers)."""
    import numpy as np
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core import checkpoint as ckpt
    from adanet_tpu_torch.core import iteration as iteration_lib
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.examples.synthetic_digits import make_dataset
    from adanet_tpu_torch.utils.convert import WithInitialVariables, convert_simple_dnn

    t_phase = time.perf_counter()
    xtr, ytr = make_dataset(TRAIN_EXAMPLES, seed=7)
    xte, yte = make_dataset(EVAL_EXAMPLES, seed=8)
    eval_batches = -(-EVAL_EXAMPLES // TRAIN_BATCH)
    counts, stats = {}, {}
    for kind in ("multi_head", "multi_label"):
        directory = os.path.join(model_dir, kind)
        estimator, labels = _multi_head_estimator(directory, "cuda", kind, MULTI_HEAD_STEPS)
        train_fn = _weighted_fn(xtr, ytr, labels=labels, weighted=False)
        test_fn = _weighted_fn(xte, yte, labels=labels, weighted=False)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        estimator.train(train_fn, max_steps=10**6)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        metrics = estimator.evaluate(test_fn)
        predictions = list(estimator.predict(lambda: ((f, None) for f, _ in test_fn())))
        counts[kind] = ops.launch_counts()
        records = [_read_json(directory, ckpt.candidate_metrics_filename(t)) for t in range(TRAIN_ITERATIONS)]
        winners = [name for r in records for name, e in r.items() if e["best"]]
        if kind == "multi_head":
            expected = 0
            keys = {"digit/accuracy", "even/auc", "value/average_loss", "average_loss"}
            shapes = {"digit/class_ids": (TRAIN_BATCH,), "even/logistic": (TRAIN_BATCH, 1),
                      "value/predictions": (TRAIN_BATCH, 1)}
        else:
            # One a weighted candidate's step; one a test batch of
            # evaluate and one of predict when the final winner is weighted.
            weighted = [sum(_is_weighted(n) for n in r) for r in records]
            expected = MULTI_HEAD_STEPS * sum(weighted) + 2 * eval_batches * _is_weighted(winners[-1])
            keys = {"accuracy", "auc", "precision", "recall", "average_loss"}
            shapes = {"class_ids": (TRAIN_BATCH, 4), "probabilities": (TRAIN_BATCH, 4)}
        if counts[kind] != dict(copy=0, sepconv=0, cell=0, combine=expected):
            raise AssertionError("%s: launches %s, K1 expected %d" % (kind, counts[kind], expected))
        if not keys <= set(metrics) or not all(np.isfinite(metrics[k]) for k in keys):
            raise AssertionError("%s: metrics %s" % (kind, metrics))
        if len(predictions) != eval_batches or any(
                tuple(predictions[0][k].shape) != s or not torch.isfinite(predictions[0][k].float()).all()
                for k, s in shapes.items()):
            raise AssertionError("%s: predictions %s" % (kind, {k: tuple(v.shape) for k, v in predictions[0].items()}))
        stats[kind] = dict(ms_per_step=secs / (MULTI_HEAD_STEPS * TRAIN_ITERATIONS) * 1e3, winners=winners,
                           k1_launches=counts[kind]["combine"],
                           metrics={k: metrics[k] for k in sorted(keys)})

    # Stop at MULTI_HEAD_STOP, restore bitwise in a fresh Estimator, resume.
    class Keeping(Estimator):
        def _save_iteration_state(self, info, iteration_number, state):
            super()._save_iteration_state(info, iteration_number, state)
            self.live = state

    directory = os.path.join(model_dir, "multi_head_resumed")
    stopped, labels = _multi_head_estimator(directory, "cuda", "multi_head", MULTI_HEAD_STEPS, cls=Keeping)
    train_fn = _weighted_fn(xtr, ytr, labels=labels, weighted=False)
    stopped.train(train_fn, max_steps=MULTI_HEAD_STOP)
    live = iteration_lib.state_payload(stopped.live)
    info = ckpt.read_manifest(directory)
    fresh, _ = _multi_head_estimator(directory, "cuda", "multi_head", MULTI_HEAD_STEPS)
    sample = next(train_fn())
    restored = fresh._init_or_restore_state(fresh._build_iteration(info.iteration_number, sample), sample, info)
    deviation = _tree_deviation(iteration_lib.state_payload(restored), live)
    if deviation != 0.0 or info.global_step != MULTI_HEAD_STOP:
        raise AssertionError("multi_head resume: stopped at %s, restore deviates by %g" % (info, deviation))
    # A fresh process calls input_fn afresh; this one picks the stream up
    # where the stopped run left it, so that the resumed run sees the
    # uninterrupted run's batches.
    skip = MULTI_HEAD_STOP % -(-TRAIN_EXAMPLES // TRAIN_BATCH)

    def picked_up():
        nonlocal skip
        for batch in train_fn():
            if skip:
                skip -= 1
                continue
            yield batch

    fresh.train(picked_up, max_steps=10**6)
    resumed = dict(stop=MULTI_HEAD_STOP, restore_deviation=deviation,
                   tensors=sum(1 for _ in _payload_tensors(live)),
                   architectures_equal=all(
                       _read_json(directory, "architecture-%d.json" % t)
                       == _read_json(os.path.join(model_dir, "multi_head"), "architecture-%d.json" % t)
                       for t in range(TRAIN_ITERATIONS)),
                   frozen_1_deviation=_tree_deviation(
                       ckpt.restore_payload(directory, "frozen-1.pt"),
                       ckpt.restore_payload(os.path.join(model_dir, "multi_head"), "frozen-1.pt")))
    if fresh.latest_global_step() != MULTI_HEAD_STEPS * TRAIN_ITERATIONS or not resumed["architectures_equal"] \
            or resumed["frozen_1_deviation"] != 0.0:
        raise AssertionError("multi_head resume: %s at step %d" % (resumed, fresh.latest_global_step()))

    # Card against CPU, beside the CPU against itself with every initial
    # parameter moved by a relative 1e-7 (random, from each of
    # MOVED_SEEDS): how far such a search carries a rounding's worth of
    # difference in 2 x 20 steps.
    def converted(seed):
        def convert(variables):
            state = convert_simple_dnn(variables)
            if seed is not None:
                noise = torch.Generator().manual_seed(seed)
                state = {k: v * (1.0 + 1e-7 * torch.randn(v.shape, generator=noise)) for k, v in state.items()}
            return state

        return lambda generator, head: WithInitialVariables(generator, 256, head.logits_dimension, convert=convert)

    runs = {}
    for run, device, seed in [("card", "cuda", None), ("cpu", "cpu", None)] + [
            ("cpu_moved_%d" % s, "cpu", s) for s in MOVED_SEEDS]:
        directory = os.path.join(model_dir, "multi_head_%s" % run)
        estimator, labels = _multi_head_estimator(directory, device, "multi_head", MULTI_HEAD_PARITY_STEPS,
                                                  wrap=converted(seed))
        estimator.train(_weighted_fn(xtr, ytr, labels=labels, weighted=False), max_steps=10**6)
        runs[run] = ([_read_json(directory, "candidate-metrics-%d.json" % t) for t in range(TRAIN_ITERATIONS)],
                     estimator.evaluate(_weighted_fn(xte, yte, labels=labels, weighted=False)))

    def gap(got_run, want_run, check):
        """Max |got - want| / max(1, |want|) over the candidates' losses
        and the final metrics (counted metrics apart); with `check`, each
        within its `_parity_bound`, and the same winners wherever the
        want run's two best EMAs are further apart than that."""
        worst = {"losses": 0.0, "counted": 0.0}
        for t, (got, want) in enumerate(zip(got_run[0], want_run[0])):
            if sorted(got) != sorted(want):
                raise AssertionError("multi_head_vs_cpu t=%d: candidates %s vs %s" % (t, sorted(got), sorted(want)))
            for name in want:
                for key in ("adanet_loss", "adanet_loss_ema"):
                    err = abs(got[name][key] - want[name][key])
                    if check and not err <= _parity_bound(key, want[name][key]):
                        raise AssertionError("multi_head_vs_cpu t=%d %s %s: %r vs %r"
                                             % (t, name, key, got[name][key], want[name][key]))
                    worst["losses"] = max(worst["losses"], err / max(1.0, abs(want[name][key])))
            if [n for n in got if got[n]["best"]] != [n for n in want if want[n]["best"]]:
                emas = sorted(e["adanet_loss_ema"] for e in want.values())
                if check and emas[1] - emas[0] > 1e-4 * max(1.0, abs(emas[0])):
                    raise AssertionError("multi_head_vs_cpu t=%d: the winners differ" % t)
                return dict(worst, near_tie_flip=t)
        for key, value in want_run[1].items():
            if isinstance(value, float):
                err = abs(got_run[1][key] - value)
                if check and not err <= _parity_bound(key, value):
                    raise AssertionError("multi_head_vs_cpu final %s: %r vs %r" % (key, got_run[1][key], value))
                part = "counted" if _parity_bound(key, value) == 1.0 / TRAIN_BATCH else "losses"
                worst[part] = max(worst[part], err / max(1.0, abs(value)))
        return dict(worst, near_tie_flip=None)

    stats.update(resume=resumed, vs_cpu=dict(steps=MULTI_HEAD_PARITY_STEPS * TRAIN_ITERATIONS,
                                             card_vs_cpu=gap(runs["card"], runs["cpu"], check=True),
                                             cpu_moved_1e7_vs_cpu=[gap(runs["cpu_moved_%d" % s], runs["cpu"], check=False)
                                                                   for s in MOVED_SEEDS]),
                 phase_secs=time.perf_counter() - t_phase, card=card_line())
    print("multi_head: " + json.dumps(stats))
    return counts, stats


def heads_vs_cpu(gen):
    """Each of the five heads' loss, eval metrics and predictions at batch
    HEADS_BATCH on the card against the CPU, without and with example
    weights, the sigmoid heads also with their scores rounded into ties
    (AUC's tie handling). Tolerances: losses and metrics 1e-5 x max(1,
    |value|) (f32 reductions over 4096 rows in another order; AUC's
    cumulative sums too), predictions 1e-6 (elementwise), class ids
    equal."""
    import torch

    from adanet_tpu_torch.core.heads import (
        BinaryClassificationHead,
        MultiClassHead,
        MultiHead,
        MultiLabelHead,
        RegressionHead,
    )

    b = HEADS_BATCH

    def case(kind, ties):
        dim = {"regression": 1, "binary": 1, "multilabel": 4, "multiclass": 10}[kind]
        logits = torch.randn(b, dim, generator=gen) * 2.0
        if ties:
            logits = torch.round(logits)
        if kind == "multiclass":
            labels = torch.randint(0, dim, (b,), generator=gen)
        elif kind == "regression":
            labels = torch.randn(b, 1, generator=gen)
        else:
            labels = (torch.rand(b, dim, generator=gen) > 0.5).float()
        return logits, labels

    heads = {"regression": RegressionHead(), "binary": BinaryClassificationHead(), "multilabel": MultiLabelHead(4),
             "multiclass": MultiClassHead(10)}
    cases = {(kind, ties): case(kind, ties) for kind in heads for ties in (False, True)}
    multi = MultiHead([MultiClassHead(10, name="digit"), BinaryClassificationHead(name="even"),
                       RegressionHead(name="value")])
    cases[("multi_head", False)] = tuple(
        {k: cases[(kind, False)][i] for k, kind in (("digit", "multiclass"), ("even", "binary"),
                                                     ("value", "regression"))} for i in (0, 1))
    heads["multi_head"] = multi
    weights = torch.rand(b, generator=gen) * 2.0
    worst = {"metrics": 0.0, "predictions": 0.0}

    def on(tree, device):
        if isinstance(tree, dict):
            return {k: on(v, device) for k, v in tree.items()}
        return None if tree is None else tree.to(device)

    checked = 0
    for (kind, ties), (logits, labels) in sorted(cases.items()):
        head = heads[kind]
        for w in (None, weights):
            if w is not None and kind == "multi_head":
                w = {"digit": weights, "even": weights}
            got = dict(head.eval_metrics(on(logits, "cuda"), on(labels, "cuda"), on(w, "cuda")))
            got["loss"] = head.loss(on(logits, "cuda"), on(labels, "cuda"), on(w, "cuda"))
            want = dict(head.eval_metrics(logits, labels, w))
            want["loss"] = head.loss(logits, labels, w)
            if sorted(got) != sorted(want):
                raise AssertionError("heads_vs_cpu %s: keys %s vs %s" % (kind, sorted(got), sorted(want)))
            for key, value in want.items():
                err = abs(float(got[key]) - float(value))
                if not err <= 1e-5 * max(1.0, abs(float(value))):
                    raise AssertionError("heads_vs_cpu %s ties=%s weights=%s %s: card %r, cpu %r"
                                         % (kind, ties, w is not None, key, float(got[key]), float(value)))
                worst["metrics"] = max(worst["metrics"], err)
                checked += 1
        got = head.predictions(on(logits, "cuda"))
        want = head.predictions(logits)
        for key, value in want.items():
            g = got[key].cpu()
            if g.dtype != value.dtype or g.shape != value.shape:
                raise AssertionError("heads_vs_cpu %s prediction %s: %s %s" % (kind, key, g.dtype, g.shape))
            if not value.is_floating_point():
                if not torch.equal(g, value):
                    raise AssertionError("heads_vs_cpu %s prediction %s differs" % (kind, key))
                continue
            worst["predictions"] = max(worst["predictions"], check_close("heads_vs_cpu %s %s" % (kind, key),
                                                                         g, value, 1e-6))
    out = dict(batch=b, cases=len(cases), values_checked=checked, max_abs_err=worst)
    print("heads_vs_cpu: " + json.dumps(out))
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
    subprocess: SIGTERM as soon as its log says iteration 1 has started
    (its first step then ends the run, whatever the host's pace); it must
    exit 0 with a mid-iteration state of iteration 1 in the manifest. A
    second run over the same --model_dir must restore that state and
    finish. Returns its numbers."""
    from adanet_tpu_torch.core import checkpoint as ckpt

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    argv = [sys.executable, "-m", "adanet_tpu_torch.research.improve_nas.trainer", *TRAINER_SMALL,
            "--boosting_iterations=2", "--train_steps=%d" % TRAINER_SIGTERM_STEPS, "--model_dir=" + model_dir]
    os.makedirs(model_dir, exist_ok=True)

    def run(name, signal_at_iteration_1):
        err_path = os.path.join(model_dir, name + ".err")
        with open(os.path.join(model_dir, name + ".out"), "w") as out, open(err_path, "w") as err:
            t0 = time.perf_counter()
            proc = subprocess.Popen(argv, cwd=root, env=env, stdout=out, stderr=err)
            try:
                deadline = time.time() + 600
                while signal_at_iteration_1 and proc.poll() is None and time.time() < deadline:
                    # Logged just before the iteration's first step, with
                    # the SIGTERM handler already installed.
                    with open(err_path) as log:
                        if "Starting iteration 1 at" in log.read():
                            proc.send_signal(signal.SIGTERM)
                            break
                    time.sleep(0.01)
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
    per_iteration = TRAINER_SIGTERM_STEPS // 2
    if (info.iteration_number != 1 or info.iteration_state_file != "ckpt-%d.pt" % info.global_step
            or not per_iteration < info.global_step < 2 * per_iteration):
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
    a ragged stream padded to 32: each padded batch's rows bitwise the
    same rows predicted inside an unpadded batch of 32 real rows (the
    padding path exactly); against the rows predicted at their own batch
    size, the same ensemble rebuilt at f32 compute within 2e-2 x max(1,
    |logits|), and bf16 within bf16's own distance from f32 at those rows
    (another batch size may take other algorithms, which round bf16 in
    another order). Launch counts zeroed just before and read just after
    must be exact.
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
    optimizer_fn = optimizer.fn_with_name("momentum", "cosine", cosine_decay_steps=MOBILE_STEPS)
    generator = improve_nas.Generator(optimizer_fn, hparams, seed=seed, num_classes=MOBILE_CLASSES)
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

    def make(cls, generator):
        return cls(
            MultiClassHead(MOBILE_CLASSES), generator, max_iteration_steps=MOBILE_STEPS, max_iterations=2,
            ensemblers=[ComplexityRegularizedEnsembler(optimizer=sgd, use_fused_combine=True)], force_grow=True,
            model_dir=os.path.join(model_dir, "mobile"), log_every_steps=0, random_seed=seed, device="cuda",
            iterations_per_loop=MOBILE_WINDOW, step_compute_dtype="bfloat16", prefetch_buffer=2,
            prefetch_to_device=True, save_checkpoint_steps=MOBILE_WINDOW, predict_batch_size=MOBILE_BATCH,
        )

    estimator = make(Timed, generator)
    images, labels = provider._images, provider._labels

    def ragged():
        start = 0
        for rows in MOBILE_PREDICT_ROWS:
            yield {"image": images[start:start + rows]}, labels[start:start + rows]
            start += rows

    def embedded():
        """Each ragged batch's rows at the head of a batch of MOBILE_BATCH
        real rows: the shapes the padded batches have, no padding."""
        start = 0
        for rows in MOBILE_PREDICT_ROWS:
            yield {"image": images[start:start + MOBILE_BATCH]}, labels[start:start + MOBILE_BATCH]
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
    inside = list(estimator.predict(embedded, predict_batch_size=0))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if estimator._open_prefetchers:
        raise AssertionError("train_nasnet_mobile: prefetchers left open")
    steps = estimator.latest_global_step()
    losses = torch.stack([v.float() for w in windows for v in w.pop("losses").values()]).tolist()
    if not all(map(math.isfinite, losses)) or not math.isfinite(metrics["loss"]):
        raise AssertionError("train_nasnet_mobile: non-finite losses %s, %s" % (losses, metrics))
    predict_forwards = 3 * len(MOBILE_PREDICT_ROWS) * 2  # padded, plain and embedded, two members
    forwards = _member_forwards(2, MOBILE_STEPS, MOBILE_EVAL_BATCHES, 2) + predict_forwards
    # K1: one an ensemble update a candidate a step (1 at t = 0; the
    # carried-over winner and the grown one at t = 1) and the ADAPTIVE
    # teacher at t = 1; one an eval batch and a predict batch.
    expected = dict(copy=0, cell=0, sepconv=forwards * len(sep_shapes),
                    combine=MOBILE_STEPS * (1 + 3) + MOBILE_EVAL_BATCHES + 3 * len(MOBILE_PREDICT_ROWS))
    if steps != 2 * MOBILE_STEPS or counts != expected or len(windows) != 2 * MOBILE_STEPS // MOBILE_WINDOW:
        raise AssertionError("train_nasnet_mobile: %d steps, %d windows, launches %s, expected %s"
                             % (steps, len(windows), counts, expected))
    # The same trained ensemble at f32 compute (a fresh estimator over the
    # model dir rebuilds its members with compute_dtype float32), padded
    # and at the rows' own batch size.
    f32 = make(TPUEstimator, improve_nas.Generator(optimizer_fn, hparams.replace(compute_dtype=torch.float32),
                                                   seed=seed, num_classes=MOBILE_CLASSES))
    f32_padded = list(f32.predict(ragged))
    f32_plain = list(f32.predict(ragged, predict_batch_size=0))

    def gap(a, b):
        return float((a["logits"].double() - b["logits"].double()).abs().max())

    predict_err, predict_gaps = 0.0, []
    for rows, a, b, c, e, f in zip(MOBILE_PREDICT_ROWS, padded, plain, inside, f32_padded, f32_plain):
        if a["logits"].shape != (rows, MOBILE_CLASSES) or b["logits"].shape != a["logits"].shape:
            raise AssertionError("train_nasnet_mobile: predict rows %s / %s, expected %d"
                                 % (a["logits"].shape, b["logits"].shape, rows))
        # The padding path: the same shapes, so the same algorithms, and
        # rows do not mix in an eval forward.
        if not torch.equal(a["logits"], c["logits"][:rows]):
            raise AssertionError("train_nasnet_mobile: %d padded rows differ from the same rows in an unpadded "
                                 "batch by %g" % (rows, float((a["logits"] - c["logits"][:rows]).abs().max())))
        # At their own batch size against padded: in f32 within PR 9's
        # bound; in bf16 within bf16's own distance from f32 at these rows
        # (another batch size may take other algorithms, which round bf16
        # in another order: 0.0307 and 0.0329 at 7 rows against 0.17-0.19
        # of bf16 from f32, H100 80GB HBM3 at 700 W).
        reach = max(gap(a, e), gap(b, f))
        predict_gaps.append(dict(rows=rows, logits_max_abs=float(b["logits"].abs().max()),
                                 bf16_own_vs_padded=gap(b, a), f32_own_vs_padded=gap(f, e), bf16_vs_f32=reach))
        check_close("f32 padded predict", e["logits"], f["logits"], 2e-2 * max(1.0, float(f["logits"].abs().max())))
        predict_err = max(predict_err, check_close("padded predict", a["logits"], b["logits"], reach))
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
        predict_gaps=predict_gaps,
        launches=counts,
        card=card_line(),
    )
    print("train_nasnet_mobile: " + json.dumps(stats))
    cases = {(s, MOBILE_BATCH) for s in sep_shapes} | {(s, MOBILE_PREDICT_ROWS[-1]) for s in sep_shapes}
    return counts, stats, cases


def windows_vs_steps(model_dir):
    """Windows leave results as they are, on the card: the gate's NASNet
    model (3 cells, 8 filters, bf16, K2 on) over 2 iterations x 8 steps
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


def _counts(combine):
    """The launch counts of a path that runs K1 only."""
    return dict(copy=0, sepconv=0, cell=0, combine=combine)


def _grow_candidates(builders, iterations):
    """Candidates an iteration under GrowStrategy with one ensembler:
    one a builder, and from iteration 1 the carried-over winner too."""
    return [builders + (1 if t else 0) for t in range(iterations)]


def _timed_search(estimator, train_fn, test_fn, steps, iterations):
    """`estimator.train` and `evaluate` with the launch counts zeroed just
    before and read just after; the last iteration's steps 11-110 timed
    at their pulls and steps 121-125 traced (`_StepClock`). Returns
    (metrics, counts, the timing numbers)."""
    import torch

    from adanet_tpu_torch import ops

    last = steps * (iterations - 1)
    clock = _StepClock(train_fn, first=last + 11, traced=last + 21 + STEP_WINDOW, window=STEP_WINDOW,
                       traced_steps=TRACED_STEPS)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    estimator.train(clock, max_steps=10**6)
    torch.cuda.synchronize()
    train_secs = time.perf_counter() - t0
    metrics = estimator.evaluate(test_fn)
    counts = ops.launch_counts()
    if estimator.latest_global_step() != steps * iterations or clock.pulls != steps * iterations:
        raise AssertionError("search: %d steps, %d pulls" % (estimator.latest_global_step(), clock.pulls))
    (host0, event0), (host1, event1) = clock.marks
    host_ms = (host1 - host0) / STEP_WINDOW * 1e3
    stats = dict(
        steps=steps * iterations,
        search_secs=train_secs,
        search_ms_per_step=train_secs / (steps * iterations) * 1e3,
        window_steps=[clock._first, clock._first + STEP_WINDOW - 1],
        window_host_ms_per_step=host_ms,
        window_event_ms_per_step=event0.elapsed_time(event1) / STEP_WINDOW,
    )
    stats.update(traced_step(clock.profile, host_ms))
    return metrics, counts, stats


def _check_k1(what, counts, steps, candidates, eval_batches, record_dir):
    """K1 exactly: one launch a candidate a training step (every candidate
    weighted) and one a test batch; the candidates an iteration as
    derived, and as `candidate-metrics-<t>.json` lists them."""
    listed = [len(_read_json(record_dir, "candidate-metrics-%d.json" % t)) for t in range(len(candidates))]
    expected = _counts(steps * sum(candidates) + eval_batches)
    if counts != expected or listed != candidates:
        raise AssertionError("%s: launches %s, expected %s; candidates %s, derived %s"
                             % (what, counts, expected, listed, candidates))


def full_dnn_gate(model_dir):
    """tests/test_convergence.py::test_search_converges_to_target_accuracy
    on the card: 8192 training and 2048 test digits, simple_dnn 256 wide
    with dropout 0.1, 3 x 800 steps at batch 128, adam 1e-3 on both sides,
    the combine fused: accuracy >= 0.94, top-5 >= 0.99, K1 exact."""
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.examples import simple_dnn
    from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset

    t_phase = time.perf_counter()
    head, _, ensembler = search_parts()
    generator = simple_dnn.Generator(optimizer_fn=fused_adam, layer_size=FULL_GATE_LAYER, initial_num_layers=1,
                                     dropout=FULL_GATE_DROPOUT, seed=0)
    xtr, ytr = make_dataset(FULL_GATE_TRAIN, seed=7)
    xte, yte = make_dataset(FULL_GATE_TEST, seed=8)
    directory = os.path.join(model_dir, "full_dnn_gate")
    estimator = Estimator(head, generator, max_iteration_steps=FULL_GATE_STEPS, max_iterations=FULL_GATE_ITERATIONS,
                          ensemblers=[ensembler], model_dir=directory, log_every_steps=0, device="cuda")
    metrics, counts, stats = _timed_search(estimator, input_fn(xtr, ytr, TRAIN_BATCH), input_fn(xte, yte, TRAIN_BATCH),
                                           FULL_GATE_STEPS, FULL_GATE_ITERATIONS)
    candidates = _grow_candidates(2, FULL_GATE_ITERATIONS)
    eval_batches = -(-FULL_GATE_TEST // TRAIN_BATCH)
    _check_k1("full_dnn_gate", counts, FULL_GATE_STEPS, candidates, eval_batches, directory)
    if not (metrics["accuracy"] >= FULL_GATE_ACCURACY and metrics["top_5_accuracy"] >= FULL_GATE_TOP5):
        raise AssertionError("full_dnn_gate: %s below %s / top-5 %s" % (metrics, FULL_GATE_ACCURACY, FULL_GATE_TOP5))
    stats = dict(accuracy=metrics["accuracy"], top_5_accuracy=metrics["top_5_accuracy"], loss=metrics["loss"],
                 best_ensemble=metrics["best_ensemble"], candidates=candidates, k1_launches=counts["combine"],
                 **stats, phase_secs=time.perf_counter() - t_phase, card=card_line())
    print("full_dnn_gate: " + json.dumps(stats))
    return counts, stats


def _cnn_initial_state(builder, initial_seed, moved=None):
    """The CPU state dict that `builder`'s SimpleCNN starts from in a
    search seeded `initial_seed`, moved by a relative 1e-7 x N(0, 1) from
    a generator seeded `moved` where that is given."""
    import zlib

    import torch

    module = builder.build_subnetwork(10, input_shape=(16, 16, 1))
    module.init_parameters(torch.Generator().manual_seed(zlib.crc32(builder.name.encode()) + initial_seed))
    state = {k: v.clone() for k, v in module.state_dict().items()}
    if moved is not None:
        noise = torch.Generator().manual_seed(moved)
        state = {k: v * (1.0 + 1e-7 * torch.randn(v.shape, generator=noise)) for k, v in state.items()}
    return state


def cnn_forward_precision(images):
    """Each CNN candidate's forward at cnn_vs_cpu's initial parameters on
    `images` (one batch): the card's bf16 logits against the CPU's, by
    the mean absolute difference over the batch's logits, within a
    quarter of bf16's own effect on them on the CPU (the mean of its f32
    forward against its bf16 one). A rounding that flips moves a few
    logits by as much as bf16 moves the largest (PERF.md), so the max
    tells no precision apart; the mean does. The bound is held to its
    derivation: the CPU's bf16 forward moved by a relative 1e-7 (each
    of MOVED_SEEDS) stays within it, and the card's f32 forward does
    not, so that a card computing the CNN in f32 fails it. The largest
    differences are reported beside the means."""
    import torch

    from adanet_tpu_torch.ensemble.weighted import full_f32_matmul
    from adanet_tpu_torch.examples import simple_cnn

    out = {}
    for blocks in (1, 2):
        builder = simple_cnn.CNNBuilder(blocks, channels=CNN_CHANNELS, learning_rate=CNN_LR)

        def logits(device, dtype, state):
            module = simple_cnn.SimpleCNN(1, 10, blocks, CNN_CHANNELS, compute_dtype=dtype)
            module.load_state_dict(state)
            with torch.no_grad(), full_f32_matmul():
                got = module.to(device)({"image": torch.from_numpy(images).to(device)}, training=False).logits
            return got.float().cpu()

        state = _cnn_initial_state(builder, 0)
        want = logits("cpu", torch.bfloat16, state)

        def gap(got):
            diff = (got - want).abs()
            return float(diff.mean()), float(diff.max())

        moved = [gap(logits("cpu", torch.bfloat16, _cnn_initial_state(builder, 0, s))) for s in MOVED_SEEDS]
        row = dict(cpu_f32=gap(logits("cpu", torch.float32, state)), cpu_moved_1e7=max(moved),
                   card=gap(logits("cuda", torch.bfloat16, state)), card_f32=gap(logits("cuda", torch.float32, state)))
        row["bound"] = 0.25 * row["cpu_f32"][0]
        out[builder.name] = row
        print("cnn_forward_precision %s (mean, max): %s" % (builder.name, json.dumps(row)))
        if not (max(m[0] for m in moved) <= row["bound"] and row["card"][0] <= row["bound"] < row["card_f32"][0]):
            raise AssertionError("cnn_forward_precision %s: %s" % (builder.name, row))
    return out


def _cnn_estimator(directory, device, steps, initial_seed=None, f32=False, moved=None):
    """The CNN family gate's search (tests/test_convergence.py:66-97):
    CNNBuilder(1 and 2 blocks, 32 channels, SGD 0.02 with momentum, bf16
    convolutions), adam 1e-3 mixture weights, the combine fused. With
    `initial_seed`, every candidate starts from parameters drawn by
    `SimpleCNN.init_parameters` from a generator seeded from it and the
    builder's name (card and CPU alike), each then moved by a relative
    1e-7 x N(0, 1) from a generator seeded `moved` where that is given;
    `f32` computes in f32."""
    import torch

    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.examples import simple_cnn
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

    class F32Builder(simple_cnn.CNNBuilder):
        def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape):
            return simple_cnn.SimpleCNN(input_shape[-1], logits_dimension, self._num_blocks, self._channels,
                                        compute_dtype=torch.float32)

    builder = F32Builder if f32 else simple_cnn.CNNBuilder
    pool = [builder(b, channels=CNN_CHANNELS, learning_rate=CNN_LR) for b in (1, 2)]
    if initial_seed is not None:
        for builder in pool:
            builder.initial_variables = _cnn_initial_state(builder, initial_seed, moved)
    head, _, ensembler = search_parts()
    return Estimator(head, SimpleGenerator(pool), max_iteration_steps=steps, max_iterations=TRAIN_ITERATIONS,
                     ensemblers=[ensembler], model_dir=directory, log_every_steps=0, device=device)


def cnn_search(model_dir):
    """tests/test_convergence.py::test_cnn_family_converges on the card:
    8192 training and 2048 test digit images, 2 x 400 steps at batch 128:
    accuracy >= 0.89 and above the linear baseline, K1 exact."""
    from adanet_tpu_torch.examples.synthetic_digits import image_input_fn, make_dataset

    t_phase = time.perf_counter()
    xtr, ytr = make_dataset(CNN_TRAIN, seed=7)
    xte, yte = make_dataset(CNN_TEST, seed=8)
    directory = os.path.join(model_dir, "cnn_search")
    estimator = _cnn_estimator(directory, "cuda", CNN_STEPS)
    metrics, counts, stats = _timed_search(estimator, image_input_fn(xtr, ytr, TRAIN_BATCH),
                                           image_input_fn(xte, yte, TRAIN_BATCH), CNN_STEPS, TRAIN_ITERATIONS)
    candidates = _grow_candidates(2, TRAIN_ITERATIONS)
    _check_k1("cnn_search", counts, CNN_STEPS, candidates, -(-CNN_TEST // TRAIN_BATCH), directory)
    if not (metrics["accuracy"] >= CNN_ACCURACY and metrics["accuracy"] > LINEAR_BASELINE_ACCURACY):
        raise AssertionError("cnn_search: %s below %s" % (metrics, CNN_ACCURACY))
    stats = dict(accuracy=metrics["accuracy"], top_5_accuracy=metrics["top_5_accuracy"], loss=metrics["loss"],
                 best_ensemble=metrics["best_ensemble"], candidates=candidates, k1_launches=counts["combine"],
                 **stats, phase_secs=time.perf_counter() - t_phase, card=card_line())
    print("cnn_search: " + json.dumps(stats))
    return counts, stats


def cnn_vs_cpu(model_dir):
    """The CNN search at 2 x CNN_PARITY_STEPS on the card and on the CPU
    from the same initial parameters, bf16 convolutions on both: every
    candidate's adanet loss and EMA and the final loss within
    CNN_PARITY_BOUND x max(1, |value|); accuracy and top-5 within one
    example of a batch (1/128); the same winners wherever the CPU's two
    best EMAs are further apart than the bound. Beside it: the CPU
    against itself with every initial parameter moved by a relative 1e-7
    (from each of MOVED_SEEDS), which the bound lies above (asserted),
    and the same search in f32 on the CPU. 40 steps carry a 1e-7 move as
    far as bf16 itself moves these numbers, so the precision is held at
    the forward instead (`cnn_forward_precision`)."""
    from adanet_tpu_torch.examples.synthetic_digits import image_input_fn, make_dataset

    xtr, ytr = make_dataset(TRAIN_BATCH * CNN_PARITY_STEPS * TRAIN_ITERATIONS, seed=7)
    xte, yte = make_dataset(CNN_TEST, seed=8)
    forward = cnn_forward_precision(xte[:TRAIN_BATCH])
    bound = CNN_PARITY_BOUND
    runs = {}
    for run, device, kwargs in [("card", "cuda", {}), ("cpu", "cpu", {}), ("cpu_f32", "cpu", dict(f32=True))] + [
            ("cpu_moved_%d" % s, "cpu", dict(moved=s)) for s in MOVED_SEEDS]:
        directory = os.path.join(model_dir, "cnn_vs_cpu_%s" % run)
        estimator = _cnn_estimator(directory, device, CNN_PARITY_STEPS, initial_seed=0, **kwargs)
        estimator.train(image_input_fn(xtr, ytr, TRAIN_BATCH), max_steps=10**6)
        runs[run] = ([_read_json(directory, "candidate-metrics-%d.json" % t) for t in range(TRAIN_ITERATIONS)],
                     estimator.evaluate(image_input_fn(xte, yte, TRAIN_BATCH)))

    def gap(got_run, want_run, check):
        worst = {"losses": 0.0, "counted": 0.0, "flip": None}
        for t, (got, want) in enumerate(zip(got_run[0], want_run[0])):
            for name in want:
                for key in ("adanet_loss", "adanet_loss_ema"):
                    err = abs(got[name][key] - want[name][key]) / max(1.0, abs(want[name][key]))
                    if check and not err <= bound:
                        raise AssertionError("cnn_vs_cpu t=%d %s %s: %r vs %r" % (t, name, key, got[name][key],
                                                                                 want[name][key]))
                    worst["losses"] = max(worst["losses"], err)
            if [n for n in got if got[n]["best"]] != [n for n in want if want[n]["best"]]:
                emas = sorted(e["adanet_loss_ema"] for e in want.values())
                if check and emas[1] - emas[0] > bound * max(1.0, abs(emas[0])):
                    raise AssertionError("cnn_vs_cpu t=%d: the winners differ" % t)
                worst["flip"] = t
                return worst
        for key, value in want_run[1].items():
            if isinstance(value, float):
                counted = key.startswith(("accuracy", "top_5"))
                err = abs(got_run[1][key] - value) / (1.0 if counted else max(1.0, abs(value)))
                if check and not err <= (1.0 / TRAIN_BATCH if counted else bound):
                    raise AssertionError("cnn_vs_cpu final %s: %r vs %r" % (key, got_run[1][key], value))
                part = "counted" if counted else "losses"
                worst[part] = max(worst[part], err)
        return worst

    moved = [gap(runs["cpu_moved_%d" % s], runs["cpu"], False) for s in MOVED_SEEDS]
    out = dict(steps=CNN_PARITY_STEPS * TRAIN_ITERATIONS, bound=bound, card_vs_cpu=gap(runs["card"], runs["cpu"], True),
               cpu_moved_1e7_vs_cpu=moved, cpu_bf16_vs_f32=gap(runs["cpu"], runs["cpu_f32"], False),
               forward=forward, card=card_line())
    if max(m["losses"] for m in moved) > bound:
        raise AssertionError("cnn_vs_cpu: the bound %g is below the moved CPU runs: %s" % (bound, out))
    print("cnn_vs_cpu: " + json.dumps(out))
    return out


def _mlp(out, dim):
    import torch
    from torch import nn

    class MLP(nn.Module):
        def __init__(self):
            super().__init__()
            self.hidden = nn.Linear(dim, 8)
            self.logits = nn.Linear(8, out)

        def forward(self, features, training=False):
            return self.logits(torch.relu(self.hidden(features["x"].float())))

    return MLP()


def bagging_gate(model_dir, **estimator_kwargs):
    """tests/test_autoensemble.py::test_bagging_improves_accuracy on the
    card: 2048 digits with 25% of the labels redrawn, three MLPs each on
    its own bootstrap stream, MeanEnsembler under AllStrategy, 150 steps,
    against each member alone: the bagged ensemble's accuracy at least
    the best single member's, and no K1 launch (mean candidates). With
    `estimator_kwargs` (prefetch), also: each iteration's bagged streams
    closed before it completes, and no prefetcher left open."""
    import numpy as np
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.autoensemble import AutoEnsembleEstimator, AutoEnsembleSubestimator
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.mean import MeanEnsembler
    from adanet_tpu_torch.ensemble.strategy import AllStrategy
    from adanet_tpu_torch.examples.synthetic_digits import make_dataset

    xtr, ytr = make_dataset(BAGGING_TRAIN, seed=3)
    xte, yte = make_dataset(BAGGING_TEST, seed=4)
    noise_rng = np.random.RandomState(0)
    flip = noise_rng.rand(len(ytr)) < 0.25
    ytr = np.where(flip, noise_rng.randint(0, 10, size=len(ytr)), ytr)
    xtr = xtr.reshape(len(xtr), -1).astype(np.float32)
    xte = xte.reshape(len(xte), -1).astype(np.float32)

    def stream(seed, batch=64):
        def fn():
            idx = np.random.RandomState(seed).randint(0, len(xtr), size=len(xtr))
            for start in range(0, len(idx) - batch + 1, batch):
                take = idx[start:start + batch]
                yield {"x": xtr[take]}, ytr[take]

        return fn

    def eval_stream(batch=64):
        for start in range(0, len(xte) - batch + 1, batch):
            yield {"x": xte[start:start + batch]}, yte[start:start + batch]

    def members():
        return {"bag_%d" % k: AutoEnsembleSubestimator(
            _mlp(10, xtr.shape[1]), optimizer=lambda params: torch.optim.Adam(params, lr=2e-3, fused=True),
            train_input_fn=stream(100 + k)) for k in range(3)}

    open_at_completion = []

    class Probe(AutoEnsembleEstimator):
        def _complete_iteration(self, *args, **kwargs):
            open_at_completion.append(len(self._open_prefetchers))
            return super()._complete_iteration(*args, **kwargs)

    def run(pool, name):
        est = Probe(head=MultiClassHead(10), candidate_pool=pool, ensemblers=[MeanEnsembler()],
                    ensemble_strategies=[AllStrategy()], max_iteration_steps=BAGGING_STEPS, max_iterations=1,
                    model_dir=os.path.join(model_dir, name), log_every_steps=0, device="cuda", **estimator_kwargs)
        est.train(stream(9), max_steps=BAGGING_STEPS)
        metrics = est.evaluate(eval_stream)
        if est._open_prefetchers:
            raise AssertionError("bagging: %d prefetchers left open" % len(est._open_prefetchers))
        return metrics

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    bagged = run(members(), "bagged")
    counts = ops.launch_counts()
    singles = [run({name: sub}, "single_%s" % name)["accuracy"] for name, sub in members().items()]
    out = dict(bagged_accuracy=bagged["accuracy"], single_accuracies=singles, k1_launches=counts["combine"],
               secs=time.perf_counter() - t0, **{key: str(value) for key, value in estimator_kwargs.items()})
    if estimator_kwargs:
        # One shared stream stays open while an iteration completes; its
        # bagged streams are closed by then.
        out["open_prefetchers_at_completion"] = open_at_completion
        if open_at_completion != [1] * 4:
            raise AssertionError("bagging prefetchers open at iteration end: %s" % open_at_completion)
    if counts != _counts(0) or not bagged["accuracy"] >= max(singles):
        raise AssertionError("bagging gate: %s" % out)
    return counts, out


def transfer_on_card(model_dir):
    """The transfer_learning tutorial at its defaults on the card (300
    pretraining steps, 2 x 200 search steps), with cuDNN's TF32 at
    torch's default (on) so that the port's own guards are what turn it
    off: accuracy > 0.3, every f32 convolution of the pretraining loop
    and of a training or eval step run with TF32 off, the frozen
    member's parameters bitwise the
    pretrained ones at each iteration's end, K1 exact."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.autoensemble import AutoEnsembleEstimator
    from adanet_tpu_torch.examples.tutorials import transfer_learning

    pretrain, forward, complete = (transfer_learning.pretrain, transfer_learning.ConvEncoder.forward,
                                   AutoEnsembleEstimator._complete_iteration)
    captured, flags, frozen_equal = {}, set(), []

    def recorded_pretrain(*args, **kwargs):
        captured["pretrained"], loss = pretrain(*args, **kwargs)
        ops.reset_launch_counts()
        return captured["pretrained"], loss

    def recorded_forward(self, features, training=False):
        flags.add(torch.backends.cudnn.allow_tf32)
        return forward(self, features, training)

    def recorded_complete(self, iteration, state, *args, **kwargs):
        live = state.subnetworks["pretrained_frozen"].module.inner.state_dict()
        frozen_equal.append(all(torch.equal(live[k].cpu(), v) for k, v in captured["pretrained"].items()))
        return complete(self, iteration, state, *args, **kwargs)

    transfer_learning.pretrain, transfer_learning.ConvEncoder.forward = recorded_pretrain, recorded_forward
    AutoEnsembleEstimator._complete_iteration = recorded_complete
    previous_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    try:
        metrics = transfer_learning.main(["--model_dir=%s" % os.path.join(model_dir, "transfer")])
        counts = ops.launch_counts()
    finally:
        torch.backends.cudnn.allow_tf32 = previous_tf32
        transfer_learning.pretrain, transfer_learning.ConvEncoder.forward = pretrain, forward
        AutoEnsembleEstimator._complete_iteration = complete
    # Three candidates at t = 0, the carried-over winner too at t = 1; one
    # K1 a candidate a step, one a test batch.
    expected = _counts(TRANSFER_STEPS * sum(_grow_candidates(3, TRAIN_ITERATIONS)) + -(-TRANSFER_TEST // TRAIN_BATCH))
    out = dict(accuracy=metrics["accuracy"], best_ensemble=metrics["best_ensemble"], tf32_in_forwards=sorted(flags),
               frozen_bitwise=frozen_equal, k1_launches=counts["combine"], secs=time.perf_counter() - t0)
    if not (metrics["accuracy"] > 0.3 and flags == {False} and frozen_equal == [True] * TRAIN_ITERATIONS
            and counts == expected):
        raise AssertionError("transfer_learning: %s, expected launches %s" % (out, expected))
    return counts, out


def boston_on_card(model_dir):
    """The boston_housing tutorial at its defaults on the card (3 x 200
    steps, the synthetic stand-in): a finite average loss, K1 exact."""
    import math

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.examples.tutorials import boston_housing

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = boston_housing.main(["--model_dir=%s" % os.path.join(model_dir, "boston")])
    counts = ops.launch_counts()
    test_batches = (506 - int(0.8 * 506)) // 32
    expected = _counts(BOSTON_STEPS * sum(_grow_candidates(2, 3)) + test_batches)
    out = dict(average_loss=metrics["average_loss"], k1_launches=counts["combine"], secs=time.perf_counter() - t0)
    if not math.isfinite(metrics["average_loss"]) or counts != expected:
        raise AssertionError("boston_housing: %s, expected launches %s" % (out, expected))
    return counts, out


def autoensemble(model_dir):
    """The AutoEnsemble phases: the bagging gate, again with device
    prefetch, transfer_learning and boston_housing."""
    t_phase = time.perf_counter()
    bagging_counts, bagging = bagging_gate(os.path.join(model_dir, "bagging"))
    _, prefetched = bagging_gate(os.path.join(model_dir, "bagging_prefetch"), prefetch_buffer=2,
                                 prefetch_to_device=True)
    transfer_counts, transfer = transfer_on_card(model_dir)
    boston_counts, boston = boston_on_card(model_dir)
    stats = dict(bagging=bagging, bagging_prefetched=prefetched, transfer_learning=transfer, boston_housing=boston,
                 phase_secs=time.perf_counter() - t_phase, card=card_line())
    print("autoensemble: " + json.dumps(stats))
    return dict(bagging=bagging_counts, transfer=transfer_counts, boston=boston_counts), stats


def replay_search(model_dir, seed):
    """`_selection_estimator`'s search at 2 x SELECTION_PARITY_STEPS on
    the card, then again from `replay.Config.from_model_dir` of the first:
    `replay.json` written after each iteration (1 then 2 indices) and at
    search end; the replayed run calls its Evaluator 0 times and writes
    the same architecture files and record; its K1 launches exact (one a
    weighted candidate a step, one a test batch of a weighted winner; no
    Evaluator batch)."""
    from adanet_tpu_torch import ops, replay

    t_phase = time.perf_counter()
    first_dir, replay_dir = os.path.join(model_dir, "replay_first"), os.path.join(model_dir, "replay_replayed")
    first, train_fn, test_fn, _, _ = _selection_estimator(first_dir, "cuda", SELECTION_PARITY_STEPS, seed)
    written = []
    record = first._write_replay_record

    def recorded():
        record()
        written.append(len(_read_json(first_dir, replay.REPLAY_FILENAME)["best_ensemble_indices"]))

    first._write_replay_record = recorded
    first.train(train_fn, max_steps=10**6)
    replayed, train_fn, test_fn, _, _ = _selection_estimator(replay_dir, "cuda", SELECTION_PARITY_STEPS, seed,
                                                             replay_config=replay.Config.from_model_dir(first_dir))
    evaluator = _Timed(replayed._evaluator, "evaluate")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    replayed.train(train_fn, max_steps=10**6)
    metrics = replayed.evaluate(test_fn)
    counts = ops.launch_counts()
    replay_secs = time.perf_counter() - t0
    weighted = [sum(_is_weighted(n) for n in _read_json(replay_dir, "candidate-metrics-%d.json" % t))
                for t in range(TRAIN_ITERATIONS)]
    final = _read_json(replay_dir, "architecture-%d.json" % (TRAIN_ITERATIONS - 1))
    final_weighted = final["ensembler_name"] == "complexity_regularized"
    expected = _counts(SELECTION_PARITY_STEPS * sum(weighted) + -(-EVAL_EXAMPLES // TRAIN_BATCH) * final_weighted)
    same = all(_read_json(replay_dir, name) == _read_json(first_dir, name)
               for name in ["architecture-%d.json" % t for t in range(TRAIN_ITERATIONS)] + [replay.REPLAY_FILENAME])
    out = dict(replay_json_indices_after_each_write=written, evaluator_calls=evaluator.calls,
               architectures_and_record_equal=same, indices=replayed._replay_config.best_ensemble_indices,
               weighted_candidates=weighted, accuracy=metrics["accuracy"], k1_launches=counts["combine"],
               replay_secs=replay_secs, phase_secs=time.perf_counter() - t_phase, card=card_line())
    if written != [1, 2, 2] or evaluator.calls != 0 or not same or counts != expected:
        raise AssertionError("replay_search: %s, expected launches %s" % (out, expected))
    print("replay_search: " + json.dumps(out))
    return counts, out


def tutorials_on_card(model_dir):
    """adanet_objective at tests/test_examples.py:98-125's settings (120
    steps, 1024 examples, lambda 0 and 1): lambda = 0 grows a 2- or
    3-layer member, every lambda = 1 member is 1-layer; mnist_simple_dnn
    on its stand-in and cifar10_cnn on synthetic data at reduced steps:
    finite losses."""
    import math

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.examples.tutorials import adanet_objective, cifar10_cnn, mnist_simple_dnn

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    results = adanet_objective.main(["--steps", "120", "--train_size", "1024", "--lambdas", "0.0,1.0",
                                     "--model_dir", os.path.join(model_dir, "objective")])
    free, priced = results[0.0][0], results[1.0][0]
    mnist = mnist_simple_dnn.main(["--max_steps=%d" % TUTORIAL_STEPS, "--iterations=3",
                                   "--model_dir=%s" % os.path.join(model_dir, "mnist")])
    cifar = cifar10_cnn.main(["--max_steps=%d" % TUTORIAL_STEPS, "--iterations=3",
                              "--model_dir=%s" % os.path.join(model_dir, "cifar10")])
    counts = ops.launch_counts()
    out = dict(objective={str(lam): dict(members=m, accuracy=a) for lam, (m, a) in results.items()},
               mnist_simple_dnn=dict(loss=mnist["loss"], accuracy=mnist["accuracy"]),
               cifar10_cnn=dict(loss=cifar["loss"], accuracy=cifar["accuracy"]),
               reduced={"mnist_simple_dnn": "--max_steps %d of 3000" % TUTORIAL_STEPS,
                        "cifar10_cnn": "--max_steps %d of 3000" % TUTORIAL_STEPS},
               k1_launches=counts["combine"], phase_secs=time.perf_counter() - t_phase, card=card_line())
    flips = (any("2_layer" in m or "3_layer" in m for m in free) and priced
             and all("1_layer" in m for m in priced))
    if not (flips and math.isfinite(mnist["loss"]) and math.isfinite(cifar["loss"]) and counts["combine"] > 0):
        raise AssertionError("tutorials: %s" % out)
    print("tutorials: " + json.dumps(out))
    return counts, out


def predict_debug(model_dir):
    """F3 on the card: under debug=True, Estimator.predict and
    TPUEstimator.predict (padded and not) raise FloatingPointError on a
    NaN feature before the model sees it; a clean batch predicts."""
    import numpy as np

    from adanet_tpu_torch.core import TPUEstimator
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset

    head, generator, ensembler = search_parts()
    x, y = make_dataset(4 * TRAIN_BATCH, seed=7)
    flat = x.reshape(len(x), -1)
    estimator = TPUEstimator(head, generator, max_iteration_steps=4, max_iterations=1, ensemblers=[ensembler],
                             model_dir=os.path.join(model_dir, "predict_debug"), log_every_steps=0, device="cuda",
                             debug=True, iterations_per_loop=2)
    estimator.train(input_fn(x, y, TRAIN_BATCH), max_steps=4)
    poisoned = flat[:32].copy()
    poisoned[3, 1] = np.nan
    raised = {}
    calls = {
        "predict": lambda fn: Estimator.predict(estimator, fn),
        "tpu_unpadded": lambda fn: estimator.predict(fn, predict_batch_size=0),
        "tpu_padded": lambda fn: estimator.predict(fn, predict_batch_size=40),
    }
    for label, predict in calls.items():
        clean = next(predict(lambda: iter([({"x": flat[:32]}, None)])))
        if not np.all(np.isfinite(clean["probabilities"].numpy())):
            raise AssertionError("predict_debug %s: a clean batch predicted %s" % (label, clean))
        try:
            next(predict(lambda: iter([({"x": poisoned}, y[:32])])))
            raised[label] = None
        except FloatingPointError as exc:
            raised[label] = str(exc)
    out = dict(raised=raised, card=card_line())
    if any(message is None or "debug=True" not in message for message in raised.values()):
        raise AssertionError("predict_debug: %s" % out)
    print("predict_debug: " + json.dumps(out))
    return out


def _write_cifar_archive(root, classes, seed):
    """A synthetic extracted archive in the published layout: python-2
    pickles (protocol 2) of byte-keyed dicts, uint8 rows of 3072
    channel-major bytes; CIFAR-10's five training batches and test batch
    (`b"labels"`), or CIFAR-100's train and test files (`b"fine_labels"`,
    `b"coarse_labels"`). Returns the directory to pass as --data_dir."""
    import pickle

    import numpy as np

    rng = np.random.RandomState(seed)
    if classes == 10:
        base = os.path.join(root, "cifar-10-batches-py")
        per_batch = CIFAR_TRAIN // 5
        files = [("data_batch_%d" % i, per_batch) for i in range(1, 6)] + [("test_batch", CIFAR_TEST)]
    else:
        base = os.path.join(root, "cifar-100-python")
        files = [("train", CIFAR_TRAIN), ("test", CIFAR_TEST)]
    os.makedirs(base, exist_ok=True)
    for name, n in files:
        entry = {b"data": rng.randint(0, 256, size=(n, 3072), dtype=np.uint8)}
        if classes == 10:
            entry[b"labels"] = rng.randint(0, 10, size=n).tolist()
        else:
            entry[b"fine_labels"] = rng.randint(0, 100, size=n).tolist()
            entry[b"coarse_labels"] = rng.randint(0, 20, size=n).tolist()
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(entry, f, protocol=2)
    return root


def _step_times(estimator_cls, marks, losses=None):
    """An Estimator class whose training steps append (iteration, host
    clock, CUDA event) to `marks` as each step returns, and to `losses`
    (when given) (iteration, the subnetworks' training losses: 0-d
    tensors on the card)."""
    import torch

    class Timed(estimator_cls):
        def _build_iteration(self, iteration_number, sample_batch):
            iteration = super()._build_iteration(iteration_number, sample_batch)
            step = iteration.train_step

            def timed(*args, **kwargs):
                out = step(*args, **kwargs)
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                marks.append((iteration_number, time.perf_counter(), event))
                if losses is not None:
                    losses.append((iteration_number, {k.split("/", 1)[1]: v for k, v in out[1].items()
                                                      if k.startswith("subnetwork_loss/")}))
                return out

            iteration.train_step = timed
            return iteration

    return Timed


def _last_iteration_ms(marks):
    """ms a step over the last iteration's steps after its first (the
    host clock and CUDA events between step ends)."""
    import torch

    torch.cuda.synchronize()
    last = [m for m in marks if m[0] == marks[-1][0]]
    (_, host0, event0), (_, host1, event1) = last[0], last[-1]
    n = len(last) - 1
    return dict(window_steps=n, host_ms_per_step=(host1 - host0) / n * 1e3,
                event_ms_per_step=event0.elapsed_time(event1) / n)


def _run_cli(module, argv, marks, losses=None):
    """`module.main(argv)` with its Estimator timed (`_step_times`), the
    launch counts zeroed just before and read just after. Returns (the
    metrics line it prints as a dict, counts, seconds, peak memory)."""
    import io

    import torch

    from adanet_tpu_torch import ops

    name = "AutoEnsembleEstimator" if hasattr(module, "AutoEnsembleEstimator") else "Estimator"
    original = getattr(module, name)
    setattr(module, name, _step_times(original, marks, losses))
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = module.main(argv)
        torch.cuda.synchronize()
    finally:
        setattr(module, name, original)
    counts = ops.launch_counts()
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError("%s returned %r" % (module.__name__, rc))
    metrics = json.loads(out.getvalue().strip().splitlines()[-1])
    return metrics, counts, secs, torch.cuda.max_memory_allocated()


def loss_summary(losses):
    """Each iteration's subnetworks' training losses (`_step_times`):
    first, least and last, read from the card once."""
    import torch

    series = collections.defaultdict(list)
    for t, step in losses:
        for name, value in step.items():
            series["t%d/%s" % (t, name)].append(value)
    out = {}
    for key, values in series.items():
        values = torch.stack(values).float().tolist()
        out[key] = dict(first=values[0], least=min(values), last=values[-1])
    return out


def _finite_metrics(what, metrics, steps):
    values = [metrics[k] for k in ("loss", "average_loss", "accuracy", "top_5_accuracy")]
    if metrics["global_step"] != steps or not all(map(math.isfinite, values)):
        raise AssertionError("%s: metrics %s" % (what, metrics))


def cifar_trainer(model_dir):
    """The improve_nas trainer CLI on CIFAR-10 and CIFAR-100 archives in the
    published layouts, at its full width (NASNet-A 6@768, batch 32, K2 and
    K1 on, its defaults), 2 x 5 and 2 x 3 steps, then its evaluation over
    the CIFAR_TEST test images: the native augment library loaded, its output
    bitwise numpy's, K1 and K2 launches exact, finite metrics. Prints the
    archive load seconds, augment ms a batch (native, numpy), ms a step,
    peak memory and the launches."""
    import numpy as np

    from adanet_tpu_torch.ops import native_augment
    from adanet_tpu_torch.research.improve_nas import cifar10, cifar100, image_processing, improve_nas, trainer

    t_phase = time.perf_counter()
    if native_augment.get_lib() is None:
        raise AssertionError("cifar_trainer: the native augment library did not load")
    per_forward = len(improve_nas.Builder(None, improve_nas.Hparams(use_pallas_sep_conv=True)).build_subnetwork(
        10, input_shape=(32, 32, 3)).nasnet.sepconv_launch_shapes())
    eval_batches = CIFAR_TEST // CIFAR_BATCH
    out, counts_by_set = {}, {}
    for classes, steps, provider_cls in ((10, CIFAR10_STEPS, cifar10.Provider), (100, CIFAR100_STEPS,
                                                                              cifar100.Provider)):
        label = "cifar%d" % classes
        t0 = time.perf_counter()
        data_dir = _write_cifar_archive(os.path.join(model_dir, label), classes, seed=classes)
        write_secs = time.perf_counter() - t0
        provider = provider_cls(data_dir, CIFAR_BATCH, seed=42)
        t0 = time.perf_counter()
        images, _ = provider._load("train")
        provider._load("test")
        load_secs = time.perf_counter() - t0
        rng = np.random.RandomState(classes)
        batch = images[:CIFAR_BATCH]
        offsets = image_processing.sample_offsets(CIFAR_BATCH, 32, 32, rng, pad=4)
        native = native_augment.augment_apply(batch, *offsets, pad=4, cutout=16)
        oracle = image_processing.apply_numpy(batch, *offsets, pad=4, cutout=16)
        if not np.array_equal(native, oracle):
            raise AssertionError("%s: native augment differs from numpy" % label)
        augment_ms = {}
        for backend, fn in (("native", native_augment.augment_apply), ("numpy", image_processing.apply_numpy),
                            ("native_again", native_augment.augment_apply)):
            t0 = time.perf_counter()
            for _ in range(AUGMENT_REPEATS):
                fn(batch, *offsets, pad=4, cutout=16)
            augment_ms[backend] = (time.perf_counter() - t0) / AUGMENT_REPEATS * 1e3
        marks = []
        metrics, counts, secs, peak = _run_cli(trainer, [
            "--dataset=%s" % label, "--data_dir=%s" % data_dir, "--batch_size=%d" % CIFAR_BATCH,
            "--boosting_iterations=%d" % CIFAR_ITERATIONS, "--train_steps=%d" % steps, "--device=cuda",
            "--model_dir=%s" % os.path.join(model_dir, label + "_model")], marks)
        _finite_metrics(label, metrics, steps)
        per_iteration = steps // CIFAR_ITERATIONS
        forwards = _member_forwards(CIFAR_ITERATIONS, per_iteration, eval_batches, CIFAR_ITERATIONS)
        # K1: one a candidate a step (1 at t = 0; the carried-over winner
        # and the grown one at t = 1) and one an eval batch.
        expected = dict(copy=0, cell=0, sepconv=forwards * per_forward, combine=per_iteration * 3 + eval_batches)
        if counts != expected or len(marks) != steps:
            raise AssertionError("%s: %d steps, launches %s, expected %s" % (label, len(marks), counts, expected))
        counts_by_set[label] = counts
        out[label] = dict(archive_write_secs=write_secs, archive_load_secs=load_secs,
                          augment_ms_per_batch=augment_ms, steps=steps, cli_secs=secs,
                          **_last_iteration_ms(marks), max_memory_allocated_bytes=peak,
                          accuracy=metrics["accuracy"], loss=metrics["loss"], best_ensemble=metrics["best_ensemble"],
                          eval_batches=eval_batches, k2_per_member_forward=per_forward, launches=counts)
    out.update(native_library=native_augment._SO, phase_secs=time.perf_counter() - t_phase, card=card_line())
    print("cifar_trainer: " + json.dumps(out))
    return counts_by_set, out


def _family_vs_cpu(gen):
    """ResNet-18 (width 8) and EfficientNet-B0 with small inputs, f32, the
    same weights (initialised on the CPU from `gen`'s seed, statistics
    moved by one training forward) on the card and the CPU: eval-mode
    logits, and ResNet-18's training-mode logits and statistics, within
    1e-5 x max(1, |value|), TF32 off. Returns the worst relative gaps."""
    import copy

    import torch

    from adanet_tpu_torch.ensemble.weighted import full_f32_matmul
    from adanet_tpu_torch.models import efficientnet, resnet

    x = torch.randn(8, 32, 32, 3, generator=gen)
    worst = {}
    previous_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, module in (("resnet18", resnet.ResNet(IMAGENET_CLASSES, depth=18, width=8, small_inputs=True,
                                                        compute_dtype=torch.float32)),
                             ("efficientnet_b0", efficientnet.EfficientNet(IMAGENET_CLASSES, small_inputs=True,
                                                                          compute_dtype=torch.float32))):
            module.init_parameters(torch.Generator().manual_seed(int(torch.randint(0, 2**31, (), generator=gen))))
            with torch.no_grad():
                module({"image": x}, training=True)  # statistics off their init values
            card = copy.deepcopy(module).cuda()
            modes = (False, True) if name == "resnet18" else (False,)
            for training in modes:
                with torch.no_grad(), full_f32_matmul():
                    want = module({"image": x}, training=training).logits
                    got = card({"image": x.cuda()}, training=training).logits.cpu()
                key = "%s_%s" % (name, "train" if training else "eval")
                worst[key] = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
            cpu_state, card_state = module.state_dict(), card.state_dict()
            worst[name + "_statistics"] = max(float((card_state[k].cpu() - v).abs().max()) / max(1.0, float(
                v.abs().max())) for k, v in cpu_state.items() if k.endswith((".mean", ".var")))
    finally:
        torch.backends.cudnn.allow_tf32 = previous_tf32
    if not max(worst.values()) <= 1e-5:
        raise AssertionError("family card/CPU forwards: %s" % worst)
    return worst


def imagenet_autoensemble(model_dir, gen):
    """The ImageNet AutoEnsemble trainer CLI at its defaults (ResNet-50
    width 64 + EfficientNet-B0, 224 x 224, batch 64, replication, K1 on)
    on its fake data, 2 x 10 steps: K1 exact (one a candidate a step, two
    at t = 0 and three at t = 1, and one a test batch), finite metrics,
    each subnetwork's training loss falling within its iteration; the
    families' card/CPU forwards (`_family_vs_cpu`). Prints ms a step (over
    iteration 1, and over a window of it by the host clock and CUDA
    events), a traced step's device busy ms, idle share and kernels, peak
    memory, the metrics. Returns (counts, the line's numbers, each step's
    training losses)."""
    from adanet_tpu_torch.research.imagenet_autoensemble import trainer

    t_phase = time.perf_counter()
    marks, clocks, losses = [], [], []
    with _timed_provider(trainer, clocks):
        metrics, counts, secs, peak = _run_cli(trainer, [
            "--dataset=fake", "--boosting_iterations=%d" % IMAGENET_ITERATIONS, "--train_steps=%d" % IMAGENET_STEPS,
            "--device=cuda", "--model_dir=%s" % os.path.join(model_dir, "imagenet_ae")], marks, losses)
    _finite_metrics("imagenet_autoensemble", metrics, IMAGENET_STEPS)
    # Training mode: every subnetwork's loss falls within its iteration
    # (the evaluation reads the batch norms' running statistics, which
    # lag weights that move fast at the recipe's learning rates).
    train_losses = loss_summary(losses)
    if len(train_losses) != 4 or not all(v["least"] < v["first"] for v in train_losses.values()):
        raise AssertionError("imagenet_autoensemble: training losses %s" % train_losses)
    (clock,) = clocks
    (host0, event0), (host1, event1) = clock.marks
    host_ms = (host1 - host0) / clock.window * 1e3
    window = dict(window_steps=[clock._first, clock._first + clock.window - 1], window_host_ms_per_step=host_ms,
                  window_event_ms_per_step=event0.elapsed_time(event1) / clock.window,
                  **traced_step(clock.profile, host_ms, clock.traced_steps))
    flags = trainer.parse_args([])
    # The trainer's fake data: max(128, 4 x batch) training examples and a
    # quarter as many (at least a batch) for the test.
    test_batches = max(IMAGENET_BATCH, max(128, 4 * IMAGENET_BATCH) // 4) // IMAGENET_BATCH
    per_iteration = IMAGENET_STEPS // IMAGENET_ITERATIONS
    expected = _counts(per_iteration * sum(_grow_candidates(2, IMAGENET_ITERATIONS)) + test_batches)
    if counts != expected or len(marks) != IMAGENET_STEPS or flags.batch_size != IMAGENET_BATCH:
        raise AssertionError("imagenet_autoensemble: %d steps, launches %s, expected %s"
                             % (len(marks), counts, expected))
    out = dict(steps=IMAGENET_STEPS, cli_secs=secs, **_last_iteration_ms(marks), timed=window,
               max_memory_allocated_bytes=peak,
               metrics={k: v for k, v in metrics.items()}, train_losses=train_losses,
               k1_launches=counts["combine"], test_batches=test_batches,
               families_vs_cpu=_family_vs_cpu(gen), phase_secs=time.perf_counter() - t_phase, card=card_line())
    print("imagenet_autoensemble: " + json.dumps(out))
    return counts, out, losses


@contextlib.contextmanager
def _timed_provider(trainer, clocks):
    """The ImageNet trainer's provider with its training stream through
    `_StepClock` (appended to `clocks`): steps 12-15 of iteration 1 timed,
    step 17 traced."""
    make_provider = trainer._provider

    class Timed:
        def __init__(self, flags):
            self._provider = make_provider(flags)
            self.num_classes = self._provider.num_classes

        def get_input_fn(self, partition="train"):
            input_fn = self._provider.get_input_fn(partition)
            if partition != "train":
                return input_fn
            clocks.append(_StepClock(input_fn, first=IMAGENET_TIMED[0], traced=IMAGENET_TIMED[1],
                                     window=IMAGENET_TIMED[2], traced_steps=IMAGENET_TIMED[3]))
            return clocks[-1]

    trainer._provider = Timed
    try:
        yield
    finally:
        trainer._provider = make_provider


def _modelflow_search(device, scheduler=None, weighted=False):
    """tests/test_experimental.py's ModelFlow search on `device`: three MLPs
    (4, 8 and 16 hidden; or 8 and 16 with `weighted`) through TrainerPhase
    and AutoEnsemblePhase (mean ensembles under Grow and All; with
    `weighted`, mean and weighted ensembles under All). Returns the best
    models' class names and eval losses."""
    import numpy as np
    import torch
    from torch import nn

    from adanet_tpu_torch import experimental as mf

    class MLP(nn.Module):
        def __init__(self, hidden):
            super().__init__()
            self.Dense_0, self.Dense_1 = nn.Linear(4, hidden), nn.Linear(hidden, 1)

        def forward(self, features, training=False):
            return self.Dense_1(torch.relu(self.Dense_0(features.float())))

    def mse(logits, labels):
        return torch.mean(torch.square(logits - labels.float()))

    def dataset(seed):
        rng = np.random.RandomState(seed)
        x = rng.randn(64, 4).astype(np.float32)
        y = (x.sum(axis=1, keepdims=True) + 0.1 * rng.randn(64, 1)).astype(np.float32)
        return lambda: ((x[s:s + 16], y[s:s + 16]) for s in range(0, 64, 16))

    def sgd(params):
        return torch.optim.SGD(params, lr=0.05)

    widths = (8, 16) if weighted else (4, 8, 16)
    models = [mf.Model(MLP(h), loss_fn=mse, optimizer=sgd, seed=i, device=device) for i, h in enumerate(widths)]
    ensemblers = [mf.MeanEnsembler(mse)] + ([mf.WeightedEnsembler(mse, optimizer=sgd)] if weighted else [])
    strategies = [mf.AllStrategy()] if weighted else [mf.GrowStrategy(), mf.AllStrategy()]
    search = mf.ModelSearch(mf.SequentialController([
        mf.InputPhase(dataset(0), dataset(1)),
        mf.TrainerPhase(models, epochs=5 if weighted else 3),
        mf.AutoEnsemblePhase(ensemblers=ensemblers, ensemble_strategies=strategies, num_candidates=len(widths)),
    ]), scheduler=scheduler)
    search.run()
    best = list(search.get_best_models(2))
    return [type(m).__name__ for m in best], [m.evaluate(dataset(1)())[0] for m in best]


def modelflow(model_dir):
    """ModelFlow on the card: the search of tests/test_experimental.py::
    test_parallel_scheduler_matches_sequential sequentially and under
    ParallelScheduler (MODELFLOW_WORKERS workers on the card's pool), the
    best model's eval loss equal within rtol 1e-5; a weighted-ensembler
    search on the card and the CPU within 1e-5 x max(1, |value|), the
    same best models (TF32 off)."""
    import torch

    from adanet_tpu_torch.ensemble.weighted import full_f32_matmul
    from adanet_tpu_torch.experimental import ParallelScheduler

    del model_dir
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sequential = _modelflow_search("cuda")
    sequential_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    parallel = _modelflow_search("cuda", ParallelScheduler(num_workers=MODELFLOW_WORKERS,
                                                           devices=[torch.device("cuda", 0)]))
    parallel_secs = time.perf_counter() - t0
    gap = abs(sequential[1][0] - parallel[1][0]) / abs(parallel[1][0])
    with full_f32_matmul():
        card = _modelflow_search("cuda", weighted=True)
        cpu = _modelflow_search("cpu", weighted=True)
    card_gap = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(card[1], cpu[1]))
    out = dict(sequential=sequential, parallel=parallel, best_loss_rel_gap=gap, sequential_secs=sequential_secs,
               parallel_secs=parallel_secs, weighted_card=card, weighted_cpu=cpu, weighted_card_vs_cpu=card_gap,
               phase_secs=time.perf_counter() - t_phase, card=card_line())
    if not (gap <= 1e-5 and card_gap <= 1e-5 and card[0] == cpu[0] and "WeightedEnsemble" in card[0]):
        raise AssertionError("modelflow: %s" % out)
    print("modelflow: " + json.dumps(out))
    return out


@contextlib.contextmanager
def _executor_step_times(marks, losses):
    """`RoundRobinExecutor`'s windows of one step (the Estimator's at
    `iterations_per_loop=1`) appending (iteration, host clock, CUDA
    event) to `marks` and (iteration, the subnetworks' training losses)
    to `losses` as each returns (the executor's counterpart of
    `_step_times`)."""
    import torch

    from adanet_tpu_torch.distributed import executor as executor_lib

    original = executor_lib.RoundRobinExecutor.train_steps

    def timed(self, state, batches):
        batches = list(batches)
        if len(batches) != 1:
            raise AssertionError("imagenet_round_robin: a window of %d steps" % len(batches))
        out = original(self, state, batches)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        t = self.iteration.iteration_number
        marks.append((t, time.perf_counter(), event))
        losses.append((t, {k.split("/", 1)[1]: v for k, v in out[1].items() if k.startswith("subnetwork_loss/")}))
        return out

    executor_lib.RoundRobinExecutor.train_steps = timed
    try:
        yield
    finally:
        executor_lib.RoundRobinExecutor.train_steps = original


def _loss_series(losses):
    """{"t<t>/<subnetwork>": [each step's training loss]}, read from the
    card once."""
    import torch

    series = collections.defaultdict(list)
    for t, step in losses:
        for name, value in step.items():
            series["t%d/%s" % (t, name)].append(value)
    return {key: torch.stack(values).float().tolist() for key, values in series.items()}


def imagenet_round_robin(model_dir, replication_losses):
    """The ImageNet AutoEnsemble trainer CLI at its defaults with
    `--placement=round_robin` (ResNet-50 width 64 + EfficientNet-B0,
    224 x 224, batch 64, fake data, 2 x 10 steps): K1 exact (the ensemble
    group's updates are replication's, one a candidate a step, and one a
    test batch), finite metrics, each subnetwork's training loss falling
    within its iteration, and each step's training loss within
    IMAGENET_RR_LOSS_BOUND x max(1, |loss|) of the replication run's
    (`imagenet_autoensemble`, the same batches and draws). Prints ms a
    step, a window's and a traced step's numbers, peak memory."""
    from adanet_tpu_torch.research.imagenet_autoensemble import trainer

    t_phase = time.perf_counter()
    marks, clocks, losses = [], [], []
    with _timed_provider(trainer, clocks), _executor_step_times(marks, losses):
        metrics, counts, secs, peak = _run_cli(trainer, [
            "--dataset=fake", "--boosting_iterations=%d" % IMAGENET_ITERATIONS, "--train_steps=%d" % IMAGENET_STEPS,
            "--device=cuda", "--placement=round_robin",
            "--model_dir=%s" % os.path.join(model_dir, "imagenet_rr")], [], None)
    _finite_metrics("imagenet_round_robin", metrics, IMAGENET_STEPS)
    train_losses = loss_summary(losses)
    if len(train_losses) != 4 or not all(v["least"] < v["first"] for v in train_losses.values()):
        raise AssertionError("imagenet_round_robin: training losses %s" % train_losses)
    rr, replication = _loss_series(losses), _loss_series(replication_losses)
    if sorted(rr) != sorted(replication) or any(len(rr[k]) != len(replication[k]) for k in rr):
        raise AssertionError("imagenet_round_robin: steps %s against replication's %s" % (
            {k: len(v) for k, v in rr.items()}, {k: len(v) for k, v in replication.items()}))
    deviation = max(abs(a - b) / max(1.0, abs(b)) for k in rr for a, b in zip(rr[k], replication[k]))
    if not deviation <= IMAGENET_RR_LOSS_BOUND:
        raise AssertionError("imagenet_round_robin: training losses %.3g from replication's, bound %.3g"
                             % (deviation, IMAGENET_RR_LOSS_BOUND))
    (clock,) = clocks
    (host0, event0), (host1, event1) = clock.marks
    host_ms = (host1 - host0) / clock.window * 1e3
    window = dict(window_steps=[clock._first, clock._first + clock.window - 1], window_host_ms_per_step=host_ms,
                  window_event_ms_per_step=event0.elapsed_time(event1) / clock.window,
                  **traced_step(clock.profile, host_ms, clock.traced_steps))
    test_batches = max(IMAGENET_BATCH, max(128, 4 * IMAGENET_BATCH) // 4) // IMAGENET_BATCH
    per_iteration = IMAGENET_STEPS // IMAGENET_ITERATIONS
    expected = _counts(per_iteration * sum(_grow_candidates(2, IMAGENET_ITERATIONS)) + test_batches)
    if counts != expected or len(marks) != IMAGENET_STEPS:
        raise AssertionError("imagenet_round_robin: %d steps, launches %s, expected %s"
                             % (len(marks), counts, expected))
    out = dict(steps=IMAGENET_STEPS, cli_secs=secs, **_last_iteration_ms(marks), timed=window,
               max_memory_allocated_bytes=peak, metrics=metrics, train_losses=train_losses,
               loss_deviation_from_replication=deviation, bound=IMAGENET_RR_LOSS_BOUND,
               k1_launches=counts["combine"], phase_secs=time.perf_counter() - t_phase, card=card_line())
    print("imagenet_round_robin: " + json.dumps(out))
    return counts, out, losses


def _linear_builders():
    """tests/helpers.py's DNNBuilder("a", 1) and ("b", 2), through the
    port's test helper (tests/torch_port_common.py)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_port_common import dnn_builder, linear_dataset

    return [dnn_builder("a", 1), dnn_builder("b", 2)], linear_dataset


def round_robin_divergence():
    """tests/test_distributed.py::test_round_robin_fused_divergence_bounded
    on the card: the fused step and the RoundRobin executor from one init
    over 30 epochs of the linear dataset; subnetwork losses within rtol
    1e-3 at every step, each candidate's EMA within 0.10 x |EMA| + 0.005
    of the fused one, the same selection. Returns the largest gaps."""
    import torch

    from adanet_tpu_torch.core.heads import RegressionHead
    from adanet_tpu_torch.core.iteration import IterationBuilder
    from adanet_tpu_torch.distributed import RoundRobinExecutor, RoundRobinStrategy
    from adanet_tpu_torch.ensemble import ComplexityRegularizedEnsembler, GrowStrategy

    def build():
        builders, linear_dataset = _linear_builders()
        factory = IterationBuilder(RegressionHead(), [ComplexityRegularizedEnsembler(
            optimizer=lambda p: torch.optim.SGD(p, lr=0.05))], [GrowStrategy()], device="cuda")
        return factory.build_iteration(0, builders, None, input_shape=(2,)), linear_dataset

    it_fused, linear_dataset = build()
    sample = next(linear_dataset()())
    st_fused = it_fused.init_state(torch.Generator().manual_seed(0), sample)
    it_rr, _ = build()
    executor = RoundRobinExecutor(it_rr, RoundRobinStrategy())
    st_rr = executor.init_state(torch.Generator().manual_seed(0), sample)
    sub_gap = 0.0
    for _ in range(30):
        for batch in linear_dataset()():
            st_fused, m_fused = it_fused.train_step(st_fused, batch)
            st_rr, m_rr = executor.train_step(st_rr, batch)
            for spec in it_fused.subnetwork_specs:
                key = "subnetwork_loss/%s" % spec.name
                a, b = float(m_fused[key]), float(m_rr[key])
                sub_gap = max(sub_gap, abs(a - b) / max(abs(a), 1e-30))
    ema_fused, ema_rr = it_fused.ema_losses(st_fused), it_rr.ema_losses(st_rr)
    gaps = {name: abs(value - ema_rr[name]) for name, value in ema_fused.items()}
    if not (sub_gap <= 1e-3 and all(gaps[n] < 0.10 * abs(v) + 0.005 for n, v in ema_fused.items())
            and it_fused.best_candidate_index(st_fused) == it_rr.best_candidate_index(st_rr)):
        raise AssertionError("round_robin divergence: subnetwork %.3g, EMAs %s against %s"
                             % (sub_gap, ema_rr, ema_fused))
    return dict(subnetwork_loss_rel_gap=sub_gap, ema_gaps=gaps, emas_fused=ema_fused)


def round_robin_search(model_dir, fused_probes):
    """The tier-1 gate's search (`train_search`'s configuration) under
    `RoundRobinStrategy()`: accuracy >= 0.88 and above 0.76, K1 exact
    (one a candidate a step in the ensemble group, one a test batch), the
    subnetworks' variables at each iteration's end within 1e-5 x max(1,
    |value|) of the fused search's (`train_search`'s probes) wherever the
    two searches trained the same builders from the same winner, and the
    fused-divergence bound on the card (`round_robin_divergence`). Prints
    ms a step, a window and traced steps of iteration 1."""
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.distributed import RoundRobinStrategy
    from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset

    t_phase = time.perf_counter()
    head, generator, ensembler = search_parts()
    xtr, ytr = make_dataset(TRAIN_EXAMPLES, seed=7)
    xte, yte = make_dataset(EVAL_EXAMPLES, seed=8)
    directory = os.path.join(model_dir, "round_robin_search")
    probes = {}
    estimator = _probing(Estimator, probes)(
        head, generator, max_iteration_steps=TRAIN_STEPS, max_iterations=TRAIN_ITERATIONS, ensemblers=[ensembler],
        model_dir=directory, log_every_steps=0, device="cuda", placement_strategy=RoundRobinStrategy())
    metrics, counts, stats = _timed_search(estimator, input_fn(xtr, ytr, TRAIN_BATCH), input_fn(xte, yte, TRAIN_BATCH),
                                           TRAIN_STEPS, TRAIN_ITERATIONS)
    candidates = _grow_candidates(2, TRAIN_ITERATIONS)
    _check_k1("round_robin_search", counts, TRAIN_STEPS, candidates, -(-EVAL_EXAMPLES // TRAIN_BATCH), directory)
    if not (metrics["accuracy"] >= GATE_ACCURACY and metrics["accuracy"] > LINEAR_BASELINE_ACCURACY):
        raise AssertionError("round_robin_search: accuracy %s below the gate %s" % (metrics, GATE_ACCURACY))
    compared, worst = [], 0.0
    for t in range(TRAIN_ITERATIONS):
        keys = sorted(k for k in probes if k.startswith("t%d/" % t))
        if t and probes["winner/%d" % (t - 1)] != fused_probes["winner/%d" % (t - 1)]:
            break
        if keys != sorted(k for k in fused_probes if k.startswith("t%d/" % t)):
            raise AssertionError("round_robin_search: subnetworks %s against the fused search's" % keys)
        for key in keys:
            want = fused_probes[key]
            worst = max(worst, float(((probes[key] - want).abs() / want.abs().clamp(min=1.0)).max()))
        compared.append(t)
    if not compared or not worst <= 1e-5:
        raise AssertionError("round_robin_search: subnetworks %.3g from the fused search's (iterations %s)"
                             % (worst, compared))
    out = dict(accuracy=metrics["accuracy"], loss=metrics["loss"], best_ensemble=metrics["best_ensemble"],
               winners=[probes["winner/%d" % t] for t in range(TRAIN_ITERATIONS)],
               fused_winners=[fused_probes["winner/%d" % t] for t in range(TRAIN_ITERATIONS)],
               subnetworks_vs_fused=worst, iterations_compared=compared, candidates=candidates,
               k1_launches=counts["combine"], **stats, divergence=round_robin_divergence(),
               phase_secs=time.perf_counter() - t_phase, card=card_line())
    print("round_robin_search: " + json.dumps(out))
    return counts, out


def round_robin_gate(model_dir):
    """tests/test_imagenet_pipeline.py::test_imagenet_autoensemble_convergence_gate
    on the card (its configuration under RoundRobin: image 32, ResNet-18
    width 8 + EfficientNet-B0, 60 steps of batch 32, resnet_lr 0.05, 256
    synthetic images from seed 11): accuracy >= 0.5, K1 exact."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.research.imagenet_autoensemble import trainer
    from adanet_tpu_torch.research.imagenet_autoensemble.imagenet_data import SyntheticProvider

    t_phase = time.perf_counter()
    flags = trainer.parse_args([
        "--dataset=fake", "--image_size=32", "--placement=round_robin", "--resnet_depth=18", "--resnet_width=8",
        "--efficientnet_variant=b0", "--candidates=resnet50,efficientnet_b0", "--boosting_iterations=1",
        "--train_steps=%d" % RR_GATE_STEPS, "--batch_size=%d" % RR_GATE_BATCH, "--resnet_lr=0.05", "--device=cuda"])
    provider = SyntheticProvider(num_classes=IMAGENET_CLASSES, num_examples=RR_GATE_EXAMPLES,
                                 batch_size=RR_GATE_BATCH, image_size=32, seed=11)
    estimator = trainer.build_estimator(flags, provider, os.path.join(model_dir, "round_robin_gate"))
    ops.reset_launch_counts()
    estimator.train(provider.get_input_fn("train"), max_steps=RR_GATE_STEPS)
    metrics = estimator.evaluate(provider.get_input_fn("test"))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    test_batches = sum(1 for _ in provider.get_input_fn("test")())
    expected = _counts(RR_GATE_STEPS * 2 + test_batches)
    if counts != expected or metrics["global_step"] != RR_GATE_STEPS:
        raise AssertionError("round_robin_gate: launches %s, expected %s; %s" % (counts, expected, metrics))
    if not (math.isfinite(metrics["average_loss"]) and metrics["accuracy"] >= RR_GATE_ACCURACY):
        raise AssertionError("round_robin_gate: %s below %s" % (metrics, RR_GATE_ACCURACY))
    out = dict(accuracy=metrics["accuracy"], average_loss=metrics["average_loss"],
               best_ensemble=metrics["best_ensemble"], k1_launches=counts["combine"],
               phase_secs=time.perf_counter() - t_phase, card=card_line())
    print("round_robin_gate: " + json.dumps(out))
    return counts, out


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _finish(procs, what, want_rcs=None):
    """Each (name, process)'s output; a process that does not end with its
    return code in `want_rcs` (0 by default), or is still running at its
    timeout, fails the phase, and every process is stopped."""
    want_rcs = want_rcs or {}
    outs = {}
    try:
        for name, proc in procs:
            out, _ = proc.communicate(timeout=PROCESS_TIMEOUT)
            outs[name] = out.decode()
            if proc.returncode != want_rcs.get(name, 0):
                raise AssertionError("%s: %s exited %d:\n%s" % (what, name, proc.returncode, outs[name][-3000:]))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def nccl_all_reduce():
    """One NCCL all-reduce in a process group of world size 1 on the card
    (NCCL refuses two ranks on one card; across cards it waits for a
    machine with two). Returns the group's backend."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method="tcp://localhost:%d" % _free_port(), world_size=1, rank=0)
    try:
        t = torch.arange(4, dtype=torch.float32, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        if t.tolist() != [0.0, 1.0, 2.0, 3.0]:
            raise AssertionError("nccl all_reduce gave %s" % t.tolist())
        return dist.get_backend()
    finally:
        dist.destroy_process_group()


def start_processes(model_dir):
    """Starts `process_phases`' five processes together: the two ranks of
    tests/torch_spmd_runner.py's search on the card (gloo), and
    tests/torch_distributed_runner.py's chief, worker and lone worker.
    Returns (their (name, process) pairs, the start time)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    spmd_runner = os.path.join(tests, "torch_spmd_runner.py")
    role_runner = os.path.join(tests, "torch_distributed_runner.py")
    os.makedirs(os.path.join(model_dir, "spmd"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = str(_free_port())

    def spawn(args):
        return subprocess.Popen([sys.executable] + args, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    t0 = time.perf_counter()
    procs = [("rank %d" % rank, spawn([spmd_runner, "spmd", os.path.join(model_dir, "spmd"), str(rank), port, "2",
                                       "cuda", "gloo"])) for rank in range(2)]
    shared_dir = os.path.join(model_dir, "chief_worker")
    procs += [("chief", spawn([role_runner, shared_dir, "0", "train", "cuda"])),
              ("worker", spawn([role_runner, shared_dir, "1", "train", "cuda"])),
              ("lone worker", spawn([role_runner, os.path.join(model_dir, "abandoned"), "1", "timeout", "cuda"]))]
    return procs, t0


def process_phases(model_dir, started):
    """`spmd_two_process` and `chief_worker`, on the processes that
    `start_processes` started: tests/torch_spmd_runner.py's search in two
    processes on the card (gloo, each feeding half of every batch, a
    collective Evaluator and ReportMaterializer), whose final winners
    must be bitwise equal and within rtol 2e-4, atol 1e-5 of a
    one-process oracle on the card on the whole batches, with each
    process's K1 launches exact (one a candidate a step and a candidate
    an Evaluator batch); the NCCL all-reduce of world size 1;
    tests/torch_distributed_runner.py's chief and worker on the card
    sharing a model dir (both end at iteration 2), and a lone worker's
    `WorkerWaitTimeout` inside `train()`. Returns (each rank's launch
    counts, the two lines' numbers)."""
    import numpy as np
    import torch

    from adanet_tpu_torch import ops

    procs, t_phase = started
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    spmd_dir, shared_dir = os.path.join(model_dir, "spmd"), os.path.join(model_dir, "chief_worker")
    try:
        backend = nccl_all_reduce()
        sys.path.insert(0, tests)
        from torch_spmd_runner import oracle_probes

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        oracle = oracle_probes(os.path.join(model_dir, "spmd_oracle"), "cuda")
        torch.cuda.synchronize()
        oracle_secs = time.perf_counter() - t0
        oracle_counts = ops.launch_counts()
    finally:
        outs = _finish(procs, "process_phases")
    processes_secs = time.perf_counter() - t_phase
    # 2 x 6 steps over 2 and 3 candidates, and the Evaluator's 4 batches
    # over them at each iteration's end.
    expected = _counts(6 * 2 + 6 * 3 + 4 * (2 + 3))
    launches = []
    for rank in range(2):
        line = [l for l in outs["rank %d" % rank].splitlines() if l.startswith("SPMD ROLE %d DONE" % rank)]
        if not line:
            raise AssertionError("spmd rank %d:\n%s" % (rank, outs["rank %d" % rank][-3000:]))
        launches.append(json.loads(line[-1].split(" launches ", 1)[1]))
    # A fresh process may launch K0 once, the self-test of its first
    # kernel load.
    if [dict(c, copy=0) for c in launches] != [expected, expected] or oracle_counts != expected:
        raise AssertionError("spmd_two_process: launches %s, oracle %s, expected %s"
                             % (launches, oracle_counts, expected))
    probes = [np.load(os.path.join(spmd_dir, "probe_%d.npz" % rank)) for rank in range(2)]
    if sorted(probes[0].files) != sorted(oracle) or sorted(probes[1].files) != sorted(oracle):
        raise AssertionError("spmd_two_process: probes %s against the oracle's %s" % (probes[0].files, sorted(oracle)))
    worst = 0.0
    for key, value in oracle.items():
        if not np.array_equal(probes[0][key], probes[1][key]):
            raise AssertionError("spmd_two_process: the ranks differ at %s" % key)
        np.testing.assert_allclose(probes[0][key], value, rtol=2e-4, atol=1e-5, err_msg=key)
        worst = max(worst, float(np.max(np.abs(probes[0][key] - value))))
    spmd = dict(ranks_bitwise_equal=True, max_abs_vs_oracle=worst, leaves=len(oracle), k1_launches=launches,
                oracle_k1_launches=oracle_counts["combine"], oracle_secs=oracle_secs, nccl_world_1_backend=backend,
                card=card_line())
    print("spmd_two_process: " + json.dumps(spmd))
    for name, marker in (("chief", "ROLE 0 DONE"), ("worker", "ROLE 1 DONE"),
                         ("lone worker", "ROLE 1 TIMED OUT CLEANLY")):
        if marker not in outs[name]:
            raise AssertionError("chief_worker: %s:\n%s" % (name, outs[name][-3000:]))
    with open(os.path.join(shared_dir, "checkpoint.json")) as f:
        manifest = f.read()
    chief_worker = dict(roles_done=["chief", "worker"], lone_worker="WorkerWaitTimeout",
                        manifest_iteration=json.loads(manifest).get("iteration_number"),
                        secs=processes_secs, card=card_line())
    if chief_worker["manifest_iteration"] != 2:
        raise AssertionError("chief_worker: manifest %s" % manifest[:500])
    print("chief_worker: " + json.dumps(chief_worker))
    return launches, dict(spmd=spmd, chief_worker=chief_worker, phase_secs=time.perf_counter() - t_phase)


def check_placement_combines(gen):
    """K1 at the shapes the placement paths add (`check_search_combine`):
    the RoundRobin gate's [1|2, 32, 8] and the data-parallel search's
    [1|2, 8, 1] (a rank's slice) and [1|2, 16, 1] (the oracle); the
    ImageNet trainer's [1|2, 64, 8] and the search's [1|2, 128, 10] are
    held by `check_slice_combines` and `check_combine`. Returns the worst
    forward or gradient error."""
    worst = 0.0
    for batch, classes in ((RR_GATE_BATCH, IMAGENET_CLASSES), (8, 1), (16, 1)):
        for n in SEARCH_COMBINE_MEMBERS:
            worst = max(worst, *check_search_combine(n, False, gen, batch=batch, classes=classes))
    return worst


# ------------------------------------------------------ elastic and multi-host


def _tests_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")


def _spawn_runner(script, args, **env):
    """A tests/ runner in its own process (stdout and stderr together)."""
    environ = dict(os.environ)
    environ.pop("ADANET_FAULTS", None)
    root = os.path.dirname(os.path.abspath(__file__))
    environ.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([root, _tests_dir(), environ.get("PYTHONPATH", "")]),
                   **env)
    return subprocess.Popen([sys.executable, os.path.join(_tests_dir(), script)] + [str(a) for a in args],
                            env=environ, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


class _Chain:
    """Runs groups of processes one after another on a thread: each step
    is (label, start() -> [(name, process)], {name: return code})."""

    def __init__(self, steps):
        import threading

        self.outs, self.secs, self.error, self._steps = {}, {}, None, steps
        self._procs, self._stopped = [], False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for label, start, rcs in self._steps:
                if self._stopped:
                    return
                t0 = time.perf_counter()
                self._procs = start()
                self.outs[label] = _finish(self._procs, label, rcs)
                self.secs[label] = time.perf_counter() - t0
        except BaseException as exc:  # re-raised by join()
            self.error = exc

    def stop(self):
        """Kills the running processes and starts no more."""
        self._stopped = True
        for _, proc in self._procs:
            if proc.poll() is None:
                proc.kill()
        self._thread.join(timeout=60)

    def join(self):
        self._thread.join(timeout=4 * PROCESS_TIMEOUT)
        if self._thread.is_alive():
            raise AssertionError("elastic_multihost_phases: a process chain did not end")
        if self.error is not None:
            raise self.error
        return self.outs


def start_elastic_multihost(model_dir):
    """Starts the group's processes, four chains on threads: the
    multi-host ImageNet search (two ranks); the elastic search in two
    processes; the same with the worker SIGKILLed at its second unit; a
    checkpoint torn on the card, then the two-process resume whose peer
    is SIGKILLed at its third broadcast."""
    def world(script, args_of, n, env_of=lambda rank: {}):
        port = _free_port()
        return lambda: [("rank %d" % r, _spawn_runner(script, args_of(r, port), **env_of(r))) for r in range(n)]

    mh_dir, wq_dir, kill_dir, chaos_dir = (os.path.join(model_dir, d) for d in (
        "multihost", "elastic_two", "elastic_sigkill", "chaos"))
    for d in (mh_dir, wq_dir, kill_dir):
        os.makedirs(d)
    # GC of the member syncs' keys: a lag of 3 broadcasts exceeds a sync
    # round's 2, and keeps two ResNet-50 payloads (2 x ~100 MB) within the
    # default 256 MiB budget.
    imagenet_env = dict(MHRR_STEPS=str(MHRR_STEPS), MHRR_ITERATIONS=str(MHRR_ITERATIONS), ADANET_KV_GC_MIN_LAG="3")
    multihost = _Chain([("multihost_round_robin", world(
        "torch_multihost_rr_runner.py", lambda r, p: ["imagenet", mh_dir, r, 2, p, "cuda", "gloo"], 2,
        lambda r: imagenet_env), {})])
    digits = dict(TEST_SEARCH="digits", ADANET_TEST_EXIT_BARRIER="1")
    killed = dict(TEST_SEARCH="digits", TEST_LEASE_TTL=str(ELASTIC_LEASE_TTL))
    elastic = _Chain([
        ("elastic_two_process", world("torch_elastic_wq_runner.py",
                                      lambda r, p: [wq_dir, "two", r, p, 2, -1, "cuda", "gloo"], 2,
                                      lambda r: digits), {}),
    ])
    sigkill = _Chain([
        ("elastic_sigkill", world("torch_elastic_wq_runner.py",
                                  lambda r, p: [kill_dir, "sigkill", r, p, 2, -1, "cuda", "gloo"], 2,
                                  lambda r: dict(killed, **({"ADANET_FAULTS": "workunit.execute:kill:after=1"}
                                                           if r else {}))), {"rank 1": -signal.SIGKILL}),
    ])
    timeouts = dict(ADANET_COLLECTIVE_TIMEOUT_SECS=str(CHAOS_DEADLINE), ADANET_HEARTBEAT_INTERVAL_SECS="1")
    chaos = _Chain([
        ("torn", lambda: [("writer", _spawn_runner("torch_chaos_ckpt_runner.py", [chaos_dir, "cuda"],
                                                   ADANET_FAULTS="checkpoint.write:torn:after=2"))],
         {"writer": -signal.SIGKILL}),
        ("multihost_peer_death", world(
            "torch_chaos_multihost_runner.py", lambda r, p: [chaos_dir, r, 2, p, "cuda", "gloo"], 2,
            lambda r: dict(timeouts, **({"ADANET_FAULTS": "collective.entry:kill:after=2"} if r else {}))),
         {"rank 1": -signal.SIGKILL}),
    ])
    return dict(multihost=multihost, elastic=elastic, sigkill=sigkill, chaos=chaos, t0=time.perf_counter(),
                dirs=dict(multihost=mh_dir, two=wq_dir, sigkill=kill_dir, chaos=chaos_dir))


def elastic_search(model_dir, lockstep):
    """Phase 11's search (4096/1024 digits, simple_dnn 128 wide, fused
    Adam, K1 on, 2 x 400) under `ElasticWorkQueueStrategy(window_steps=8,
    speculate_steps=8)` in one process (tests/torch_elastic_wq_runner.py's
    `digits_search`): accuracy >= 0.88 and above 0.76, K1 exact (one a
    candidate a step, every ensemble window run by this process, and one
    a test batch), the speculation's K1 launches 0 and its windows
    grafted in. Prints ms a step beside `lockstep`'s (phase 11's numbers,
    this run), each drain's dispatched and reused steps. Returns (counts,
    the line's numbers, the frozen payloads' digest)."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.distributed.scheduler import ElasticWorkQueueExecutor

    sys.path.insert(0, _tests_dir())
    from torch_elastic_wq_runner import digits_search, frozen_digest, selection_sequence

    t_phase = time.perf_counter()
    directory = os.path.join(model_dir, "elastic_search")
    drains, speculation = [], []
    run_iteration, speculate = ElasticWorkQueueExecutor.run_iteration, Estimator._speculate_next_iteration

    def counted(self, *args, **kwargs):
        result = run_iteration(self, *args, **kwargs)
        drains.append(dict(namespace=kwargs.get("queue_namespace"), dispatched=result.dispatched_steps,
                           reused=result.reused_steps, steps=result.steps_trained))
        return result

    def counted_speculation(self, *args, **kwargs):
        before = ops.launch_counts()["combine"]
        t0 = time.perf_counter()
        out = speculate(self, *args, **kwargs)
        torch.cuda.synchronize()
        speculation.append(dict(launches=ops.launch_counts()["combine"] - before, secs=time.perf_counter() - t0))
        return out

    ElasticWorkQueueExecutor.run_iteration, Estimator._speculate_next_iteration = counted, counted_speculation
    try:
        estimator, train_fn, test_fn = digits_search(directory, "cuda")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        estimator.train(train_fn, max_steps=10**6)
        torch.cuda.synchronize()
        train_secs = time.perf_counter() - t0
        metrics = estimator.evaluate(test_fn)
        counts = ops.launch_counts()
    finally:
        ElasticWorkQueueExecutor.run_iteration, Estimator._speculate_next_iteration = run_iteration, speculate
    steps = TRAIN_STEPS * TRAIN_ITERATIONS
    candidates = _grow_candidates(2, TRAIN_ITERATIONS)
    _check_k1("elastic_search", counts, TRAIN_STEPS, candidates, -(-EVAL_EXAMPLES // TRAIN_BATCH), directory)
    if estimator.latest_global_step() != steps:
        raise AssertionError("elastic_search: %d steps" % estimator.latest_global_step())
    if not (metrics["accuracy"] >= GATE_ACCURACY and metrics["accuracy"] > LINEAR_BASELINE_ACCURACY):
        raise AssertionError("elastic_search: accuracy %s below the gate %s" % (metrics, GATE_ACCURACY))
    reused = sum(d["reused"] for d in drains)
    if [s["launches"] for s in speculation] != [0] or reused != 2 * ELASTIC_WINDOW:
        raise AssertionError("elastic_search: speculation %s, %d steps reused" % (speculation, reused))
    out = dict(accuracy=metrics["accuracy"], loss=metrics["loss"], best_ensemble=metrics["best_ensemble"],
               selection=selection_sequence(directory), k1_launches=counts["combine"],
               speculation_k1_launches=speculation[0]["launches"], speculation_secs=speculation[0]["secs"],
               drains=drains, dispatched_steps=sum(d["dispatched"] for d in drains if "spec" not in d["namespace"]),
               reused_steps=reused, search_secs=train_secs, ms_per_step=train_secs / steps * 1e3,
               lockstep_ms_per_step=lockstep["search_ms_per_step"], phase_secs=time.perf_counter() - t_phase,
               card=card_line())
    print("elastic_search: " + json.dumps(out))
    return counts, out, frozen_digest(directory)


def _done_record(out, marker):
    """The JSON after `marker` on a runner's output line."""
    line = [entry for entry in out.splitlines() if entry.startswith(marker)]
    if not line:
        raise AssertionError("no %r line:\n%s" % (marker, out[-3000:]))
    return json.loads(line[-1][len(marker):].strip())


def multihost_round_robin(started, rr_losses):
    """The ImageNet AutoEnsemble's `build_estimator` at the trainer's
    defaults (ResNet-50 w64 + EfficientNet-B0, 224 x 224, batch 64, fake
    data, `--placement=round_robin`) in two processes on the card (gloo,
    owners [[0], [1], [0]]: process 1 trains the first candidate,
    EfficientNet-B0, the chief ResNet-50 and the ensembles; members sync
    through the store every step), both feeding the same batches, 2 x 5 steps: each
    subnetwork's training losses at iteration 0's steps within
    IMAGENET_RR_LOSS_BOUND x max(1, |loss|) of the in-process
    `imagenet_round_robin`'s at the same steps, K1 exact on the chief (one
    a candidate a step; process 1, which owns no ensemble, none), finite
    metrics. Prints ms a step (host clock and CUDA events, iteration 1
    after its first step), ms and bytes a member sync, peak memory a
    process."""
    outs = started["multihost"].join()["multihost_round_robin"]
    directory = started["dirs"]["multihost"]
    ranks = []
    for rank in range(2):
        if "MHRR ROLE %d DONE" % rank not in outs["rank %d" % rank]:
            raise AssertionError("multihost_round_robin: rank %d:\n%s" % (rank, outs["rank %d" % rank][-3000:]))
        with open(os.path.join(directory, "imagenet_%d.json" % rank)) as f:
            ranks.append(json.load(f))
    chief, worker = ranks
    per_iteration = MHRR_STEPS // MHRR_ITERATIONS
    expected = _counts(per_iteration * sum(_grow_candidates(2, MHRR_ITERATIONS)))
    # A fresh process may launch K0 once, the self-test of its first
    # kernel load.
    if dict(chief["launches"], copy=0) != expected or dict(worker["launches"], copy=0) != _counts(0):
        raise AssertionError("multihost_round_robin: launches %s / %s, expected %s / none"
                             % (chief["launches"], worker["launches"], expected))
    _finite_metrics("multihost_round_robin", chief["metrics"], MHRR_STEPS)
    in_process = _loss_series(rr_losses)
    series = collections.defaultdict(list)
    for t, step in chief["losses"]:
        for name, value in step.items():
            series["t%d/%s" % (t, name)].append(value)
    compared = {key: values for key, values in series.items() if key.startswith("t0/")}
    if sorted(compared) != sorted(k for k in in_process if k.startswith("t0/")) or any(
            len(v) != per_iteration for v in compared.values()):
        raise AssertionError("multihost_round_robin: losses %s against %s" % (dict(series), in_process))
    deviation = max(abs(a - b) / max(1.0, abs(b)) for key, values in compared.items()
                    for a, b in zip(values, in_process[key]))
    if not deviation <= IMAGENET_RR_LOSS_BOUND or not all(math.isfinite(v) for vs in series.values() for v in vs):
        raise AssertionError("multihost_round_robin: losses %.3g from the in-process run's, bound %.3g"
                             % (deviation, IMAGENET_RR_LOSS_BOUND))
    out = dict(owners=[[0], [1], [0]], steps=MHRR_STEPS, loss_deviation_from_in_process=deviation,
               bound=IMAGENET_RR_LOSS_BOUND, k1_launches=[chief["launches"]["combine"], worker["launches"]["combine"]],
               eval_k1_launches=chief["eval_launches"]["combine"], metrics=chief["metrics"])
    for name, record in (("chief", chief), ("worker", worker)):
        syncs = record["syncs"]
        out[name] = dict(host_ms_per_step=record["host_ms_per_step"], event_ms_per_step=record["event_ms_per_step"],
                         train_secs=record["train_secs"], syncs=syncs["syncs"],
                         sync_ms=syncs["secs"] / max(1, syncs["syncs"]) * 1e3,
                         sync_bytes=syncs["bytes"] / max(1, syncs["syncs"]),
                         max_memory_allocated_bytes=record["max_memory_allocated_bytes"],
                         store_bytes_retained_peak=record["store_bytes_retained_peak"])
    out["secs"] = started["multihost"].secs["multihost_round_robin"]
    out["card"] = card_line()
    print("multihost_round_robin: " + json.dumps(out))
    return out


def elastic_two_process(started, digest, selection):
    """`elastic_search`'s search in two processes on the card over the
    process group's store (`CoordinationKV`, gloo): the selection and
    every frozen parameter bitwise `elastic_search`'s (`digest`), the
    worker having run units; then again with the worker SIGKILLed at its
    second unit (`workunit.execute` armed to kill, lease TTL 2 s): the
    chief finishes alone, bitwise the same. K1 on the chief one a
    candidate a step, none on the worker (ensemble windows are the
    chief's). Returns (each rank's K1 launches, the line's numbers)."""
    outs = dict(started["elastic"].join(), **started["sigkill"].join())
    secs = dict(started["elastic"].secs, **started["sigkill"].secs)
    expected = _counts(TRAIN_STEPS * sum(_grow_candidates(2, TRAIN_ITERATIONS)))
    runs = {}
    for label, tag, killed in (("elastic_two_process", "two", False), ("elastic_sigkill", "sigkill", True)):
        directory = started["dirs"][tag]
        with open(os.path.join(directory, "%s.json" % tag)) as f:
            record = json.load(f)
        chief = _done_record(outs[label]["rank 0"], "ELASTIC WQ ROLE 0 DONE")
        worker = None if killed else _done_record(outs[label]["rank 1"], "ELASTIC WQ ROLE 1 DONE")
        if (record["final_step"], record["final_iteration"]) != (TRAIN_STEPS * TRAIN_ITERATIONS, TRAIN_ITERATIONS):
            raise AssertionError("%s: %s" % (label, record))
        if record["frozen_digest"] != digest or record["selection"] != selection:
            raise AssertionError("%s: frozen digest %s, selection %s against elastic_search's %s, %s"
                                 % (label, record["frozen_digest"], record["selection"], digest, selection))
        if dict(chief["launches"], copy=0) != expected or (
                worker is not None and dict(worker["launches"], copy=0) != _counts(0)):
            raise AssertionError("%s: launches %s / %s, expected %s / none" % (
                label, chief["launches"], worker and worker["launches"], expected))
        worker_steps = None if worker is None else sum(d[0] for d in worker["drains"])
        if worker_steps == 0:
            raise AssertionError("%s: the worker ran no unit" % label)
        runs[label] = dict(accuracy=record["accuracy"], frozen_bitwise_elastic_search=True,
                           chief_dispatched_steps=sum(d[0] for d in chief["drains"]),
                           worker_dispatched_steps=worker_steps,
                           k1_launches=[chief["launches"]["combine"]] + ([] if worker is None
                                                                          else [worker["launches"]["combine"]]),
                           secs=secs[label])
    out = dict(runs, card=card_line())
    print("elastic_two_process: " + json.dumps(out))
    return runs["elastic_two_process"]["k1_launches"], out


def multihost_peer_death(started):
    """tests/torch_chaos_multihost_runner.py on the card: a model dir torn
    mid-checkpoint on the card (`checkpoint.write:torn`), then two
    processes resume it under multi-host RoundRobin and process 1 (owner
    of "a") is SIGKILLed at its third broadcast (a member sync). The chief
    must declare it lost within the deadline (CHAOS_DEADLINE s), finish
    the iteration with "b", persist it, and exit 0; the torn file
    quarantined, "a" dead in the metrics file."""
    outs = started["chaos"].join()
    directory = started["dirs"]["chaos"]
    record = _done_record(outs["multihost_peer_death"]["rank 0"], "CHAOS CHIEF DONE")
    with open(os.path.join(directory, "architecture-0.json")) as f:
        members = [e["builder_name"] for e in json.load(f)["subnetworks"]]
    metrics = _read_json(directory, "candidate-metrics-0.json")
    dead = sorted(name for name, entry in metrics.items() if entry["dead"])
    if not (record["peer_lost"] and record["iteration_number"] == 1 and members == ["2_layer_dnn"]
            and dead == ["t0_1_layer_dnn_grow_complexity_regularized"]
            and os.path.exists(os.path.join(directory, "ckpt-6.pt.corrupt"))
            and not os.path.exists(os.path.join(directory, "ckpt-6.pt"))):
        raise AssertionError("multihost_peer_death: %s, members %s, dead %s, files %s"
                             % (record, members, dead, sorted(os.listdir(directory))))
    out = dict(record, members=members, dead=dead, deadline_secs=CHAOS_DEADLINE,
               torn_secs=started["chaos"].secs["torn"], secs=started["chaos"].secs["multihost_peer_death"],
               card=card_line())
    print("multihost_peer_death: " + json.dumps(out))
    return out


def elastic_multihost_phases(model_dir, lockstep, rr_losses):
    """Phases 38-41: `elastic_search` alone in this process (so that its
    ms a step compares with phase 11's), then the processes of phases
    39-41, started together (`start_elastic_multihost`), and their
    checks. Returns (elastic_search's K1 launches and its speculation's,
    the chief's and worker's K1 launches of the multi-host and
    two-process runs)."""
    elastic_counts, elastic_out, digest = elastic_search(model_dir, lockstep)
    started = start_elastic_multihost(model_dir)
    try:
        multihost = multihost_round_robin(started, rr_losses)
        two_launches, _ = elastic_two_process(started, digest, elastic_out["selection"])
        multihost_peer_death(started)
    finally:
        for chain in ("multihost", "elastic", "sigkill", "chaos"):
            started[chain].stop()
    return dict(elastic=elastic_counts["combine"], speculation=elastic_out["speculation_k1_launches"],
                multihost=multihost["k1_launches"], two_process=two_launches)


# ------------------------------------------ long context and export of any ensemble

# ring_attention: q, k, v [batch, seq, heads, head size] at the head shape
# of TransformerConfig's defaults (4 heads of 32 at dim 128), sequence
# 2048, 8 shards in one process; timed calls a case.
RING_SHAPE, RING_SHARDS, RING_TIMED = (8, 2048, 4, 32), 8, 3
# long_context_search: the tutorial at its defaults (seq 512, batch 16,
# 2 x 30 steps, 8 shards, 4 test batches); the CPU runs its first
# LONG_CONTEXT_CPU_STEPS steps from the same seeds, each step's losses
# within LONG_CONTEXT_LOSS_BOUND x max(1, |loss|) of the card's (f32 on
# both, TF32 off; sums in other orders, compounded by Adam: 6.7e-6 at
# most on an H100), and the same steps at bf16 compute on the CPU, the
# control, must fall outside it (7.5e-3 from the CPU's f32 run).
LONG_CONTEXT_CPU_STEPS, LONG_CONTEXT_LOSS_BOUND = 4, 1e-4
# transformer_full_width: TransformerConfig()'s defaults (vocab 32,000, 2
# layers, 4 heads, dim 128, MLP 512, sequence 2048, bf16), ring over 8
# shards, batch 8, one iteration of 10 steps (steps 4-7 timed, 8-9
# traced), one test batch.
FULL_WIDTH_BATCH, FULL_WIDTH_STEPS = 8, 10
# export_programs: the request sizes each program serves in a fresh
# process: 1, 7 and every bucket; the card-exported program on the CPU
# within EXPORT_CPU_BOUND x max(1, max|card|) on every float output.
EXPORT_ROWS, EXPORT_CPU_BOUND = (1, 7) + BUCKETS, 1e-4
# serve_while_search: phase 11's search (digits, simple_dnn 128 wide,
# fused combine) at 3 x SWS_STEPS steps with export_serving=True and the
# default cascade, the frontend serving from its model_dir meanwhile.
SWS_STEPS, SWS_ITERATIONS = 60, 3


def _allclose_error(got, want, atol, rtol):
    """max |got - want| - rtol |want|, and whether it stays within atol
    (numpy's assert_allclose rule)."""
    import torch

    diff = (got.float() - want.float()).abs()
    excess = float((diff - rtol * want.float().abs()).max())
    return float(diff.max()), excess <= atol


def _peak_mb(fn):
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**20


def ring_attention_phase(gen):
    """Ring attention over 8 shards in one process against full
    attention on the card, at RING_SHAPE, f32 and bf16, causal and not,
    outputs and gradients of sum(out^2): f32 within the JAX tests' rtol =
    atol 2e-4 (outputs) and 1e-3 (gradients); bf16 (f32 scores and sums
    inside, rounded once) within twice the distance of full attention's
    bf16 result from its f32 result at the same inputs. Times (CUDA
    events) and peak memory of a forward and backward of each."""
    import torch

    from adanet_tpu_torch.parallel import SequenceMesh, full_attention, ring_attention

    mesh = SequenceMesh(RING_SHARDS)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            q, k, v = (torch.randn(RING_SHAPE, generator=gen).cuda().to(dtype).requires_grad_(True)
                       for _ in range(3))

            def run(fn, inputs=(q, k, v)):
                out = fn(*inputs, causal)
                return (out,) + torch.autograd.grad((out.float() ** 2).sum(), inputs)

            ring_fn = lambda a, b, c, causal: ring_attention(a, b, c, mesh, causal=causal)  # noqa: E731
            ring, ring_mb = _peak_mb(lambda: run(ring_fn))
            full, full_mb = _peak_mb(lambda: run(full_attention))
            names = ("out", "dq", "dk", "dv")
            errors, ok = {}, True
            if dtype == torch.float32:
                for name, a, b in zip(names, ring, full):
                    tol = 2e-4 if name == "out" else 1e-3
                    errors[name], within = _allclose_error(a, b, tol, tol)
                    ok &= within
                bound = "rtol = atol 2e-4 (out), 1e-3 (gradients)"
            else:
                f32 = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
                ref = run(full_attention, f32)
                bound = {}
                for name, a, b, r in zip(names, ring, full, ref):
                    limit = 2 * float((b.float() - r.float()).abs().max())
                    errors[name] = float((a.float() - r.float()).abs().max())
                    bound[name] = limit
                    ok &= errors[name] <= limit
            times = {}
            for label, fn in (("ring", ring_fn), ("full", full_attention)):
                run(fn)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(RING_TIMED):
                    run(fn)
                end.record()
                torch.cuda.synchronize()
                times[label] = start.elapsed_time(end) / RING_TIMED
            row = dict(dtype=str(dtype).replace("torch.", ""), causal=causal, shape=list(RING_SHAPE),
                       shards=RING_SHARDS, max_abs_diff=errors, bound=bound, ring_ms=times["ring"],
                       full_ms=times["full"], ring_peak_mb=ring_mb, full_peak_mb=full_mb, card=card_line())
            print("ring_attention: " + json.dumps(row))
            if not ok:
                raise AssertionError("ring_attention: %s" % row)
            rows.append(row)
            del q, k, v, ring, full
    return rows


def start_ring_two_process(model_dir):
    """Starts the two processes of `ring_two_process` (gloo group on a
    free port, each a shard of RING_SHAPE on the card)."""
    out_dir = os.path.join(model_dir, "ring_two_process")
    os.makedirs(out_dir, exist_ok=True)
    port = _free_port()
    shape = ",".join(str(d) for d in RING_SHAPE)
    procs = [("rank%d" % r, _spawn_runner("torch_ring_runner.py", [out_dir, r, 2, port, "cuda", "float32", "causal",
                                                                    shape])) for r in (0, 1)]
    return out_dir, procs, time.perf_counter()


def ring_two_process(started):
    """Form (b): two processes on the card, one shard each, the
    key/value blocks staged through host memory (gloo), against form (a)
    with 2 shards in this process on the same inputs: forward and
    gradients within 1e-6. Prints ms a forward and backward and the
    bytes staged through the host a step."""
    import numpy as np
    import torch

    sys.path.insert(0, _tests_dir())
    import torch_ring_runner

    from adanet_tpu_torch.parallel import SequenceMesh, ring_attention

    out_dir, procs, t0 = started
    _finish(procs, "ring_two_process")
    secs = time.perf_counter() - t0
    got = np.load(os.path.join(out_dir, "ring.npz"))
    stats = json.load(open(os.path.join(out_dir, "ring.json")))
    q, k, v = torch_ring_runner.inputs(RING_SHAPE, torch.float32, "cuda")
    out = ring_attention(q, k, v, SequenceMesh(2), causal=True)
    grads = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
    errors = {"out": float(np.abs(got["out"] - out.detach().cpu().numpy()).max())}
    for name, grad in zip("qkv", grads):
        errors["d" + name] = float(np.abs(got["d" + name] - grad.cpu().numpy()).max())
    row = dict(shape=list(RING_SHAPE), processes=2, causal=True, max_abs_diff_vs_one_process=errors, bound=1e-6,
               ms_per_step=stats["ms"], first_step_ms=stats["ms_first"], hops_per_step=stats["hops"],
               host_staged_bytes_per_step=stats["staged_bytes"], hop_secs_per_step=stats["hop_secs"],
               wall_secs=secs, card=card_line())
    print("ring_two_process: " + json.dumps(row))
    if max(errors.values()) > 1e-6:
        raise AssertionError("ring_two_process: %s" % row)
    return row


def _step_losses(metrics):
    """Each recorded step's losses (0-d tensors read once)."""
    return [{k: float(v) for k, v in m.items() if "loss" in k} for m in metrics]


def long_context_search(model_dir):
    """The long-context tutorial at its defaults on the card (8 shards in
    one process): accuracy, loss, best ensemble, ms a step, K1 exact
    (one a candidate a step, one a test batch); then its first
    LONG_CONTEXT_CPU_STEPS steps on the CPU from the same seeds, each
    step's losses within LONG_CONTEXT_LOSS_BOUND x max(1, |loss|), and
    the same steps at bf16 compute on the CPU, which must fall outside
    that bound. Returns (counts, the row, the estimator)."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.examples.tutorials import long_context_ring_attention as tutorial
    from adanet_tpu_torch.parallel import SequenceMesh

    runs = {}
    for run, device, dtype in (("cuda", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                               ("cpu_bf16", "cpu", torch.bfloat16)):
        directory = os.path.join(model_dir, "long_context_" + run)
        args = tutorial.parse_args(["--model_dir", directory, "--device", device])
        estimator = tutorial.build_estimator(args, SequenceMesh(args.devices), _recording(Estimator), dtype)
        train = tutorial.make_batches(0, 10, args.batch_size, args.seq_len)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if device == "cuda":
            estimator.train(train, max_steps=args.max_steps)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            metrics = estimator.evaluate(tutorial.make_batches(1, 4, args.batch_size, args.seq_len))
            counts = ops.launch_counts()
            _check_k1("long_context_search", counts, args.max_steps // args.iterations,
                      _grow_candidates(2, args.iterations), 4, directory)
            runs[run] = dict(estimator=estimator, secs=secs, metrics=metrics, counts=counts, args=args)
        else:
            estimator.train(train, max_steps=LONG_CONTEXT_CPU_STEPS)
            runs[run] = dict(secs=time.perf_counter() - t0)
        runs[run]["losses"] = _step_losses(estimator.metrics)
    card, cpu = runs["cuda"], runs["cpu"]

    def worst_relative(other):
        return max(abs(got[key] - value) / max(1.0, abs(value))
                   for got, want in zip(card["losses"], other["losses"]) for key, value in want.items())

    worst, control = worst_relative(cpu), worst_relative(runs["cpu_bf16"])
    metrics, args = card["metrics"], card["args"]
    row = dict(accuracy=metrics["accuracy"], loss=metrics["average_loss"], best=metrics["best_ensemble"],
               steps=args.max_steps, seq_len=args.seq_len, shards=args.devices, batch=args.batch_size,
               ms_per_step=card["secs"] / args.max_steps * 1e3, train_secs=card["secs"],
               k1_launches=card["counts"]["combine"], cpu_steps=len(cpu["losses"]), cpu_secs=cpu["secs"],
               cpu_loss_bound="%g x max(1, |loss|)" % LONG_CONTEXT_LOSS_BOUND, cpu_worst_relative=worst,
               cpu_bf16_control_worst_relative=control, card=card_line())
    print("long_context_search: " + json.dumps(row))
    if (len(cpu["losses"]) != LONG_CONTEXT_CPU_STEPS or not math.isfinite(row["loss"])
            or not worst <= LONG_CONTEXT_LOSS_BOUND < control):
        raise AssertionError("long_context_search: %s" % row)
    return card["counts"], row, card["estimator"]


def transformer_full_width(model_dir):
    """TransformerConfig()'s defaults on the card, ring over 8 shards,
    batch 8 of 2048 random tokens from the seed, one iteration of
    FULL_WIDTH_STEPS steps: ms a step (host clock and CUDA events over
    steps 4-7), device ms (steps 8-9 traced), peak memory, K1 exact."""
    import numpy as np
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.models.transformer import TransformerBuilder, TransformerConfig
    from adanet_tpu_torch.parallel import SequenceMesh
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

    config = TransformerConfig(sp_mesh=SequenceMesh(RING_SHARDS))
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, config.vocab_size, (FULL_WIDTH_BATCH * 4, config.max_seq_len))
    labels = rng.randint(0, 2, FULL_WIDTH_BATCH * 4)

    def input_fn():
        for start in range(0, len(tokens), FULL_WIDTH_BATCH):
            yield {"tokens": tokens[start:start + FULL_WIDTH_BATCH]}, labels[start:start + FULL_WIDTH_BATCH]

    directory = os.path.join(model_dir, "transformer_full_width")
    estimator = Estimator(
        MultiClassHead(2), SimpleGenerator([TransformerBuilder(config)]), max_iteration_steps=FULL_WIDTH_STEPS,
        max_iterations=1, model_dir=directory, log_every_steps=0, device="cuda",
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.01),
                                                   use_fused_combine=True)],
    )
    clock = _StepClock(input_fn, first=4, traced=8, window=4, traced_steps=2)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    estimator.train(clock, max_steps=FULL_WIDTH_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    metrics = estimator.evaluate(lambda: itertools.islice(input_fn(), 1))
    counts = ops.launch_counts()
    _check_k1("transformer_full_width", counts, FULL_WIDTH_STEPS, [1], 1, directory)
    (host0, event0), (host1, event1) = clock.marks
    host_ms = (host1 - host0) / 4 * 1e3
    row = dict(config=dict(vocab_size=config.vocab_size, num_layers=config.num_layers, num_heads=config.num_heads,
                           model_dim=config.model_dim, mlp_dim=config.mlp_dim, max_seq_len=config.max_seq_len,
                           compute_dtype="bfloat16", shards=RING_SHARDS),
               batch=FULL_WIDTH_BATCH, steps=FULL_WIDTH_STEPS, train_secs=secs, window_host_ms_per_step=host_ms,
               window_event_ms_per_step=event0.elapsed_time(event1) / 4,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, loss=metrics["average_loss"],
               k1_launches=counts["combine"], card=card_line())
    row.update(traced_step(clock.profile, host_ms, steps=2))
    print("transformer_full_width: " + json.dumps(row))
    if not math.isfinite(row["loss"]):
        raise AssertionError("transformer_full_width: %s" % row)
    return counts, row


def _multi_head_export_search(model_dir):
    """A two-member multi-head search (the serving tutorial's two-head
    builders, a regression and a 3-class head) with both member outputs
    exported."""
    import torch

    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import MultiClassHead, MultiHead, RegressionHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.examples.tutorials import serving_example
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

    estimator = Estimator(
        head=MultiHead([RegressionHead(name="reg"), MultiClassHead(3, name="cls")]),
        subnetwork_generator=SimpleGenerator([serving_example.TwoHeadBuilder("narrow", 8),
                                              serving_example.TwoHeadBuilder("wide", 16)]),
        max_iteration_steps=8, max_iterations=2, model_dir=os.path.join(model_dir, "multi_head_export"),
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.01),
                                                   use_fused_combine=True)],
        log_every_steps=0, device="cuda", export_subnetwork_logits=True, export_subnetwork_last_layer=True,
    )
    estimator.train(serving_example.input_fn, max_steps=16)
    return estimator


def _flat_outputs(prefix, tree, out):
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flat_outputs(prefix + "/" + key, value, out)
    else:
        out[prefix] = tree


def start_export_programs(model_dir, long_context, seq_len):
    """Exports three winners (`Estimator.export_saved_model`): the
    long-context search's, the simple_dnn search's (phase 11's model
    dir, rebuilt by a fresh Estimator) and a multi-head ensemble with
    member outputs, and starts, for each, tests/torch_serve_runner.py in
    a fresh process (torch, numpy and the kernels' custom ops only) at
    EXPORT_ROWS. `export_programs` checks them."""
    import numpy as np
    import torch

    from adanet_tpu_torch.core import export
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.examples.synthetic_digits import make_dataset

    head, generator, ensembler = search_parts()
    dnn = Estimator(head, generator, max_iteration_steps=TRAIN_STEPS, max_iterations=TRAIN_ITERATIONS,
                    ensemblers=[ensembler], model_dir=os.path.join(model_dir, "search"), log_every_steps=0,
                    device="cuda")
    multi_head = _multi_head_export_search(model_dir)
    digits = make_dataset(64, seed=9)[0].reshape(64, -1)
    rng = np.random.RandomState(11)
    cases = {
        "long_context": (long_context, {"tokens": rng.randint(0, 63, (max(EXPORT_ROWS), seq_len))}, 1),
        "simple_dnn": (dnn, {"x": digits}, 1),
        "multi_head": (multi_head, {"x": rng.randn(max(EXPORT_ROWS), 4).astype(np.float32)}, 0),
    }
    procs, rows = [], {}
    for name, (estimator, pool, k1_per_call) in cases.items():
        directory = os.path.join(model_dir, "export_" + name)
        t0 = time.perf_counter()
        estimator.export_saved_model(directory, ({k: v[:1] for k, v in pool.items()}, None))
        export_secs = time.perf_counter() - t0
        requests = {}
        for i, rows_n in enumerate(EXPORT_ROWS):
            for key, value in pool.items():
                requests["%d/%s" % (i, key)] = value[:rows_n]
        np.savez(os.path.join(directory, "requests.npz"), **requests)
        procs.append((name, _spawn_runner("torch_serve_runner.py", [
            directory, os.path.join(directory, "requests.npz"), os.path.join(directory, "served.npz"), "cuda"])))
        rows[name] = dict(export_secs=export_secs, k1_per_call=k1_per_call, directory=directory)
    return cases, procs, rows


def export_programs(started):
    """The served outputs of `start_export_programs`' processes bitwise
    the in-process `predict` on the card, with K1's launches inside each
    exact (one a call for a weighted winner, none for dict logits); each
    card-exported program served on the CPU at 1 and 7 rows within
    EXPORT_CPU_BOUND; the signatures' platforms and fallback reasons."""
    import numpy as np

    from adanet_tpu_torch.core import export

    cases, procs, rows = started
    _finish(procs, "export_programs")
    for name, (estimator, pool, k1_per_call) in cases.items():
        directory = rows[name].pop("directory")
        served = np.load(os.path.join(directory, "served.npz"))
        modules = [str(m) for m in served["__modules__"]]
        model_code = [m for m in modules if m.startswith(("adanet_tpu_torch.core", "adanet_tpu_torch.models",
                                                          "adanet_tpu_torch.examples", "adanet_tpu_torch.ensemble"))]
        if model_code or int(served["__launches__"]) != k1_per_call * len(EXPORT_ROWS):
            raise AssertionError("export_programs %s: model code %s, K1 launches %s"
                                 % (name, model_code, served["__launches__"]))
        cpu = export.load_serving_program(directory, device="cpu")
        cpu_worst = 0.0
        for i, rows_n in enumerate(EXPORT_ROWS):
            features = {key: value[:rows_n] for key, value in pool.items()}
            want = {}
            _flat_outputs(str(i), next(iter(estimator.predict(lambda: iter([features])))), want)
            for key, value in want.items():
                if not np.array_equal(served[key], value.numpy()):
                    raise AssertionError("export_programs %s: served %s differs from predict" % (name, key))
            if i >= 2:  # the CPU serves the first two requests, 1 and 7 rows
                continue
            on_cpu = {}
            _flat_outputs(str(i), cpu(features), on_cpu)
            for key, value in want.items():
                if value.is_floating_point():
                    err = float((on_cpu[key].float() - value.float()).abs().max())
                    bound = EXPORT_CPU_BOUND * max(1.0, float(value.abs().max()))
                    cpu_worst = max(cpu_worst, err / max(1.0, float(value.abs().max())))
                    if err > bound:
                        raise AssertionError("export_programs %s: cpu %s off by %g" % (name, key, err))
        signature = export.serving_signature(directory)
        rows[name].update(
            rows=list(EXPORT_ROWS), bitwise_vs_predict=True, served_k1_launches=int(served["__launches__"]),
            cpu_worst_relative=cpu_worst, platforms=signature["platforms"],
            multi_platform_fallback_reason=signature["multi_platform_fallback_reason"],
            polymorphic_fallback_reason=signature["polymorphic_fallback_reason"],
            program_bytes=os.path.getsize(os.path.join(directory, export.SERVING_FILE)))
    out = dict(programs=rows, cpu_bound="%g x max(1, max|card|)" % EXPORT_CPU_BOUND, card=card_line())
    print("export_programs: " + json.dumps(out))
    return out


def _k1_nodes(path):
    """The K1 custom ops in the graph of the exported program at `path`:
    its K1 launches a call."""
    import torch

    program = torch.export.load(path)
    return sum(1 for node in program.graph.nodes
               if node.op == "call_function" and "weighted_combine" in str(node.target))


class _CountedPrograms:
    """While entered, every program `export.load_serving_program` loads
    counts its calls (`calls`, by the program's path)."""

    def __enter__(self):
        import threading

        from adanet_tpu_torch.core import export

        self._export, self._load = export, export.load_serving_program
        self.calls, lock = collections.Counter(), threading.Lock()

        def load(export_dir, filename=None, device="cuda"):
            fn = self._load(export_dir, filename, device)
            path = os.path.join(export_dir, filename or export.SERVING_FILE)

            def call(features):
                with lock:
                    self.calls[path] += 1
                return fn(features)

            call.module = fn.module
            return call

        export.load_serving_program = load
        return self

    def __exit__(self, *exc):
        self._export.load_serving_program = self._load


def _sws_estimator(directory):
    """`serve_while_search`'s search: phase 11's configuration at
    SWS_ITERATIONS x SWS_STEPS with `export_serving` (the default cascade)."""
    from adanet_tpu_torch.core.estimator import Estimator

    head, generator, ensembler = search_parts()
    return Estimator(head, generator, max_iteration_steps=SWS_STEPS, max_iterations=SWS_ITERATIONS,
                     ensemblers=[ensembler], model_dir=directory, log_every_steps=0, device="cuda",
                     export_serving=True)


def sws_search_main(directory):
    """`serve_while_search`'s searcher (`--sws-search`): trains the search
    from where `directory` stands, launch counts zeroed just before and
    read just after, and prints `sws_search:` with them. A fault armed
    through ADANET_FAULTS may kill it first."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset

    xtr, ytr = make_dataset(TRAIN_EXAMPLES, seed=7)
    estimator = _sws_estimator(directory)
    start = estimator.latest_iteration_number()
    ops.reset_launch_counts()
    estimator.train(input_fn(xtr, ytr, TRAIN_BATCH), max_steps=10**6)
    torch.cuda.synchronize()
    print("sws_search: " + json.dumps(dict(start_iteration=start, iterations=estimator.latest_iteration_number(),
                                           launches=ops.launch_counts())), flush=True)


class _FlipPrograms:
    """While entered, the K1 custom ops of each program in a generation's
    directory, read when the pool's `serving.flip` seam is reached (before
    an armed fault can rot the program), by the directory's name."""

    def __enter__(self):
        from adanet_tpu_torch.core import export
        from adanet_tpu_torch.robustness import faults

        self._faults, self._trip = faults, faults.trip
        self.k1 = {}

        def trip(site, path=None, data=None):
            if site == "serving.flip" and path is not None:
                gen_dir = os.path.dirname(path)
                self.k1[os.path.basename(gen_dir)] = {
                    name: _k1_nodes(os.path.join(gen_dir, name))
                    for name in (export.SERVING_FILE, export.CASCADE_FILE)
                    if os.path.exists(os.path.join(gen_dir, name))
                }
            return self._trip(site, path=path, data=data)

        faults.trip = trip
        return self

    def __exit__(self, *exc):
        self._faults.trip = self._trip


def _published_k1(programs):
    """K1 launches of one generation's publication: the program's sample
    run, and with a cascade the calibration's full call and the cheap
    program's sample run and calibration call."""
    full = programs["serving.pt2"]
    cheap = programs.get("cascade.pt2")
    return full if cheap is None else 2 * full + 2 * cheap


def serve_while_search(model_dir):
    """Phase 11's search at SWS_ITERATIONS x SWS_STEPS with
    export_serving=True and the default cascade, in a process of its own
    (`--sws-search`), while a frontend over the same model_dir answers a
    stream of requests (1 to 32 rows) from another thread under a pool
    with `PoolConfig(canary_requests=2)`: the chaos gate of
    tests/test_serving.py. The searcher is SIGKILLed by an armed torn
    write of iteration 1's frozen payload (`checkpoint.write:torn:
    after=1`) and started again, which heals and finishes the search;
    the pool's second flip (gen-1's) is rotted at `serving.flip`, so it
    is rejected, quarantined and rolled back; the last generation is
    promoted through its canary window. Every request answered ok, zero
    errors, >= 2 flips, >= 1 rollback; at the end, the cascade-free
    answers of the last generation bitwise the offline
    `load_serving_program` on the same padded bucket, and each cascade
    answer's rows bitwise the offline level-0 program's (clear rows) or
    the full program's on the residual bucket (the rest). K1 exact in
    this process: one a K1 of a served program for each call the pool
    and the batcher (the canary mirror included) made to it; and in the
    restarted searcher: one a candidate a training step of iterations 1
    and 2, and for each generation it published, one a K1 of its program
    for the export's sample run and, with a cascade, for the
    calibration's full call, and as many for the cascade program's sample
    run and calibration call (the killed searcher's counts die with it).
    Prints the level-0 share and the published agreement."""
    import threading

    import numpy as np
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core import export
    from adanet_tpu_torch.examples.synthetic_digits import make_dataset
    from adanet_tpu_torch.observability import flightrec
    from adanet_tpu_torch.robustness import faults
    from adanet_tpu_torch.serving import (Batcher, BatcherConfig, FrontendConfig, ModelPool, PoolConfig,
                                          ServingFrontend, batcher as batcher_lib, publisher)

    xte = make_dataset(256, seed=12)[0].reshape(256, -1)
    directory = os.path.join(model_dir, "serve_while_search")
    flightrec.uninstall()
    pool = ModelPool(directory, PoolConfig(canary_requests=SWS_CANARY_REQUESTS))
    batcher = Batcher(pool)
    frontend = ServingFrontend(batcher, FrontendConfig(default_deadline_secs=120.0, poll_interval_secs=0.05)).start()
    results, stop = [], threading.Event()
    sizes = itertools.cycle(BURST_ROWS)

    def client():
        offset = 0
        while not stop.is_set():
            if pool.active is None:
                time.sleep(0.01)
                continue
            n = next(sizes)
            rows = xte[offset % 200:offset % 200 + n]
            offset += n
            results.append(frontend.submit({"x": rows}, timeout=120.0))

    def searcher(fault=None):
        environ = dict(os.environ, OMP_NUM_THREADS="1")
        environ.pop("ADANET_FAULTS", None)
        if fault:
            environ["ADANET_FAULTS"] = fault
        return subprocess.run([sys.executable, os.path.abspath(__file__), "--sws-search", directory],
                              env=environ, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=PROCESS_TIMEOUT)

    thread = threading.Thread(target=client, daemon=True)
    with _CountedPrograms() as programs, _FlipPrograms() as flipped:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        faults.arm("serving.flip", "rot", after=1)
        try:
            thread.start()
            killed = searcher("checkpoint.write:torn:after=1")
            if killed.returncode != -signal.SIGKILL:
                raise AssertionError("serve_while_search: the armed searcher returned %d\n%s"
                                     % (killed.returncode, killed.stdout[-4000:]))
            _wait_until("gen-0's bootstrap", lambda: pool.active is not None, timeout=120)
            served_while_dead = len(results)
            time.sleep(1.0)
            served_while_dead = len(results) - served_while_dead
            restarted = searcher()
            lines = [line for line in restarted.stdout.splitlines() if line.startswith("sws_search: ")]
            if restarted.returncode != 0 or not lines:
                raise AssertionError("serve_while_search: the restarted searcher returned %d\n%s"
                                     % (restarted.returncode, restarted.stdout[-4000:]))
            search = json.loads(lines[-1][len("sws_search: "):])
            _wait_until("the last generation's promotion",
                        lambda: pool.active is not None and pool.active.iteration_number == SWS_ITERATIONS - 1,
                        timeout=120)
            time.sleep(0.5)
        finally:
            faults.disarm()
            stop.set()
            thread.join(timeout=120)
            drained = frontend.drain(timeout=120.0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
    gens = [t for t, _ in publisher.list_generations(directory)]
    bad = [r for r in results if not r.ok]
    levels = collections.Counter(r.cascade_level for r in results)
    quarantined = [name for name in os.listdir(publisher.serving_root(directory)) if ".corrupt" in name]
    flips = [e for e in pool.events if e["event"] == "flip"]
    if (not drained or bad or pool.flips < 2 or pool.rollbacks < 1 or flips[-1]["how"] != "canary"
            or gens != [0, SWS_ITERATIONS - 1] or quarantined != ["gen-1.corrupt"] or not results
            or not served_while_dead or {r.generation for r in results} - {e["iteration_number"] for e in flips}):
        raise AssertionError("serve_while_search: drained %s, failed %s, events %s, generations %s, quarantined %s, "
                             "requests %d (%d while the searcher was down)"
                             % (drained, [(r.status, r.error) for r in bad[:3]], pool.events, gens, quarantined,
                                len(results), served_while_dead))
    stats = batcher.cascade_stats()
    k1 = {path: _k1_nodes(path) for path in programs.calls}
    served = sum(calls * k1[path] for path, calls in programs.calls.items())
    cheap = _grow_candidates(2, SWS_ITERATIONS)
    searched = dict(search=SWS_STEPS * sum(cheap[1:]), publications=sum(
        _published_k1(flipped.k1["gen-%d" % t]) for t in range(1, SWS_ITERATIONS)))
    expected_search = dict(copy=search["launches"]["copy"], combine=sum(searched.values()), sepconv=0, cell=0)
    if (counts["combine"] != served or counts["sepconv"] or counts["cell"] or search["start_iteration"] != 1
            or search["launches"] != expected_search):
        raise AssertionError("serve_while_search: launches %s, expected %d K1 (program calls %s, K1 a call %s); the "
                             "restarted searcher's %s, expected %s (%s)"
                             % (counts, served, dict(programs.calls), k1, search, expected_search, searched))
    last = publisher.generation_dir(directory, SWS_ITERATIONS - 1)
    signature = export.serving_signature(last)
    full = export.load_serving_program(last)
    cheap = export.load_serving_program(last, export.CASCADE_FILE) if "cascade" in signature else None
    final_pool = ModelPool(directory)
    final_pool.poll()
    off = Batcher(final_pool, BatcherConfig(cascade=False))
    on = Batcher(final_pool)
    checked = 0
    for n in (1, 3, 8, 17, 32):
        request = {"x": xte[:n]}
        bucket = batcher_lib.bucket_for(n, off.config.bucket_sizes)
        padded, _ = batcher_lib.pad_batch([request], bucket)
        _, (served_rows,) = off.execute([request])
        offline = batcher_lib.split_rows(full(padded), [n])[0]
        for key in offline:
            if not np.array_equal(served_rows[key], offline[key]):
                raise AssertionError("serve_while_search: served %s differs from the offline program" % key)
        _, (answered,) = on.execute([request])
        mask = on.last_row_fallthrough
        if mask is not None and cheap is not None:
            level0 = batcher_lib.split_rows(cheap(padded), [n])[0]
            residual = np.flatnonzero(mask)
            if len(residual):
                rbucket = batcher_lib.bucket_for(len(residual), on.config.bucket_sizes)
                rpadded, _ = batcher_lib.pad_batch([{"x": xte[:n][residual]}], rbucket)
                full_rows = batcher_lib.split_rows(full(rpadded), [len(residual)])[0]
            for key in answered:
                want = level0[key].copy()
                if len(residual):
                    want[residual] = full_rows[key]
                if not np.array_equal(answered[key], want):
                    raise AssertionError("serve_while_search: cascade answer %s differs" % key)
        checked += 1
    cascade = signature.get("cascade") or {}
    row = dict(steps=SWS_STEPS * SWS_ITERATIONS, generations=gens, quarantined=quarantined, flips=pool.flips,
               rollbacks=pool.rollbacks, events=[(e["event"], e["iteration_number"], e.get("how")) for e in pool.events],
               requests=len(results), requests_while_searcher_down=served_while_dead,
               rows=int(sum(r.outputs["logits"].shape[0] for r in results)), cascade_levels=dict(
                   (str(k), v) for k, v in levels.items()),
               level0_row_share=None if stats["row_fallthrough_rate"] is None else 1 - stats["row_fallthrough_rate"],
               cascade_threshold=cascade.get("threshold"), holdout_agreement=cascade.get("holdout_agreement"),
               target_agreement=cascade.get("target_agreement"), shadow_divergence=stats["shadow_divergence"],
               final_checks=checked, secs=secs, k1_launches=counts["combine"], k1_served=served,
               restarted_searcher=search, restarted_searcher_k1_expected=searched,
               program_calls=sum(programs.calls.values()), card=card_line())
    print("serve_while_search: " + json.dumps(row))
    return counts, row


# --------------------------------------- canary, quarantine and the store

# canary_flip: requests of CANARY_ROWS rows (bucket 32); the window is
# PoolConfig's default of CANARY_REQUESTS mirrored batches, and as many
# unmirrored batches are timed before it.
CANARY_REQUESTS, CANARY_ROWS = 8, 32
# serve_while_search's canary window (tests/test_serving.py's gate).
SWS_CANARY_REQUESTS = 2


def _wait_until(what, condition, timeout=PROCESS_TIMEOUT):
    deadline = time.monotonic() + timeout
    while not condition():
        if time.monotonic() > deadline:
            raise AssertionError("%s: not within %d s" % (what, timeout))
        time.sleep(0.02)


def _copy_generation(source, model_dir, t, rot=False):
    """gen-<t> under `model_dir`: the artifacts of the published generation
    `source` copied byte for byte, with a manifest of its own written by
    the publisher's writer (no second export), renamed into place; with
    `rot`, one byte of the program flipped after the manifest was
    written. Returns its path."""
    import shutil

    from adanet_tpu_torch.core import export
    from adanet_tpu_torch.robustness import integrity
    from adanet_tpu_torch.serving import publisher

    root = publisher.serving_root(model_dir)
    os.makedirs(root, exist_ok=True)
    staging = tempfile.mkdtemp(prefix=".stage-gen-", dir=root)
    for name in os.listdir(source):
        if name != integrity.GENERATION_MANIFEST:
            shutil.copyfile(os.path.join(source, name), os.path.join(staging, name))
    publisher.write_generation_manifest(staging, t)
    if rot:
        path = os.path.join(staging, export.SERVING_FILE)
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
    final = publisher.generation_dir(model_dir, t)
    os.replace(staging, final)
    return final


def _fsck_json(argv):
    """`adanet_tpu_torch.tools.ckpt_fsck --json`'s report and exit code."""
    import io
    from contextlib import redirect_stdout

    from adanet_tpu_torch.tools import ckpt_fsck

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = ckpt_fsck.main(list(argv) + ["--json"])
    return rc, json.loads(buf.getvalue())


def canary_flip(model_dir, pool, sep_shapes, rng):
    """`serve`'s pool, with `PoolConfig(canary_requests=8)`, serving the
    NASNet-A (6@768) bf16 program's gen-0, under a frontend of its own:
    CANARY_REQUESTS unmirrored bucket-32 batches; then gen-1, gen-0's
    artifacts copied byte for byte under a manifest of its own, staged as
    the canary, and CANARY_REQUESTS mirrored batches (the incumbent
    answers, the candidate runs the same padded bucket) promote it
    `how="canary"`, with a divergence of 0 on every batch and K1 and K2
    launched exactly twice the incumbent's alone; gen-2, a copy whose
    program is rotted after its manifest was written, is rejected before
    load (no K0), quarantined as `gen-2.corrupt` and not retried; a fixed
    request is answered bitwise alike by gen-0, by gen-1 and after the
    rejection; `ckpt_fsck --json`'s `serving` section names generation 1.
    Launch counts zeroed just before and read just after; exact. Returns
    (the counts, the `canary_flip:` numbers)."""
    import numpy as np
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.observability import metrics
    from adanet_tpu_torch.serving import Batcher, FrontendConfig, ServingFrontend, publisher

    requests = [{"image": torch.randn(CANARY_ROWS, 32, 32, 3, generator=rng).numpy()}
                for _ in range(CANARY_REQUESTS)]
    probe = {"image": torch.randn(CANARY_ROWS, 32, 32, 3, generator=rng).numpy()}
    gauge = metrics.registry().gauge("serving.batcher.canary_divergence")
    per_program = NUM_MEMBERS * len(sep_shapes)
    source = publisher.generation_dir(model_dir, 0)
    if pool.config.canary_requests != CANARY_REQUESTS or pool.stats()["active_generation"] != 0:
        raise AssertionError("canary_flip: the pool is %s with %s" % (pool.stats(), pool.config))
    calls = 0

    def answer(features, generation):
        nonlocal calls
        t0 = time.perf_counter()
        result = frontend.submit(features, timeout=300.0)
        ms = (time.perf_counter() - t0) * 1e3
        if not result.ok or result.generation != generation:
            raise AssertionError("canary_flip: %s %s from generation %s, expected %d"
                                 % (result.status, result.error, result.generation, generation))
        calls += 1
        return result, ms

    ops.reset_launch_counts()
    frontend = ServingFrontend(Batcher(pool), FrontendConfig(default_deadline_secs=300.0,
                                                             poll_interval_secs=0.05)).start()
    try:
        plain_ms = [answer(r, 0)[1] for r in requests]
        by_gen0, _ = answer(probe, 0)
        t0 = time.monotonic()
        _copy_generation(source, model_dir, 1)
        _wait_until("gen-1's staging", lambda: pool.canary_record() is not None)
        stage_secs = time.monotonic() - t0
        calls += 1  # the gate's smoke sample
        before = ops.launch_counts()
        mirrored_ms, divergences = [], []
        for r in requests:
            mirrored_ms.append(answer(r, 0)[1])
            divergences.append(gauge.value)
        window = {k: v - before[k] for k, v in ops.launch_counts().items()}
        calls += CANARY_REQUESTS  # the candidate's mirrored calls
        stats = pool.stats()
        if (stats["active_generation"], stats["canary_generation"]) != (1, None) or pool.events[-1]["how"] != "canary":
            raise AssertionError("canary_flip: %s after the window; events %s" % (stats, pool.events))
        by_gen1, _ = answer(probe, 1)
        before = ops.launch_counts()
        _copy_generation(source, model_dir, 2, rot=True)
        _wait_until("gen-2's rejection", lambda: pool.rollbacks >= 1)
        rejection = {k: v - before[k] for k, v in ops.launch_counts().items()}
        after_reject, _ = answer(probe, 1)
    finally:
        drained = frontend.drain(timeout=120.0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    retried = pool.poll()
    serving_dirs = sorted(name for name in os.listdir(publisher.serving_root(model_dir)) if not name.startswith("."))
    twice = {"copy": 0, "combine": 2 * CANARY_REQUESTS, "sepconv": 2 * CANARY_REQUESTS * per_program, "cell": 0}
    expected = {"copy": 1, "combine": calls, "sepconv": calls * per_program, "cell": 0}
    reason = pool.events[-1].get("reason", "")
    if (not drained or window != twice or counts != expected or any(rejection.values()) or retried
            or serving_dirs != ["gen-0", "gen-1", "gen-2.corrupt"] or pool.rollbacks != 1
            or "digest mismatch" not in reason):
        raise AssertionError("canary_flip: drained %s, window %s (expected %s), launches %s (expected %s), "
                             "rejection %s, retried %s, dirs %s, events %s"
                             % (drained, window, twice, counts, expected, rejection, retried, serving_dirs,
                                pool.events))
    if max(divergences) != 0.0:
        raise AssertionError("canary_flip: the same program on the same rows diverged: %s" % divergences)
    for key in by_gen0.outputs:
        if not (np.array_equal(by_gen0.outputs[key], by_gen1.outputs[key])
                and np.array_equal(by_gen1.outputs[key], after_reject.outputs[key])):
            raise AssertionError("canary_flip: %s differs across the flip or the rejection" % key)
    rc, report = _fsck_json([model_dir])
    serving = report["serving"]
    if rc != 0 or serving["selected_generation"] != 1 or [g["iteration_number"] for g in serving["generations"]] != [0, 1]:
        raise AssertionError("canary_flip: ckpt_fsck rc %d, serving %s" % (rc, serving))
    row = dict(
        unmirrored_batch_ms=float(np.median(plain_ms)), mirrored_batch_ms=float(np.median(mirrored_ms)),
        unmirrored_batch_ms_all=plain_ms, mirrored_batch_ms_all=mirrored_ms, canary_gate_load_secs=stage_secs,
        divergences=divergences, window_launches=window, rejection_launches=rejection, launches=counts,
        program_calls=calls, events=[(e["event"], e["iteration_number"], e.get("how")) for e in pool.events],
        reason=reason, serving_dirs=serving_dirs, fsck_selected_generation=serving["selected_generation"],
        card=card_line(),
    )
    print("canary_flip: " + json.dumps(row))
    return counts, row


def graft_main(graft_dir, store_root, first_dir):
    """`store_warm_start`'s grafting process (`--graft-only`): an Estimator
    of `train_search`'s configuration over a fresh `graft_dir`, given the
    first search's `replay.json` and the same store. Counts its training
    steps, batches, launches and nvcc builds, predicts the test digits
    (saved beside it, `predictions.npz`) and prints `graft:` with the
    numbers."""
    import numpy as np
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch import replay
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.iteration import Iteration
    from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset
    from adanet_tpu_torch.ops import _build

    steps = [0]
    step, train_steps = Iteration.train_step, Iteration.train_steps

    def counted_step(self, *args, **kwargs):
        steps[0] += 1
        return step(self, *args, **kwargs)

    def counted_steps(self, state, batches, *args, **kwargs):
        steps[0] += len(batches)
        return train_steps(self, state, batches, *args, **kwargs)

    Iteration.train_step, Iteration.train_steps = counted_step, counted_steps
    head, generator, ensembler = search_parts()
    xtr, ytr = make_dataset(TRAIN_EXAMPLES, seed=7)
    xte, yte = make_dataset(EVAL_EXAMPLES, seed=8)
    pulls = [0]

    def train_fn():
        pulls[0] += 1
        return input_fn(xtr, ytr, TRAIN_BATCH)()

    config = replay.Config.load(os.path.join(first_dir, replay.REPLAY_FILENAME))
    estimator = Estimator(head, generator, max_iteration_steps=TRAIN_STEPS, max_iterations=TRAIN_ITERATIONS,
                          ensemblers=[ensembler], model_dir=graft_dir, log_every_steps=0, device="cuda",
                          artifact_store=store_root, replay_config=config)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    estimator.train(train_fn, max_steps=10**6)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    predictions = [p for p in estimator.predict(input_fn(xte, yte, TRAIN_BATCH))]
    np.savez(os.path.join(graft_dir, "predictions.npz"),
             **{key: np.concatenate([p[key].numpy() for p in predictions]) for key in predictions[0]})
    print("graft: " + json.dumps(dict(
        secs=secs, grafts=estimator._store_graft_count, training_steps=steps[0], batches_pulled=pulls[0],
        launches=launches, nvcc_builds=sorted(_build.BUILD_LOG), global_step=estimator.latest_global_step(),
        iterations=estimator.latest_iteration_number())), flush=True)


def store_warm_start(model_dir, first_secs):
    """`train_search` published both its iterations to `<model_dir>/store`;
    a second Estimator in a fresh process and model dir, given the first's
    `replay.json` and the same store, grafts both iterations
    (`graft_main`) with zero training steps, zero batches, zero launches
    and zero nvcc builds, lands the first's payloads byte for byte and
    predicts bitwise as the first; fsck's store section (with the
    grafted search's closure leased, `--gc --dry-run`) is clean and would
    remove nothing. Prints `store_warm_start:`, the graft's seconds
    against the first search's."""
    import numpy as np

    from adanet_tpu_torch.core import checkpoint as ckpt_lib
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset
    from adanet_tpu_torch.store import ArtifactStore, leases

    first_dir, store_root = os.path.join(model_dir, "search"), os.path.join(model_dir, "store")
    graft_dir = os.path.join(model_dir, "graft")
    os.makedirs(graft_dir)
    environ = dict(os.environ, OMP_NUM_THREADS="1")
    environ.pop("ADANET_FAULTS", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--graft-only", graft_dir, "--store",
                           store_root, "--first", first_dir], env=environ, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=PROCESS_TIMEOUT)
    process_secs = time.perf_counter() - t0
    lines = [line for line in proc.stdout.splitlines() if line.startswith("graft: ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError("store_warm_start: rc %d\n%s" % (proc.returncode, proc.stdout[-6000:]))
    graft = json.loads(lines[-1][len("graft: "):])
    if (graft["grafts"] != TRAIN_ITERATIONS or graft["training_steps"] or graft["batches_pulled"]
            or any(graft["launches"].values()) or graft["nvcc_builds"]
            or graft["global_step"] != TRAIN_STEPS * TRAIN_ITERATIONS):
        raise AssertionError("store_warm_start: %s" % graft)
    for t in range(TRAIN_ITERATIONS):
        for name in (ckpt_lib.frozen_filename(t), ckpt_lib.architecture_filename(t)):
            with open(os.path.join(first_dir, name), "rb") as a, open(os.path.join(graft_dir, name), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError("store_warm_start: %s differs from the first search's" % name)
    head, generator, ensembler = search_parts()
    xte, yte = make_dataset(EVAL_EXAMPLES, seed=8)
    first = Estimator(head, generator, max_iteration_steps=TRAIN_STEPS, max_iterations=TRAIN_ITERATIONS,
                      ensemblers=[ensembler], model_dir=first_dir, log_every_steps=0, device="cuda")
    want = [p for p in first.predict(input_fn(xte, yte, TRAIN_BATCH))]
    got = np.load(os.path.join(graft_dir, "predictions.npz"))
    for key in want[0]:
        if not np.array_equal(got[key], np.concatenate([p[key].numpy() for p in want])):
            raise AssertionError("store_warm_start: grafted predictions %s differ from the first search's" % key)
    store = ArtifactStore(store_root)
    digests = sorted({d for _, _, ref in store.iter_refs("frozen") for d in ref["blobs"].values()})
    lease = leases.acquire(store, owner="chip-smoke-%d" % os.getpid(), ttl_secs=600.0, digests=digests)
    try:
        rc, report = _fsck_json([graft_dir, "--store", store_root, "--gc", "--dry-run"])
    finally:
        leases.release(store, lease)
    section = report["store"]
    if rc != 0 or not section["clean"] or section["dangling_refs"] or section["would_gc"] or not section["leases"]["live"]:
        raise AssertionError("store_warm_start: ckpt_fsck rc %d, store %s" % (rc, section))
    row = dict(graft_secs=graft["secs"], graft_process_secs=process_secs, first_search_secs=first_secs,
               graft=graft, store=dict((k, section[k]) for k in ("blob_count", "bytes", "ref_count", "leases",
                                                                 "would_gc", "clean")),
               predictions_bitwise=sorted(want[0]), card=card_line())
    print("store_warm_start: " + json.dumps(row))
    return row


def start_serving_example(model_dir):
    """The serving tutorial on the card, as a user runs it (`python -m
    ...serving_example`), in a process of its own beside the group's
    other phases; it prints its launch counts last."""
    environ = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.abspath(__file__)),
                                               os.environ.get("PYTHONPATH", "")]))
    code = ("import json; from adanet_tpu_torch import ops; "
            "from adanet_tpu_torch.examples.tutorials import serving_example; serving_example.main([]); "
            "print('serving_example_counts: ' + json.dumps(ops.launch_counts()))")
    log = open(os.path.join(model_dir, "serving_example.log"), "w")
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=log, stderr=subprocess.STDOUT, env=environ,
                            cwd=model_dir)
    return proc, log, time.perf_counter()


def serving_example_on_card(started):
    """The tutorial's process: the two-head search, its export, batches 1
    and 7 served by a process without model code."""
    proc, log, t0 = started
    rc = proc.wait(timeout=PROCESS_TIMEOUT)
    log.close()
    with open(log.name) as f:
        out = f.read()
    served = [line for line in out.splitlines() if line.startswith("served batch")]
    counts = [json.loads(line.split(": ", 1)[1]) for line in out.splitlines()
              if line.startswith("serving_example_counts: ")]
    row = dict(served=served, secs=time.perf_counter() - t0, k1_launches=counts[-1]["combine"] if counts else None,
               card=card_line())
    print("serving_example: " + json.dumps(row))
    if rc != 0 or len(served) != 2 or "OK: hermetic multi-head serving round trip" not in out or not counts:
        raise AssertionError("serving_example: rc %s\n%s" % (rc, out[-4000:]))
    # Dict logits take the combine that launches no K1 (nor K2 or K3).
    if any(counts[-1][name] for name in ("combine", "sepconv", "cell")):
        raise AssertionError("serving_example: launches %s, expected no K1, K2 or K3" % counts[-1])
    return counts[-1], row


class _CombineShapes:
    """Records the (members, rows, classes, weights' rank, bias) of every
    K1 plan looked up while it is entered."""

    def __enter__(self):
        from adanet_tpu_torch.ops import ensemble_kernels as ek

        self._ek, self._plan_for, self.seen = ek, ek.plan_for, set()

        def plan_for(n, first, w, bias, stacked):
            self.seen.add((n, int(first.shape[0]), int(first.shape[1]), w.dim(), bias is not None))
            return self._plan_for(n, first, w, bias, stacked)

        ek.plan_for = plan_for
        return self

    def __exit__(self, *exc):
        self._ek.plan_for = self._plan_for


def check_group_combines(seen, gen):
    """K1 against its plain version at every shape the group launched it
    at (`check_search_combine`: both weight forms and under autograd).
    Returns (worst forward or gradient error, the shapes)."""
    worst = 0.0
    for n, b, c, rank, use_bias in sorted(seen):
        if rank != 1:
            raise AssertionError("the group launched K1 with weights of rank %d" % rank)
        worst = max(worst, *check_search_combine(n, use_bias, gen, batch=b, classes=c))
    shapes = sorted({(n, b, c) for n, b, c, _, _ in seen})
    print("K1 at the long-context and export paths' shapes %s: worst abs err %g" % (shapes, worst))
    return worst, shapes


def long_context_export_phases(model_dir, long_context_gen):
    """The fifteenth slice's group: `ring_attention`, `ring_two_process`
    (its processes started first), `long_context_search`,
    `transformer_full_width`, `export_programs`, `serve_while_search`,
    `serving_example`, then K1 at every shape they launched it at.
    Returns ({phase: K1 launches}, K1's worst error, the shapes)."""
    started = example = None
    try:
        with _CombineShapes() as shapes:
            # Phases 42-45 have the card to themselves; the tutorial's
            # process and the programs' serving processes run beside
            # phases 46-47.
            ring_attention_phase(long_context_gen)
            started = start_ring_two_process(model_dir)
            ring_two_process(started)
            lc_counts, lc_row, lc_estimator = long_context_search(model_dir)
            fw_counts, _ = transformer_full_width(model_dir)
            example = start_serving_example(model_dir)
            serving = start_export_programs(model_dir, lc_estimator, lc_row["seq_len"])
            try:
                sws_counts, sws_row = serve_while_search(model_dir)
            finally:
                exported = export_programs(serving)
            example_counts, _ = serving_example_on_card(example)
    finally:
        for proc in ([p for _, p in started[1]] if started else []) + ([example[0]] if example else []):
            if proc.poll() is None:
                proc.kill()
    worst, combine_shapes = check_group_combines(shapes.seen, long_context_gen)
    launches = dict(long_context=lc_counts["combine"], transformer_full_width=fw_counts["combine"],
                    export_programs={k: v["served_k1_launches"] for k, v in exported["programs"].items()},
                    serve_while_search=sws_counts["combine"],
                    serve_while_search_searcher=sws_row["restarted_searcher"]["launches"]["combine"],
                    serving_example=example_counts["combine"])
    return launches, worst, combine_shapes


def trainer_on_card():
    """The trainer CLI on the card, on fake data, at a small size."""
    from adanet_tpu_torch.research.improve_nas import trainer

    t0 = time.perf_counter()
    rc = trainer.main([*TRAINER_SMALL, "--boosting_iterations=2", "--train_steps=8", "--device=cuda"])
    if rc != 0:
        raise AssertionError("trainer returned %r" % rc)
    print("trainer: rc %d in %.1f s" % (rc, time.perf_counter() - t0))


class _PhaseClock:
    """Seconds between marks, by the name of the phase that just ended."""

    def __init__(self):
        self.secs, self._t0 = {}, time.perf_counter()
        self._t = self._t0

    def mark(self, name):
        now = time.perf_counter()
        self.secs[name] = now - self._t
        self._t = now

    def line(self):
        return json.dumps(dict(self.secs, total=time.perf_counter() - self._t0))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--publish-only", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--graft-only", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--store", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--first", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--sws-search", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from adanet_tpu_torch.ops import _build

    if args.publish_only:
        # `start_publisher`'s process: the kernels are built already.
        path, info = publish(args.publish_only, args.seed)
        with open(os.path.join(args.publish_only, "publish.json"), "w") as f:
            json.dump(dict(path=path, info=info), f)
        return 0
    if args.graft_only:
        # `store_warm_start`'s process: the kernels are built already.
        graft_main(args.graft_only, args.store, args.first)
        return 0
    if args.sws_search:
        # `serve_while_search`'s searcher.
        sws_search_main(args.sws_search)
        return 0
    print(card_line())
    clock = _PhaseClock()
    build_kernels()
    _build.self_test()
    clock.mark("build")
    rng = torch.Generator().manual_seed(args.seed + 1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as model_dir:
        # The served ensemble in this process: the kernels' shapes, and
        # the in-process predict the served program is held against.
        served_frozen, served_ensembler, served_predict = served_ensemble(args.seed, "cuda")
        nasnet = served_frozen.weighted_subnetworks[0].subnetwork.module.nasnet
        sep_shapes, cell_signatures = nasnet.sepconv_launch_shapes(), model_cell_signatures(nasnet)
        publisher = None
        try:
            if cell_signatures != CELL_SIGNATURES:
                raise AssertionError("the model's cells %s differ from CELL_SIGNATURES" % cell_signatures)
            errors = check_kernels(sep_shapes, rng)
            combine_errors, _ = check_combine(rng)
            errors["combine"] = max([errors["combine"]] + list(combine_errors.values()))
            errors["cell"] = check_cells(rng)
            print("kernel checks passed: max abs err %s" % errors)
            clock.mark("kernel_checks")
            tune_counts, tuned = autotune_path(rng)
            clock.mark("autotune_path")
            # The single-kernel traces come before the large ones of the
            # training phases and the served batch, after which the
            # tracer has been seen to deliver no kernels; device_ms then
            # falls back to queued events.
            combine_rows = time_combine(rng)
            rows, per_shape, host = time_kernels(sep_shapes, combine_rows, rng)
            rows["cell"], cell_rows, cell_host = time_cells(rng)
            host.update(cell_host)
            time_tuned(tuned)
            trace_served_combine(served_frozen, served_ensembler, rng)
            clock.mark("kernel_timing")
            # The serving generation is exported in a process of its own
            # (niced, one thread) while the phases up to the serving
            # phase run here; their timings share the host with it.
            publisher = start_publisher(model_dir, args.seed)
            check_sepconv_grads(sep_shapes, rng)
            clock.mark("sepconv_grads")
            fused_probes = {}
            train_counts, train_stats = train_search(model_dir, fused_probes)
            clock.mark("train_search")
            warm_start = store_warm_start(model_dir, train_stats["search_secs"])
            clock.mark("store_warm_start")
            train_vs_cpu()
            clock.mark("train_vs_cpu")
            t_selection = time.perf_counter()
            selection_counts, _ = search_selection(model_dir, args.seed)
            selection_vs_cpu(args.seed)
            multi_head_counts, _ = multi_head_search(model_dir)
            heads_vs_cpu(rng)
            print("selection_phases: " + json.dumps({"secs": time.perf_counter() - t_selection,
                                                     "card": card_line()}))
            clock.mark("selection_phases")
            t_gates = time.perf_counter()
            full_gate_counts, _ = full_dnn_gate(model_dir)
            cnn_counts, _ = cnn_search(model_dir)
            cnn_vs_cpu(model_dir)
            autoensemble_counts, _ = autoensemble(model_dir)
            replay_counts, _ = replay_search(model_dir, args.seed)
            tutorials_on_card(model_dir)
            predict_debug(model_dir)
            print("gates_autoensemble_replay_phases: " + json.dumps({"secs": time.perf_counter() - t_gates,
                                                                      "card": card_line()}))
            clock.mark("gates_autoensemble_replay_phases")
            t_slice = time.perf_counter()
            cifar_counts, _ = cifar_trainer(model_dir)
            imagenet_counts, _, imagenet_losses = imagenet_autoensemble(model_dir, rng)
            modelflow(model_dir)
            errors["combine"] = max(errors["combine"], check_slice_combines(rng))
            print("cifar_imagenet_modelflow_phases: " + json.dumps({"secs": time.perf_counter() - t_slice,
                                                                     "card": card_line()}))
            clock.mark("cifar_imagenet_modelflow_phases")
            gen_dir, published = wait_publisher(publisher, model_dir)
        finally:
            if publisher is not None and publisher[0].poll() is None:
                publisher[0].kill()
        print("published %s in %.1f s" % (os.path.basename(gen_dir), published["publish_process_secs"]))
        clock.mark("publish_wait")
        counts, served, served_program, served_pool = serve(model_dir, sep_shapes, rng, served_predict, published)
        clock.mark("serve")
        canary_counts, canary_row = canary_flip(model_dir, served_pool, sep_shapes, rng)
        clock.mark("canary_flip")
        t_placement = time.perf_counter()
        rr_imagenet_counts, _, rr_imagenet_losses = imagenet_round_robin(model_dir, imagenet_losses)
        rr_search_counts, _ = round_robin_search(model_dir, fused_probes)
        # The processes start up while the gate trains.
        started = start_processes(model_dir)
        try:
            rr_gate_counts, _ = round_robin_gate(model_dir)
        except BaseException:
            for _, proc in started[0]:
                proc.kill()
            raise
        spmd_launches, _ = process_phases(model_dir, started)
        errors["combine"] = max(errors["combine"], check_placement_combines(rng))
        print("placement_phases: " + json.dumps({"secs": time.perf_counter() - t_placement, "card": card_line()}))
        clock.mark("placement_phases")
        t_elastic = time.perf_counter()
        elastic_launches = elastic_multihost_phases(model_dir, train_stats, rr_imagenet_losses)
        print("elastic_multihost_phases: " + json.dumps({"secs": time.perf_counter() - t_elastic,
                                                          "card": card_line()}))
        clock.mark("elastic_multihost_phases")
        t_long = time.perf_counter()
        long_context_launches, long_context_err, _ = long_context_export_phases(model_dir, rng)
        errors["combine"] = max(errors["combine"], long_context_err)
        print("long_context_export_phases: " + json.dumps({"secs": time.perf_counter() - t_long,
                                                            "card": card_line()}))
        clock.mark("long_context_export_phases")
        nasnet_counts, _ = train_nasnet(model_dir)
        clock.mark("train_nasnet")
        with deterministic_cudnn():
            resume_counts, _ = resume_nasnet(model_dir)
        clock.mark("resume_nasnet")
        gate_counts, _, gate_shapes = nasnet_gate(model_dir)
        clock.mark("nasnet_gate")
        _, parity_cases = nasnet_train_vs_cpu()
        clock.mark("nasnet_train_vs_cpu")
        with deterministic_cudnn():
            windows_vs_steps(model_dir)
        clock.mark("windows_vs_steps")
        gate_bf16_counts, _, _ = nasnet_gate(model_dir, "nasnet_gate_bf16", step_compute_dtype="bfloat16",
                                             prefetch_buffer=2, prefetch_to_device=True)
        clock.mark("nasnet_gate_bf16")
        mobile_counts, _, mobile_cases = train_nasnet_mobile(model_dir, args.seed)
        for n in SEARCH_COMBINE_MEMBERS:
            check_search_combine(n, False, rng, batch=MOBILE_BATCH, classes=MOBILE_CLASSES)
        clock.mark("train_nasnet_mobile")
        train_cases = (
            {(shape, NASNET_BATCH, "bfloat16") for shape in sep_shapes}
            | {(shape, TRAIN_BATCH, "bfloat16") for shape in gate_shapes}
            | {(shape, batch, "float32") for shape, batch in parity_cases}
            | {(shape, batch, "bfloat16") for shape, batch in mobile_cases}
        )
        train_errors = check_train_sepconv(train_cases, rng)
        errors["sepconv"] = max(errors["sepconv"], train_errors["forward_float32"], train_errors["forward_bfloat16"])
        clock.mark("check_train_sepconv")
        trainer_on_card()
        profile_batch(served_program, rng)
        compare_with_cpu(args.seed, rng)
        clock.mark("trainer_profile_compare")
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
            kernels[-1]["selection_launches"] = selection_counts["combine"]
            kernels[-1]["multi_head_launches"] = multi_head_counts["multi_head"]["combine"]
            kernels[-1]["multi_label_launches"] = multi_head_counts["multi_label"]["combine"]
            kernels[-1]["full_gate_launches"] = full_gate_counts["combine"]
            kernels[-1]["cnn_launches"] = cnn_counts["combine"]
            kernels[-1]["bagging_launches"] = autoensemble_counts["bagging"]["combine"]
            kernels[-1]["transfer_launches"] = autoensemble_counts["transfer"]["combine"]
            kernels[-1]["boston_launches"] = autoensemble_counts["boston"]["combine"]
            kernels[-1]["replay_launches"] = replay_counts["combine"]
            kernels[-1]["cifar10_launches"] = cifar_counts["cifar10"]["combine"]
            kernels[-1]["cifar100_launches"] = cifar_counts["cifar100"]["combine"]
            kernels[-1]["imagenet_ae_launches"] = imagenet_counts["combine"]
            kernels[-1]["imagenet_round_robin_launches"] = rr_imagenet_counts["combine"]
            kernels[-1]["round_robin_search_launches"] = rr_search_counts["combine"]
            kernels[-1]["round_robin_gate_launches"] = rr_gate_counts["combine"]
            kernels[-1]["spmd_two_process_launches"] = [c["combine"] for c in spmd_launches]
            kernels[-1]["multihost_round_robin_launches"] = elastic_launches["multihost"]
            kernels[-1]["elastic_search_launches"] = elastic_launches["elastic"]
            kernels[-1]["elastic_two_process_launches"] = elastic_launches["two_process"]
            kernels[-1]["speculation_launches"] = elastic_launches["speculation"]
            kernels[-1]["long_context_launches"] = long_context_launches["long_context"]
            kernels[-1]["transformer_full_width_launches"] = long_context_launches["transformer_full_width"]
            kernels[-1]["export_programs_launches"] = long_context_launches["export_programs"]
            kernels[-1]["serve_while_search_launches"] = long_context_launches["serve_while_search"]
            kernels[-1]["serving_example_launches"] = long_context_launches["serving_example"]
            kernels[-1]["serve_while_search_searcher_launches"] = long_context_launches[
                "serve_while_search_searcher"]
            kernels[-1]["store_warm_start_launches"] = warm_start["graft"]["launches"]["combine"]
        if name in ("copy", "combine", "sepconv"):
            kernels[-1]["canary_flip_launches"] = canary_counts[name]
            kernels[-1]["canary_window_launches"] = canary_row["window_launches"][name]
        if name == "sepconv":
            kernels[-1]["train_launches"] = nasnet_counts["sepconv"]
            kernels[-1]["nasnet_gate_launches"] = gate_counts["sepconv"]
            kernels[-1]["resume_launches"] = resume_counts["sepconv"]
            kernels[-1]["nasnet_gate_bf16_launches"] = gate_bf16_counts["sepconv"]
            kernels[-1]["nasnet_mobile_launches"] = mobile_counts["sepconv"]
            kernels[-1]["cifar10_launches"] = cifar_counts["cifar10"]["sepconv"]
            kernels[-1]["cifar100_launches"] = cifar_counts["cifar100"]["sepconv"]
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
    print("phase_secs: " + clock.line())
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
