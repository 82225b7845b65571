"""Long-context AdaNet: transformer candidates with ring attention.

Port of adanet_tpu/examples/tutorials/long_context_ring_attention.py. An
AdaNet search whose candidates are transformer encoders reading
sequences cut into shards: attention runs as exact ring attention
(`adanet_tpu_torch/parallel/ring_attention.py`), the key/value blocks
coming round to each shard's queries.

The task is synthetic long-range retrieval: each sequence holds a marker
token whose POSITION decides the label (first quarter 0, third quarter
1), so the signal never sits near the sequence end and a model reading
only the last shard cannot shortcut. The search grows an ensemble of
1-layer and 2-layer transformer candidates, whose mixture weights
combine through K1.

`--devices N` runs the N shards one after another in this process (on
the card they share it). `--processes N` runs one shard a process
instead: the script starts N copies of itself, which join a gloo group
on a free local port and rotate the key/value blocks between them (each
process runs the same search on the same data; rank 0 prints).

Run: python -m adanet_tpu_torch.examples.tutorials.long_context_ring_attention [--device cpu]
"""

from __future__ import annotations

import argparse
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

VOCAB, MARKER = 64, 63


def make_batches(seed, num_batches, batch_size, seq_len):
    rng = np.random.RandomState(seed)

    def fn():
        for _ in range(num_batches):
            tokens = rng.randint(0, VOCAB - 1, size=(batch_size, seq_len))
            # The marker lands in the first or third quarter, never near
            # the sequence end, so the label must travel across the ring.
            labels = rng.randint(0, 2, size=(batch_size,))
            quarter = seq_len // 4
            for row, label in enumerate(labels):
                lo = 0 if label == 0 else 2 * quarter
                tokens[row, rng.randint(lo, lo + quarter)] = MARKER
            yield {"tokens": tokens}, labels.astype(np.int32)

    return fn


def _spawn(args, argv):
    """Starts one copy of this script a shard; returns rank 0's exit
    code after every copy has ended."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = [sys.executable, "-m", "adanet_tpu_torch.examples.tutorials.long_context_ring_attention"] + list(argv)
    procs = [
        subprocess.Popen(base + ["--rank", str(r), "--address", "127.0.0.1:%d" % port],
                         stdout=None if r == 0 else subprocess.DEVNULL)
        for r in range(args.processes)
    ]
    codes = [proc.wait(timeout=args.timeout) for proc in procs]
    if any(codes):
        raise SystemExit("a shard's process failed: exit codes %s" % codes)
    return 0


def build_estimator(args, sp_mesh, estimator_cls=None, compute_dtype=torch.float32):
    """The tutorial's search: 1- and 2-layer transformer candidates (dim
    64, 4 heads, `compute_dtype`, Adam 1e-3) over `sp_mesh`, the mixture
    weights through K1 (`use_fused_combine`), SGD 0.01."""
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.models.transformer import TransformerBuilder, TransformerConfig
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

    def candidate(num_layers):
        return TransformerBuilder(
            TransformerConfig(
                vocab_size=VOCAB, num_layers=num_layers, num_heads=4, model_dim=64, mlp_dim=128,
                max_seq_len=args.seq_len, compute_dtype=compute_dtype, sp_mesh=sp_mesh,
            ),
            optimizer=lambda params: torch.optim.Adam(params, lr=1e-3),
        )

    return (estimator_cls or Estimator)(
        head=MultiClassHead(n_classes=2),
        subnetwork_generator=SimpleGenerator([candidate(1), candidate(2)]),
        max_iteration_steps=args.max_steps // args.iterations or 1,
        max_iterations=args.iterations,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda params: torch.optim.SGD(params, lr=0.01),
                                                   use_fused_combine=True)],
        model_dir=args.model_dir or tempfile.mkdtemp(prefix="adanet_ring_"),
        log_every_steps=10,
        device=args.device,
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seq_len", type=int, default=512)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--max_steps", type=int, default=60)
    parser.add_argument("--iterations", type=int, default=2)
    parser.add_argument("--devices", type=int, default=8, help="sequence shards in this process")
    parser.add_argument("--processes", type=int, default=1, help="one sequence shard a process instead")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--address", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--timeout", type=float, default=1800.0, help=argparse.SUPPRESS)
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--device", default=None, help="the card by default; 'cpu' to run on the CPU")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.processes > 1 and args.rank is None:
        return _spawn(args, sys.argv[1:] if argv is None else argv)

    from adanet_tpu_torch.parallel import SequenceMesh

    shards = args.processes if args.rank is not None else args.devices
    if args.seq_len % shards != 0:
        raise SystemExit(
            "seq_len=%d must be divisible by the %d sequence shards; pick --seq_len or --devices accordingly."
            % (args.seq_len, shards)
        )
    if args.rank is not None:
        sp_mesh = SequenceMesh.connect(args.address, shards, args.rank)
        where = "%d processes" % shards
    else:
        sp_mesh = SequenceMesh(shards)
        where = "one process"
    device = torch.device(args.device or "cuda")
    print("ring attention over %d shards (%s, %s); seq_len=%d -> %d per shard"
          % (shards, where, device.type, args.seq_len, args.seq_len // shards))

    est = build_estimator(args, sp_mesh)
    t0 = time.perf_counter()
    est.train(make_batches(0, 10, args.batch_size, args.seq_len), max_steps=args.max_steps)
    train_secs = time.perf_counter() - t0
    metrics = est.evaluate(make_batches(1, 4, args.batch_size, args.seq_len))
    print("accuracy: %.3f | loss: %.4f | best: %s"
          % (metrics["accuracy"], metrics["average_loss"], metrics["best_ensemble"]))
    print("OK: long-context search with ring attention")
    metrics.update(train_secs=train_secs, estimator=est, sp_stats=dict(sp_mesh.stats))
    return metrics


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
