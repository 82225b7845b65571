"""One process of ring attention across processes (form (b)).

    python tests/torch_ring_runner.py OUT_DIR RANK SHARDS PORT [cpu|cuda] [float32|bfloat16] [causal|full] [B,S,H,D]

Every process draws the same q, k, v ([2, 32, 4, 8] unless given, from
numpy seed 0), joins the gloo group of SHARDS
processes (store on 127.0.0.1:PORT, served by rank 0), runs
`ring_attention` over it, and differentiates sum(out ** 2). Rank 0
writes the output, the three gradients and the mesh's stats to
OUT_DIR/ring.npz and OUT_DIR/ring.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from adanet_tpu_torch.parallel import SequenceMesh, ring_attention  # noqa: E402


def inputs(shape, dtype, device):
    rng = np.random.RandomState(0)
    return [torch.tensor(rng.randn(*shape), dtype=torch.float32).to(device, dtype).requires_grad_(True)
            for _ in range(3)]


def main(argv):
    out_dir, rank, shards, port = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    device = argv[4] if len(argv) > 4 else "cpu"
    dtype = getattr(torch, argv[5] if len(argv) > 5 else "float32")
    causal = (argv[6] if len(argv) > 6 else "causal") == "causal"
    shape = tuple(int(d) for d in argv[7].split(",")) if len(argv) > 7 else (2, 32, 4, 8)
    mesh = SequenceMesh.connect("127.0.0.1:%d" % port, shards, rank, timeout_secs=120)
    q, k, v = inputs(shape, dtype, device)
    times = []
    for _ in range(3 if device == "cuda" else 1):
        mesh.reset_stats()
        t0 = time.perf_counter()
        out = ring_attention(q, k, v, mesh, causal=causal)
        grads = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
        if device == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if rank == 0:
        np.savez(os.path.join(out_dir, "ring.npz"), out=out.float().detach().cpu().numpy(),
                 **{"d" + n: g.float().cpu().numpy() for n, g in zip("qkv", grads)})
        with open(os.path.join(out_dir, "ring.json"), "w") as f:
            json.dump(dict(mesh.stats, ms=times[-1], ms_first=times[0], shape=list(shape)), f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
