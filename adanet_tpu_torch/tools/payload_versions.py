"""Times two forms of a NASNet-A training state's checkpoint payload.

    python3 -m adanet_tpu_torch.tools.payload_versions [--pairs 6] \\
        [--num_cells 18] [--num_conv_filters 32] [--device cuda]

Builds a NASNet-A subnetwork (6@768 CIFAR by default) and its momentum
`Chain`, takes one training step so that every optimizer slot exists,
and times its `state_dict`s as a checkpoint payload in two forms:

- `packed`: `checkpoint.plain`, the form the port saves (the tensors of
  one device and dtype in one buffer, one copy to the host);
- `per_tensor`: one non-blocking copy to the host per tensor, then one
  synchronize.

For each: device-to-host ms, `checkpoint.to_bytes` ms, decode ms
(`torch.load(weights_only=True)`) and load ms (`load_state_dict` of the
module and the optimizer, synchronized), all by the host clock. The
forms alternate (packed, per_tensor, per_tensor, packed, ...), so that
both see the same machine. Prints `payload_versions: {json}` with each
form's medians, the pairs each form won, and every run.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

import torch

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.core import checkpoint as ckpt
from adanet_tpu_torch.research.improve_nas import improve_nas, optimizer

PARTS = ("device_to_host", "serialise", "decode", "load")


def per_tensor(tree):
    """One non-blocking host copy per tensor, then one synchronize."""

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(value) for value in node)
        return node.detach().to("cpu", non_blocking=True) if torch.is_tensor(node) else node

    out = walk(tree)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out


def trained_state(num_cells, num_conv_filters, device):
    """A NASNet-A subnetwork and its `Chain` after one training step."""
    hparams = improve_nas.Hparams(num_cells=num_cells, num_conv_filters=num_conv_filters)
    builder = improve_nas.Builder(optimizer.fn_with_name("momentum", "cosine", cosine_decay_steps=10), hparams)
    module = builder.build_subnetwork(10, input_shape=(32, 32, 3))
    module.init_parameters(torch.Generator().manual_seed(0))
    module.to(device)
    opt = builder.build_train_optimizer()(list(module.named_parameters()))
    images = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(1)).to(device)
    out = module(images, training=True, generator=torch.Generator(device=device).manual_seed(2))
    (out.logits.float().square().mean() + out.extras["aux_logits"].float().square().mean()).backward()
    opt.step()
    return module, opt


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--pairs", type=int, default=6, help="runs of each form")
    parser.add_argument("--num_cells", type=int, default=18)
    parser.add_argument("--num_conv_filters", type=int, default=32)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    module, opt = trained_state(args.num_cells, args.num_conv_filters, device)
    state = {"module": module.state_dict(), "optimizer": opt.state_dict()}
    forms = {"packed": ckpt.plain, "per_tensor": per_tensor}
    runs = {name: [] for name in forms}
    for name in ["packed", "per_tensor", "per_tensor", "packed"] * ((args.pairs + 1) // 2):
        if len(runs[name]) == args.pairs:
            continue
        t0 = time.perf_counter()
        payload = forms[name](state)
        t1 = time.perf_counter()
        data = ckpt.to_bytes(payload)
        t2 = time.perf_counter()
        back = torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
        t3 = time.perf_counter()
        module.load_state_dict(back["module"])
        opt.load_state_dict(back["optimizer"])
        if device.type == "cuda":
            torch.cuda.synchronize()
        t4 = time.perf_counter()
        runs[name].append(dict(zip(PARTS, [(b - a) * 1e3 for a, b in ((t0, t1), (t1, t2), (t2, t3), (t3, t4))]),
                               bytes=len(data)))
    medians = {name: {part: sorted(r[part] for r in rows)[len(rows) // 2] for part in PARTS}
               for name, rows in runs.items()}
    packed_wins = {part: sum(p[part] < q[part] for p, q in zip(runs["packed"], runs["per_tensor"])) for part in PARTS}
    print("payload_versions: " + json.dumps(dict(
        device=str(device), pairs=args.pairs, medians=medians, packed_wins_of_pairs=packed_wins, runs=runs,
        card=torch.cuda.get_device_name(0) if device.type == "cuda" else None,
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
