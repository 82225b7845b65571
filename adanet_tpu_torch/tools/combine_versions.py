"""K1, the mixture combine, of one version of the port, timed so that two
versions can be compared on one card.

    python3 adanet_tpu_torch/tools/combine_versions.py --root DIR [--tag NAME] [--seed N]

Imports `adanet_tpu_torch` from DIR (a checkout of any version of the
port, such as an earlier commit unpacked with `git archive`), builds its
kernels and times its K1 through `fused_weighted_combine(stacked, w,
bias)`, the entry point every version has, on f32 inputs made from a
seeded generator (the same in every version): at the served [2, 32, 10]
and [2, 1, 10] (scalar weights, no bias) and at the byte-bound [4, 4096,
1001] (scalar weights without bias, vector weights with a bias). Per
shape: device us per call from torch.profiler (the sum of the call's
kernels), device us from CUDA events around calls queued behind a sleep
kernel, CUDA-event ms and host enqueue us per call, and the max abs error
against a plain f32 sum (the call fails above 1e-5 x max(1, max|ref|)).
Where the version has them, also the members' entry point on the same
logits as separate tensors, and on members placed one element off 16
bytes, which takes the kernel's scalar variant (one element a thread).
Then the served combine: `ComplexityRegularizedEnsembler.build_ensemble`
with the fused combine, scalar weights and two f32 members of [32, 10]
and [1, 10], called inside `torch.inference_mode` as the served program
calls it: the same timings over every kernel the call launches, and
those kernels by name and count.

The timing helpers are `chip_smoke.py`'s, from the checkout that holds
this file. Run one process per version, in the order A, B, B, A, to
compare two versions on one card. Prints one line `combine_versions:
{json}`. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import types

HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (N, B, C, vector weights and bias): the shapes of PERF.md's K1 rows
# that every version takes (f32 logits).
CASES = (
    (2, 32, 10, False),
    (2, 1, 10, False),
    (4, 4096, 1001, False),
    (4, 4096, 1001, True),
)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "combine_versions_chip_smoke", os.path.join(HERE_ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _offset_members(members, offset):
    """The members copied into one buffer, each starting `offset`
    elements past a 16-byte boundary."""
    import torch

    n, (b, c) = len(members), members[0].shape
    buf = torch.empty(n, b * c + offset, dtype=members[0].dtype, device=members[0].device)
    for i, m in enumerate(members):
        buf[i, offset:] = m.reshape(-1)
    return [buf[i, offset:].view(b, c) for i in range(n)]


def time_version(seed: int):
    import torch

    from adanet_tpu_torch.ops import ensemble_kernels as ek

    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for n, b, c, vector in CASES:
        members = [torch.randn(b, c, generator=gen).cuda() for _ in range(n)]
        w = torch.randn((n, c) if vector else (n,), generator=gen).cuda()
        bias = torch.randn(c, generator=gen).cuda() if vector else None
        stacked = torch.stack(members)
        want = (stacked * (w[:, None, :] if vector else w[:, None, None])).sum(0)
        if bias is not None:
            want = want + bias
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        calls = {"stacked": lambda: ek.fused_weighted_combine(stacked, w, bias)}
        if hasattr(ek, "fused_weighted_combine_members"):
            misaligned = _offset_members(members, 1)
            calls["members"] = lambda: ek.fused_weighted_combine_members(members, w, bias)
            calls["members_scalar_variant"] = (
                lambda: ek.fused_weighted_combine_members(misaligned, w, bias))
        big = b * c > 1 << 16
        row = dict(shape=[n, b, c], weights="vector" if vector else "scalar", bias=vector)
        for form, fn in calls.items():
            err = float((fn().float() - want).abs().max())
            if not err <= tol:
                raise AssertionError("%s %s: max abs err %g > %g" % (form, row, err, tol))
            device, by_name, source = cs.device_ms(fn, calls=10, expect="combine_kernel")
            row[form] = dict(
                max_abs_err=err,
                device_us=device * 1e3, device_source=source, kernels=sorted(by_name),
                queued_device_us=cs.queued_device_ms(fn) * 1e3,
                ms=cs.cuda_time_ms(fn, iters=50 if big else 100),
                host_us=cs.host_enqueue_us(fn, calls=200 if big else 1000),
            )
        rows.append(row)
    rows += time_served_combine(cs, gen)
    return rows


def _kernel_counts(fn):
    """Device kernels of one call of `fn`, by name: count."""
    import collections

    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return dict(collections.Counter(
        event.name.split("(")[0][:60] for event in prof.events()
        if getattr(event, "device_type", None) == torch.autograd.DeviceType.CUDA))


def time_served_combine(cs, gen):
    import torch

    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler

    ensembler = ComplexityRegularizedEnsembler(use_fused_combine=True)
    params = {"weights": [torch.tensor(0.6).cuda(), torch.tensor(0.4).cuda()], "bias": None}
    rows = []
    for b in (32, 1):
        outs = [types.SimpleNamespace(logits=torch.randn(b, 10, generator=gen).cuda()) for _ in range(2)]
        want = 0.6 * outs[0].logits + 0.4 * outs[1].logits

        def fn():
            with torch.inference_mode():
                return ensembler.build_ensemble(params, outs).logits

        err = float((fn() - want).abs().max())
        if not err <= 1e-5 * max(1.0, float(want.abs().max())):
            raise AssertionError("served combine at [2, %d, 10]: max abs err %g" % (b, err))
        device, _, source = cs.device_ms(fn, calls=10, expect="combine_kernel")
        rows.append(dict(
            shape=[2, b, 10], weights="scalar", bias=False,
            served_combine=dict(
                max_abs_err=err, device_us=device * 1e3, device_source=source,
                kernels=_kernel_counts(fn), queued_device_us=cs.queued_device_ms(fn) * 1e3,
                ms=cs.cuda_time_ms(fn, iters=100), host_us=cs.host_enqueue_us(fn, calls=1000),
            ),
        ))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", required=True, help="checkout whose adanet_tpu_torch to time")
    parser.add_argument("--tag", default="", help="name of the version in the output line")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("combine_versions: no CUDA card", file=sys.stderr)
        return 1
    import adanet_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(adanet_tpu_torch.__file__))) != root:
        raise RuntimeError("adanet_tpu_torch came from %s, not %s" % (adanet_tpu_torch.__file__, root))
    rows = time_version(args.seed)
    print("combine_versions: " + json.dumps(dict(tag=args.tag, root=args.root, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
