"""`adanet_tpu_torch.tools.profile_nasnet` on the CPU: the aggregation of
a `torch.profiler` Chrome trace written here (its CPU events ignored, the
card's kernel, copy and set events summed by category and by kernel), the
categories of the kernels' names, the count of sep-conv forwards against
the fused sep-conv's calls in one step of a small NASNet-A, and the
refusal to profile without a card."""

import argparse
import json

import numpy as np
import pytest
import torch

from adanet_tpu_torch.tools import profile_nasnet
from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def test_aggregation_reads_a_profiler_trace(tmp_path):
    a = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        (a @ a).relu().sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    assert profile_nasnet.aggregate_trace(path)[0] == 0.0  # host events only
    doc = json.load(open(path))
    assert any(e.get("cat") == "cpu_op" for e in doc["traceEvents"])
    device = [("void (anonymous namespace)::sepconv_kernel<__nv_bfloat16, 3, 1>(Plan, int)", "kernel", 5.0),
              ("void (anonymous namespace)::sepconv_kernel<__nv_bfloat16, 3, 1>(Plan, int)", "kernel", 7.0),
              ("void (anonymous namespace)::combine_kernel<float, 4>(Plan)", "kernel", 2.0),
              ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n", "kernel", 11.0),
              ("void at::native::vectorized_elementwise_kernel<4, ReluFunctor>", "kernel", 3.0),
              ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1.5),
              ("Memset (Device)", "gpu_memset", 0.5)]
    for i, (name, cat, dur) in enumerate(device):
        doc["traceEvents"].append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 10.0 * i,
                                   "dur": dur})
    json.dump(doc, open(path, "w"))
    total, by_cat, by_kernel, launches = profile_nasnet.aggregate_trace(path)
    assert total == pytest.approx(30.0)
    assert by_cat == {"K2 sepconv_kernel": 12.0, "K1 combine_kernel": 2.0, "gemm": 11.0, "elementwise": 3.0,
                      "memcpy": 1.5, "memset": 0.5}
    assert by_kernel["void (anonymous namespace)::sepconv_kernel<__nv_bfloat16, 3, 1>(Plan, int)"] == 12.0
    assert launches["void (anonymous namespace)::sepconv_kernel<__nv_bfloat16, 3, 1>(Plan, int)"] == 2


@pytest.mark.parametrize("name,category", [
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<float>", "convolution (cuDNN)"),
    ("void at::native::reduce_kernel<512, 1>", "reduction"),
    ("void (anonymous namespace)::sep_layer_kernel<__nv_bfloat16>(Step)", "K3 cell kernels"),
    ("copy_bytes_kernel(void const*, void*, long)", "K0 copy_bytes_kernel"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>", "elementwise"),
    ("void at::native::batch_norm_collect_statistics_kernel", "batch norm"),
    ("something_else", "other"),
])
def test_categories(name, category):
    assert profile_nasnet.categorize(name) == category


def test_sepconv_forwards_count_the_fused_calls(monkeypatch):
    from adanet_tpu_torch.models import nasnet

    calls = [0]
    fused = nasnet.fused_sep_conv

    def counted(*args, **kwargs):
        calls[0] += 1
        return fused(*args, **kwargs)

    monkeypatch.setattr(nasnet, "fused_sep_conv", counted)
    args = argparse.Namespace(batch=2, cells=3, filters=4, pallas_sepconv=True)
    step, modules = profile_nasnet.build_step(args, device="cpu")
    seen = {}
    for module in profile_nasnet.sepconv_modules(modules):
        module.register_forward_hook(lambda m, i, o: seen.__setitem__(m, seen.get(m, 0) + 1))
    calls[0] = 0
    metrics = step()
    assert all(np.isfinite(float(v)) for v in metrics.values() if torch.is_tensor(v) and v.dim() == 0)
    forwards = sum(n * len(m.launch_shapes()) for m, n in seen.items())
    assert forwards == calls[0] > 0


def test_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_nasnet.main(["--steps", "1"])
