"""Tests of the training slice that need an NVIDIA card (marked `cuda`;
they skip without one). Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

This file imports no jax, which the card's machine does not have, and
`--noconftest` keeps pytest from loading tests/conftest.py, which does.

- A few search steps with the fused combine on the card (K1 forward
  under autograd, its plain backward) against the same steps on the CPU,
  within atol 1e-4 x max(1, |value|), and one K1 launch per candidate a
  step.
- K2's gradient through `_FusedSepConv` against plain autograd.
"""

import pytest
import torch

from adanet_tpu_torch import ops
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.core.iteration import IterationBuilder
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples import simple_dnn
from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset
from adanet_tpu_torch.ops import sepconv_kernels as sk
from adanet_tpu_torch.utils import convert

from torch_port_common import require_cuda


def _adam(params):
    return torch.optim.Adam(params, lr=1e-3, eps=1e-8)


def _steps(device, batches):
    factory = IterationBuilder(
        MultiClassHead(10), [ComplexityRegularizedEnsembler(optimizer=_adam, use_fused_combine=True)],
        [GrowStrategy()], device=device,
    )
    builders = simple_dnn.Generator(optimizer_fn=_adam, layer_size=32, initial_num_layers=1).generate_candidates(
        None, 0, [], []
    )
    for i, builder in enumerate(builders):
        builder.initial_variables = convert.convert_simple_dnn(
            convert.simple_dnn_variables(builder._num_layers, 32, 256, 10, seed=i)
        )
    iteration = factory.build_iteration(0, builders, input_shape=(256,))
    state = iteration.init_state(torch.Generator().manual_seed(0), batches[0])
    trace = []
    for batch in batches:
        state, metrics = iteration.train_step(state, batch)
        trace.append({k: float(v) for k, v in metrics.items()})
    return trace, iteration.best_candidate_index(state)


@pytest.mark.cuda
def test_fused_search_steps_on_the_card_match_the_cpu():
    require_cuda()
    x, y = make_dataset(10 * 64, seed=3)
    batches = list(input_fn(x, y, 64)())
    ops.reset_launch_counts()
    card, card_best = _steps("cuda", batches)
    assert ops.launch_counts()["combine"] == 2 * len(batches)
    cpu, cpu_best = _steps("cpu", batches)
    assert card_best == cpu_best
    for got, want in zip(card, cpu):
        for key, value in want.items():
            assert abs(got[key] - value) <= 1e-4 * max(1.0, abs(value)), (key, got[key], value)


@pytest.mark.cuda
def test_sepconv_gradient_on_the_card():
    require_cuda()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 16, 64, generator=gen).cuda()
    dw = (torch.randn(64, 1, 5, 5, generator=gen) / 5).cuda()
    pw = (torch.randn(64, 64, 1, 1, generator=gen) / 8).cuda()
    torch.backends.cudnn.allow_tf32 = False
    grads = []
    for fn in (sk.fused_sep_conv, sk.sep_conv_reference):
        inputs = [t.clone().requires_grad_(True) for t in (x, dw, pw)]
        out = fn(*inputs, 2)
        grads.append(torch.autograd.grad(out.square().sum(), inputs))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * max(1.0, float(want.abs().max())))
