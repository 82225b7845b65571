"""Shared tiny fleet configuration of the port's fleet tests and runner.

The port's counterpart of tests/fleet_common.py: one 2-trial fleet used
by the tier-1 fleet gate, the chaos runner, and the parent test's
oracle/resume runs, so "a SIGKILLed fleet resumes to the oracle fleet's
winner and champion architecture" is a meaningful assertion. It imports
no jax, so that `chip_smoke.py` runs the same fleet on the card; every
builder takes a `device` ("cpu" in the tests).

The two trials share the generator (`torch_port_common.dnn_builder`'s
"a" and "b", the port's `DNNBuilder`), seed, and step budget and differ
ONLY in adanet lambda/beta: `reg_lo` is unregularized, `reg_hi` is
heavily over-regularized. Under the fleet's uniform comparator `reg_lo`
wins deterministically — and `reg_hi` doubles as the "a-priori single
search" baseline config for the equal-budget gate.
"""

import torch

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import RegressionHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.fleet import Comparator, FleetController, TrialSpec
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

from torch_multihost_rr_runner import full_batches  # noqa: F401  (re-export)
from torch_port_common import dnn_builder

#: Per-iteration step budget and the cumulative rung schedule.
MAX_ITERATION_STEPS = 6
RUNGS = (1, 2)

#: Uniform comparator strengths (applied to every trial alike).
COMPARATOR_LAMBDA = 0.01
COMPARATOR_BETA = 0.001

#: The over-regularized baseline trial's strengths.
HI_LAMBDA = 2.0
HI_BETA = 0.5


def input_fn():
    return iter(full_batches())


def sgd(params):
    """The mixture weights' optimizer (fleet_common's `optax.sgd(0.05)`)."""
    return torch.optim.SGD(params, lr=0.05)


def _make_generator():
    return SimpleGenerator([dnn_builder("a", 1), dnn_builder("b", 2)])


def _trial(trial_id: str, adanet_lambda: float, adanet_beta: float):
    return TrialSpec(
        trial_id=trial_id,
        make_head=RegressionHead,
        make_generator=_make_generator,
        generator_id="tests.helpers/dnn_a1_b2",
        max_iteration_steps=MAX_ITERATION_STEPS,
        random_seed=42,
        adanet_lambda=adanet_lambda,
        adanet_beta=adanet_beta,
        make_ensembler_optimizer=lambda: sgd,
    )


def make_trials():
    return [
        _trial("reg_hi", HI_LAMBDA, HI_BETA),
        _trial("reg_lo", 0.0, 0.0),
    ]


def make_comparator(eval_steps: int = 4):
    return Comparator(
        input_fn,
        eval_steps=eval_steps,
        adanet_lambda=COMPARATOR_LAMBDA,
        adanet_beta=COMPARATOR_BETA,
    )


def build_fleet(work_dir: str, device="cpu", **kwargs) -> FleetController:
    defaults = dict(
        rung_iterations=RUNGS,
        survivor_fraction=0.5,
        comparator=make_comparator(),
        workers=1,
        device=device,
    )
    defaults.update(kwargs)
    return FleetController(
        make_trials(), input_fn, work_dir=work_dir, **defaults
    )


def build_single_search(model_dir: str, max_iterations: int, device="cpu", **kwargs):
    """The a-priori single search at the fleet's TOTAL step budget: the
    `reg_hi` config (what an operator would have launched without the
    fleet), trained for `max_iterations` iterations."""
    defaults = dict(
        head=RegressionHead(),
        subnetwork_generator=_make_generator(),
        max_iteration_steps=MAX_ITERATION_STEPS,
        ensemblers=[
            ComplexityRegularizedEnsembler(
                optimizer=sgd,
                adanet_lambda=HI_LAMBDA,
                adanet_beta=HI_BETA,
                use_fused_combine=True,
            )
        ],
        max_iterations=max_iterations,
        model_dir=model_dir,
        log_every_steps=0,
        device=device,
    )
    defaults.update(kwargs)
    return Estimator(**defaults)
