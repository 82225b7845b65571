"""Candidate tracking: EMA of each ensemble candidate's AdaNet loss.

Port of adanet_tpu/core/candidate.py. Each ensemble candidate's
`adanet_loss` is tracked as a zero-debiased exponential moving average,
and the best candidate is the argmin of the EMAs. A candidate whose loss
goes non-finite is quarantined ("dead") and excluded from selection. The
state is 0-d tensors on the training device, updated without a host
sync.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CandidateState:
    """Per-candidate moving-average state, updated every train step."""

    ema_biased: torch.Tensor  # decay-weighted sum (before zero-debias)
    ema_count: torch.Tensor  # number of EMA updates applied
    adanet_loss: torch.Tensor  # last raw adanet loss
    dead: torch.Tensor  # True once the loss went non-finite


def initial_candidate_state(device=None, initial_ema=None, decay: float = 0.9) -> CandidateState:
    """A fresh state, or, with a finite `initial_ema`, one seeded to read
    it back as its EMA (the carried-over previous ensemble's frozen
    loss)."""
    if initial_ema is not None:
        return CandidateState(
            ema_biased=torch.tensor(initial_ema * (1.0 - decay), dtype=torch.float32, device=device),
            ema_count=torch.tensor(1, dtype=torch.int32, device=device),
            adanet_loss=torch.tensor(initial_ema, dtype=torch.float32, device=device),
            dead=torch.tensor(False, device=device),
        )
    return CandidateState(
        ema_biased=torch.tensor(0.0, dtype=torch.float32, device=device),
        ema_count=torch.tensor(0, dtype=torch.int32, device=device),
        adanet_loss=torch.tensor(float("inf"), dtype=torch.float32, device=device),
        dead=torch.tensor(False, device=device),
    )


def update_candidate_state(state: CandidateState, adanet_loss, decay: float) -> CandidateState:
    """One EMA update, with non-finite quarantine."""
    adanet_loss = adanet_loss.detach().to(torch.float32)
    dead = state.dead | ~torch.isfinite(adanet_loss)
    update = ~dead
    biased = torch.where(
        update, decay * state.ema_biased + (1.0 - decay) * adanet_loss, state.ema_biased
    )
    return CandidateState(
        ema_biased=biased,
        ema_count=state.ema_count + update.to(torch.int32),
        adanet_loss=torch.where(update, adanet_loss, state.adanet_loss),
        dead=dead,
    )


def debiased_ema(state: CandidateState, decay: float) -> torch.Tensor:
    """Zero-debiased EMA value; +inf when never updated or dead."""
    debiased = state.ema_biased / (1.0 - torch.pow(decay, state.ema_count.to(torch.float32)))
    live = (state.ema_count > 0) & ~state.dead
    return torch.where(live, debiased, torch.full_like(debiased, float("inf")))
