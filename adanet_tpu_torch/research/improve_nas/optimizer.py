"""Optimizers and learning-rate schedules keyed by name, as optax has them.

Port of research/improve_nas/trainer/optimizer.py, whose optimizers are
optax's: `fn_with_name(name, schedule, cosine_decay_steps)` returns
`optimizer_fn(learning_rate) -> Rule`, a rule (adagrad, adam, momentum,
rmsprop or sgd) at optax's defaults with a constant or cosine learning
rate. `Chain` is the `torch.optim.Optimizer` that applies a rule after
optax's gradient transforms, in optax's order:

1. `clip_by_global_norm`: g <- g / |g| * clip_norm when the global norm
   |g| over every parameter reaches clip_norm (optax divides by the
   norm, not by norm + 1e-6 as `torch.nn.utils.clip_grad_norm_` does);
2. `add_decayed_weights`: g <- g + weight_decay * p on the parameters
   the mask selects (coupled L2, after clipping; not AdamW);
3. the rule, whose learning rate is the schedule at the rule's own
   update count; an update that is not applied (a skipped step) does
   not advance it. The count is an int32 tensor on the parameters'
   device and the schedule is computed from it there in f32, as optax
   computes it, so that an update reads nothing on the host and the
   train step's guard (`core/iteration.py`) keeps or drops the count
   with the rest; `state_dict` holds it as an int.

The rules follow optax, not torch's defaults: adagrad starts its sum of
squares at 0.1 and adds eps 1e-7 under the root; rmsprop decays by 0.9
and takes rsqrt(nu + 1e-8); adam adds eps 1e-8 outside the root;
momentum is `optax.sgd(momentum=0.9)` (no nesterov, no dampening). A
rule's `eps`, `initial_scale` and `momentum` (rmsprop only,
`rmsprop(...)`) take optax's `rmsprop` arguments: nu starts at
`initial_scale`, the update is g * rsqrt(nu + eps) with eps inside the
root, and with `momentum` optax's `trace` runs after the learning rate,
`t <- momentum * t - lr * g * rsqrt(nu + eps)` and p <- p + t
(`chain(scale_by_rms, scale_by_learning_rate, trace)`), where
`torch.optim.RMSprop` starts nu at 0, adds eps outside the root and
applies the learning rate after its momentum. The slots are made at
their initial values when the optimizer is. Every
update is a few multi-tensor (`torch._foreach_*`) operations over all
parameters, computed on the device without a host read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional, Sequence

import torch

#: optax's defaults.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAGRAD_INITIAL, ADAGRAD_EPS = 0.1, 1e-7
RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-8
MOMENTUM = 0.9
RULES = ("adagrad", "adam", "momentum", "rmsprop", "sgd")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One of optax's optimizers (`name` in `RULES`) at its defaults, with
    its learning rate as a function of its update count (a 0-d tensor)
    returning a 0-d f32 tensor on the count's device."""

    name: str
    learning_rate: Callable[[torch.Tensor], torch.Tensor]
    eps: float = RMSPROP_EPS
    initial_scale: float = 0.0
    momentum: Optional[float] = None


def rmsprop(
    learning_rate: float,
    eps: float = RMSPROP_EPS,
    initial_scale: float = 0.0,
    momentum: Optional[float] = None,
) -> Rule:
    """`optax.rmsprop(learning_rate, decay=0.9, eps=eps,
    initial_scale=initial_scale, momentum=momentum)` at a constant
    learning rate."""
    return Rule("rmsprop", constant_schedule(learning_rate), eps=eps, initial_scale=initial_scale, momentum=momentum)


def constant_schedule(value: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda count: torch.full((), value, dtype=torch.float32, device=torch.as_tensor(count).device)


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """`optax.cosine_decay_schedule` at alpha=0, in float32 on the
    count's device, in optax's order of operations."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got %r." % (decay_steps,))

    def schedule(count) -> torch.Tensor:
        count = torch.clamp(torch.as_tensor(count), max=decay_steps).to(torch.float32)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * count / float(decay_steps)))
        return init_value * cosine

    return schedule


def fn_with_name(
    optimizer_name: str,
    learning_rate_schedule: str = "constant",
    cosine_decay_steps: Optional[int] = None,
) -> Callable[[float], Rule]:
    """Returns `optimizer_fn(learning_rate) -> Rule` (reference:
    optimizer.py:83-131): the cosine schedule decays over
    `cosine_decay_steps` to alpha=0."""
    name = optimizer_name.lower()
    if name not in RULES:
        raise ValueError("Invalid optimizer '{}'".format(optimizer_name))
    schedule_name = learning_rate_schedule.lower()
    if schedule_name not in ("constant", "cosine"):
        raise ValueError("Invalid learning_rate_schedule '{}'".format(learning_rate_schedule))
    if schedule_name == "cosine" and not cosine_decay_steps:
        raise ValueError("cosine schedule requires cosine_decay_steps.")

    def optimizer_fn(learning_rate: float) -> Rule:
        if schedule_name == "cosine":
            return Rule(name, cosine_decay_schedule(learning_rate, cosine_decay_steps))
        return Rule(name, constant_schedule(learning_rate))

    return optimizer_fn


#: Each rule's slots and their initial values.
_SLOTS = {
    "momentum": (("trace", 0.0),),
    "adam": (("mu", 0.0), ("nu", 0.0)),
    "adagrad": (("sum_of_squares", ADAGRAD_INITIAL),),
    "rmsprop": (("nu", 0.0),),
}


def _slot_specs(rule: Rule):
    """(slot, initial value) pairs of `rule`."""
    if rule.name != "rmsprop":
        return _SLOTS.get(rule.name, ())
    return (("nu", rule.initial_scale),) + ((("trace", 0.0),) if rule.momentum is not None else ())


class Chain(torch.optim.Optimizer):
    """optax.chain(clip_by_global_norm(clip_norm), add_decayed_weights(
    weight_decay, mask), rule) on `params`; `decay_mask[i]` says whether
    parameter i is decayed (none is when it is None). A non-positive
    `clip_norm` or `weight_decay` leaves that transform out, as the JAX
    builder does. The update count is `param_groups[0]["count"]`, an
    int32 tensor."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        rule: Rule,
        decay_mask: Optional[Sequence[bool]] = None,
        clip_norm: float = 0.0,
        weight_decay: float = 0.0,
    ):
        params = list(params)
        if rule.name not in RULES:
            raise ValueError("Invalid optimizer '{}'".format(rule.name))
        if rule.momentum is not None and rule.name != "rmsprop":
            raise ValueError("a rule's momentum is rmsprop's; use the 'momentum' rule")
        super().__init__(params, dict(count=0))
        self.param_groups[0]["count"] = self._count(0)
        self.rule = rule
        self.clip_norm = float(clip_norm)
        self.weight_decay = float(weight_decay)
        if decay_mask is None:
            decay_mask = [False] * len(params)
        if len(decay_mask) != len(params):
            raise ValueError("decay_mask has %d entries for %d parameters" % (len(decay_mask), len(params)))
        self._decayed = [i for i, keep in enumerate(decay_mask) if keep]
        for key, init in _slot_specs(rule):
            self._slots(key, params, init)

    def _count(self, value: int) -> torch.Tensor:
        params = self.param_groups[0]["params"]
        return torch.tensor(int(value), dtype=torch.int32, device=params[0].device if params else None)

    def state_dict(self):
        """torch's `state_dict`, the count as an int."""
        out = super().state_dict()
        for group in out["param_groups"]:
            group["count"] = int(group["count"])
        return out

    def load_state_dict(self, state_dict) -> None:
        """torch's `load_state_dict`, the count back on the device."""
        super().load_state_dict(state_dict)
        self.param_groups[0]["count"] = self._count(self.param_groups[0]["count"])

    def _slots(self, key: str, params, init: float):
        out = []
        for p in params:
            state = self.state[p]
            if key not in state:
                state[key] = torch.full_like(p, init, memory_format=torch.preserve_format)
            out.append(state[key])
        return out

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Chain takes no closure")
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if self.clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            keep = norm < self.clip_norm
            one = torch.ones_like(norm)
            # where(keep, g, g / norm * clip_norm), as optax's select.
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, self.clip_norm)))
        if self.weight_decay > 0 and self._decayed:
            torch._foreach_add_(
                [grads[i] for i in self._decayed], [params[i] for i in self._decayed], alpha=self.weight_decay
            )
        count = group["count"]
        name = self.rule.name
        if name == "sgd":
            updates = grads
        elif name == "momentum":
            updates = self._slots("trace", params, 0.0)
            torch._foreach_mul_(updates, MOMENTUM)
            torch._foreach_add_(updates, grads)
        elif name == "adam":
            mu = self._slots("mu", params, 0.0)
            nu = self._slots("nu", params, 0.0)
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
            # optax's bias corrections, 1 - b ** (count + 1), in f32.
            t = (count + 1).to(torch.float32)
            bc1 = 1.0 - torch.pow(torch.full_like(t, ADAM_B1), t)
            bc2 = 1.0 - torch.pow(torch.full_like(t, ADAM_B2), t)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            updates = torch._foreach_div(mu, bc1)
            torch._foreach_div_(updates, denom)
        else:
            if name == "adagrad":
                acc = self._slots("sum_of_squares", params, ADAGRAD_INITIAL)
                torch._foreach_addcmul_(acc, grads, grads)
                eps = ADAGRAD_EPS
            else:  # rmsprop
                acc = self._slots("nu", params, self.rule.initial_scale)
                torch._foreach_mul_(acc, RMSPROP_DECAY)
                torch._foreach_addcmul_(acc, grads, grads, value=1.0 - RMSPROP_DECAY)
                eps = self.rule.eps
            scale = torch._foreach_add(acc, eps)
            torch._foreach_sqrt_(scale)
            torch._foreach_reciprocal_(scale)
            updates = torch._foreach_mul(scale, grads)
        # optax's scale_by_learning_rate, then apply_updates.
        updates = torch._foreach_mul(updates, -self.rule.learning_rate(count))
        if self.rule.momentum is not None:
            # optax's trace after the learning rate (optax.rmsprop's momentum).
            trace = self._slots("trace", params, 0.0)
            torch._foreach_mul_(trace, self.rule.momentum)
            torch._foreach_add_(trace, updates)
            updates = trace
        torch._foreach_add_(params, updates)
        group["count"] = count + 1
