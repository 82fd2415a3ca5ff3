"""Advanced-objective attacks: feature-level and logit-level losses
(counterpart of ``transferattack_tpu/advanced_objective/``)."""
from __future__ import annotations

import dataclasses

import torch


def objective_loop(atk, x, y, gen, loss_fn, use_momentum: bool = False, sign: float = 1.0):
    """``atk.epoch`` steps of ``atk.update_delta`` along ``sign`` times the
    gradient of ``loss_fn(delta, state)`` w.r.t. delta, or along ``sign``
    times its momentum; returns the final delta (the loop JAX writes out in
    each of these attacks' ``run``)."""
    state = atk.init_state(x, y, gen)
    for _ in range(atk.epoch):
        d = state.delta.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(loss_fn(d, state), d)
        atk.grad_evals += 1
        momentum = atk.get_momentum(grad, state.momentum) if use_momentum else state.momentum
        state = dataclasses.replace(
            state, delta=atk.update_delta(state.delta, x,
                                          sign * (momentum if use_momentum else grad)),
            momentum=momentum, step=state.step + 1)
    return atk.finalize(state, x, y)
