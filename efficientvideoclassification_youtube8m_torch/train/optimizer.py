"""Optimizers and schedules with TF 1.3 semantics (port of the JAX
package's train/optimizer.py).

  * `exponential_decay` steps by ``global_step * batch_size /
    decay_examples`` (staircased with floor), computed in float32; the
    learning rate is a per-call input of `update`, because the shared
    global step that drives it advances by 2 per batch in faithful mode;
  * TF-Adam keeps epsilon OUTSIDE the bias correction:
    ``lr * sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)`` (torch.optim.Adam
    puts it elsewhere, so it is not used);
  * slim's `clip_gradient_norm` clips EACH gradient tensor by its own
    norm, not by the global norm.

Parameters, gradients and slots are dicts of tensors keyed by parameter
name (``dict(module.named_parameters())``). `Optimizer.update` runs under
``torch.no_grad()`` and updates the parameters and the slots IN PLACE.
The learning rate and the step count stay 0-dim CPU tensors, which
PyTorch reads as scalars in the device's elementwise kernels.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

import torch

Tensors = Dict[str, torch.Tensor]


def exponential_decay(
    base_learning_rate: float,
    batch_size: int,
    decay_examples: float,
    decay_rate: float,
    staircase: bool = True,
) -> Callable[[Union[int, torch.Tensor]], torch.Tensor]:
    """`tf.train.exponential_decay(base, step*batch, decay_examples, rate)`;
    the schedule returns a float32 scalar tensor."""

    def schedule(global_step) -> torch.Tensor:
        p = (torch.as_tensor(global_step).to(torch.float32) * batch_size
             / decay_examples)
        if staircase:
            p = torch.floor(p)
        return base_learning_rate * decay_rate ** p

    return schedule


def clip_grads_per_variable(grads: Tensors, max_norm: float) -> Tensors:
    """slim.learning.clip_gradient_norms: per-tensor clip_by_norm."""

    def clip(g):
        norm = torch.sqrt(torch.sum(torch.square(g)))
        return g * torch.clamp(max_norm / torch.clamp(norm, min=1e-30),
                               max=1.0)

    return {name: clip(g) for name, g in grads.items()}


def _zeros(params: Tensors) -> Tensors:
    return {name: torch.zeros_like(p) for name, p in params.items()}


def _tf_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    def init_fn(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update_fn(grads, state, params, lr):
        state["count"] += 1
        t = torch.tensor(state["count"], dtype=torch.float32)
        lr_t = lr * torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        for name, p in params.items():
            g, m, v = grads[name], state["mu"][name], state["nu"][name]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p.sub_(lr_t * m / (torch.sqrt(v) + eps))
        return state

    return init_fn, update_fn


def _sgd(momentum: float = 0.0):
    def init_fn(params):
        return {"accum": _zeros(params)} if momentum else {}

    def update_fn(grads, state, params, lr):
        for name, p in params.items():
            step = grads[name]
            if momentum:
                # tf.train.MomentumOptimizer: accum = momentum*accum + g;
                # var -= lr * accum
                step = state["accum"][name].mul_(momentum).add_(step)
            p.sub_(lr * step)
        return state

    return init_fn, update_fn


def _rmsprop(decay: float = 0.9, momentum: float = 0.0, eps: float = 1e-10):
    def init_fn(params):
        return {"ms": {n: torch.ones_like(p) for n, p in params.items()},  # TF
                "mom": _zeros(params)}

    def update_fn(grads, state, params, lr):
        for name, p in params.items():
            g, ms, mom = grads[name], state["ms"][name], state["mom"][name]
            ms.mul_(decay).add_((1 - decay) * g * g)
            mom.mul_(momentum).add_(lr * g / torch.sqrt(ms + eps))
            p.sub_(mom)
        return state

    return init_fn, update_fn


def _adagrad(initial_accumulator_value: float = 0.1):
    def init_fn(params):
        return {"accum": {n: torch.full_like(p, initial_accumulator_value)
                          for n, p in params.items()}}

    def update_fn(grads, state, params, lr):
        for name, p in params.items():
            g = grads[name]
            accum = state["accum"][name].add_(g * g)
            p.sub_(lr * g / torch.sqrt(accum))
        return state

    return init_fn, update_fn


_BUILDERS = {
    "AdamOptimizer": _tf_adam,
    "GradientDescentOptimizer": _sgd,
    "MomentumOptimizer": lambda: _sgd(momentum=0.9),
    "RMSPropOptimizer": _rmsprop,
    "AdagradOptimizer": _adagrad,
}


class Optimizer:
    """(init, update) pair taking the learning rate as a per-call input.

    `init(params)` returns the slots; `update(grads, state, params,
    learning_rate)` clips the gradients (per variable, when
    `clip_gradient_norm` > 0), then updates `params` and the slots of
    `state` in place under ``torch.no_grad()``, and returns `state`."""

    def __init__(self, init_fn, update_fn, clip_gradient_norm: float = 0.0):
        self._init = init_fn
        self._update = update_fn
        self.clip_gradient_norm = clip_gradient_norm

    def init(self, params: Tensors) -> dict:
        with torch.no_grad():
            return self._init(params)

    def update(self, grads: Tensors, state: dict, params: Tensors,
               learning_rate) -> dict:
        lr = torch.as_tensor(learning_rate, dtype=torch.float32)
        with torch.no_grad():
            if self.clip_gradient_norm > 0:
                grads = clip_grads_per_variable(grads, self.clip_gradient_norm)
            return self._update(grads, state, params, lr)


def make_optimizer(optimizer_name: str, clip_gradient_norm: float = 1.0
                   ) -> Optimizer:
    """The flag-named optimizer with the reference's clipping (the
    reference resolves `--optimizer` by name inside `tf.train`)."""
    if optimizer_name not in _BUILDERS:
        raise ValueError(
            f"Unknown optimizer {optimizer_name!r}; known: {sorted(_BUILDERS)}")
    init_fn, update_fn = _BUILDERS[optimizer_name]()
    return Optimizer(init_fn, update_fn, clip_gradient_norm)
