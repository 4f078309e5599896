"""Train state: parameters, AdamW moments, the step counter and the
gradient-compression error feedback, with the logical-axes plumbing.

Counterpart of ``repro.train.state``.  Parameters are leaf tensors that
require a gradient, wrapped in ``Param`` with their logical axes; the
step counter is an int32 scalar on the parameters' device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.model_api import Param, tree_map
from repro_torch.optim.adamw import AdamWState, adamw_init


class TrainState(NamedTuple):
    params: Any                  # Param-wrapped tree
    opt: AdamWState
    step: torch.Tensor
    err_fb: Any = None           # gradient-compression error feedback


def _trainable(p: Param) -> Param:
    return Param(p.value.detach().requires_grad_(True), p.axes)


def train_state_from_params(params, *, grad_compression: bool = False,
                            n_pods: int = 1) -> TrainState:
    """A fresh state (zero moments, step 0) around ``params``, made leaf
    tensors that require a gradient."""
    params = tree_map(_trainable, params)
    opt = adamw_init(params)
    err = None
    if grad_compression:
        # per-pod error-feedback residuals, a leading n_pods axis
        err = tree_map(lambda p: Param(torch.zeros(
            (n_pods,) + tuple(p.value.shape), dtype=torch.float32,
            device=p.value.device), ("pods",) + tuple(p.axes)), params)
    return TrainState(params=params, opt=opt, step=torch.zeros(
        (), dtype=torch.int32, device=opt.step.device), err_fb=err)


def make_train_state(model, seed: int = 0, device="cuda", *,
                     grad_compression: bool = False,
                     n_pods: int = 1) -> TrainState:
    """The state of a model's random initial parameters from ``seed``
    (``model.init(seed, device)``)."""
    return train_state_from_params(model.init(seed, device=device),
                                   grad_compression=grad_compression,
                                   n_pods=n_pods)


def _spec_params(spec, dtype):
    """A model's (shape, axes, init) spec as Params of meta tensors."""
    if isinstance(spec, dict):
        return {k: _spec_params(v, dtype) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_spec_params(v, dtype) for v in spec]
    shape, axes, _ = spec
    return Param(torch.empty(shape, dtype=dtype, device="meta"), axes)


def abstract_train_state(model, *, grad_compression: bool = False,
                         n_pods: int = 1) -> TrainState:
    """The state's shapes and dtypes on the ``meta`` device: nothing is
    allocated (the dry-run path, a restore's ``like``)."""
    params = _spec_params(model.param_spec(), model.cfg.dtype)
    return train_state_from_params(params, grad_compression=grad_compression,
                                   n_pods=n_pods)


def train_state_axes(state: TrainState) -> TrainState:
    """The logical-axes tree matching the state's structure."""
    p_axes = tree_map(lambda p: tuple(p.axes), state.params)
    err_axes = None
    if state.err_fb is not None:
        err_axes = tree_map(lambda p: ("pods",) + tuple(p.axes),
                            state.params)
    return TrainState(params=p_axes,
                      opt=AdamWState(step=(), mu=p_axes, nu=p_axes),
                      step=(), err_fb=err_axes)


def train_state_to(state: TrainState, device) -> TrainState:
    """The state on ``device``, parameters again leaves requiring a
    gradient."""
    def move(t):
        if isinstance(t, Param):
            return Param(move(t.value), t.axes)
        out = t.detach().to(device)
        return out.requires_grad_(True) if t.requires_grad else out

    opt = state.opt
    return TrainState(
        params=tree_map(move, state.params),
        opt=AdamWState(move(opt.step), tree_map(move, opt.mu),
                       tree_map(move, opt.nu)),
        step=move(state.step),
        err_fb=None if state.err_fb is None else tree_map(move,
                                                          state.err_fb))
