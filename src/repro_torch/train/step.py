"""Train and eval steps.

Counterpart of ``repro.train.step``.  ``make_train_step`` returns a
``(state, batch) -> (state, metrics)`` function: the loss and its
gradients by ``torch.autograd``, then ``adamw_update``.  Options:

  * microbatches=N   -- gradient accumulation over N equal slices of the
                        batch's leading axis, the losses and gradients
                        summed in float32 and scaled by 1/N;
  * grad_compression -- with a mesh that has a "pod" axis (this process
                        one of its ranks), the MXInt-compressed pod-axis
                        gradient reduction: each pod takes its slice of
                        the batch, computes its gradients, adds its
                        error-feedback residual, compresses, and the
                        dequantized payloads are summed over the pods
                        (``compressed_psum``) and divided by their
                        number; the loss is the pods' mean.  Without
                        such a mesh it is off, as in the reference.

Gradients flow in the modes the reference trains in: "off" (float),
"fake" (quantize-dequantize with straight-through gradients) and "sim"
(whose integer stages stop gradients, as the reference's do).  Kernel
mode and packed ``MXTensor`` planes carry no gradient (a kernel launch is
invisible to autograd), so the step raises ``ValueError`` for them before
any forward, rather than seem to train while every gradient is dropped.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core import gradient_compression as gc
from repro_torch.core.quantize import MXTensor
from repro_torch.models.model_api import Param, tree_leaves, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.parallel import collectives
from repro_torch.train.state import TrainState


def check_trainable(model, params=None) -> None:
    """Raise ``ValueError`` unless ``model`` (and ``params``, when given)
    can carry gradients: no kernel mode in any layer group, no packed
    planes."""
    if "kernel" in model.cfg.quant.modes():
        raise ValueError("mode='kernel' is inference only: the Hopper "
                         "kernels carry no gradient; train in 'off', "
                         "'fake' or 'sim'")
    if params is not None:
        for leaf in tree_leaves(params):
            if isinstance(leaf.value, MXTensor):
                raise ValueError("packed MXTensor planes carry no gradient; "
                                 "train on float parameters")


def _slice(batch: Dict, i: int, n: int) -> Dict:
    out = {}
    for k, x in batch.items():
        x = torch.as_tensor(x)
        size = x.shape[0] // n
        out[k] = x[i * size:(i + 1) * size]
    return out


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss as a float32 scalar, detached; the gradient of every leaf of
    ``params`` in ``tree_leaves`` order, zeros where the loss does not
    reach it)."""
    leaves = [p.value for p in tree_leaves(params)]
    loss = loss_fn(params, batch)
    if loss.requires_grad:
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    else:
        grads = [None] * len(leaves)
    grads = [torch.zeros_like(v) if g is None else g
             for g, v in zip(grads, leaves)]
    return loss.detach(), grads


def _microbatch_value_and_grad(loss_fn, params, batch, n_micro: int):
    """Accumulate the loss and gradients over n_micro slices of the
    leading batch axis, in float32, then scale by 1/n_micro."""
    loss_acc = None
    grad_acc = [torch.zeros(p.value.shape, dtype=torch.float32,
                            device=p.value.device)
                for p in tree_leaves(params)]
    for i in range(n_micro):
        loss, grads = value_and_grad(loss_fn, params,
                                     _slice(batch, i, n_micro))
        loss_acc = (torch.zeros((), dtype=torch.float32, device=loss.device)
                    if loss_acc is None else loss_acc) + loss
        grad_acc = [a + g for a, g in zip(grad_acc, grads)]
    scale = 1.0 / n_micro
    return loss_acc * scale, [g * scale for g in grad_acc]


def _has_pod_axis(mesh) -> bool:
    names = getattr(mesh, "axis_names", None) or getattr(
        mesh, "mesh_dim_names", None) or ()
    return "pod" in names


def make_train_step(model, *, lr_fn: Callable, opt_cfg: AdamWConfig = None,
                    microbatches: int = 1, grad_compression: bool = False,
                    mesh=None) -> Callable:
    opt_cfg = opt_cfg or AdamWConfig()
    check_trainable(model)
    use_compression = (grad_compression and mesh is not None
                       and _has_pod_axis(mesh))

    def loss_fn(params, batch):
        return model.loss(params, batch).to(torch.float32)

    def compute_grads(params, batch):
        if microbatches > 1:
            return _microbatch_value_and_grad(loss_fn, params, batch,
                                              microbatches)
        return value_and_grad(loss_fn, params, batch)

    def train_step(state: TrainState, batch):
        check_trainable(model, state.params)
        if use_compression:
            loss, grads, err_fb = _pod_compressed_grads(
                compute_grads, state.params, batch, state.err_fb, mesh)
        else:
            loss, grads = compute_grads(state.params, batch)
            err_fb = state.err_fb
        grads = tree_unflatten(state.params, [
            Param(g, p.axes) for g, p in zip(grads,
                                             tree_leaves(state.params))])
        lr = lr_fn(state.step)
        new_params, new_opt, gnorm = adamw_update(
            grads, state.opt, state.params, lr, opt_cfg)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": state.step}
        return TrainState(new_params, new_opt, state.step + 1,
                          err_fb), metrics

    return train_step


def _pod_compressed_grads(compute_grads, params, batch, err_fb, mesh):
    """This pod's gradients of its slice of ``batch``, reduced over the
    mesh's "pod" axis by ``compressed_psum`` and divided by the pod count;
    the loss averaged over the pods.  ``err_fb`` holds a residual per pod
    on a leading axis (``train_state_from_params(grad_compression=True,
    n_pods=)``): this rank reads and writes its pod's row, as the
    reference keeps row p on pod p's devices.  Returns (loss, gradients
    in ``tree_leaves`` order, the new error state)."""
    if err_fb is None:
        raise ValueError("grad_compression over a 'pod' mesh needs the "
                         "error state: make the train state with "
                         "grad_compression=True and n_pods=")
    names = tuple(mesh.mesh_dim_names)
    n_pods = mesh.size(names.index("pod"))
    pod = mesh.get_local_rank("pod")
    group = mesh.get_group("pod")
    loss, grads = compute_grads(params, _slice(batch, pod, n_pods))
    errs = [e.value[pod] for e in tree_leaves(err_fb)]
    red, new = gc.compressed_psum(grads, group, errs)
    grads = [g / n_pods for g in red]
    loss = collectives.all_reduce_sum(loss, group) / n_pods
    rows = []
    for e, r in zip(tree_leaves(err_fb), new):
        v = e.value.clone()
        v[pod] = r
        rows.append(Param(v, e.axes))
    return loss, grads, tree_unflatten(err_fb, rows)


def make_eval_step(model) -> Callable:
    """``(params, batch) -> loss``, with no autograd graph."""
    def eval_step(params, batch):
        with torch.no_grad():
            return model.loss(params, batch)
    return eval_step
