"""The generic fit step: one AdamW step of a differentiable objective.

The port of `repro.training.steps.make_fit_step` (the LM train, serve and
prefill steps come with the LM substrate).
"""

from __future__ import annotations

import torch

from repro_torch.optim.optimizers import (apply_updates, clip_by_global_norm,
                                          tree_leaves, tree_map,
                                          tree_unflatten)


def make_fit_step(opt, loss_fn, *, clip: float = 1.0):
    """Single-program fit step for non-LM objectives.

    `loss_fn(params, *args) -> (loss, aux_dict)`; `opt` an
    `repro_torch.optim.Optimizer`. Returns ``fit_step(state, *args) ->
    (new_state, metrics)`` over the reference's ``{"params", "opt",
    "step"}`` state. The loss and the gradients come from
    `torch.autograd.grad` on leaf copies of the parameters; the update runs
    without autograd. Metrics are the aux values, the loss before the
    update and the gradients' global norm before clipping, all detached.
    This is what `launch.fit` drives: the loss closes over
    `ops.mwd_diff` and `params` is the coefficient field being recovered.
    """
    def fit_step(state, *args):
        params, opt_state, step = state["params"], state["opt"], state["step"]
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        grads, gnorm = clip_by_global_norm(grads, clip)
        updates, new_opt = opt.update(grads, opt_state, params, step)
        new_params = apply_updates(params, updates)
        metrics = dict(tree_map(torch.Tensor.detach, aux),
                       loss=loss.detach(), grad_norm=gnorm)
        return ({"params": new_params, "opt": new_opt, "step": step + 1},
                metrics)

    return fit_step
